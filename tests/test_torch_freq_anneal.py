"""The port's frequency anneal (``ops/freq_anneal.py``, ``FREQ_ANNEAL_STEPS``)
against the JAX package.

The window and the fold are elementwise float32 (one multiply per weight
entry), so both sides agree to 1e-7.  The train steps run mid-window (step
4 of 10: at L=4 octave 0 is open, octave 1 eased in at 0.6, octaves 2-3
masked) from the same JAX-initialized params with the JAX step's draws
replayed (``fold_in(key, step)`` -> split, as ``tests/test_torch_train.py``
and ``tests/test_torch_train_coarse.py``), at those files' tolerances:
float32 metrics rtol 5e-4, gradients per leaf rtol 5e-4 and atol 5e-4 x
the leaf's largest entry.  The masked columns' gradients are exactly 0 on
both sides, and Adam leaves those weights exactly where they were.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerf_keras_tpu.config import NeRFConfig
from nerf_keras_tpu.engine import step as jstep
from nerf_keras_tpu.engine.trainer import Trainer as JaxTrainer
from nerf_keras_tpu.ops import freq_anneal as jfa
from nerf_keras_tpu_torch.engine import step as pstep
from nerf_keras_tpu_torch.engine.trainer import Trainer
from nerf_keras_tpu_torch.ops import freq_anneal as pfa
from nerf_keras_tpu_torch.utils.checkpoint import models_to_jax

torch.set_num_threads(1)

NEAR, FAR = 2.0, 6.0
HORIZON, STEP = 10, 4
TOL = 5e-4


def _cfg(sampler="coarse", **kw):
    base = dict(batch_size=24, ns_coarse=8, ns_fine=16, num_layers=4, hidden_dim=32,
                skip_layer=2, l_xyz=4, l_dir=2, compute_dtype="float32", use_pallas=False,
                learning_rate=5e-3, height=8, width=8, freq_anneal_steps=HORIZON,
                train_sampler=sampler)
    if sampler == "proposal":
        base.update(prop_anneal_steps=10, ema_decay=0.9)
    base.update(kw)
    return NeRFConfig(**base).validate()


def _batch(seed, b):
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 1, (b, 3)).astype(np.float32)
    dirs = rng.normal(size=(b, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    origins = (np.tile([0, 0, 4.0], (b, 1)) + rng.normal(size=(b, 3)) * 0.1).astype(np.float32)
    return images, origins, dirs


def _jax_state(cfg, step):
    """JAX-initialized params with random biases (so every bias path is
    under test) at ``step``."""
    st = jstep.init_train_state(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(3)

    def bias(x):
        x = np.asarray(x, np.float32)
        if x.ndim == 1:
            x = x + (rng.normal(size=x.shape) * 0.1).astype(np.float32)
        return jnp.asarray(x)

    params = jax.tree_util.tree_map(bias, st.params)
    ema = None if st.ema is None else jax.tree_util.tree_map(jnp.array, params)
    return st._replace(params=params, ema=ema, step=jnp.asarray(step, jnp.int32))


def _port(cfg, st):
    tr = Trainer(cfg, NEAR, FAR, device="cpu")
    tr.replace_params(jax.tree_util.tree_map(np.asarray, st.params))
    tr.step = int(st.step)
    return tr


def _draws(cfg, key, step, b):
    """The JAX train step's uniforms at ``step``: the t key, then the pdf
    key (parity) or one split per chain level (proposal)."""
    key_t, key_pdf = jax.random.split(jax.random.fold_in(key, step))
    t = torch.as_tensor(np.array(jax.random.uniform(key_t, (b, cfg.ns_coarse))))
    if cfg.train_sampler != "proposal":
        pdf = np.array(jax.random.uniform(key_pdf, (b, cfg.ns_fine), dtype=jnp.float32))
        return {"t": t, "pdf": torch.as_tensor(pdf)}
    _, sub = jax.random.split(key_pdf)
    chain = np.array(jax.random.uniform(sub, (b, cfg.ns_fine), dtype=jnp.float32))
    return {"t": t, "chain": [torch.as_tensor(chain)]}


def _grab_grads():
    """An optax transform whose state after ``update`` is the gradients."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g),
    )


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _masked_rows(cfg, l_xyz, alpha):
    """The encoding rows (JAX layout) the window zeroes at ``alpha``."""
    w = np.asarray(jfa.freq_window(l_xyz, alpha))
    return np.flatnonzero(w == 0.0)


@pytest.mark.parametrize("alpha", [0.0, 0.37, 1.0])
@pytest.mark.parametrize("l_xyz", [0, 4, 10])
def test_freq_window_matches_jax(l_xyz, alpha):
    ours = pfa.freq_window(l_xyz, alpha).numpy()
    theirs = np.asarray(jfa.freq_window(l_xyz, alpha))
    assert ours.shape == theirs.shape == (3 + 6 * l_xyz,)
    np.testing.assert_allclose(ours, theirs, atol=1e-7, rtol=0)
    for step in (0, 3, 7, 13):
        assert pfa.anneal_alpha(step, 7) == float(jfa.anneal_alpha(step, 7))


@pytest.mark.parametrize("alpha", [0.0, 0.37, 1.0])
@pytest.mark.parametrize("sampler,levels", [("coarse", 1), ("proposal", 1), ("proposal", 2)])
def test_fold_train_params_matches_jax(sampler, levels, alpha):
    """Coarse/fine trees (the skip layer's trailing rows, the heads) and
    proposal chains of one and two levels, folded at the step where the
    anneal reads ``alpha``; the unfolded models are left as they were."""
    extra = dict(prop_levels=2, prop_samples=6) if levels == 2 else {}
    # num_layers 5 with skip 2: trunk[3] reads the skip concat and so does
    # the heads' input (layer 4 is a skip layer too).
    cfg = _cfg(sampler, num_layers=5, **extra)
    st = _jax_state(cfg, 0)
    tr = _port(cfg, st)
    step = int(round(alpha * HORIZON))
    folded = pfa.fold_train_params(cfg, tr.params, step)
    want = jfa.fold_train_params(cfg, st.params, step)
    got = models_to_jax(folded)
    for a, b in zip(_leaves(got), _leaves(want)):
        np.testing.assert_allclose(a, b, atol=1e-7, rtol=0)
    for a, b in zip(_leaves(tr.params_tree()), _leaves(st.params)):
        np.testing.assert_array_equal(a, b)
    if alpha == 0.0:
        rows = _masked_rows(cfg, cfg.l_xyz, 0.0)
        assert (got["fine"]["trunk"][0]["w"][rows] == 0).all()
    off = pfa.fold_train_params(_cfg(sampler, freq_anneal_steps=0), tr.params, step)
    assert isinstance(off, pfa.FoldedModels) and off.step == step
    assert all(off[k] is m for k, m in tr.params.items())


@pytest.mark.parametrize("sampler", ["coarse", "proposal"])
def test_train_step_mid_window_matches_jax(sampler, monkeypatch):
    """One parity step and one online-proposal step at step 4 of a 10-step
    anneal: metrics, every gradient leaf (the masked octaves' exactly 0),
    and the masked weights untouched by Adam."""
    cfg = _cfg(sampler)
    st = _jax_state(cfg, STEP)
    key = jax.random.PRNGKey(7)
    batch = _batch(1, cfg.batch_size)
    jbatch = tuple(jnp.asarray(x) for x in batch)
    monkeypatch.setattr(jstep, "make_optimizer", lambda c: _grab_grads())
    jst, jm = jstep.make_train_step(cfg, NEAR, FAR)(
        st._replace(opt_state=_grab_grads().init(st.params)), jbatch, key)
    grads = jst.opt_state

    tr = _port(cfg, st)
    before = tr.params_tree()
    pm = tr.train_step(batch, draws=_draws(cfg, key, STEP, cfg.batch_size))
    for k in ("loss_coarse", "loss", "psnr"):
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=TOL, err_msg=k)
    got = tr.params_tree(grad=True)
    for a, c in zip(_leaves(grads), _leaves(got)):
        np.testing.assert_allclose(c, a, rtol=TOL, atol=TOL * np.abs(a).max())

    alpha = STEP / HORIZON
    rows = _masked_rows(cfg, cfg.l_xyz, alpha)
    assert len(rows) == 12  # octaves 2 and 3
    nets = ["fine"] if sampler == "proposal" else ["coarse", "fine"]
    for name in nets:
        hidden = cfg.hidden_dim
        for tree in (got[name], jax.device_get(grads)[name]):
            assert (np.asarray(tree["trunk"][0]["w"])[rows] == 0).all()
            assert (np.asarray(tree["trunk"][3]["w"])[hidden + rows] == 0).all()
        after = tr.params_tree()[name]["trunk"][0]["w"]
        np.testing.assert_array_equal(after[rows], before[name]["trunk"][0]["w"][rows])
        assert not np.array_equal(after, before[name]["trunk"][0]["w"])
    if sampler == "proposal":
        prows = _masked_rows(cfg, cfg.prop_l_xyz, alpha)
        assert (got["proposal"]["layers"][0]["w"][prows] == 0).all()


def test_in_place_fold_restores_raw_weights():
    """The step folds the window into the parameters and must hand Adam the
    raw values back, also when the loss raises."""
    cfg = _cfg()
    tr = _port(cfg, _jax_state(cfg, STEP))
    raw = tr.params_tree()

    def boom(*a, **k):
        raise RuntimeError("boom")

    grad_fn = pstep.make_grad_fn(cfg, NEAR, FAR, render_pass=boom)
    with pytest.raises(RuntimeError, match="boom"):
        grad_fn(tr.state, tr.put_batch(_batch(1, cfg.batch_size)))
    for a, b in zip(_leaves(tr.params_tree()), _leaves(raw)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("sampler", ["coarse", "proposal"])
def test_eval_render_and_digest_mid_window_match_jax(sampler):
    """Eval, render and ``infer_digest`` read the eval weights folded at
    the current step (the JAX package folds the state it is given)."""
    cfg = _cfg(sampler)
    st = _jax_state(cfg, STEP)
    batch = _batch(2, cfg.batch_size)
    jm = jstep.make_eval_step(cfg, NEAR, FAR)(st, tuple(jnp.asarray(x) for x in batch))
    tr = _port(cfg, st)
    pm = tr.evaluate([batch])
    for k in ("loss_coarse", "loss", "psnr"):
        np.testing.assert_allclose(pm[k], float(jm[k]), rtol=TOL, err_msg=k)
    _, o, d = _batch(3, 16)
    ref = jstep.make_render_fn(cfg, NEAR, FAR)(st, jnp.asarray(o), jnp.asarray(d))
    out = tr.render_rays(o, d, keys=("rgb_fine",))
    np.testing.assert_allclose(out["rgb_fine"], np.asarray(ref["rgb_fine"]), atol=1e-4,
                               rtol=0)
    # The window matters here: the unfolded weights render otherwise, and
    # the annealed config's render refuses them.
    o_t, d_t = torch.as_tensor(o), torch.as_tensor(d)
    with torch.no_grad():
        raw = pstep.make_render_fn(dataclasses.replace(cfg, freq_anneal_steps=0), NEAR,
                                   FAR)(tr.params, o_t, d_t)["rgb_fine"]
    assert np.abs(raw.numpy() - np.asarray(ref["rgb_fine"])).max() > 1e-3
    for fn in (pstep.make_render_fn(cfg, NEAR, FAR),
               lambda m, o, d: pstep.make_eval_step(cfg, NEAR, FAR)(m, (o, o, d))):
        with pytest.raises(ValueError, match="fold_train_params"):
            fn(tr.eval_params, o_t, d_t)

    jt = JaxTrainer(cfg, NEAR, FAR)
    jt.replace_params(st.params)
    jt.state = jt.state._replace(step=st.step)
    assert tr.infer_digest() == jt.infer_digest()
    tr.step = HORIZON  # past the horizon the window is the identity
    jt.state = jt.state._replace(step=jnp.asarray(HORIZON, jnp.int32))
    assert tr.infer_digest() == jt.infer_digest()
    folded = tr._folded_eval_params()
    assert all(folded[k] is m for k, m in tr.eval_params.items())


def test_int8_render_mid_window_uses_the_folded_weights():
    """The int8 tables bake the folded fine weights; the online-proposal
    int8 render folds the live proposal net (JAX ``trainer.py:473-488``)."""
    cfg = _cfg("proposal")
    st = _jax_state(cfg, STEP)
    tr = _port(cfg, st)
    _, o, d = _batch(4, 64)
    tr.quantize_for_inference(o, d)
    flt = tr.render_rays(o, d, keys=("rgb_fine",))["rgb_fine"]
    q = tr.render_rays(o, d, keys=("rgb_fine",), quant=True)["rgb_fine"]
    assert np.abs(q - flt).max() < 2e-2
    jt = JaxTrainer(cfg, NEAR, FAR)
    jt.replace_params(st.params)
    jt.state = jt.state._replace(step=st.step)
    jt.quantize_for_inference(o, d)
    jq = jt.render_rays(o, d, keys=("rgb_fine",), quant=True)["rgb_fine"]
    np.testing.assert_allclose(q, jq, atol=5e-3, rtol=0)
