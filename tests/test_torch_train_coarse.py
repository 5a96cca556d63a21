"""The port's coarse+fine parity train step, eval step and full render
against the JAX package.

The JAX side runs its XLA path (``USE_PALLAS=false``; with
``STOP_PDF_GRADIENT`` also its fused megakernel path in interpret mode)
at tiny widths; both sides start from the same JAX-initialized params
(random nonzero biases added, so the bias paths are under test) and the
JAX step's draws are replayed into the port by copying its key schedule:
``fold_in(key, step)`` -> split into the t key and the pdf key, then
``jax.random.uniform`` of ``(B, NS_COARSE)`` and ``(B, NS_FINE)``
(``step.py:935``, ``sampling.py:140``).

The port on the CPU takes each kernel's plain version: under
``STOP_PDF_GRADIENT`` the plain K1 (encode, MLP, composite) and autograd
for K2, otherwise ``make_forward_pass`` with the plain K5
(``NeRFMLP.forward``) and autograd through ``sample_pdf``.

Tolerances, against the errors the assertions compute (float32,
summation order only; measured at these inputs in brackets): metrics,
relative, 5e-4 [2.4e-7]; gradients, per leaf max |diff| over the leaf's
largest entry, 5e-4 [1.1e-6 with STOP_PDF_GRADIENT; without it 4.8e-6,
in the coarse leaves, whose gradient runs through sample_pdf's
1/denominator]; params and EMA after Adam as ``tests/test_torch_train.py``
holds them (Adam's first update is nearly ``-lr * sign(g)``, so they
agree at atol 5e-4 where the gradient is resolved and within ``2 lr``
elsewhere).
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
from nerf_keras_tpu_torch.engine import step as pstep
from nerf_keras_tpu_torch.engine.trainer import Trainer
from nerf_keras_tpu_torch.ops.kernels import fused_mlp as k5
from nerf_keras_tpu_torch.ops.kernels import fused_render as k1
from nerf_keras_tpu_torch.ops.rays import pose_spherical

# One torch thread beside the JAX workers of the tier-1 run.
torch.set_num_threads(1)

NEAR, FAR = 2.0, 6.0
LR = 5e-3
GRAD_TOL = 5e-4


def _cfg(**kw):
    base = dict(
        batch_size=24, ns_coarse=8, ns_fine=16, num_layers=4, hidden_dim=32,
        skip_layer=2, l_xyz=4, l_dir=2, compute_dtype="float32", use_pallas=False,
        ema_decay=0.9, learning_rate=LR, height=8, width=8,
    )
    base.update(kw)
    return NeRFConfig(**base).validate()


def _batch(seed, b):
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 1, (b, 3)).astype(np.float32)
    dirs = rng.normal(size=(b, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    origins = (np.tile([0, 0, 4.0], (b, 1)) + rng.normal(size=(b, 3)) * 0.1).astype(np.float32)
    return images, origins, dirs


def _draws(cfg, key, step, b):
    key_t, key_pdf = jax.random.split(jax.random.fold_in(key, step))
    t = np.array(jax.random.uniform(key_t, (b, cfg.ns_coarse)))
    pdf = np.array(jax.random.uniform(key_pdf, (b, cfg.ns_fine), dtype=jnp.float32))
    return {"t": torch.as_tensor(t), "pdf": torch.as_tensor(pdf)}


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _grab_grads():
    """An optax transform whose state after ``update`` is the gradients."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g),
    )


def _jax_state(cfg, step=0):
    st = jstep.init_train_state(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(3)

    def bias(x):
        x = np.asarray(x, np.float32)
        if x.ndim != 1:
            return jnp.asarray(x)
        return jnp.asarray(x + (rng.normal(size=x.shape) * 0.1).astype(np.float32))

    params = jax.tree_util.tree_map(bias, st.params)
    ema = jax.tree_util.tree_map(lambda x: jnp.array(x, copy=True), params)
    return st._replace(params=params, ema=ema, step=jnp.asarray(step, jnp.int32))


def _port(cfg, st):
    tr = Trainer(cfg, NEAR, FAR, device="cpu")
    tr.replace_params(jax.tree_util.tree_map(np.asarray, st.params))
    tr.step = int(st.step)
    return tr


STEP_CASES = {
    "stop": dict(),
    "stop_dist_white": dict(distortion_loss_mult=1e-4, white_bkgd=True),
    "stop_coarse_only": dict(ns_fine=0),
    "pdf_grad": dict(stop_pdf_gradient=False),
    "pdf_grad_dist_white": dict(stop_pdf_gradient=False, distortion_loss_mult=1e-4,
                                white_bkgd=True),
    "stop_fused_interpret": dict(use_pallas=True),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_parity_train_step_matches_jax(case, monkeypatch):
    """One full parity step at step 3: metrics, each gradient leaf of both
    models before Adam, params and EMA after it."""
    cfg = _cfg(**STEP_CASES[case])
    st = _jax_state(cfg, 3)
    key = jax.random.PRNGKey(11)
    batch = _batch(1, cfg.batch_size)
    jbatch = tuple(jnp.asarray(x) for x in batch)

    new_st, jm = jstep.make_train_step(cfg, NEAR, FAR)(st, jbatch, key)
    with monkeypatch.context() as m:
        m.setattr(jstep, "make_optimizer", lambda c: _grab_grads())
        grads = jstep.make_train_step(cfg, NEAR, FAR)(
            st._replace(opt_state=_grab_grads().init(st.params)), jbatch, key)[0].opt_state

    tr = _port(cfg, st)
    before = (k1.launches, k1.bwd_launches, k5.launches, k5.bwd_launches)
    pm = tr.train_step(batch, draws=_draws(cfg, key, 3, cfg.batch_size))
    assert (k1.launches, k1.bwd_launches, k5.launches, k5.bwd_launches) == before
    assert tr.step == 4
    merr = max(abs(float(pm[k]) / float(jm[k]) - 1.0) for k in ("loss_coarse", "loss", "psnr"))
    assert merr <= 5e-4, merr

    jg = _leaves(grads)
    pg = _leaves(tr.params_tree(grad=True))
    assert len(jg) == len(pg) == 2 * len(_leaves(st.params["fine"]))
    gerr = [float(np.abs(c - a).max() / max(np.abs(a).max(), 1e-12)) for a, c in zip(jg, pg)]
    assert max(gerr) <= GRAD_TOL, gerr

    for after_j, after_p in ((new_st.params, tr.params_tree()), (new_st.ema, tr.ema_tree())):
        scale = 1.0 if after_j is new_st.params else 1.0 - cfg.ema_decay
        for a, c, g in zip(_leaves(after_j), _leaves(after_p), jg):
            resolved = np.abs(g) > 1e-3 * np.abs(g).max()
            np.testing.assert_allclose(c[resolved], a[resolved], atol=5e-4 * scale, rtol=0)
            assert np.all(np.abs(c - a) <= 2 * LR * scale * 1.001 + 1e-6)


def test_pdf_gradient_reaches_the_coarse_model():
    """STOP_PDF_GRADIENT=false moves the coarse gradients (the fine loss
    reaches the coarse MLP through sample_pdf); the fine ones do not move."""
    batch, draws = _batch(2, 24), None
    got = {}
    for stop in (True, False):
        cfg = _cfg(stop_pdf_gradient=stop)
        tr = _port(cfg, _jax_state(cfg))
        draws = draws or _draws(cfg, jax.random.PRNGKey(5), 0, 24)
        tr.train_step(batch, draws=draws)
        got[stop] = tr.params_tree(grad=True)
    dc = max(float(np.abs(a - b).max() / np.abs(b).max())
             for a, b in zip(_leaves(got[False]["coarse"]), _leaves(got[True]["coarse"])))
    df = max(float(np.abs(a - b).max() / np.abs(b).max())
             for a, b in zip(_leaves(got[False]["fine"]), _leaves(got[True]["fine"])))
    assert dc > 1e-2 and df < 1e-5


@pytest.mark.parametrize("white", [False, True])
def test_eval_step_matches_jax(white):
    cfg = _cfg(white_bkgd=white)
    st = _jax_state(cfg)
    batch = _batch(4, cfg.batch_size)
    jm = jstep.make_eval_step(cfg, NEAR, FAR)(st, tuple(jnp.asarray(x) for x in batch))
    tr = _port(cfg, st)
    pm = pstep.make_eval_step(cfg, NEAR, FAR)(tr.params, tr.put_batch(batch))
    for k in ("loss_coarse", "loss", "psnr"):
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=5e-4, err_msg=k)
    got = tr.evaluate([batch])
    np.testing.assert_allclose(got["loss_coarse"], float(jm["loss_coarse"]), rtol=5e-4)


def test_full_render_matches_jax():
    """make_render_fn(full=True): all eight maps, and the Trainer's chunked
    render keeps them (keys that ask for weights_* or preds_* imply full)."""
    cfg = _cfg()
    st = _jax_state(cfg)
    _, o, d = _batch(5, 19)
    ref = jstep.make_render_fn(cfg, NEAR, FAR, full=True)(st, jnp.asarray(o), jnp.asarray(d))
    tr = _port(cfg, st)
    with torch.no_grad():
        out = pstep.make_render_fn(cfg, NEAR, FAR, full=True)(
            tr.params, torch.as_tensor(o), torch.as_tensor(d))
    assert sorted(out) == sorted(ref) and len(out) == 8
    for k in sorted(ref):
        want = np.asarray(ref[k])
        assert tuple(out[k].shape) == want.shape, k
        atol = 1e-3 if k.startswith("depth") else 1e-4
        np.testing.assert_allclose(out[k].numpy(), want, rtol=0, atol=atol, err_msg=k)
    chunked = tr.render_rays(o, d, chunk=7, keys=("preds_fine", "weights_coarse", "rgb_fine"))
    assert sorted(chunked) == ["preds_fine", "rgb_fine", "weights_coarse"]
    np.testing.assert_allclose(chunked["preds_fine"], out["preds_fine"].numpy(), rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="full=True"):
        pstep.make_render_fn(dataclasses.replace(cfg, train_sampler="proposal"), NEAR, FAR,
                             full=True)


def test_port_checkpoint_restores_in_jax(tmp_path):
    """A coarse+fine state trained by the port, saved in the JAX key layout
    (params, EMA, step, Adam state), loads into the JAX package's Trainer,
    which renders the same frame; and into a fresh port Trainer exactly."""
    cfg = _cfg(lr_final=1e-4, lr_decay_steps=20)
    tr = Trainer(cfg, NEAR, FAR, device="cpu")
    tr.train_epoch([_batch(6, cfg.batch_size)] * 2)
    path = str(tmp_path / "c.ckpt.npz")
    tr.save(path, scene={"near": NEAR, "far": FAR})

    jt = JaxTrainer(cfg, NEAR, FAR).restore(path)
    assert int(jt.state.step) == 2
    assert int(jt.state.opt_state[0].count) == 2
    for a, c in zip(_leaves(jt.state.params), _leaves(tr.params_tree())):
        np.testing.assert_array_equal(a, c)
    pose = pose_spherical(45.0, -30.0, 4.0)
    fj = jt.render_image(pose, 6, 6, 7.0)
    fp = tr.render_image(pose, 6, 6, 7.0)
    np.testing.assert_allclose(fp["rgb"], np.asarray(fj["rgb"]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(fp["depth"], np.asarray(fj["depth"]), rtol=0, atol=1e-3)

    fresh = Trainer(cfg, NEAR, FAR, device="cpu").restore(path)
    assert fresh.step == 2
    for x, y in zip(_leaves(tr.params_tree()) + _leaves(tr.ema_tree()),
                    _leaves(fresh.params_tree()) + _leaves(fresh.ema_tree())):
        np.testing.assert_array_equal(x, y)


def test_training_on_cpu_learns_in_both_modes():
    """A few bf16 steps on one batch lower the loss in both
    STOP_PDF_GRADIENT modes without launching a kernel."""
    batch = _batch(7, 24)
    before = (k1.launches, k1.bwd_launches, k5.launches, k5.bwd_launches)
    for stop in (True, False):
        tr = Trainer(_cfg(stop_pdf_gradient=stop, compute_dtype="bfloat16"), NEAR, FAR,
                     device="cpu")
        first = float(tr.train_step(batch)["loss"])
        tr.train_epoch([batch] * 6)
        assert float(tr.train_step(batch)["loss"]) < first
    assert (k1.launches, k1.bwd_launches, k5.launches, k5.bwd_launches) == before
