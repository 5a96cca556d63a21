"""The port's proposal train step, eval step and render against the JAX package.

The JAX side runs its XLA path (``USE_PALLAS=false``) with the bench
recipe's knobs at tiny widths: distortion 1e-4, the sampling anneal, the
exploration floor, EMA 0.9 and an exponential LR decay.  Both sides start
from the same JAX-initialized params; the JAX step's draws are replayed
into the port by copying its key schedule (``fold_in(key, step)`` ->
split into t and chain keys; with the aux pass on the step, the chain key
split again into (chain, aux); one split per chain level; then
``jax.random.uniform``).

Tolerances.  float32: metrics rtol 5e-4; gradients per leaf rtol 5e-4 and
atol 5e-4 x the leaf's largest entry.  Adam's first update is
``-lr * g / (|g| + 1e-7)``, i.e. nearly ``-lr * sign(g)``, so a gradient
entry that is rounding noise (``|g|`` below 1e-3 of its leaf's largest)
can flip sign between the frameworks: params and EMA after the step agree
at atol 5e-4 where the gradient is resolved and within the Adam bound
``2 lr`` elsewhere.  bf16: as stated at ``BF16_GRAD_TOL``.
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
from nerf_keras_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from nerf_keras_tpu_torch.engine import step as pstep
from nerf_keras_tpu_torch.engine.trainer import Trainer
from nerf_keras_tpu_torch.ops.kernels import fused_render as k1
from nerf_keras_tpu_torch.ops.proposal import proposal_from_jax
from nerf_keras_tpu_torch.ops.rays import pose_spherical

# See tests/test_torch_fused_render.py: one torch thread beside JAX workers.
torch.set_num_threads(1)

NEAR, FAR = 2.0, 6.0
LR = 5e-3
# bf16: the fine MLP's products round operands to bf16 on both sides but
# sum in another order, and a flip of a hidden activation's rounding moves
# a few gradient entries: measured 1.2e-3 of the leaf scale (gradients)
# and 1.0e-5 relative (metrics) at these inputs; bounds ~10x above.
# (float32 measured 2.7e-4 and 3.8e-7.)
BF16_GRAD_TOL = 1.5e-2
BF16_METRIC_TOL = 2e-4


def _cfg(levels=1, dtype="float32", **kw):
    extra = dict(prop_levels=2, prop_samples=6) if levels == 2 else {}
    base = dict(
        batch_size=20, ns_coarse=8, ns_fine=12, num_layers=4, hidden_dim=32,
        skip_layer=2, l_xyz=4, l_dir=2, compute_dtype=dtype, use_pallas=False,
        train_sampler="proposal", distortion_loss_mult=1e-4,
        prop_anneal_steps=10, prop_explore=0.03, ema_decay=0.9,
        learning_rate=LR, lr_final=1e-4, lr_decay_steps=50, height=8, width=8,
    )
    base.update(extra)
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
    """The uniforms JAX's train step draws at ``step`` (step.py:935,
    proposal.py:379, sampling.py:67 and :136-140; the aux pass's split at
    step.py:785-786 and its stratified t at :826-829)."""
    key_t, key_pdf = jax.random.split(jax.random.fold_in(key, step))
    t_shape = (b, cfg.ns_coarse) if cfg.sampling_mode == "stratified" else (cfg.ns_coarse,)
    union = cfg.prop_union or (cfg.prop_union_every > 0 and step % cfg.prop_union_every == 0)
    out = {}
    if cfg.prop_aux_samples and not union:
        key_pdf, key_aux = jax.random.split(key_pdf)
        out["aux"] = torch.as_tensor(np.array(
            jax.random.uniform(key_aux, (b, cfg.prop_aux_samples))))
    chain, k = [], key_pdf
    n2 = cfg.prop_samples or cfg.ns_coarse
    for i in range(cfg.prop_levels):
        k, sub = jax.random.split(k)
        n = cfg.ns_fine if i == cfg.prop_levels - 1 else n2
        chain.append(torch.as_tensor(np.array(jax.random.uniform(sub, (b, n), dtype=jnp.float32))))
    t = torch.as_tensor(np.array(jax.random.uniform(key_t, t_shape)))
    return {"t": t, "chain": chain, **out}


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _grab_grads():
    """An optax transform whose state after ``update`` is the gradients
    themselves, with zero updates: it reads the JAX step's gradients."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g),
    )


def _jax_state(cfg, step):
    st = jstep.init_train_state(jax.random.PRNGKey(0), cfg)
    return st._replace(step=jnp.asarray(step, jnp.int32))


def _port(cfg, st):
    tr = Trainer(cfg, NEAR, FAR, device="cpu")
    tr.replace_params(jax.tree_util.tree_map(np.asarray, st.params))
    tr.step = int(st.step)
    return tr


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("levels", [1, 2])
def test_train_step_matches_jax(levels, dtype, monkeypatch):
    """One full proposal train step (at step 5: the anneal is mid-way):
    metrics, each gradient leaf before Adam, params and EMA after it."""
    _check_step_matches_jax(_cfg(levels, dtype), 5, monkeypatch)


def _check_step_matches_jax(cfg, step, monkeypatch):
    """One port train step at ``step`` against the JAX step from the same
    state, with the JAX draws replayed (module docstring)."""
    dtype = cfg.compute_dtype
    st = _jax_state(cfg, step)
    key = jax.random.PRNGKey(7)
    batch = _batch(1, cfg.batch_size)
    jbatch = tuple(jnp.asarray(x) for x in batch)

    new_st, jm = jstep.make_train_step(cfg, NEAR, FAR)(st, jbatch, key)
    with monkeypatch.context() as m:
        m.setattr(jstep, "make_optimizer", lambda c: _grab_grads())
        grads = jstep.make_train_step(cfg, NEAR, FAR)(
            st._replace(opt_state=_grab_grads().init(st.params)), jbatch, key)[0].opt_state

    tr = _port(cfg, st)
    pm = tr.train_step(batch, draws=_draws(cfg, key, step, cfg.batch_size))
    assert tr.step == step + 1
    mtol = 5e-4 if dtype == "float32" else BF16_METRIC_TOL
    for k in ("loss_coarse", "loss", "psnr"):
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=mtol, err_msg=k)

    gtol = 5e-4 if dtype == "float32" else BF16_GRAD_TOL
    jg = _leaves(grads)
    pg = _leaves(tr.params_tree(grad=True))
    assert len(jg) == len(pg)
    for a, c in zip(jg, pg):
        np.testing.assert_allclose(c, a, rtol=gtol, atol=gtol * np.abs(a).max())

    lr = LR  # Adam's first update reads the schedule at count 0
    for after_j, after_p in ((new_st.params, tr.params_tree()), (new_st.ema, tr.ema_tree())):
        scale = 1.0 if after_j is new_st.params else 1.0 - cfg.ema_decay
        for a, c, g in zip(_leaves(after_j), _leaves(after_p), jg):
            resolved = np.abs(g) > 1e-3 * np.abs(g).max()
            np.testing.assert_allclose(c[resolved], a[resolved], atol=5e-4 * scale, rtol=0)
            assert np.all(np.abs(c - a) <= 2 * lr * scale * 1.001 + 1e-6)


@pytest.mark.parametrize("lr_final", [None, 1e-4])
def test_adam_matches_optax(lr_final):
    """Five steps of identical gradients through optax's Adam (with and
    without the exponential decay) and the port's."""
    cfg = _cfg(lr_final=lr_final, lr_decay_steps=3 if lr_final else 0)
    rng = np.random.default_rng(0)
    shapes = [(4, 3), (3,), (7,)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    opt = jstep.make_optimizer(cfg)
    jp, state = list(params), opt.init(list(params))
    tp = [torch.tensor(p) for p in params]
    adam = pstep.make_optimizer(cfg, tp)
    for i in range(5):
        g = [rng.normal(size=s).astype(np.float32) * 10.0 ** (i - 2) for s in shapes]
        upd, state = opt.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        adam.step([torch.tensor(x) for x in g])
        for a, c in zip(jp, tp):
            np.testing.assert_allclose(c.numpy(), np.asarray(a), rtol=1e-6, atol=1e-7)
    if lr_final:
        assert adam.learning_rate(4) == pytest.approx(1e-4)  # clipped at LR_FINAL


@pytest.mark.parametrize("levels", [1, 2])
def test_eval_step_matches_jax(levels):
    cfg = _cfg(levels)
    st = _jax_state(cfg, 0)
    batch = _batch(2, cfg.batch_size)
    jm = jstep.make_eval_step(cfg, NEAR, FAR)(st, tuple(jnp.asarray(x) for x in batch))
    tr = _port(cfg, st)
    pm = pstep.make_eval_step(cfg, NEAR, FAR)(tr.params, tr.put_batch(batch))
    for k in ("loss_coarse", "loss", "psnr"):
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=5e-4, err_msg=k)
    # The Trainer evaluates the EMA shadow, which equals the params here.
    got = tr.evaluate([batch])
    np.testing.assert_allclose(got["loss"], float(jm["loss"]), rtol=5e-4)


@pytest.mark.parametrize("levels", [1, 2])
def test_proposal_render_matches_jax(levels):
    cfg = _cfg(levels)
    st = _jax_state(cfg, 0)
    _, o, d = _batch(3, 16)
    render = jstep.make_proposal_render_fn(
        cfg, NEAR, FAR, prop_l_xyz=cfg.prop_l_xyz, union=True, levels=levels,
        prop_samples=cfg.prop_samples)
    ref = render(st.params["proposal"], st.params["fine"], jnp.asarray(o), jnp.asarray(d))
    tr = _port(cfg, st)
    out = pstep.make_proposal_render_fn(
        cfg, NEAR, FAR, prop_l_xyz=cfg.prop_l_xyz, union=True, levels=levels,
        prop_samples=cfg.prop_samples)(
        tr.params["proposal"], tr.params["fine"], torch.as_tensor(o), torch.as_tensor(d))
    assert sorted(out) == ["depth_fine", "rgb_fine"]
    np.testing.assert_allclose(out["rgb_fine"].detach().numpy(), np.asarray(ref["rgb_fine"]),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(out["depth_fine"].detach().numpy(),
                               np.asarray(ref["depth_fine"]), atol=1e-3, rtol=0)
    frame = tr.render_image(pose_spherical(30.0, -30.0, 4.0), 6, 5, 6.0)
    np.testing.assert_allclose(
        frame["rgb"].reshape(-1, 3),
        tr.render_rays(*tr.pose_rays(pose_spherical(30.0, -30.0, 4.0), 6, 5, 6.0),
                       keys=("rgb_fine",))["rgb_fine"], rtol=0, atol=0)


def test_proposal_configs_are_supported():
    """Every TRAIN_SAMPLER=proposal config builds a Trainer and its render,
    in both sample layouts (before the port's training slice none did, and
    before the union-free slice the union-free layout did not)."""
    for levels, union in ((1, True), (2, True), (1, False), (2, False)):
        cfg = _cfg(levels, prop_union=union)
        pstep.make_render_fn(cfg, NEAR, FAR)
        tr = Trainer(cfg, NEAR, FAR, device="cpu")
        assert sorted(tr.params) == ["fine", "proposal"]
        assert all(p.requires_grad for m in tr.params.values() for p in m.parameters())
        assert not any(p.requires_grad for m in tr.ema.values() for p in m.parameters())


@pytest.mark.parametrize("knob", [
    dict(prop_union=False, step=5),
    dict(prop_union=False, prop_aux_samples=8, step=5),
    dict(prop_union=False, prop_union_every=2, step=0),
    dict(freq_anneal_steps=5),
    dict(prop_union=False, levels=2, step=5),
    dict(prop_union=False, prop_union_every=2, step=1),
])
def test_unported_training_knobs_raise(knob, monkeypatch):
    """The knobs this test once held as refused train now, each replayed
    against the JAX train step as :func:`test_train_step_matches_jax`
    (float32): the union-free layout at 1 and 2 levels, its aux coverage
    pass (JAX's aux key split replayed into ``draws['aux']``), and the
    interleave at a union step (0) and a union-free one (1).
    ``FREQ_ANNEAL_STEPS`` trains at the horizon exactly as without it;
    tests/test_torch_freq_anneal.py holds its steps inside the window."""
    knob = dict(knob)
    if "step" in knob:
        step, levels = knob.pop("step"), knob.pop("levels", 1)
        _check_step_matches_jax(_cfg(levels, prop_explore=0.1, **knob), step, monkeypatch)
        return
    cfg = _cfg(**knob)
    if "freq_anneal_steps" in knob:
        # At the horizon the window is all ones: the step is the
        # unannealed config's, bit for bit; one step earlier it is not.
        pstep.check_train_support(cfg)
        batch = _batch(0, cfg.batch_size)
        draws = _draws(cfg, jax.random.PRNGKey(3), 5, cfg.batch_size)
        ref = Trainer(_cfg(), NEAR, FAR, device="cpu")
        trainers = [Trainer(cfg, NEAR, FAR, device="cpu"),
                    Trainer(cfg, NEAR, FAR, device="cpu"), ref]
        for tr, step in zip(trainers, (5, 4, 5)):
            tr.replace_params(ref.params_tree())
            tr.step = step
        at, inside, want = [tr.train_step(batch, draws=draws) for tr in trainers]
        for k in ("loss_coarse", "loss", "psnr"):
            assert float(at[k]) == float(want[k]), k
        assert float(inside["loss"]) != float(want["loss"])
        for a, c in zip(_leaves(trainers[0].params_tree()), _leaves(ref.params_tree())):
            np.testing.assert_array_equal(a, c)


def test_float32_kernels_are_refused_on_cuda():
    """Its name is historical: float32 MLPs now train on CUDA through the
    f32 kernels (ops/kernels/fused_f32.py), so check_train_support takes
    no device and accepts either compute dtype."""
    for dtype in ("float32", "bfloat16"):
        pstep.check_train_support(_cfg(dtype=dtype))


def test_training_on_cpu_learns_and_is_seeded():
    """A few steps on one batch lower the loss; two trainers from one seed
    agree exactly; the CPU path launches no kernel; train_epoch and
    evaluate return floats."""
    cfg = _cfg(levels=2, dtype="bfloat16")
    batch = _batch(4, cfg.batch_size)
    before = (k1.launches, k1.bwd_launches)
    a, b = Trainer(cfg, NEAR, FAR, device="cpu"), Trainer(cfg, NEAR, FAR, device="cpu")
    first = float(a.train_step(batch)["loss"])
    ma = a.train_epoch([batch] * 6)
    mb = b.train_epoch([batch] * 7)
    assert (k1.launches, k1.bwd_launches) == before
    assert a.step == b.step == 7
    for x, y in zip(_leaves(a.params_tree()), _leaves(b.params_tree())):
        np.testing.assert_array_equal(x, y)
    last = float(a.train_step(batch)["loss"])
    assert last < first
    assert set(ma) == set(mb) == {"loss_coarse", "loss", "psnr"}
    ev = a.evaluate([batch])
    assert all(np.isfinite(v) for v in ev.values())


def test_checkpoint_round_trip(tmp_path):
    """A port-trained state (params, EMA, step, Adam state) written in the
    JAX key layout and read into a fresh Trainer renders the identical
    frame; its keys equal those the JAX save_checkpoint writes for the same
    tree."""
    cfg = _cfg(levels=2)
    tr = Trainer(cfg, NEAR, FAR, device="cpu")
    tr.train_epoch([_batch(5, cfg.batch_size)] * 2)
    path = str(tmp_path / "p.ckpt.npz")
    tr.save(path, scene={"near": NEAR, "far": FAR})
    fresh = Trainer(cfg, NEAR, FAR, device="cpu").restore(path)
    assert fresh.step == 2
    for x, y in zip(_leaves(tr.params_tree()) + _leaves(tr.ema_tree()),
                    _leaves(fresh.params_tree()) + _leaves(fresh.ema_tree())):
        np.testing.assert_array_equal(x, y)
    pose = pose_spherical(45.0, -30.0, 4.0)
    f0, f1 = tr.render_image(pose, 6, 6, 7.0), fresh.render_image(pose, 6, 6, 7.0)
    np.testing.assert_array_equal(f0["rgb"], f1["rgb"])
    np.testing.assert_array_equal(f0["depth"], f1["depth"])
    assert np.isfinite(f0["rgb"]).all() and f0["rgb"].std() > 0

    jpath = str(tmp_path / "j.ckpt.npz")
    jax_save_checkpoint(jpath, jstep.init_train_state(jax.random.PRNGKey(0), cfg), cfg)
    jkeys = set(np.load(jpath).files)
    assert set(np.load(path).files) == jkeys
    assert ".params['proposal']['l1']['layers'][0]['w']" in jkeys
    tree = proposal_from_jax(jax.tree_util.tree_map(
        np.asarray, jstep.init_train_state(jax.random.PRNGKey(0), cfg).params["proposal"]))
    assert sorted(tree) == ["l1", "l2"]
