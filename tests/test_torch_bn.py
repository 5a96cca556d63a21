"""The BatchNorm MLP (``BATCH_NORM``) of the port against the JAX package.

* ``NeRFMLP(batch_norm=True)`` against ``apply_nerf_mlp`` with a
  ``bn_state``, float32, in training mode (batch statistics over all
  rays x samples) and inference mode (running statistics): raw
  predictions atol 1e-5; the running statistics after one training pass
  atol 1e-6, a tolerance that an update with the unbiased variance (what
  ``nn.BatchNorm1d`` stores) misses by more than 10x at these shapes.
* One coarse+fine train step of a BN config (the JAX step's XLA path; the
  port's plain path on every device) with the JAX draws replayed as in
  ``tests/test_torch_train_coarse.py``, held at that file's tolerances
  (a bias feeding a BN layer has zero gradient, rounding noise on both
  sides: it is held against its model's largest gradient entry), and the
  running statistics after it; the eval step and a frame.
* BN checkpoints both ways: the JAX package's ``save_checkpoint`` restored
  by the port's ``Trainer``, the port's restored by the JAX
  ``load_checkpoint``, which renders the same frame.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerf_keras_tpu.config import NeRFConfig
from nerf_keras_tpu.engine import step as jstep
from nerf_keras_tpu.models.mlp import apply_nerf_mlp, init_nerf_params
from nerf_keras_tpu.utils import checkpoint as jckpt
from nerf_keras_tpu_torch.engine.trainer import Trainer
from nerf_keras_tpu_torch.models import mlp as pmlp
from nerf_keras_tpu_torch.ops.kernels import fused_mlp as k5
from nerf_keras_tpu_torch.ops.kernels import fused_render as k1
from nerf_keras_tpu_torch.ops.rays import pose_spherical

torch.set_num_threads(1)

NEAR, FAR = 2.0, 6.0
LR = 5e-3
GRAD_TOL = 5e-4
PRED_TOL = 1e-5
STAT_TOL = 1e-6


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _bn_params(seed=0, layers=4, hidden=32, skip=2, l_xyz=4, l_dir=2):
    """JAX BN params with random gamma/beta/biases and random running stats."""
    params = init_nerf_params(jax.random.PRNGKey(seed), layers, hidden, skip, l_xyz, l_dir,
                              batch_norm=True)
    rng = np.random.default_rng(seed)

    def perturb(path, x):
        x = np.asarray(x, np.float32)
        name = jax.tree_util.keystr(path)
        if "gamma" in name:
            return x + rng.normal(size=x.shape).astype(np.float32) * 0.2
        if x.ndim == 1:
            return x + rng.normal(size=x.shape).astype(np.float32) * 0.1
        return x

    params = jax.tree_util.tree_map_with_path(perturb, params)
    stats = [{"mean": rng.normal(size=hidden).astype(np.float32) * 0.1,
              "var": rng.uniform(0.5, 1.5, hidden).astype(np.float32)} for _ in range(layers)]
    bn = {"trunk": stats, "branch": {
        "mean": rng.normal(size=hidden // 2).astype(np.float32) * 0.1,
        "var": rng.uniform(0.5, 1.5, hidden // 2).astype(np.float32)}}
    return params, bn


def _encodings(b=6, s=5, l_xyz=4, l_dir=2, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, 3 + 6 * l_xyz)).astype(np.float32)
    d = rng.normal(size=(b, s, 3 + 6 * l_dir)).astype(np.float32)
    return x, d


def _unbiased_forward(self, x, train, mesh=None):
    """A KerasBatchNorm that stores the unbiased batch variance, as
    ``nn.BatchNorm1d`` does: the mutation the statistics test must catch."""
    flat = x.reshape(-1, x.shape[-1])
    mean, var = flat.mean(dim=0), flat.var(dim=0, unbiased=True)
    with torch.no_grad():
        self.mean.copy_(pmlp.BN_MOMENTUM * self.mean + (1 - pmlp.BN_MOMENTUM) * mean)
        self.var.copy_(pmlp.BN_MOMENTUM * self.var + (1 - pmlp.BN_MOMENTUM) * var)
    inv = torch.rsqrt(flat.var(dim=0, unbiased=False) + pmlp.BN_EPS) * self.gamma
    return (x - mean) * inv + self.beta


@pytest.mark.parametrize("train", [False, True])
def test_bn_mlp_matches_jax(train, monkeypatch):
    params, bn = _bn_params()
    x, d = _encodings()
    want, want_bn = apply_nerf_mlp(params, jnp.asarray(x), jnp.asarray(d),
                                   compute_dtype=jnp.float32, skip_layer=2,
                                   bn_state=bn, train=train)
    mlp = pmlp.NeRFMLP.from_jax_params(_np(params), skip_layer=2,
                                       compute_dtype=torch.float32, bn_state=bn)
    assert mlp.batch_norm and len(mlp.bn_layers()) == 5
    with torch.no_grad():
        got = mlp(torch.as_tensor(x), torch.as_tensor(d), bn_train=train)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=PRED_TOL)
    got_bn = mlp.bn_state()
    for a, b in zip(_leaves(got_bn), _leaves(want_bn)):
        np.testing.assert_allclose(a, b, rtol=0, atol=STAT_TOL)
    if not train:
        for a, b in zip(_leaves(got_bn), _leaves(bn)):
            np.testing.assert_array_equal(a, b)  # inference leaves the stats alone
        return
    # The unbiased variance in the update misses the statistics' tolerance
    # by more than 10x (N = 30 samples: a 1/29 relative step).
    unbiased = pmlp.NeRFMLP.from_jax_params(_np(params), skip_layer=2,
                                            compute_dtype=torch.float32, bn_state=bn)
    monkeypatch.setattr(pmlp.KerasBatchNorm, "forward", _unbiased_forward)
    with torch.no_grad():
        unbiased(torch.as_tensor(x), torch.as_tensor(d), bn_train=True)
    miss = max(float(np.abs(a - b).max())
               for a, b in zip(_leaves(unbiased.bn_state()), _leaves(want_bn)))
    assert miss > 10 * STAT_TOL, miss


def test_bn_params_round_trip_and_refusals():
    params, bn = _bn_params()
    mlp = pmlp.NeRFMLP.from_jax_params(_np(params), skip_layer=2, bn_state=bn)
    for a, b in zip(_leaves(mlp.to_jax_params()), _leaves(params)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(_leaves(mlp.bn_state()), _leaves(bn)):
        np.testing.assert_array_equal(a, b)
    plain = pmlp.NeRFMLP(num_layers=4, hidden_dim=32, skip_layer=2, l_xyz=4, l_dir=2)
    with pytest.raises(ValueError, match="BatchNorm"):
        plain.load_jax_params(_np(params))
    # No kernel has BatchNorm: the kernel wrappers refuse a BN model.
    t = torch.linspace(2, 6, 5).expand(3, 5).contiguous()
    o, dirs = torch.zeros(3, 3), torch.ones(3, 3)
    with pytest.raises(ValueError, match="no BatchNorm"):
        k1.render_rays_fused(mlp, o, dirs, t, l_xyz=4, l_dir=2, skip_layer=2)
    x, d = _encodings()
    with pytest.raises(ValueError, match="no BatchNorm"):
        k5.apply_nerf_mlp_fused(mlp, torch.as_tensor(x), torch.as_tensor(d),
                                need_input_grads=False)


def _cfg(**kw):
    base = dict(
        batch_size=24, ns_coarse=8, ns_fine=16, num_layers=4, hidden_dim=32,
        skip_layer=2, l_xyz=4, l_dir=2, compute_dtype="float32", use_pallas=False,
        ema_decay=0.9, learning_rate=LR, height=8, width=8, batch_norm=True,
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


def _grab_grads():
    """An optax transform whose state after ``update`` is the gradients."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g),
    )


def _jax_state(cfg, step=0, seed=0):
    st = jstep.init_train_state(jax.random.PRNGKey(seed), cfg)
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
    tr.replace_params(_np(st.params), bn=_np(st.bn))
    tr.step = int(st.step)
    return tr


@pytest.mark.parametrize("stop", [True, False])
def test_bn_train_step_matches_jax(stop, monkeypatch):
    """One step at step 3: metrics, every gradient leaf (gamma/beta too),
    params and EMA after Adam, and the running statistics, which the EMA
    shadow shares; no kernel launches, on any device."""
    cfg = _cfg(stop_pdf_gradient=stop)
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

    jg, pg = _leaves(grads), _leaves(tr.params_tree(grad=True))
    assert len(jg) == len(pg) == 2 * len(_leaves(st.params["fine"]))
    # A bias feeding a BN layer (every trunk layer's, the branch's, and the
    # feature head's, which reaches the branch BN through its product) has
    # zero gradient: the batch mean subtracts it.  Those leaves are held
    # against the model's largest gradient entry, every other leaf against
    # its own.
    paths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(grads)[0]]
    model_max = {m: max(float(np.abs(g).max()) for p, g in zip(paths, jg) if p.startswith(m))
                 for m in ("['coarse']", "['fine']")}
    zero = {p for p, g in zip(paths, jg)
            if float(np.abs(g).max()) < 1e-6 * model_max[p[:p.index("]") + 1]]}
    assert zero == {p for p in paths if p.endswith("['b']") and "rgb" not in p
                    and "sigma" not in p}, sorted(zero)
    gerr = [float(np.abs(c - a).max()
                  / (model_max[p[:p.index("]") + 1]] if p in zero else np.abs(a).max()))
            for p, a, c in zip(paths, jg, pg)]
    assert max(gerr) <= GRAD_TOL, gerr

    for after_j, after_p in ((new_st.params, tr.params_tree()), (new_st.ema, tr.ema_tree())):
        scale = 1.0 if after_j is new_st.params else 1.0 - cfg.ema_decay
        for a, c, g in zip(_leaves(after_j), _leaves(after_p), jg):
            resolved = np.abs(g) > 1e-3 * np.abs(g).max()
            np.testing.assert_allclose(c[resolved], a[resolved], atol=5e-4 * scale, rtol=0)
            assert np.all(np.abs(c - a) <= 2 * LR * scale * 1.001 + 1e-6)

    moved = max(float(np.abs(a - b).max()) for a, b in zip(_leaves(new_st.bn), _leaves(st.bn)))
    assert moved > 100 * STAT_TOL
    for a, b in zip(_leaves(tr.bn_tree()), _leaves(new_st.bn)):
        np.testing.assert_allclose(a, b, rtol=0, atol=STAT_TOL)
    ema_bn = {k: m.bn_state() for k, m in tr.ema.items()}
    for a, b in zip(_leaves(ema_bn), _leaves(tr.bn_tree())):
        np.testing.assert_array_equal(a, b)


def test_bn_eval_and_render_match_jax():
    cfg = _cfg()
    st = _jax_state(cfg)
    st = st._replace(bn=jax.tree_util.tree_map(
        lambda x: x + 0.05 * jnp.arange(x.shape[0], dtype=jnp.float32) / x.shape[0], st.bn))
    batch = _batch(4, cfg.batch_size)
    jm = jstep.make_eval_step(cfg, NEAR, FAR)(st, tuple(jnp.asarray(x) for x in batch))
    tr = _port(cfg, st)
    pm = tr.evaluate([batch])
    for k in ("loss_coarse", "loss", "psnr"):
        np.testing.assert_allclose(pm[k], float(jm[k]), rtol=5e-4, err_msg=k)
    _, o, d = _batch(5, 19)
    ref = jstep.make_render_fn(cfg, NEAR, FAR)(st, jnp.asarray(o), jnp.asarray(d))
    out = tr.render_rays(o, d, chunk=8)
    for k in ("rgb_coarse", "rgb_fine", "depth_coarse", "depth_fine"):
        atol = 1e-3 if k.startswith("depth") else 1e-4
        np.testing.assert_allclose(out[k], np.asarray(ref[k]), rtol=0, atol=atol, err_msg=k)


def test_bn_checkpoints_both_ways(tmp_path):
    cfg = _cfg()
    key = jax.random.PRNGKey(2)
    st = _jax_state(cfg)
    step = jstep.make_train_step(cfg, NEAR, FAR)
    for _ in range(2):
        st, _ = step(st, tuple(jnp.asarray(x) for x in _batch(6, cfg.batch_size)), key)
    jpath = str(tmp_path / "jax.ckpt.npz")
    jckpt.save_checkpoint(jpath, st, cfg, scene={"near": NEAR, "far": FAR})

    tr = Trainer(cfg, NEAR, FAR, device="cpu").restore(jpath)
    assert tr.step == 2 and tr.state.opt.count == 2
    for got, want in ((tr.params_tree(), st.params), (tr.ema_tree(), st.ema),
                      (tr.bn_tree(), st.bn)):
        for a, b in zip(_leaves(got), _leaves(want)):
            np.testing.assert_array_equal(a, b)

    tr.train_epoch([_batch(7, cfg.batch_size)])
    ppath = str(tmp_path / "port.ckpt.npz")
    tr.save(ppath, scene={"near": NEAR, "far": FAR})
    template = jstep.init_train_state(jax.random.PRNGKey(0), cfg)
    back = jckpt.load_checkpoint(ppath, jax.device_get(template))
    assert int(back.step) == 3 and int(back.opt_state[0].count) == 3
    for got, want in ((back.params, tr.params_tree()), (back.ema, tr.ema_tree()),
                      (back.bn, tr.bn_tree())):
        for a, b in zip(_leaves(got), _leaves(want)):
            np.testing.assert_array_equal(a, b)
    pose = pose_spherical(45.0, -30.0, 4.0)
    o, d = tr.pose_rays(pose, 6, 6, 7.0)
    ref = jstep.make_render_fn(cfg, NEAR, FAR)(back._replace(params=back.ema),
                                               jnp.asarray(o.numpy()), jnp.asarray(d.numpy()))
    frame = tr.render_image(pose, 6, 6, 7.0)
    np.testing.assert_allclose(frame["rgb"].reshape(-1, 3), np.asarray(ref["rgb_fine"]),
                               rtol=0, atol=1e-4)
    assert Trainer(cfg, NEAR, FAR, device="cpu").restore(ppath).step == 3
