"""The parity step's three training paths on the CPU against the JAX package.

* ``render_rays_fused``'s gradients with ``bwd_mode`` "residual" and
  "recompute" against the JAX ``render_rays_fused`` in the same mode (its
  Pallas kernels in interpret mode), for an rgb loss and for a loss on the
  weights (``weights_grad``, a linear term plus the distortion loss), at
  ``tests/test_pallas.py``'s shapes (b=20, s=16, L 4/2).  On the CPU the
  port takes the plain K1 and autograd for either mode.
* K6's plain version, ``apply_nerf_render_reference``, against
  ``apply_nerf_render_pallas`` (interpret mode): forward, gradients, the
  weights' stop-gradient; the CPU wrapper takes the plain path.
* One parity train step through each ``render_pass`` of
  ``nerf_keras_tpu_torch.exp_train_paths`` (b: default, c: recompute, a:
  encodings in, K6), with the JAX step's draws replayed, against each
  other and, for a, against the JAX step with ``_make_fused_train_forward``
  patched to the encodings-in forward, as ``scripts/exp_train_paths.py``
  builds it.
* The module's command line.

Tolerances (float32; the errors at these inputs in brackets): K1
gradients atol/rtol 5e-4 [the JAX kernel's sin(z + pi/2) cos, ~1e-6], in
bf16 3e-2 [accumulation order flips bf16 roundings]; K6 forward atol 1e-5,
gradients 5e-4; train-step metrics relative 5e-4, gradients per leaf max
|diff| over the leaf's largest entry 5e-4; variant a against b 1e-5 (the
same plain arithmetic, the direction encoded per sample instead of per
ray).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerf_keras_tpu.config import NeRFConfig
from nerf_keras_tpu.engine import step as jstep
from nerf_keras_tpu.models.mlp import init_nerf_params
from nerf_keras_tpu.ops import encode_position as jencode
from nerf_keras_tpu.ops import sample_pdf as jsample_pdf
from nerf_keras_tpu.ops import sample_rays as jsample_rays
from nerf_keras_tpu.ops import sorted_union as jsorted_union
from nerf_keras_tpu.ops.pallas.fused_render import apply_nerf_render_pallas
from nerf_keras_tpu.ops.pallas.fused_render import render_rays_fused as jax_render
from nerf_keras_tpu.ops.volume import distortion_loss as jdistortion
from nerf_keras_tpu_torch import exp_train_paths
from nerf_keras_tpu_torch.engine import step as pstep
from nerf_keras_tpu_torch.engine.trainer import Trainer
from nerf_keras_tpu_torch.models.mlp import NeRFMLP
from nerf_keras_tpu_torch.ops.encoding import encode_position
from nerf_keras_tpu_torch.ops.kernels import fused_render as k1
from nerf_keras_tpu_torch.ops.rays import sample_rays
from nerf_keras_tpu_torch.ops.volume import distortion_loss

# One torch thread beside the JAX workers of the tier-1 run.
torch.set_num_threads(1)

ARCH = dict(num_layers=4, hidden_dim=32, skip_layer=2, l_xyz=4, l_dir=2)
NEAR, FAR = 2.0, 6.0


def _params(seed=0):
    """JAX params at ARCH with nonzero random biases."""
    p = init_nerf_params(jax.random.PRNGKey(seed), **ARCH)
    rng = np.random.default_rng(seed + 1)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32) + (
            rng.normal(size=x.shape).astype(np.float32) * 0.1 if x.ndim == 1 else 0.0), p)


def _mlp(params, dtype):
    return NeRFMLP.from_jax_params(params, skip_layer=ARCH["skip_layer"],
                                   compute_dtype=getattr(torch, dtype))


def _rays(seed, b=20, s=16):
    rng = np.random.default_rng(seed)
    o = np.tile([0, 0, 4.0], (b, 1)).astype(np.float32)
    d = rng.normal(size=(b, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = np.sort(rng.uniform(2.0, 6.0, (b, s)), axis=-1).astype(np.float32)
    target = rng.uniform(0, 1, (b, 3)).astype(np.float32)
    lin = rng.normal(size=(b, s)).astype(np.float32)
    return o, d, t, target, lin


def _port_grads(mlp, loss):
    mlp.zero_grad(set_to_none=True)
    loss.backward()
    return jax.tree_util.tree_leaves(mlp.to_jax_params(grad=True))


@pytest.mark.parametrize("dtype,tol", [("float32", 5e-4), ("bfloat16", 3e-2)])
@pytest.mark.parametrize("weights_loss", [False, True])
@pytest.mark.parametrize("bwd_mode", ["residual", "recompute"])
def test_render_rays_fused_grads_match_jax(bwd_mode, weights_loss, dtype, tol):
    params = _params()
    o, d, t, target, lin = _rays(13 if not weights_loss else 29)

    def combined(rgb, w, xp, dist):
        loss = ((rgb - xp.asarray(target)) ** 2).mean()
        if weights_loss:
            loss = loss + 0.05 * (xp.asarray(lin) * w).sum() + 0.1 * dist(
                xp.asarray(t), w, NEAR, FAR)
        return loss

    def jloss(p):
        rgb, w = jax_render(p, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t),
                            l_xyz=4, l_dir=2, compute_dtype=jnp.dtype(dtype),
                            skip_layer=2, max_tile_fwd=8 * 16, max_tile_bwd=8 * 16,
                            bwd_mode=bwd_mode, weights_grad=weights_loss)
        return combined(rgb, w, jnp, jdistortion)

    jl, jg = jax.value_and_grad(jloss)(params)
    mlp = _mlp(params, dtype)
    rgb, w = k1.render_rays_fused(mlp, *(torch.as_tensor(x) for x in (o, d, t)), l_xyz=4,
                                  l_dir=2, skip_layer=2, weights_grad=weights_loss,
                                  bwd_mode=bwd_mode)
    loss = combined(rgb, w, torch, lambda tt, ww, n, f: distortion_loss(
        torch.as_tensor(tt), ww, n, f))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=tol, atol=tol)
    for a, g in zip(jax.tree_util.tree_leaves(jg), _port_grads(mlp, loss)):
        np.testing.assert_allclose(g, np.asarray(a), atol=tol, rtol=tol)


def test_unknown_bwd_mode_raises():
    mlp = _mlp(_params(), "float32")
    o, d, t, _, _ = (torch.as_tensor(x) for x in _rays(0))
    with pytest.raises(ValueError, match="bwd_mode"):
        k1.render_rays_fused(mlp, o, d, t, l_xyz=4, l_dir=2, skip_layer=2, bwd_mode="cached")


def _encodings(seed, b, s):
    """The points' encodings and a random unit direction per sample (so a
    per-ray reading of d_enc would show)."""
    o, d, t, target, _ = _rays(seed, b, s)
    rng = np.random.default_rng(seed + 100)
    ds = rng.normal(size=(b, s, 3)).astype(np.float32)
    ds /= np.linalg.norm(ds, axis=-1, keepdims=True)
    pts = o[:, None, :] + d[:, None, :] * t[..., None]
    x_enc = np.array(jencode(jnp.asarray(pts), 4))
    d_enc = np.array(jencode(jnp.asarray(ds), 2))
    return x_enc, d_enc, t, target


def test_apply_nerf_render_reference_matches_jax():
    """b=12: ragged against the JAX kernel's ray tile."""
    params = _params(3)
    x_enc, d_enc, t, target = _encodings(5, 12, 16)

    def jfwd(p):
        return apply_nerf_render_pallas(p, jnp.asarray(x_enc), jnp.asarray(d_enc),
                                        jnp.asarray(t), compute_dtype=jnp.float32,
                                        skip_layer=2)

    rgb_j, w_j = jfwd(params)
    jg = jax.grad(lambda p: ((jfwd(p)[0] - target) ** 2).mean())(params)
    jg_w = jax.grad(lambda p: (jfwd(p)[1] ** 2).sum())(params)
    assert all(float(jnp.abs(x).max()) == 0.0 for x in jax.tree_util.tree_leaves(jg_w))

    mlp = _mlp(params, "float32")
    xe, de, tt = (torch.as_tensor(x) for x in (x_enc, d_enc, t))
    rgb, w = k1.apply_nerf_render_reference(mlp, xe, de, tt)
    np.testing.assert_allclose(rgb.detach().numpy(), np.asarray(rgb_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_j), atol=1e-5, rtol=0)
    loss = ((rgb - torch.as_tensor(target)) ** 2).mean()
    pg = _port_grads(mlp, loss)
    for a, g in zip(jax.tree_util.tree_leaves(jg), pg):
        np.testing.assert_allclose(g, np.asarray(a), atol=5e-4, rtol=5e-4)
    # The weights carry no gradient: a loss on them adds exactly nothing.
    assert not w.requires_grad
    rgb, w = k1.apply_nerf_render_reference(mlp, xe, de, tt)
    both = _port_grads(mlp, ((rgb - torch.as_tensor(target)) ** 2).mean() + (w ** 2).sum())
    for a, c in zip(pg, both):
        np.testing.assert_array_equal(a, c)
    # Its VJP is autograd's.
    g_rgb = torch.as_tensor(np.random.default_rng(0).normal(size=(12, 3)).astype(np.float32))
    vjp = k1.apply_nerf_render_reference_vjp(mlp, xe, de, tt, g_rgb)
    want = torch.autograd.grad([k1.apply_nerf_render_reference(mlp, xe, de, tt)[0]],
                               list(mlp.parameters()), [g_rgb])
    for a, c in zip(vjp, want):
        torch.testing.assert_close(a, c, rtol=0, atol=0)


def test_apply_nerf_render_fused_takes_the_plain_path_on_cpu():
    mlp = _mlp(_params(), "float32")
    x_enc, d_enc, t, _ = (torch.as_tensor(x) for x in _encodings(2, 8, 16))
    before = (k1.enc_launches, k1.enc_bwd_launches)
    with torch.no_grad():
        got = k1.apply_nerf_render_fused(mlp, x_enc, d_enc, t)
        want = k1.apply_nerf_render_reference(mlp, x_enc, d_enc, t)
    assert (k1.enc_launches, k1.enc_bwd_launches) == before
    for a, c in zip(got, want):
        torch.testing.assert_close(a, c, rtol=0, atol=0)
    with pytest.raises(ValueError, match="cuda or cpu"):
        k1.apply_nerf_render_fused(mlp, x_enc.to("meta"), d_enc.to("meta"), t.to("meta"))


# ---------------------------------------------------------------------------
# One parity step through each training path.

def _cfg(**kw):
    base = dict(batch_size=24, ns_coarse=8, ns_fine=16, num_layers=4, hidden_dim=32,
                skip_layer=2, l_xyz=4, l_dir=2, compute_dtype="float32", use_pallas=True,
                ema_decay=0.9, learning_rate=5e-3, height=8, width=8)
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
    """The JAX step's uniforms: fold_in(key, step) -> split -> uniform."""
    key_t, key_pdf = jax.random.split(jax.random.fold_in(key, step))
    return {"t": torch.as_tensor(np.array(jax.random.uniform(key_t, (b, cfg.ns_coarse)))),
            "pdf": torch.as_tensor(np.array(jax.random.uniform(key_pdf, (b, cfg.ns_fine))))}


def _jax_state(cfg):
    st = jstep.init_train_state(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(3)

    def bias(x):
        x = np.asarray(x, np.float32)
        return jnp.asarray(x + (rng.normal(size=x.shape) * 0.1).astype(np.float32)
                           if x.ndim == 1 else x)

    params = jax.tree_util.tree_map(bias, st.params)
    return st._replace(params=params, ema=jax.tree_util.tree_map(jnp.array, params),
                       step=jnp.asarray(3, jnp.int32))


def _grab_grads():
    """An optax transform whose state after ``update`` is the gradients."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g),
    )


def _jax_fwd_enc(cfg):
    """``scripts/exp_train_paths.py``'s variant a: XLA encodes, then the
    encodings-in kernel (K6)."""
    cdt = jnp.float32

    def fwd_enc(params, key, ray_o, ray_d, t_vals):
        def render(p, t):
            pts, ds_ = jsample_rays(ray_o, ray_d, t)
            return apply_nerf_render_pallas(
                p, jencode(pts, cfg.l_xyz).astype(cdt), jencode(ds_, cfg.l_dir).astype(cdt),
                t, compute_dtype=cdt, skip_layer=cfg.skip_layer)

        rgb_c, w_c = render(params["coarse"], t_vals)
        t_mid = 0.5 * (t_vals[..., 1:] + t_vals[..., :-1])
        t_fine = jsample_pdf(key, t_mid, jax.lax.stop_gradient(w_c), cfg.ns_fine,
                             deterministic=key is None)
        rgb_f, _ = render(params["fine"], jsorted_union(t_vals, t_fine))
        return rgb_c, rgb_f

    return fwd_enc


def _port_step(cfg, st, batch, draws, variant):
    tr = Trainer(cfg, NEAR, FAR, device="cpu")
    tr.replace_params(jax.tree_util.tree_map(np.asarray, st.params))
    tr.step = int(st.step)
    step = pstep.make_train_step(cfg, NEAR, FAR,
                                 render_pass=exp_train_paths.variant_pass(cfg, variant))
    metrics = step(tr.state, tr.put_batch(batch), draws, tr.generator)
    leaves = jax.tree_util.tree_leaves(tr.params_tree(grad=True))
    return {k: float(v) for k, v in metrics.items()}, leaves


def test_training_paths_match_each_other_and_jax(monkeypatch):
    cfg = _cfg()
    st = _jax_state(cfg)
    key = jax.random.PRNGKey(11)
    batch = _batch(1, cfg.batch_size)
    draws = _draws(cfg, key, 3, cfg.batch_size)
    before = (k1.launches, k1.bwd_launches, k1.recompute_launches, k1.enc_launches,
              k1.enc_bwd_launches)
    out = {v: _port_step(cfg, st, batch, draws, v) for v in ("b", "c", "a")}
    assert (k1.launches, k1.bwd_launches, k1.recompute_launches, k1.enc_launches,
            k1.enc_bwd_launches) == before
    # c is b on the CPU (the same plain K1, autograd for either backward).
    assert out["c"][0] == out["b"][0]
    for x, y in zip(out["c"][1], out["b"][1]):
        np.testing.assert_array_equal(x, y)
    for k in out["b"][0]:
        np.testing.assert_allclose(out["a"][0][k], out["b"][0][k], rtol=1e-5, atol=1e-5)
    for x, y in zip(out["a"][1], out["b"][1]):
        np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-5)

    # Variant a against the JAX step with the encodings-in forward.
    monkeypatch.setattr(jstep, "_make_fused_train_forward",
                        lambda c, mesh=None, want_weights=False: _jax_fwd_enc(c))
    monkeypatch.setattr(jstep, "make_optimizer", lambda c: _grab_grads())
    jb = tuple(jnp.asarray(x) for x in batch)
    new_st, jm = jstep.make_train_step(cfg, NEAR, FAR)(
        st._replace(opt_state=_grab_grads().init(st.params)), jb, key)
    merr = max(abs(out["a"][0][k] / float(jm[k]) - 1.0) for k in ("loss_coarse", "loss", "psnr"))
    assert merr <= 5e-4, merr
    jg = [np.asarray(x) for x in jax.tree_util.tree_leaves(new_st.opt_state)]
    assert len(jg) == len(out["a"][1])
    gerr = [float(np.abs(c - a).max() / max(np.abs(a).max(), 1e-12))
            for a, c in zip(jg, out["a"][1])]
    assert max(gerr) <= 5e-4, gerr


def test_encodings_in_path_refuses_a_weights_loss():
    render = exp_train_paths.encodings_in_render_pass(_cfg())
    mlp = NeRFMLP(**ARCH)
    o, d, t, _, _ = (torch.as_tensor(x) for x in _rays(0, 4, 8))
    with pytest.raises(ValueError, match="no gradient"):
        render(mlp, o, d, t, weights_grad=True)
    rgb, w = render(mlp, o, d, t)
    points, dirs_s = sample_rays(o, d, t)
    want = k1.apply_nerf_render_reference(mlp, encode_position(points, 4),
                                          encode_position(dirs_s, 2), t)
    torch.testing.assert_close(rgb, want[0], rtol=0, atol=0)


def test_module_cli():
    with pytest.raises(SystemExit) as exc:
        exp_train_paths.main(["--help"])
    assert exc.value.code == 0
    with pytest.raises(SystemExit):
        exp_train_paths.main(["--phases", "steps,nope"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no card"):
            exp_train_paths.main(["--phases", "pdf"])
