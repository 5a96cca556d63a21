"""The proposal sampler's ops and K2's plain version against the JAX package.

Inputs come from numpy with a seed; the JAX draws are replayed into the
port through its explicit-uniform arguments (``noise=``), so both sides
see the same numbers.  Tolerances: 1e-5 where both sides run the same
float32 formula (t-values, inverse CDF, binning, losses); 1e-4 where
float32 products are summed in another order (the proposal net); K2's
module as stated at its test.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_keras_tpu.config import NeRFConfig
from nerf_keras_tpu.models import mlp as jmlp
from nerf_keras_tpu.ops import proposal as jprop
from nerf_keras_tpu.ops import sampling as jsamp
from nerf_keras_tpu.ops import volume as jvol
from nerf_keras_tpu.ops.pallas.fused_render import render_rays_fused as jax_k1
from nerf_keras_tpu_torch.models.mlp import NeRFMLP
from nerf_keras_tpu_torch.ops import proposal, sampling, volume
from nerf_keras_tpu_torch.ops.kernels import fused_render as k1

# See tests/test_torch_fused_render.py: one torch thread beside JAX workers.
torch.set_num_threads(1)

T = torch.as_tensor


def _np(x):
    return np.asarray(x)


def _rays(seed, b, s, near=2.0, far=6.0):
    rng = np.random.default_rng(seed)
    o = (rng.normal(size=(b, 3)) * 0.3 + np.array([0.0, 0.0, 4.0])).astype(np.float32)
    d = rng.normal(size=(b, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = np.sort(rng.uniform(near, far, (b, s)), axis=-1).astype(np.float32)
    return o, d, t


# ---------------------------------------------------------------- sampling

@pytest.mark.parametrize("mode,shape", [("shared", (7,)), ("stratified", (5, 7))])
def test_generate_t_vals_replays_jax(mode, shape):
    """'shared' (one jitter vector for every ray) and 'stratified', fed the
    uniforms JAX draws from the same key."""
    key = jax.random.PRNGKey(11)
    ref = _np(jsamp.generate_t_vals(key, 2.0, 6.0, (5,), 7, mode))
    noise = T(_np(jax.random.uniform(key, shape)))
    out = sampling.generate_t_vals(2.0, 6.0, (5,), 7, mode, noise=noise)
    assert out.shape == (5, 7)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)
    if mode == "shared":
        assert bool((out == out[:1]).all())  # every ray the same jitter


def test_generate_t_vals_shared_draws_from_the_generator():
    a = sampling.generate_t_vals(2.0, 6.0, (4,), 8, "shared",
                                 generator=torch.Generator().manual_seed(1))
    b = sampling.generate_t_vals(2.0, 6.0, (4,), 8, "shared",
                                 generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    jitter = a[0] - torch.linspace(2.0, 6.0, 8)
    assert bool(((jitter >= 0) & (jitter < 0.5 + 1e-6)).all())
    with pytest.raises(ValueError, match="noise has shape"):
        sampling.generate_t_vals(2.0, 6.0, (4,), 8, "shared", noise=torch.zeros(4, 8))


@pytest.mark.parametrize("stratified", [True, False])
def test_sample_pdf_random_modes_replay_jax(stratified):
    """The stratified draw ``u_j = (j + U_j)/F`` (the proposal chain's
    intermediate draw) and the iid draw, fed JAX's uniforms."""
    rng = np.random.default_rng(3)
    b, s, f = 6, 10, 12
    t = np.sort(rng.uniform(2.0, 6.0, (b, s)), axis=-1).astype(np.float32)
    t_mid = 0.5 * (t[:, 1:] + t[:, :-1])
    w = rng.uniform(0, 1, (b, s)).astype(np.float32) ** 3
    key = jax.random.PRNGKey(5)
    ref = _np(jsamp.sample_pdf(key, jnp.asarray(t_mid), jnp.asarray(w), f,
                               stratified=stratified))
    noise = T(_np(jax.random.uniform(key, (b, f), dtype=jnp.float32)))
    out = sampling.sample_pdf(T(t_mid), T(w), f, stratified=stratified, noise=noise)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)
    if stratified:  # one draw per stratum: ascending per ray
        assert bool((torch.diff(out, dim=-1) >= 0).all())


# ------------------------------------------------------------------ losses

def _naive_distortion(t, w, near, far):
    s = (t - near) / (far - near)
    delta = np.concatenate([s[:, 1:] - s[:, :-1], np.zeros_like(s[:, :1])], axis=-1)
    mid = s + 0.5 * delta
    pair = np.abs(mid[:, :, None] - mid[:, None, :])
    total = (w[:, :, None] * w[:, None, :] * pair).sum((1, 2))
    return float(np.mean(total + (w ** 2 * delta).sum(-1) / 3.0))


def test_distortion_loss_matches_jax_and_the_double_sum():
    _, _, t = _rays(4, 9, 13)
    w = np.random.default_rng(4).uniform(0, 0.2, (9, 13)).astype(np.float32)
    ours = float(volume.distortion_loss(T(t), T(w), 2.0, 6.0))
    theirs = float(jvol.distortion_loss(jnp.asarray(t), jnp.asarray(w), 2.0, 6.0))
    np.testing.assert_allclose(ours, theirs, rtol=1e-5)
    np.testing.assert_allclose(ours, _naive_distortion(t.astype(np.float64),
                                                        w.astype(np.float64), 2.0, 6.0),
                               rtol=1e-5)


def test_distortion_loss_gradient_matches_jax():
    _, _, t = _rays(5, 4, 8)
    w = np.random.default_rng(5).uniform(0, 0.3, (4, 8)).astype(np.float32)
    wt = T(w).requires_grad_(True)
    volume.distortion_loss(T(t), wt, 2.0, 6.0).backward()
    ref = jax.grad(lambda x: jvol.distortion_loss(jnp.asarray(t), x, 2.0, 6.0))(jnp.asarray(w))
    np.testing.assert_allclose(wt.grad.numpy(), _np(ref), atol=1e-6, rtol=1e-5)


def test_binned_fine_weights_edges():
    """Bin j is [t_j, t_{j+1}); the last bin is open; a sample on an edge
    lands in that edge's bin; a sample below the first edge in none."""
    t_vals = np.array([[2.0, 3.0, 4.0, 5.0]], np.float32)
    t_all = np.array([[1.5, 2.0, 2.5, 3.0, 3.0, 4.99, 5.0, 7.0]], np.float32)
    w = np.array([[10.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0]], np.float32)
    want = np.array([[1.0 + 2.0, 4.0 + 8.0, 16.0, 32.0 + 64.0]], np.float32)
    ours = proposal.binned_fine_weights(T(t_all), T(w), T(t_vals)).numpy()
    theirs = _np(jprop.binned_fine_weights(jnp.asarray(t_all), jnp.asarray(w),
                                           jnp.asarray(t_vals)))
    np.testing.assert_array_equal(ours, want)
    np.testing.assert_array_equal(theirs, want)
    # Random rays with the union layout (edges reused verbatim).
    _, _, tv = _rays(6, 5, 6)
    rng = np.random.default_rng(6)
    tf = np.sort(np.concatenate([tv, rng.uniform(1.0, 6.5, (5, 9)).astype(np.float32)],
                                axis=-1), axis=-1)
    wf = rng.uniform(0, 1, tf.shape).astype(np.float32)
    np.testing.assert_allclose(
        proposal.binned_fine_weights(T(tf), T(wf), T(tv)).numpy(),
        _np(jprop.binned_fine_weights(jnp.asarray(tf), jnp.asarray(wf), jnp.asarray(tv))),
        atol=1e-6, rtol=0)


def test_interlevel_loss_matches_jax():
    rng = np.random.default_rng(7)
    wp = rng.uniform(0, 0.3, (6, 8)).astype(np.float32)
    wt = rng.uniform(0, 0.3, (6, 8)).astype(np.float32)
    np.testing.assert_allclose(
        float(proposal.interlevel_loss(T(wp), T(wt))),
        float(jprop.interlevel_loss(jnp.asarray(wp), jnp.asarray(wt))), rtol=1e-6)


# ----------------------------------------------------------- proposal nets

def _jax_net(seed, **kw):
    return jax.tree_util.tree_map(np.asarray, jprop.init_proposal(jax.random.PRNGKey(seed), **kw))


def test_proposal_mlp_carries_jax_params_exactly():
    params = _jax_net(0, l_xyz=3, hidden=16, depth=3)
    net = proposal.ProposalMLP.from_jax_params(params)
    assert (net.l_xyz, len(net.layers)) == (3, 3)
    back = net.to_jax_params()
    for a, b in zip(jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)


def test_proposal_init_is_glorot_with_zero_biases():
    net = proposal.ProposalMLP(l_xyz=4, hidden=64, depth=3,
                               generator=torch.Generator().manual_seed(0))
    for layer in net.layers:
        fan_out, fan_in = layer.weight.shape
        limit = (6.0 / (fan_in + fan_out)) ** 0.5
        assert float(layer.weight.abs().max()) <= limit
        assert float(layer.weight.abs().max()) > 0.8 * limit
        assert float(layer.bias.abs().max()) == 0.0
    chain = proposal.init_proposal_chain(2, generator=torch.Generator().manual_seed(0))
    nets = proposal.chain_nets(chain)
    assert len(nets) == 2 and not torch.equal(nets[0].layers[0].weight, nets[1].layers[0].weight)
    tree = proposal.proposal_to_jax(chain)
    assert sorted(tree) == ["l1", "l2"]
    again = proposal.proposal_from_jax(tree)
    assert torch.equal(proposal.chain_nets(again)[1].layers[2].weight, nets[1].layers[2].weight)


def test_proposal_weights_match_jax():
    params = _jax_net(1, l_xyz=4, hidden=32, depth=3)
    # Nonzero biases so the density is not near zero everywhere.
    params["layers"][-1]["b"] = np.array([1.5], np.float32)
    o, d, t = _rays(8, 7, 12)
    ref = _np(jprop.proposal_weights(params, jnp.asarray(o), jnp.asarray(d),
                                     jnp.asarray(t), 4))
    net = proposal.ProposalMLP.from_jax_params(params)
    with torch.no_grad():
        out = proposal.proposal_weights(net, T(o), T(d), T(t), 4)
    assert float(out.sum()) > 0.1
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-4)


def _chain_cfg(levels):
    extra = dict(prop_levels=2, prop_samples=6) if levels == 2 else {}
    return NeRFConfig(ns_coarse=8, ns_fine=10, train_sampler="proposal",
                      prop_anneal_steps=10, prop_explore=0.1, **extra).validate()


def _chain_params(levels):
    tree = jax.tree_util.tree_map(np.asarray, jprop.init_proposal_chain(
        jax.random.PRNGKey(3), levels, l_xyz=4, hidden=32, depth=3))
    for net in jprop.chain_nets(tree):
        net["layers"][-1]["b"] = np.array([1.0], np.float32)
    return tree


def _chain_noise(cfg, key):
    """The uniforms JAX's train chain draws from ``key``: one split per
    level (ops/proposal.py), then jax.random.uniform (ops/sampling.py)."""
    n2 = cfg.prop_samples or cfg.ns_coarse
    out = []
    for i in range(cfg.prop_levels):
        key, sub = jax.random.split(key)
        n = cfg.ns_fine if i == cfg.prop_levels - 1 else n2
        out.append(T(_np(jax.random.uniform(sub, (KB, n), dtype=jnp.float32))))
    return out


KB = 9


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("levels", [1, 2])
def test_chain_sampler_replays_jax(levels, train):
    cfg = _chain_cfg(levels)
    tree = _chain_params(levels)
    o, d, _ = _rays(9, KB, 2)
    t = np.broadcast_to(np.linspace(2.0, 6.0, 8, dtype=np.float32), (KB, 8)).copy()
    key, step = jax.random.PRNGKey(21), 4
    jchain = jprop.make_chain_sampler(cfg, 4, True, levels, cfg.prop_samples, train)
    t_all_j, lv_j = jchain(tree, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t),
                           key if train else None, jnp.asarray(step) if train else None)
    chain = proposal.make_chain_sampler(cfg, 4, True, levels, cfg.prop_samples, train)
    noise = _chain_noise(cfg, key) if train else None
    with torch.no_grad():
        t_all, lv = chain(proposal.proposal_from_jax(tree), T(o), T(d), T(t), step,
                          noise=noise)
    assert t_all.shape == (KB, 8 + 10)
    np.testing.assert_allclose(t_all.numpy(), _np(t_all_j), atol=1e-4, rtol=0)
    assert len(lv) == levels
    for (w, tp), (wj, tpj) in zip(lv, lv_j):
        np.testing.assert_allclose(tp.numpy(), _np(tpj), atol=1e-4, rtol=0)
        np.testing.assert_allclose(w.numpy(), _np(wj), atol=1e-4, rtol=1e-3)


def test_chain_refuses_the_union_free_layout():
    cfg = dataclasses.replace(_chain_cfg(1), prop_union=False)
    with pytest.raises(NotImplementedError, match="PROP_UNION=false"):
        proposal.make_chain_sampler(cfg, 4, False, 1, 0, True)


def test_anneal_exponent():
    assert proposal.anneal_exponent(0, 10) == 0.0
    assert proposal.anneal_exponent(10, 10) == 1.0
    assert proposal.anneal_exponent(25, 10) == 1.0
    np.testing.assert_allclose(proposal.anneal_exponent(5, 10), 5.0 / 5.5, rtol=1e-6)


# --------------------------------------------------- K2's plain version

ARCH = dict(num_layers=4, hidden_dim=32, skip_layer=2, l_xyz=4, l_dir=2)
# Gradients are compared per leaf with rtol = tol and atol = tol x the
# leaf's largest entry.  float32: the JAX test's own 5e-4 (measured
# 3.7e-6 of the leaf scale).  bf16: the two formulations round at other
# places (the JAX kernel rounds dPre to bf16 before each product and
# returns bf16 weight gradients; autograd rounds the cotangent of each
# rounded operand), and a rounding flip of a hidden activation moves a
# few entries: measured 8.6e-3 of the leaf scale with the weights terms,
# 4.4e-3 without, so the bound is 8e-2, ~10x above.
K2_TOL = {"float32": 5e-4, "bfloat16": 8e-2}


@pytest.mark.parametrize("weights_grad", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_vjp_matches_jax_kernel(dtype, weights_grad):
    """Autograd of render_rays_reference against the JAX megakernel's VJP
    (its Pallas backward in interpret mode), loss = rgb MSE + a random
    linear functional of the weights + distortion; with
    ``weights_grad=False`` the weights terms are cut on both sides."""
    params = jax.tree_util.tree_map(
        np.asarray, jmlp.init_nerf_params(jax.random.PRNGKey(0), **ARCH))
    rng = np.random.default_rng(29)
    for leaf in (params["sigma"], params["trunk"][1], params["rgb"]):
        leaf["b"] = rng.normal(size=leaf["b"].shape).astype(np.float32) * 0.3
    b, s = 20, 16
    o, d, t = _rays(29, b, s)
    target = rng.uniform(0, 1, (b, 3)).astype(np.float32)
    lin = rng.normal(size=(b, s)).astype(np.float32)

    def combined(rgb, w, xp, dist, tt, tgt, ln):
        return (xp.mean((rgb - tgt) ** 2) + 0.05 * xp.sum(ln * w)
                + 0.1 * dist(tt, w, 2.0, 6.0))

    def loss_jax(p):
        rgb, w = jax_k1(p, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t),
                        l_xyz=4, l_dir=2, compute_dtype=jnp.dtype(dtype),
                        skip_layer=2, weights_grad=weights_grad,
                        max_tile_fwd=8 * s, max_tile_bwd=8 * s)
        return combined(rgb, w, jnp, jvol.distortion_loss, jnp.asarray(t),
                        jnp.asarray(target), jnp.asarray(lin))

    gj = jax.grad(loss_jax)(params)
    mlp = NeRFMLP.from_jax_params(params, skip_layer=2, compute_dtype=getattr(torch, dtype))
    rgb, w = k1.render_rays_fused(mlp, T(o), T(d), T(t), l_xyz=4, l_dir=2,
                                  skip_layer=2, weights_grad=weights_grad)
    assert w.requires_grad == weights_grad
    combined(rgb, w, torch, volume.distortion_loss, T(t), T(target), T(lin)).backward()
    gp = mlp.to_jax_params(grad=True)
    tol = K2_TOL[dtype]
    for a, c in zip(jax.tree_util.tree_leaves(gj), jax.tree_util.tree_leaves(gp)):
        a = _np(a)
        np.testing.assert_allclose(c, a, rtol=tol, atol=tol * np.abs(a).max())
    # The weights terms move the density head's gradient by ~0.93 of its
    # largest entry (measured), far beyond either tolerance.
    if weights_grad:
        g_sigma = gp["sigma"]["w"]
        mlp.zero_grad()
        rgb, _ = k1.render_rays_reference(mlp, T(o), T(d), T(t), l_xyz=4, l_dir=2,
                                          skip_layer=2)
        torch.mean((rgb - T(target)) ** 2).backward()
        moved = np.abs(g_sigma - mlp.sigma.weight.grad.numpy().T).max()
        assert moved > 0.5 * np.abs(g_sigma).max()


def test_reference_vjp_is_autograd_of_the_reference():
    mlp = NeRFMLP(**ARCH, generator=torch.Generator().manual_seed(1))
    o, d, t = (T(x) for x in _rays(2, 6, 9))
    g_rgb = torch.randn(6, 3, generator=torch.Generator().manual_seed(2))
    g_w = torch.randn(6, 9, generator=torch.Generator().manual_seed(3))
    got = k1.render_rays_reference_vjp(mlp, o, d, t, g_rgb, g_w, l_xyz=4, l_dir=2,
                                       skip_layer=2)
    rgb, w = k1.render_rays_reference(mlp, o, d, t, l_xyz=4, l_dir=2, skip_layer=2)
    ((rgb * g_rgb).sum() + (w * g_w).sum()).backward()
    for p, g in zip(mlp.parameters(), got):
        torch.testing.assert_close(g, p.grad, rtol=0, atol=0)


def test_k2_pack_and_layout():
    """K2's pack holds W (row = layer input column) for the columns that get
    a gradient, and the workspace layout matches K1's widths."""
    mlp = NeRFMLP(**ARCH, generator=torch.Generator().manual_seed(4))
    cpu = torch.device("cpu")
    fwd, bwd = k1.pack_weights(mlp, cpu), k1.pack_weights_bwd(mlp, cpu)
    hid = ARCH["hidden_dim"]
    assert bwd.desc[:, 1].tolist() == [0] + [hid] * 3 + [hid, hid, hid // 2]
    assert bwd.desc[:, 0].tolist() == [hid] * 4 + [hid + 16, hid // 2, 16]
    lay = k1.workspace_layout(fwd, bwd)
    assert lay[:, 1].tolist() == fwd.desc[:, 0].tolist()
    assert lay[:, 3].tolist() == bwd.desc[:, 0].tolist()
    assert lay[1:, 0].tolist() == np.cumsum(lay[:-1, 1]).tolist()
    # Branch layer's pack row c, un-interleaved, is W_branch^T[c] = w[c, :].
    k_pad, n, n_pad, w_off, _ = bwd.desc[5]
    rows = bwd.w[w_off:w_off + n_pad * k_pad].float().reshape(n_pad, k_pad // 16, 16)
    inv = torch.argsort(k1._K_INTERLEAVE)
    got = rows[..., inv].reshape(n_pad, k_pad)[:n, :hid // 2]
    want = mlp.branch.weight.detach().T[:hid].to(torch.bfloat16).float()
    torch.testing.assert_close(got, want, rtol=0, atol=0)
