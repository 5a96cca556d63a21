"""Any hidden width up to 256 on the kernels: the zero-padded packs, on the CPU.

The bf16 kernels are instantiated at hidden 64, 128 and 256 (K4 also 32);
another width runs on a pack zero-padded to the next
(``fused_render.kernel_width``, ``layer_maps``, ``padded_layers``;
``quant_render.pad_qparams``).  Here:

* The padding identity: a model padded from ``H`` to ``H'`` (a
  ``NeRFMLP`` of ``H'`` units holding the padded matrices) gives the
  unpadded model's forward and gradients to float32 rounding, every padded
  gradient entry is exactly 0, and ``unpack_grads`` maps a padded
  backward's flat dW/db back to the model's real shapes.  The four offsets
  that move with the padding are checked by name: sigma (head column
  ``H'``), skip (the x_enc rows of a skip layer at ``H'``), branch (the
  d_enc rows at ``H'``) and rgb (an input ``H'/2`` wide).
* The wgmma packs at hidden 16, 96 and 192, with K5's input-gradient pack
  at L 4/2 and 16/6 (64 or 128 x_enc and 32 or 64 d_enc gradient columns,
  32-deep stages beyond 64/32), against a numpy model of the padding and
  of the descriptors' addressing.
* K4's padded int8 tables: the plain int8 MLP on them equals the unpadded
  one bit for bit; no padded scale or requant entry is 0.
* Each module that holds a kernel against the JAX package at hidden 16 and
  96 and (L_XYZ, L_DIR) = (4, 2) and (16, 6): ``render_rays_fused``
  (residual backward), ``apply_nerf_render_pallas`` and
  ``apply_nerf_mlp_pallas`` run as the JAX package's own tests run them
  (interpret mode on the CPU), the port's CPU wrappers take the plain
  versions; inputs from a seed with numpy, the weights carried across by
  ``NeRFMLP.from_jax_params``.

Tolerances (float32; measured at these inputs in brackets).  Padding
identity: forward atol 1e-5 [1.2e-7], gradients per leaf 1e-5 of the
leaf's largest entry [< 1e-6], padded entries exactly 0.  unpack_grads:
the bf16-rounded gradients of one bf16 ulp (2^-8 relative to each entry).
Against JAX: values 1e-5 [< 1e-6]; gradients per leaf max |diff| over the
leaf's largest entry 5e-4 [the JAX kernel's sin(z + pi/2) cos, ~1e-6]; K1
at L_XYZ 16 as stated at ``JAX_K1_HIGH_OCTAVE_TOL``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_keras_tpu.models.mlp import init_nerf_params
from nerf_keras_tpu.ops.pallas.fused_mlp import apply_nerf_mlp_pallas
from nerf_keras_tpu.ops.pallas.fused_render import apply_nerf_render_pallas
from nerf_keras_tpu.ops.pallas.fused_render import render_rays_fused as jax_render
from nerf_keras_tpu_torch.models.mlp import NeRFMLP, is_skip, randomize_biases_
from nerf_keras_tpu_torch.ops import quant
from nerf_keras_tpu_torch.ops.kernels import fused_mlp as k5
from nerf_keras_tpu_torch.ops.kernels import fused_render as k1
from nerf_keras_tpu_torch.ops.kernels import quant_render as k4

# One torch thread beside the JAX workers of the tier-1 run.
torch.set_num_threads(1)

CPU = torch.device("cpu")
PAD_TOL = 1e-5
JAX_VAL_TOL = 1e-5
JAX_GRAD_TOL = 5e-4
# K1 at L_XYZ 16: the top octave scales the point by 2^15, so one f32 ulp
# of a coordinate near 4 (4.8e-7) moves its phase by 1.6e-2 rad, and the
# JAX kernel's cos z = sin(z + pi/2) rounds z + pi/2 (~1e5 rad) to 2^-7.
# The frameworks form the points and the cos in other ways, so their
# top-octave features differ at that level: measured rgb 2.8e-4, weights
# 4.7e-4, gradients 4.4e-2 (per leaf, over its largest entry).  K6 and K5,
# which take the encodings as inputs, keep the strict tolerances there.
JAX_K1_HIGH_OCTAVE_TOL = (1e-3, 1e-1)


def _mlp(hidden, num_layers=5, skip=2, l_xyz=4, l_dir=2, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return randomize_biases_(NeRFMLP(num_layers=num_layers, hidden_dim=hidden, skip_layer=skip,
                                     l_xyz=l_xyz, l_dir=l_dir, compute_dtype=torch.float32,
                                     generator=gen), gen)


def _padded_model(mlp):
    """A ``NeRFMLP`` of the kernel width holding ``padded_layers``."""
    hp = k1.kernel_width(mlp.hidden_dim)
    big = NeRFMLP(num_layers=mlp.num_layers, hidden_dim=hp, skip_layer=mlp.skip_layer,
                  l_xyz=mlp.l_xyz, l_dir=mlp.l_dir, compute_dtype=torch.float32)
    layers = k1._dense_layers(mlp, hp)
    nl = mlp.num_layers
    with torch.no_grad():
        for layer, (w, b) in zip(big.trunk, layers[:nl]):
            layer.weight.copy_(w)
            layer.bias.copy_(b)
        w, b = layers[nl]
        big.feature.weight.copy_(w[:hp])
        big.feature.bias.copy_(b[:hp])
        big.sigma.weight.copy_(w[hp:])
        big.sigma.bias.copy_(b[hp:])
        for layer, (w, b) in zip((big.branch, big.rgb), layers[nl + 1:]):
            layer.weight.copy_(w)
            layer.bias.copy_(b)
    return big


def _vjp(mlp, x, d, g):
    mlp.zero_grad(set_to_none=True)
    out = mlp(x, d)
    (out * g).sum().backward()
    return out.detach()


@pytest.mark.parametrize("arch", [(16, 5, 2), (96, 8, 4), (192, 4, 3)])
def test_padding_is_exact(arch):
    """Forward and gradients of the padded model are the model's; every
    padded entry of every gradient is exactly 0 (a zero unit's ReLU mask
    passes nothing back)."""
    hidden, num_layers, skip = arch
    mlp = _mlp(hidden, num_layers, skip)
    big = _padded_model(mlp)
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.normal(size=(40, mlp.xyz_dim)), dtype=torch.float32)
    d = torch.tensor(rng.normal(size=(40, mlp.dir_dim)), dtype=torch.float32)
    g = torch.tensor(rng.normal(size=(40, 4)), dtype=torch.float32)
    want, got = _vjp(mlp, x, d, g), _vjp(big, x, d, g)
    assert float((got - want).abs().max()) <= PAD_TOL
    hp = big.hidden_dim
    maps = k1.layer_maps(mlp, hp)
    small_layers = k1._dense_layers(mlp)
    big_layers = [(lyr.weight, lyr.bias) for lyr in big.trunk]
    big_layers.append((torch.cat([big.feature.weight, big.sigma.weight]),
                       torch.cat([big.feature.bias, big.sigma.bias])))
    big_layers += [(big.branch.weight, big.branch.bias), (big.rgb.weight, big.rgb.bias)]
    small_grads = [(lyr.weight.grad, lyr.bias.grad) for lyr in mlp.trunk]
    small_grads.append((torch.cat([mlp.feature.weight.grad, mlp.sigma.weight.grad]),
                        torch.cat([mlp.feature.bias.grad, mlp.sigma.bias.grad])))
    small_grads += [(mlp.branch.weight.grad, mlp.branch.bias.grad),
                    (mlp.rgb.weight.grad, mlp.rgb.bias.grad)]
    big_grads = [(w.grad, b.grad) for w, b in big_layers[:num_layers]]
    big_grads.append((torch.cat([big.feature.weight.grad, big.sigma.weight.grad]),
                      torch.cat([big.feature.bias.grad, big.sigma.bias.grad])))
    big_grads += [(big.branch.weight.grad, big.branch.bias.grad),
                  (big.rgb.weight.grad, big.rgb.bias.grad)]
    assert len(maps) == len(small_layers) == len(big_grads)
    for (in_idx, out_idx, k, n), (gw, gb), (sw, sb) in zip(maps, big_grads, small_grads):
        assert gw.shape == (n, k)
        real = gw[out_idx[:, None], in_idx[None, :]]
        scale = max(float(sw.abs().max()), 1e-12)
        assert float((real - sw).abs().max()) <= PAD_TOL * scale
        assert float((gb[out_idx] - sb).abs().max()) <= PAD_TOL * max(float(sb.abs().max()), 1e-12)
        pad = torch.ones((n, k), dtype=torch.bool)
        pad[out_idx[:, None], in_idx[None, :]] = False
        assert int(torch.count_nonzero(gw[pad])) == 0
        bpad = torch.ones(n, dtype=torch.bool)
        bpad[out_idx] = False
        assert int(torch.count_nonzero(gb[bpad])) == 0


@pytest.mark.parametrize("hidden", [16, 96])
@pytest.mark.parametrize("offset", ["sigma", "skip", "branch", "rgb"])
def test_the_moved_offsets(offset, hidden):
    """The four places the padding moves, each against the padded matrices
    themselves: sigma at head column H', the skip layer's x_enc rows at
    H', the branch's d_enc rows at H', and the rgb input H'/2 wide."""
    mlp = _mlp(hidden, num_layers=5, skip=2)
    hp = k1.kernel_width(hidden)
    layers = k1._dense_layers(mlp, hp)
    nl, xd, dd = mlp.num_layers, mlp.xyz_dim, mlp.dir_dim
    if offset == "sigma":
        w, b = layers[nl]
        in_idx = k1.layer_maps(mlp, hp)[nl][0]
        assert w.shape[0] == hp + 1
        assert torch.equal(w[hp, in_idx], mlp.sigma.weight[0])
        assert float(b.detach()[hp]) == float(mlp.sigma.bias.detach()[0])
        assert not w[hidden:hp].any() and not b[hidden:hp].any()
    elif offset == "skip":
        i = next(i for i in range(1, nl) if is_skip(i - 1, mlp.skip_layer))
        w, _ = layers[i]
        assert w.shape == (hp, hp + xd)
        assert torch.equal(w[:hidden, hp:], mlp.trunk[i].weight[:, hidden:])
        assert torch.equal(w[:hidden, :hidden], mlp.trunk[i].weight[:, :hidden])
        assert not w[:, hidden:hp].any() and not w[hidden:].any()
    elif offset == "branch":
        w, _ = layers[nl + 1]
        assert w.shape == (hp // 2, hp + dd)
        assert torch.equal(w[:hidden // 2, hp:], mlp.branch.weight[:, hidden:])
        assert not w[:, hidden:hp].any() and not w[hidden // 2:].any()
    else:
        w, b = layers[nl + 2]
        assert w.shape == (3, hp // 2)
        assert torch.equal(w[:, :hidden // 2], mlp.rgb.weight) and not w[:, hidden // 2:].any()
        assert torch.equal(b, mlp.rgb.bias)


@pytest.mark.parametrize("hidden", [16, 96, 192])
def test_unpack_grads_gives_the_real_shapes(hidden):
    """A padded backward's flat dW/db (the padded model's gradients laid out
    as the workspace's dW slabs and the bias pack) come back from
    ``unpack_grads`` at the model's shapes and values (bf16-rounded
    weights, f32 biases)."""
    mlp = _mlp(hidden, num_layers=8, skip=4, l_xyz=10, l_dir=4)
    big = _padded_model(mlp)
    rng = np.random.default_rng(2)
    x = torch.tensor(rng.normal(size=(30, mlp.xyz_dim)), dtype=torch.float32)
    d = torch.tensor(rng.normal(size=(30, mlp.dir_dim)), dtype=torch.float32)
    g = torch.tensor(rng.normal(size=(30, 4)), dtype=torch.float32)
    _vjp(mlp, x, d, g)
    _vjp(big, x, d, g)
    fwd = k1.pack_weights_wg(mlp, CPU)
    layout = k1.workspace_layout(fwd, k1.pack_weights_bwd_wg(mlp, CPU))
    dw = torch.zeros(int((layout[:, 1].astype(np.int64) * layout[:, 3]).sum()))
    db = torch.zeros(fwd.b.numel())
    grads = [(lyr.weight.grad, lyr.bias.grad) for lyr in big.trunk]
    grads.append((torch.cat([big.feature.weight.grad, big.sigma.weight.grad]),
                  torch.cat([big.feature.bias.grad, big.sigma.bias.grad])))
    grads += [(big.branch.weight.grad, big.branch.bias.grad), (big.rgb.weight.grad, big.rgb.bias.grad)]
    for (gw, gb), (_, _, _, _, b_off), (_, a_w, _, d_w, off) in zip(grads, fwd.desc, layout):
        dw[off:off + a_w * d_w].view(a_w, d_w)[:gw.shape[1], :gw.shape[0]] = gw.T
        db[b_off:b_off + gb.numel()] = gb
    got = k1.unpack_grads(mlp, fwd, layout, dw, db)
    for (name, p), gg in zip(mlp.named_parameters(), got):
        assert gg.shape == p.shape, name
        want = p.grad
        if name.endswith("weight"):
            torch.testing.assert_close(gg, want, rtol=2 ** -8, atol=1e-7 * float(want.abs().max()))
        else:
            torch.testing.assert_close(gg, want, rtol=0, atol=PAD_TOL * float(want.abs().max()))


def _desc_address(n_pad, k_pad, ks):
    """Element offset of (n, k) in a layer's wgmma pack from the B
    descriptor's arithmetic (csrc/nerf_wgmlp.cuh: ks-deep slices, k16 steps
    2 * n_pad * 16 bytes apart, LBO n_pad * 16 bytes, SBO 128 bytes)."""
    n = np.arange(n_pad)[:, None]
    k = np.arange(k_pad)[None, :]
    s, q, kk = k // ks, k % ks // 16, k % 16
    return (s * ks * n_pad + q * 2 * n_pad * 16 // 2 + (n // 8) * 64 + (kk // 8) * n_pad * 8
            + (n % 8) * 8 + kk % 8)


def _numpy_padded(mlp, hp):
    """An independent numpy model of the padded layers (W^T, (out, in))."""
    hid, nl, xd, dd = mlp.hidden_dim, mlp.num_layers, mlp.xyz_dim, mlp.dir_dim
    out = []

    def put_in(w, k_in_real, skip_in):
        # w: real (n_real, k_real) -> rows stay, columns to the padded input
        if not skip_in:
            m = np.zeros((w.shape[0], k_in_real), np.float32)
            m[:, :w.shape[1]] = w
            return m
        m = np.zeros((w.shape[0], hp + xd), np.float32)
        m[:, :hid] = w[:, :hid]
        m[:, hp:] = w[:, hid:]
        return m

    for i, layer in enumerate(mlp.trunk):
        w = layer.weight.detach().numpy()
        skip_in = i > 0 and is_skip(i - 1, mlp.skip_layer)
        m = put_in(w, xd if i == 0 else hp, skip_in)
        full = np.zeros((hp, m.shape[1]), np.float32)
        full[:hid] = m
        out.append(full)
    w = np.concatenate([mlp.feature.weight.detach().numpy(), mlp.sigma.weight.detach().numpy()])
    m = put_in(w, hp, is_skip(nl - 1, mlp.skip_layer))
    full = np.zeros((hp + 1, m.shape[1]), np.float32)
    full[:hid] = m[:hid]
    full[hp] = m[hid]
    out.append(full)
    w = mlp.branch.weight.detach().numpy()
    full = np.zeros((hp // 2, hp + dd), np.float32)
    full[:hid // 2, :hid] = w[:, :hid]
    full[:hid // 2, hp:] = w[:, hid:]
    out.append(full)
    full = np.zeros((3, hp // 2), np.float32)
    full[:, :hid // 2] = mlp.rgb.weight.detach().numpy()
    out.append(full)
    return out


@pytest.mark.parametrize("hidden", [16, 96, 192])
@pytest.mark.parametrize("which", ["fwd", "bwd", "ig_4_2", "ig_16_6"])
def test_padded_packs_match_a_numpy_model(hidden, which):
    """Every element of every layer of the padded pack where the kernel's
    descriptor addresses it, against the numpy model; the widths the
    kernels check (nerf_wgmlp.cuh: wg_dims_ok, wg_input_grads_ok)."""
    lx, ld = {"ig_4_2": (4, 2), "ig_16_6": (16, 6)}.get(which, (10, 4))
    mlp = _mlp(hidden, num_layers=8, skip=4, l_xyz=lx, l_dir=ld)
    hp = k1.kernel_width(hidden)
    mats = _numpy_padded(mlp, hp)
    ks = k1.WG_KS
    if which == "fwd":
        pack = k1.pack_weights_wg(mlp, CPU)
        assert [int(n) for n in pack.desc[:8, 2]] == [hp] * 8
        assert (pack.desc[8, 1], pack.desc[8, 2], pack.desc[9, 2], pack.desc[10, 2]) == (
            hp + 1, hp + 8, hp // 2, 8)
    elif which == "bwd":
        pack = k1.pack_weights_bwd_wg(mlp, CPU)
        rows = [0] + [hp] * 7 + [hp, hp, hp // 2]
        mats = [m.T[:r] for m, r in zip(mats, rows)]
    else:
        pack = k1.pack_weights_bwd_wg(mlp, CPU, input_grads=True)
        kx, kd, ks = k1.ig_cols(mlp.xyz_dim, mlp.dir_dim)
        assert (kx, kd, ks) == ((64, 32, 64) if which == "ig_4_2" else (128, 64, 32))
        want = [kx] + [hp + kx if is_skip(i - 1, 4) else hp for i in range(1, 9)]
        assert [int(n) for n in pack.desc[:9, 2]] == want
        assert (pack.desc[9, 2], pack.desc[10, 2]) == (hp + kd, hp // 2)
        mats = [m.T for m in mats]
    w = pack.w.float().numpy()
    for mat, (k_pad, n, n_pad, w_off, _) in zip(mats, pack.desc):
        assert n == mat.shape[0] and k_pad == -(-mat.shape[1] // 16) * 16
        want = np.zeros((n_pad, k_pad), np.float32)
        want[:n, :mat.shape[1]] = torch.tensor(mat).to(torch.bfloat16).float().numpy()
        addr = _desc_address(n_pad, k_pad, ks)
        np.testing.assert_array_equal(addr, k1.wg_layout(n_pad, k_pad, ks))
        np.testing.assert_array_equal(w[w_off + addr], want)


@pytest.mark.parametrize("hidden", [48, 96, 192])
def test_k4_padded_tables_are_exact(hidden):
    """The int8 MLP on ``pad_qparams``' tables equals the unpadded one bit
    for bit; padded columns carry scale 1 and requant 1 (finite, nonzero);
    the pack has K4's widths."""
    mlp = _mlp(hidden, num_layers=8, skip=4, l_xyz=10, l_dir=4)
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.normal(size=(64, mlp.xyz_dim)), dtype=torch.float32)
    d = torch.tensor(rng.normal(size=(64, mlp.dir_dim)), dtype=torch.float32)
    tree = quant.mlp_tree(mlp)
    qp = quant.quantize_mlp(tree, quant.mlp_calibration_absmax(tree, x, d, 4), 4)
    hq = k1.kernel_width(hidden, k4.K4_HIDDEN)
    padded = k4.pad_qparams(qp, 4, hq)
    got = quant.apply_nerf_mlp_quant(padded, x, d, skip_layer=4)
    want = quant.apply_nerf_mlp_quant(qp, x, d, skip_layer=4)
    assert torch.equal(got, want)
    for row in [padded["inv_feat"], padded["inv_h2"], *padded["inv_h"],
                *(lyr["scale"] for lyr in padded["trunk"])]:
        assert bool(torch.isfinite(row).all()) and bool((row != 0).all())
    pack = k4.pack_qparams(padded, CPU)
    assert [int(n) for n in pack.desc[:8, 2]] == [hq] * 8
    assert (pack.desc[8, 1], pack.desc[9, 2]) == (hq + 1, hq // 2)


def _jax_params(hidden, l_xyz, l_dir, seed=0):
    arch = dict(num_layers=4, hidden_dim=hidden, skip_layer=2, l_xyz=l_xyz, l_dir=l_dir)
    p = init_nerf_params(jax.random.PRNGKey(seed), **arch)
    rng = np.random.default_rng(seed + 1)
    return jax.tree_util.tree_map(
        lambda v: np.asarray(v, np.float32) + (
            rng.normal(size=v.shape).astype(np.float32) * 0.1 if v.ndim == 1 else 0.0), p)


def _leaf_err(got, want):
    return max(float(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32)).max()
                     / max(np.abs(np.asarray(b, np.float32)).max(), 1e-12))
               for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)))


JAX_CASES = [(h, lx, ld) for h in (16, 96) for lx, ld in ((4, 2), (16, 6))]


def _rays(seed, b=8, s=16):
    rng = np.random.default_rng(seed)
    o = np.tile([0, 0, 4.0], (b, 1)).astype(np.float32)
    d = rng.normal(size=(b, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = np.sort(rng.uniform(2.0, 6.0, (b, s)), axis=-1).astype(np.float32)
    return o, d, t, rng.uniform(0, 1, (b, 3)).astype(np.float32)


@pytest.mark.parametrize("hidden,l_xyz,l_dir", JAX_CASES)
def test_render_rays_fused_matches_jax(hidden, l_xyz, l_dir):
    """K1/K2's module: rgb, weights and the residual backward's gradients."""
    params = _jax_params(hidden, l_xyz, l_dir)
    o, d, t, target = _rays(hidden + l_xyz)

    def jloss(p):
        rgb, w = jax_render(p, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t), l_xyz=l_xyz,
                            l_dir=l_dir, compute_dtype=jnp.float32, skip_layer=2,
                            max_tile_fwd=8 * 16, max_tile_bwd=8 * 16, bwd_mode="residual")
        return jnp.mean((rgb - jnp.asarray(target)) ** 2), (rgb, w)

    (_, (rgb_j, w_j)), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    mlp = NeRFMLP.from_jax_params(params, skip_layer=2, compute_dtype=torch.float32)
    rgb, w = k1.render_rays_fused(mlp, *(torch.as_tensor(v) for v in (o, d, t)), l_xyz=l_xyz,
                                  l_dir=l_dir, skip_layer=2)
    vtol, gtol = (JAX_VAL_TOL, JAX_GRAD_TOL) if l_xyz <= 10 else JAX_K1_HIGH_OCTAVE_TOL
    errs = (float(np.abs(rgb.detach().numpy() - np.asarray(rgb_j)).max()),
            float(np.abs(w.numpy() - np.asarray(w_j)).max()))
    ((rgb - torch.as_tensor(target)) ** 2).mean().backward()
    gerr = _leaf_err(mlp.to_jax_params(grad=True), jg)
    assert max(errs) <= vtol and gerr <= gtol, (errs, gerr)


@pytest.mark.parametrize("hidden,l_xyz,l_dir", JAX_CASES)
def test_apply_nerf_render_matches_jax(hidden, l_xyz, l_dir):
    """K6's module: rgb, weights and the rgb loss's gradients."""
    params = _jax_params(hidden, l_xyz, l_dir, seed=1)
    rng = np.random.default_rng(hidden)
    b, s = 8, 16
    x_enc = rng.normal(size=(b, s, 3 + 6 * l_xyz)).astype(np.float32)
    d_enc = rng.normal(size=(b, s, 3 + 6 * l_dir)).astype(np.float32)
    t = np.sort(rng.uniform(2.0, 6.0, (b, s)), axis=-1).astype(np.float32)
    g = rng.normal(size=(b, 3)).astype(np.float32)

    def jloss(p):
        rgb, w = apply_nerf_render_pallas(p, jnp.asarray(x_enc), jnp.asarray(d_enc),
                                          jnp.asarray(t), compute_dtype=jnp.float32,
                                          skip_layer=2)
        return jnp.sum(rgb * jnp.asarray(g)), (rgb, w)

    (_, (rgb_j, w_j)), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    mlp = NeRFMLP.from_jax_params(params, skip_layer=2, compute_dtype=torch.float32)
    rgb, w = k1.apply_nerf_render_fused(mlp, torch.as_tensor(x_enc), torch.as_tensor(d_enc),
                                        torch.as_tensor(t))
    assert float(np.abs(rgb.detach().numpy() - np.asarray(rgb_j)).max()) <= JAX_VAL_TOL
    assert float(np.abs(w.numpy() - np.asarray(w_j)).max()) <= JAX_VAL_TOL
    (rgb * torch.as_tensor(g)).sum().backward()
    assert _leaf_err(mlp.to_jax_params(grad=True), jg) <= JAX_GRAD_TOL


@pytest.mark.parametrize("hidden,l_xyz,l_dir", JAX_CASES)
def test_apply_nerf_mlp_matches_jax(hidden, l_xyz, l_dir):
    """K5's module with input gradients: predictions, parameter and
    encoding gradients (N = 70: a ragged last tile on the JAX side)."""
    params = _jax_params(hidden, l_xyz, l_dir, seed=2)
    rng = np.random.default_rng(hidden + 1)
    n = 70
    x = rng.normal(size=(n, 3 + 6 * l_xyz)).astype(np.float32)
    d = rng.normal(size=(n, 3 + 6 * l_dir)).astype(np.float32)
    g = rng.normal(size=(n, 4)).astype(np.float32)

    def jloss(p, xx, dd):
        out = apply_nerf_mlp_pallas(p, xx, dd, compute_dtype=jnp.float32, skip_layer=2,
                                    tile=64, bwd_tile=64, need_input_grads=True)
        return jnp.sum(out * jnp.asarray(g)), out

    (_, out_j), (gp, gx, gd) = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        params, jnp.asarray(x), jnp.asarray(d))
    mlp = NeRFMLP.from_jax_params(params, skip_layer=2, compute_dtype=torch.float32)
    xt = torch.as_tensor(x).requires_grad_()
    dt = torch.as_tensor(d).requires_grad_()
    out = k5.apply_nerf_mlp_fused(mlp, xt, dt, need_input_grads=True)
    assert float(np.abs(out.detach().numpy() - np.asarray(out_j)).max()) <= JAX_VAL_TOL
    (out * torch.as_tensor(g)).sum().backward()
    assert _leaf_err(mlp.to_jax_params(grad=True), gp) <= JAX_GRAD_TOL
    assert _leaf_err([xt.grad.numpy(), dt.grad.numpy()], [gx, gd]) <= JAX_GRAD_TOL
