"""The layouts the Hopper kernels read, checked on the CPU with numpy.

* The wgmma weight packs (``pack_weights_wg``, ``pack_weights_bwd_wg``
  with and without K5's input gradients):
  every element of every layer is found where the kernel's B descriptor
  addresses it (csrc/nerf_wgmlp.cuh: k-slices of ``WG_KS`` staged one at
  a time; per k16 step a K-major operand with LBO = n_pad * 16 bytes between
  the two 8-wide k halves and SBO = 128 bytes between 8-column groups).
* The dW workspace (csrc/nerf_wgmlp.cuh ``store_ws``, nerf_tile.cuh
  ``store_tile``): gathering it through nerf_dw.cuh's MN-major
  descriptors (LBO = 128 bytes between 8-sample groups, SBO = 1024 bytes
  between 8-column groups, 64-sample stages) gives A^T D.
* The chunk plan of the backward (``chunk_plan``): whole rays in order, a
  ragged last chunk, the byte budget, one chunk when the batch fits; for
  K5 (``S = 1``) chunks of whole 128-row sample tiles.
* K4's int8 pack (``quant_render.pack_qparams``): every int8 element of
  every layer is found where the s8 descriptor addresses it (16-byte
  core-matrix rows of 16 k, k32 steps, 128-k stages); and the two
  identities K4's epilogue computes by instead of type conversions
  (csrc/quant_render_fwd.cu), in float32 numpy: the magic-number
  int -> float for |acc| <= 2^22, and the requantization's round-and-clamp;
  the adversarial case of ``k4_adversarial.py`` reaches k * 127^2 where K4
  converts and sees a K4 that would not.
"""

import numpy as np
import pytest
import torch

import k4_adversarial
from nerf_keras_tpu_torch.models.mlp import NeRFMLP, randomize_biases_
from nerf_keras_tpu_torch.ops import quant
from nerf_keras_tpu_torch.ops.encoding import encode_position
from nerf_keras_tpu_torch.ops.kernels import fused_render as k1
from nerf_keras_tpu_torch.ops.kernels import quant_render as k4


def _desc_address(n_pad, k_pad):
    """Element offset of (n, k) in a layer's pack, from the descriptors:
    slice start, k16 step start, core matrix (n // 8, k % 16 // 8), then
    row n % 8 (16 bytes each) and k % 8 within it."""
    n = np.arange(n_pad)[:, None]
    k = np.arange(k_pad)[None, :]
    ks = k1.WG_KS
    s, q, kk = k // ks, k % ks // 16, k % 16
    stage = s * ks * n_pad
    step = q * 2 * n_pad * 16 // 2          # 2 * n_pad * 16 bytes per step
    lbo, sbo = n_pad * 16 // 2, 128 // 2     # in elements
    return stage + step + (n // 8) * sbo + (kk // 8) * lbo + (n % 8) * 8 + kk % 8


@pytest.mark.parametrize("arch", [(8, 256, 4), (5, 64, 4), (3, 128, 2), (4, 64, 1)])
@pytest.mark.parametrize("which", ["fwd", "bwd", "bwd_input_grads"])
def test_wg_pack_matches_the_descriptor(arch, which):
    num_layers, hidden, skip = arch
    gen = torch.Generator().manual_seed(7)
    mlp = randomize_biases_(NeRFMLP(num_layers=num_layers, hidden_dim=hidden,
                                    skip_layer=skip, generator=gen), gen)
    cpu = torch.device("cpu")
    if which == "fwd":
        pack, ref = k1.pack_weights_wg(mlp, cpu), k1.pack_weights(mlp, cpu)
        mats = [wt for wt, _ in k1._dense_layers(mlp)]
    else:
        ig = which == "bwd_input_grads"
        pack = k1.pack_weights_bwd_wg(mlp, cpu, input_grads=ig)
        ref = k1.pack_weights_bwd(mlp, cpu, input_grads=ig)
        mats = [m for m, _ in k1._bwd_layers(mlp, input_grads=ig)]
        if ig:
            # The widths K5's input-gradient walk takes (nerf_wgmlp.cuh:
            # wg_input_grads_ok): layer 0 is the x_enc part alone (64), a
            # layer after a skip concat hidden + 64, the branch hidden + 32.
            want = [64] + [hidden + 64 * (i > 1 and (i - 1) % skip == 0)
                           for i in range(1, num_layers + 1)]
            assert pack.desc[:num_layers + 1, 2].tolist() == want
            assert pack.desc[num_layers + 1, 2] == hidden + 32
    np.testing.assert_array_equal(pack.desc, ref.desc)
    torch.testing.assert_close(pack.b, ref.b, rtol=0, atol=0)
    w = pack.w.float().numpy()
    assert w.size == ref.w.numel()
    for mat, (k_pad, n, n_pad, w_off, _) in zip(mats, pack.desc):
        want = np.zeros((n_pad, k_pad), np.float32)
        want[:n, :mat.shape[1]] = mat.detach().to(torch.bfloat16).float().numpy()
        addr = _desc_address(n_pad, k_pad)
        np.testing.assert_array_equal(addr, k1.wg_layout(n_pad, k_pad))
        assert np.array_equal(np.sort(addr.ravel()), np.arange(n_pad * k_pad))
        np.testing.assert_array_equal(w[w_off + addr], want)


def _tiled(x):
    """A (rows, W) bf16 workspace as the kernels store it: element (r, c)
    at (r // 64) * 64 * W + (c // 8) * 512 + (r % 64) * 8 + c % 8."""
    rows, width = x.shape
    r = np.arange(rows)[:, None]
    c = np.arange(width)[None, :]
    out = np.empty(rows * width, x.dtype)
    out[(r // 64) * 64 * width + (c // 8) * 512 + (r % 64) * 8 + c % 8] = x
    return out


@pytest.mark.parametrize("a_w,d_w", [(320, 272), (64, 16), (288, 128)])
def test_dw_descriptors_read_the_tiled_workspace(a_w, d_w):
    rng = np.random.default_rng(0)
    rows = 192
    a = rng.normal(size=(rows, a_w)).astype(np.float32)
    d = rng.normal(size=(rows, d_w)).astype(np.float32)
    ta, td = _tiled(a), _tiled(d)
    m = np.arange(a_w)[:, None]
    n = np.arange(d_w)[:, None]
    kk = np.arange(16)[None, :]
    dw = np.zeros((a_w, d_w))
    for st in range(rows // 64):
        for q in range(4):
            # MN-major operands: core (mn // 8 at SBO, kk // 8 at LBO),
            # row kk % 8 of 8 elements, element mn % 8.
            base_a = st * 64 * a_w + q * 128
            base_d = st * 64 * d_w + q * 128
            ga = ta[base_a + (m // 8) * 512 + (kk // 8) * 64 + (kk % 8) * 8 + m % 8]
            gd = td[base_d + (n // 8) * 512 + (kk // 8) * 64 + (kk % 8) * 8 + n % 8]
            dw += ga.astype(np.float64) @ gd.T.astype(np.float64)
    np.testing.assert_allclose(dw, a.T.astype(np.float64) @ d.astype(np.float64),
                               rtol=1e-12, atol=1e-9)


BPS = 10_112  # workspace bytes per sample at 8x256, L 10/4


def test_workspace_bytes_per_sample():
    mlp = NeRFMLP(num_layers=8, hidden_dim=256, skip_layer=4)
    cpu = torch.device("cpu")
    fwd, bwd = k1.pack_weights_wg(mlp, cpu), k1.pack_weights_bwd_wg(mlp, cpu)
    assert k1.DwBuffers.bytes_per_sample(fwd, bwd) == BPS


def _check_plan(plan, b, s, budget):
    assert plan[0][0] == 0
    assert [r for r, _ in plan[1:]] == [r + c for r, c in plan[:-1]]
    assert sum(c for _, c in plan) == b
    assert all(c == plan[0][1] for _, c in plan[:-1]) and 0 < plan[-1][1] <= plan[0][1]
    for _, c in plan:
        assert -(-c * s // 128) * 128 * BPS <= budget or c == 1


@pytest.mark.parametrize("b,s", [(4096, 160), (4096, 192), (16384, 64), (1001, 24)])
def test_chunk_plan_default_budget(b, s):
    plan = k1.chunk_plan(b, s, BPS)
    _check_plan(plan, b, s, k1.DW_CHUNK_BYTES)
    assert k1.DW_CHUNK_BYTES <= 1 << 30  # the workspace stays far below the old 7.6 GB


def test_chunk_plan_ragged_and_small_budget():
    budget = 40 << 20  # an L2-sized chunk
    plan = k1.chunk_plan(4096, 160, BPS, budget)
    _check_plan(plan, 4096, 160, budget)
    assert len(plan) >= 3 and plan[-1][1] < plan[0][1]
    assert plan[0][1] * 160 <= 4096


def test_chunk_plan_one_chunk_when_it_fits():
    assert k1.chunk_plan(100, 64, BPS) == [(0, 100)]
    assert k1.chunk_plan(4096, 160, BPS, 8 << 30) == [(0, 4096)]


@pytest.mark.parametrize("n,budget", [
    (786_432, None),         # the parity step's fine pass: 12 chunks, ragged last
    (262_144, None),         # the coarse pass: 4 chunks
    (100_003, 40 << 20),     # a ragged N over 25 chunks
    (3000, 64 * 128 * BPS),  # one chunk: N fits
])
def test_chunk_plan_of_samples(n, budget):
    """K5 plans chunks of samples (S = 1): whole 128-row tiles in every
    chunk but the last, the exact cover of N in order, each chunk's
    workspace within the budget."""
    cap = k1.DW_CHUNK_BYTES if budget is None else budget
    plan = k1.chunk_plan(n, 1, BPS, budget)
    _check_plan(plan, n, 1, cap)
    assert all(c % 128 == 0 for _, c in plan[:-1])
    assert (len(plan) == 1) == (-(-n // 128) * 128 * BPS <= cap)


def test_chunk_plan_ray_larger_than_budget():
    plan = k1.chunk_plan(5, 4096, BPS, 1 << 20)
    assert plan == [(i, 1) for i in range(5)]


# ---------------------------------------------------------------------------
# K4 (csrc/quant_render_fwd.cu)

def _qparams(arch, seed=7):
    """Calibrated int8 tables of a random-bias MLP (L_XYZ 10, L_DIR 4)."""
    num_layers, hidden, skip = arch
    gen = torch.Generator().manual_seed(seed)
    mlp = randomize_biases_(NeRFMLP(num_layers=num_layers, hidden_dim=hidden,
                                    skip_layer=skip, generator=gen), gen)
    rng = np.random.default_rng(seed)
    pts = torch.as_tensor(rng.uniform(-1.5, 1.5, (512, 3)), dtype=torch.float32)
    dirs = torch.as_tensor(rng.normal(size=(512, 3)), dtype=torch.float32)
    dirs = dirs / dirs.norm(dim=-1, keepdim=True)
    tree = quant.mlp_tree(mlp)
    stats = quant.mlp_calibration_absmax(tree, encode_position(pts, 10),
                                         encode_position(dirs, 4), skip)
    return quant.quantize_mlp(tree, stats, skip)


def _s8_desc_address(n_pad, k_pad):
    """Byte offset of (n, k) in a layer's int8 pack, from the descriptors:
    128-k stage, k32 step (2 * n_pad * 16 bytes each), core matrix (n // 8
    at SBO = 128, k % 32 // 16 at LBO = n_pad * 16), then row n % 8 (16
    bytes) and k % 16 within it."""
    n = np.arange(n_pad)[:, None]
    k = np.arange(k_pad)[None, :]
    ks = k4.K4_KS
    s, q, kk = k // ks, k % ks // 32, k % 32
    stage = s * ks * n_pad
    step = q * 2 * n_pad * 16
    return stage + step + (n // 8) * 128 + (kk // 16) * n_pad * 16 + (n % 8) * 16 + kk % 16


@pytest.mark.parametrize("arch", [(8, 256, 4), (5, 64, 4), (3, 128, 2), (4, 64, 1)])
def test_k4_pack_matches_the_s8_descriptor(arch):
    num_layers, hidden, skip = arch
    qp = _qparams(arch)
    pack = k4.pack_qparams(qp, torch.device("cpu"))
    w = pack.w.numpy()
    layers = k4._layers(qp)
    assert len(layers) == pack.desc.shape[0] == num_layers + 3
    w_end = f_end = 0
    for (wq, scale, b, inv), (k_pad, n, n_pad, w_off, f_off) in zip(layers, pack.desc):
        k = wq.shape[0]
        assert (k_pad, n, n_pad) == (-(-k // 32) * 32, wq.shape[1], -(-n // 8) * 8)
        # The layers follow each other, as the kernel's descriptor check takes them.
        assert (w_off, f_off) == (w_end, f_end)
        want = np.zeros((n_pad, k_pad), np.int8)
        want[:n, :k] = wq.T.numpy()
        addr = _s8_desc_address(n_pad, k_pad)
        np.testing.assert_array_equal(addr, k4.q_layout(n_pad, k_pad))
        assert np.array_equal(np.sort(addr.ravel()), np.arange(n_pad * k_pad))
        np.testing.assert_array_equal(w[w_off + addr], want)
        f = pack.f[f_off:f_off + 3 * n_pad].reshape(3, n_pad)
        torch.testing.assert_close(f[0, :n], scale.reshape(-1), rtol=0, atol=0)
        torch.testing.assert_close(f[1, :n], b.reshape(-1), rtol=0, atol=0)
        if inv is not None:
            torch.testing.assert_close(f[2, :inv.numel()], inv.reshape(-1), rtol=0, atol=0)
        assert not f[:, n:].any()
        w_end += n_pad * k_pad
        f_end += 3 * n_pad
    assert w.size == w_end
    # The widths the kernel's instantiations take.
    hid = pack.desc[:num_layers, 2]
    assert (hid == hidden).all()
    assert pack.desc[num_layers, 1:3].tolist() == [hidden + 1, hidden + 8]
    assert pack.desc[num_layers + 1, 2] == hidden // 2
    assert pack.desc[num_layers + 2, 1:3].tolist() == [3, 8]
    # inv_x, then inv_d, each padded to 32, end the f32 pack (one bulk copy
    # of 16-byte granules).
    assert (pack.x_off, pack.d_off) == (f_end, f_end + 64)
    assert pack.f.numel() == pack.d_off + 32 and pack.f.numel() % 4 == 0


def test_k4_pack_rejects_minus_128():
    qp = _qparams((2, 64, 4))
    qp["trunk"][1]["wq"] = qp["trunk"][1]["wq"].clone()
    qp["trunk"][1]["wq"][0, 0] = -128
    with pytest.raises(ValueError, match="-127, 127"):
        k4.pack_qparams(qp, torch.device("cpu"))


def test_dequant_magic_number_is_exact():
    """float(acc) = bits(acc + 0x4B400000) - 1.5 * 2^23 for every int32
    with |acc| <= 2^22, and not beyond; k * 127^2 stays within for k <= 260,
    so every padded k <= 256 (the kernel's kMagicK) may take it."""
    acc = np.arange(-(1 << 22), (1 << 22) + 1, dtype=np.int32)
    got = (acc + np.int32(0x4B400000)).view(np.float32) - np.float32(12582912.0)
    np.testing.assert_array_equal(got, acc.astype(np.float32))
    beyond = np.array([(1 << 22) + 1, -(1 << 22) - 1], dtype=np.int32)
    got = (beyond + np.int32(0x4B400000)).view(np.float32) - np.float32(12582912.0)
    assert not np.any(got == beyond.astype(np.float32))
    assert 260 * 127 ** 2 <= 1 << 22 < 261 * 127 ** 2


def _magic_requant(c):
    """K4's requant: the int8 in the low byte of float32(c + 1.5 * 2^23)."""
    bits = (c.astype(np.float32) + np.float32(12582912.0)).view(np.uint32)
    return (bits & 0xFF).astype(np.uint8).view(np.int8)


_GRID = np.concatenate([
    np.arange(-131.0, 131.0, 0.25),                  # x.5 ties, +-126.5, +-127.5
    np.nextafter(np.float32(np.arange(-130.5, 131.0, 1.0)), np.float32(0)),
    np.nextafter(np.float32(np.arange(-130.5, 131.0, 1.0)), np.float32(np.inf)),
    [1e30, -1e30, np.inf, -np.inf, np.nan, 0.0, -0.0, 1e-30, -1e-30],
]).astype(np.float32)


def test_requant_magic_number_is_rint_then_clamp():
    """min(max(v, -127), 127) + 1.5 * 2^23 against the former K4's
    min(max(rint(v), -127), 127) (rint half to even; fmax/fmin return the
    other operand of a NaN, as CUDA's fmaxf/fminf)."""
    v = _GRID
    with np.errstate(invalid="ignore"):
        want = np.fmin(np.fmax(np.rint(v), np.float32(-127)), np.float32(127)).astype(np.int8)
    got = _magic_requant(np.fmin(np.fmax(v, np.float32(-127)), np.float32(127)))
    np.testing.assert_array_equal(got, want)
    assert got[np.isnan(v)].tolist() == [-127]


def test_requant_after_relu_is_one_max():
    """After a relu, K4 takes min(max(y * inv, 0), 127) for
    q(relu(y) * inv): the same int8 for every y (NaN and infinities
    included) when inv > 0, and for every finite y when inv = 0 (a padded
    column, whose y is 0)."""
    y = _GRID[:, None]
    for inv, finite in (([0.37, 1.0, 3.9e-3, 127 / 1e-8, 1e38], False), ([0.0], True)):
        iv = np.array(inv, np.float32)[None, :]
        yy = y[np.isfinite(y[:, 0])] if finite else y
        with np.errstate(over="ignore", invalid="ignore"):
            got = _magic_requant(np.fmin(np.fmax(yy * iv, np.float32(0)), np.float32(127)))
            prod = np.fmax(yy, np.float32(0)) * iv
            want = np.fmin(np.fmax(np.rint(prod), np.float32(-127)),
                           np.float32(127)).astype(np.int8)
        np.testing.assert_array_equal(got, want)


def test_adversarial_case_reaches_the_bound_and_sees_a_wrong_conversion():
    """The accumulators of the layer after the skip and of the branch are
    exactly k * 127^2 (beyond 2^22), the other layers' within 2^22, and a
    K4 that took the magic-number conversion everywhere would miss K4's
    gates (rgb/weights max 1e-3, mean 1e-5) by 10x or more."""
    cpu = torch.device("cpu")
    qp, o, d, t = k4_adversarial.adversarial_case(cpu)
    seen = k4_adversarial.max_accumulators(qp, o, d, t)
    assert seen[319] == 319 * 127 ** 2 and seen[283] == 283 * 127 ** 2
    assert all(v <= 1 << 22 for k, v in seen.items() if k <= 256)
    want = k4.render_rays_reference_quant(qp, o, d, t)
    exact = quant._qdot
    quant._qdot = k4_adversarial.magic_qdot
    try:
        bad = k4.render_rays_reference_quant(qp, o, d, t)
    finally:
        quant._qdot = exact
    miss = max(max(float((a - b).abs().max()) / 1e-3, float((a - b).abs().mean()) / 1e-5)
               for a, b in zip(bad, want))
    assert miss >= 10.0
    assert all(bool(torch.isfinite(x).all()) for x in want)
