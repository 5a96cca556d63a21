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
"""

import numpy as np
import pytest
import torch

from nerf_keras_tpu_torch.models.mlp import NeRFMLP, randomize_biases_
from nerf_keras_tpu_torch.ops.kernels import fused_render as k1


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
