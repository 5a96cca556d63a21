"""Hidden widths up to 1024 on the kernels: the packs and layouts of the
64-row split tile, and the modules and the slice at 320, 512 and 1024, on
the CPU.

Hidden 512 runs on its own instantiation (``csrc/nerf_wgmlp.cuh``: a
64-row tile whose two consumer warpgroups each compute a part of every
layer's output columns, ``Split<N>``: 256 + 256 of the trunk, 256 + 264 of
the merged head, 128 + 128 of the branch, the 8-wide rgb head warpgroup 0's
alone; weight stages 32 k deep), and widths 257-511 run zero-padded to it
(``fused_render.kernel_width``/``layer_maps``/``padded_layers``,
``quant_render.pad_qparams``).  Hidden 1024 runs the same tile in column
passes (``n_passes``: a layer wider than 520 columns in passes of 512, the
merged head's 1,032 as 512 + 520), each pass's columns a block of the pack
of their own, and widths 513-1023 run zero-padded to it.  Here, with numpy
models of the addressing:

* The forward pack and K2's transposed pack at hidden 320, 640 and 960
  (padded) and 512 and 1024: every element where a warpgroup's B
  descriptor addresses it in its column pass, for
  32-deep stages (hidden 512's) as for 64-deep ones, at the column offset
  of each warpgroup's part; a 32-deep stage is one contiguous run of the
  pack.
* K4's int8 tables at 320 and 512: the padding is exact, the pack has
  K4's widths, each part's f32 scale/bias/requant rows and its int8
  columns where the 64-deep stages' descriptor addresses them.
* ``layer_maps`` at hp 512: sigma at head column 512, the skip layer's and
  the branch's encodings at 512, the rgb input 256 wide.
* The dW product's tiles (``csrc/nerf_dw.cuh``): on the 128-row tile a
  layer's whole d_width, an instantiated width; on the split tile units
  of up to 256 D columns (``dw_units``), each part of them a contiguous
  run of a workspace stage, whose written columns cover each layer once;
  the persistent walk of ``dw_schedule`` (a model of it, ``_dw_walk``)
  covers every (layer, row, column, sample stage) once, at the ``wide``
  phase's chunks, ragged last chunks and other SM counts, with the
  window tiles' sample ranges, and gives every block the same parts of
  128 columns to within one; the array the kernel reads.
* K4's persistent grid of clusters at hidden 512 and 1024 (a model of the
  launch's grid and of the kernel's walk, ``_k4_walk``): every ray once,
  for B below, at and above the SM count, both blocks of a cluster the
  same stages (phantom groups and the tiles a shorter group lacks
  drained).
* The split tile's clusters of two blocks (``nerf_wgmlp.cuh``,
  "Clusters"): the rows kernel's grid (``fused_render.cluster_grid``) and
  a model of each block's walk (``walk_steps``): every tile once, both
  blocks of a cluster the same steps; every weight stage halves into two
  16-byte-aligned runs for the multicast copies.
* K1/K2's, K6's, K5's and K4's modules at hidden 320 and 512 against the
  JAX package (interpret mode on the CPU; the port's CPU wrappers take the
  plain versions), 4 layers, skip 2, 8 rays x 16 samples.
* The slice: one parity train step and one frame of the port's
  ``Trainer`` against the JAX step and render at hidden 512.

Tolerances: packs and layouts exact.  Against JAX (float32), as
``tests/test_torch_widths.py``: values 1e-5, gradients per leaf max |diff|
over the leaf's largest entry 5e-4; K4 values 1e-5 (``test_torch_quant``);
the step's metrics 5e-4 relative and gradients per leaf 5e-4 of the leaf's
largest entry (``test_torch_train_coarse``), the frame's rgb 1e-4 and
depth 1e-3.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_keras_tpu.engine import step as jstep
from nerf_keras_tpu.models.mlp import init_nerf_params
from nerf_keras_tpu.ops import encode_position, sample_rays
from nerf_keras_tpu.ops import quant as jq
from nerf_keras_tpu.ops.pallas.fused_mlp import apply_nerf_mlp_pallas
from nerf_keras_tpu.ops.pallas.fused_render import apply_nerf_render_pallas
from nerf_keras_tpu.ops.pallas.fused_render import render_rays_fused as jax_render
from nerf_keras_tpu.ops.pallas.quant_render import render_rays_fused_quant as jax_k4
from nerf_keras_tpu_torch.engine import step as pstep
from nerf_keras_tpu_torch.models.mlp import NeRFMLP, is_skip
from nerf_keras_tpu_torch.ops import quant
from nerf_keras_tpu_torch.ops.kernels import fused_mlp as k5
from nerf_keras_tpu_torch.ops.kernels import fused_render as k1
from nerf_keras_tpu_torch.ops.kernels import quant_render as k4
import k4_adversarial
from test_torch_train_coarse import (
    FAR,
    GRAD_TOL,
    NEAR,
    _batch,
    _cfg,
    _draws,
    _grab_grads,
    _jax_state,
    _leaves,
    _port,
)
from test_torch_widths import _jax_params, _leaf_err, _mlp, _numpy_padded, _rays

# One torch thread beside the JAX workers of the tier-1 run.
torch.set_num_threads(1)

CPU = torch.device("cpu")
JAX_VAL_TOL = 1e-5
JAX_GRAD_TOL = 5e-4
WIDE = (320, 512, 640, 960, 1024)


def _split(n):
    """``Split<N>`` of csrc/nerf_wgmlp.cuh: warpgroup 0's columns of an
    N-wide layer on the split tile, then warpgroup 1's."""
    lo = n if n <= 8 else n // 64 * 32
    return lo, n - lo


def _products(n):
    """``SplitProduct<N>``: the (first column, width) of each warpgroup's
    product: the wider part's width, warpgroup 0 from 0, warpgroup 1
    ending at N."""
    width = max(_split(n))
    return (0, width), (n - width, width)


def _pass_parts(n_pad, cols=k1.PASS_COLS):
    """Each warpgroup's product on the split tile, pass by pass
    (``layer_passes``; the bf16 kernels' passes are ``cols`` =
    WG_PASS_COLS wide, K4's PASS_COLS): ``(c0, w, n0, width)``, the pass's
    first column and width (its block of the pack is ``w`` wide, ``k_pad *
    c0`` elements in), and the product's first column within the pass and
    width."""
    c0 = 0
    for w in k1.pass_widths(n_pad, cols):
        for n0, width in _products(w):
            yield c0, w, n0, width
        c0 += w


def _part_address(n_pad, k_pad, ks, n0, width):
    """Element offsets of columns [n0, n0 + width) of a layer's pack from a
    warpgroup's B descriptor (``wg_product``): ks-deep stages, each a
    contiguous run starting at k0 * n_pad; the part's start n0 * 16 bytes
    into the stage; k16 steps 2 * n_pad * 16 bytes apart; core matrices
    n_pad * 16 bytes apart along K (LBO) and 128 along N (SBO)."""
    j = np.arange(width)[:, None]
    k = np.arange(k_pad)[None, :]
    s, q, kk = k // ks, k % ks // 16, k % 16
    return (s * ks * n_pad + n0 * 8 + q * n_pad * 16 + (j // 8) * 64 + (kk // 8) * n_pad * 8
            + (j % 8) * 8 + kk % 8)


@pytest.mark.parametrize("hidden", WIDE)
@pytest.mark.parametrize("which", ["fwd", "bwd"])
def test_wide_packs_match_a_numpy_model(hidden, which):
    """Every element of every layer of the forward pack (K1, K5, K6, the
    backward's recompute) and of K2's transposed pack at hidden 320 (padded
    to 512) and 512, where each warpgroup's part of the split tile reads
    it from 32-deep stages, against the numpy model of the padding; the
    widths the kernels check (wg_dims_ok)."""
    mlp = _mlp(hidden, num_layers=8, skip=4, l_xyz=10, l_dir=4)
    hp = k1.kernel_width(hidden)
    assert hp == (512 if hidden <= 512 else 1024)
    mats = _numpy_padded(mlp, hp)
    if which == "fwd":
        pack = k1.pack_weights_wg(mlp, CPU)
        assert [int(n) for n in pack.desc[:8, 2]] == [hp] * 8
        assert (pack.desc[8, 1], pack.desc[8, 2], pack.desc[9, 2], pack.desc[10, 2]) == (
            hp + 1, hp + 8, hp // 2, 8)
    else:
        pack = k1.pack_weights_bwd_wg(mlp, CPU)
        rows = [0] + [hp] * 7 + [hp, hp, hp // 2]
        mats = [m.T[:r] for m, r in zip(mats, rows)]
    w = pack.w.float().numpy()
    for mat, (k_pad, n, n_pad, w_off, _) in zip(mats, pack.desc):
        assert n == mat.shape[0] and k_pad == -(-mat.shape[1] // 16) * 16
        if n_pad == 0:
            continue
        want = np.zeros((n_pad, k_pad), np.float32)
        want[:n, :mat.shape[1]] = torch.tensor(mat).to(torch.bfloat16).float().numpy()
        # The pack's layout does not depend on the stage depth.
        cols = k1.wg_pass_cols(hp)
        np.testing.assert_array_equal(k1.wg_layout(n_pad, k_pad, k1.WG_KS_NARROW, cols),
                                      k1.wg_layout(n_pad, k_pad, k1.WG_KS, cols))
        for c0, pw, n0, width in _pass_parts(n_pad, k1.wg_pass_cols(hp)):
            lo, hi = _split(pw)
            assert lo % 32 == 0 or pw == 8
            addr = k_pad * c0 + _part_address(pw, k_pad, k1.WG_KS_NARROW, n0, width)
            np.testing.assert_array_equal(w[w_off + addr], want[c0 + n0:c0 + n0 + width])


def test_split_parts_of_the_512_layers():
    """The parts the split tile's warpgroups write (Split<N>) and the
    columns their products take (SplitProduct<N>) at 512: each product a
    wgmma width (multiple of 8, <= 264, 132 f32 a thread at most) that
    starts at the warpgroup's part, where a ReLU mask is taken whole
    32-column mask words."""
    assert _split(512) == (256, 256)  # trunk, K2's dX products
    assert _split(520) == (256, 264)  # merged head
    assert _split(256) == (128, 128)  # branch, K2's rgb dX
    assert _split(8) == (8, 0)        # rgb head: warpgroup 0 writes it
    assert _products(520) == ((0, 264), (256, 264))
    assert _products(8) == ((0, 8), (0, 8))
    for n in (512, 520, 256):
        lo, hi = _split(n)
        (a0, w0), (a1, w1) = _products(n)
        assert a0 == 0 and w0 >= lo and a1 == lo and a1 + w1 == n
    for n in (512, 256):
        assert all(p % 32 == 0 for p in _split(n))
    assert max(w for n in (512, 520, 256, 8) for _, w in _products(n)) // 2 == 132


# The widths of the split tile's products at hidden H: the trunk and K2's
# dX products H, the merged head H + 8, the branch and the rgb head's dX
# H / 2, the rgb head 8.
def _layer_widths(hidden):
    return {"trunk": hidden, "dx": hidden, "head": hidden + 8, "branch": hidden // 2,
            "rgb_dx": hidden // 2, "rgb": 8}


# csrc/nerf_wgmlp.cuh: a thread's f32 sums of a pass part at hidden 1024
# (WgTile::kSumAcc), its fresh sum as many; ptxas allocates a 384-thread
# block's registers at 168 a thread.
SUM_ACC, PTXAS_REGS = 68, 168


@pytest.mark.parametrize("hidden", [512, 1024])
def test_column_passes_of_the_1024_layers(hidden):
    """The split tile's column passes (``pass_widths`` of ``wg_pass_cols``,
    csrc/nerf_wgmlp.cuh: n_passes): at 1024 the trunk and K2's dX products
    4 x 256, the merged head 3 x 256 + 264 (sigma in the last), the branch
    and the rgb head's dX 2 x 256, the rgb head 8; at 512 every layer in
    one pass.  Each pass's product for each warpgroup (SplitProduct)
    covers the pass's columns, each written by one warpgroup (Split) once;
    each product is a wgmma width (a multiple of 8); at 1024 at most 136
    columns, so the pass's f32 sums and a fresh sum (68 f32 a thread each)
    and two sets of A fragments (8 registers each at 32-deep stages) take
    152 of the 168 registers ptxas allocates a thread; the park holds every
    pass of a layer but the last."""
    assert k1.WG_PASS_COLS == 256 and k1.PASS_COLS == 512  # K4's stay 512
    assert k1.wg_pass_cols(1024) == 256 and k1.wg_pass_cols(512) is None
    want = {1024: {"trunk": [256] * 4, "head": [256] * 3 + [264], "branch": [256] * 2,
                   "rgb": [8]},
            512: {"trunk": [512], "head": [520], "branch": [256], "rgb": [8]}}
    widths = _layer_widths(hidden)
    for name, n in widths.items():
        cols = k1.wg_pass_cols(hidden)
        passes = k1.pass_widths(n, cols)
        assert passes == want[hidden].get(name, want[hidden]["trunk"] if name == "dx"
                                          else want[hidden]["branch"])
        written, parts = [], list(_pass_parts(n, cols))
        for i, (c0, pw, n0, width) in enumerate(parts):
            assert 0 <= n0 and n0 + width <= pw and width % 8 == 0
            assert width // 2 <= (SUM_ACC if hidden == 1024 else 132)
            lo, hi = _split(pw)
            start, cnt = (0, lo) if i % 2 == 0 else (lo, hi)  # warpgroup 0, then 1
            assert n0 <= start and start + cnt <= n0 + width  # the product covers its part
            written += list(range(c0 + start, c0 + start + cnt))
        assert sorted(written) == list(range(n))
        if hidden == 1024:
            assert sum(passes[:-1]) <= hidden - k1.WG_PASS_COLS  # the park: WgTile::kParkCols
    assert 2 * SUM_ACC + 2 * (k1.WG_KS_NARROW // 16) * 4 <= PTXAS_REGS - 16
    for n in (8, 256, 264):
        assert k1.pass_widths(n, k1.WG_PASS_COLS) == [n]
    for n in (256, 264, 520):
        assert k1.pass_widths(n, k1.wg_pass_cols(512)) == [n]
    assert k1.pass_widths(1032) == [512, 520]  # K4's passes at 1024


def _sum_depth(hidden):
    """The k of a fresh wgmma sum at ``hidden``: a 32-deep stage at 512
    (csrc/nerf_wgmlp.cuh: wg_product_staged), kSumDepth at 1024
    (wg_product_sums; without NKT_SUM_DEPTH)."""
    import re
    from pathlib import Path
    if hidden <= 512:
        return k1.WG_KS_NARROW
    text = (Path(k1.__file__).parents[2] / "csrc" / "nerf_wgmlp.cuh").read_text()
    return int(re.search(r"#else\nconstexpr int kSumDepth = (\d+);", text).group(1))


def _fresh_sums(k_pad, depth, ks):
    """The fresh sums over a layer of k_pad k in ks-deep stages
    (wg_product_sums, wg_product_staged): [(first k, last k + 1)], a sum
    starting at every stage whose first k is a multiple of ``depth``."""
    starts = [k0 for k0 in range(0, k_pad, ks) if k0 % depth == 0]
    return list(zip(starts, starts[1:] + [k_pad]))


@pytest.mark.parametrize("hidden", [512, 1024])
def test_stage_parts_cover_each_column_once(hidden):
    """The split tile's fresh sums: their depth (a 32-deep stage at 512,
    ``wg_product_staged``; kSumDepth, 64 k, at 1024, ``wg_product_sums``)
    is a whole number of the 32-deep stages and at most the shallowest wide
    layer, so each layer of the forward and transposed packs at 512 and
    1024 (k_pad from the packs) splits into sums of whole stages, each k
    in exactly one, every sum but the last kSumDepth deep; and each pass
    part of every product width is added into its own sums once (the
    passes and parts of ``test_column_passes_of_the_1024_layers``)."""
    depth, ks = _sum_depth(hidden), k1.WG_KS_NARROW
    assert depth % ks == 0 and ks <= depth <= 256
    mlp = _mlp(hidden, 8, 4, 10, 4)
    for pack in (k1.pack_weights_wg(mlp, CPU), k1.pack_weights_bwd_wg(mlp, CPU)):
        for k_pad, _, n_pad, _, _ in pack.desc:
            k_pad = int(k_pad)
            if not n_pad:
                continue
            sums = _fresh_sums(k_pad, depth, ks)
            assert [k for a, c in sums for k in range(a, c)] == list(range(k_pad))
            assert all(a % ks == 0 and c - a == depth for a, c in sums[:-1])
            assert 0 < sums[-1][1] - sums[-1][0] <= depth
            cols = [c0 + n0 + j for c0, _, n0, w in _pass_parts(int(n_pad),
                                                                 k1.wg_pass_cols(hidden))
                    for j in range(w)]
            assert set(cols) == set(range(int(n_pad)))


@pytest.mark.parametrize("hidden", [512, 1024])
def test_shared_memory_at_1024(hidden):
    """The split tile's blocks (a model of the hosts' carve-ups:
    fused_render_fwd.cu, fused_mlp_fwd.cu, nerf_rows.cuh,
    quant_render_fwd.cu) in the 232,448 bytes a block may use, with 32-deep
    stages of the widest pass: at 512 the 520-column head, K1 (its x_enc
    tile and one ray's S = 192 predictions) 4 stages, K5's forward 4, the
    rows kernel (its ReLU bits and column sums) 3; at 1024 the head's last
    256-column pass (264 columns), K1 4 stages, K5's forward 5, the rows
    kernel 5, with the park and the rows kernel's bits and sums in the
    global scratch (``glob_bytes``: the park of 64 x 768 bf16, 9 layers'
    bits, two sets of four rows of sums); K4 at 1024 with its park of 64 x
    512 bytes and its f32 rows in global memory, two 64-deep int8 stages of
    its 520-column pass."""
    smem, bars, max_stages = 232_448, 128, 8
    ldx, xyz_pad, dir_pad = hidden + 64 + 8, 64, 32
    stage = (520 if hidden == 512 else 264) * 32 * 2
    rest = {"k1": bars + 2 * (64 * ldx + 64 * xyz_pad + dir_pad) + 4 * (8 + 192 * 4),
            "k5": bars + 2 * 64 * ldx + 4 * 64 * 4,
            "rows": bars + 2 * 64 * ldx + (4 * 9 * 64 * (hidden // 32) + 4 * 2 * 4 * hidden
                                           if hidden == 512 else 0)}
    want = {512: {"k1": 4, "k5": 4, "rows": 3}, 1024: {"k1": 4, "k5": 5, "rows": 5}}[hidden]
    assert {k: min(max_stages, (smem - r) // stage) for k, r in rest.items()} == want
    if hidden == 1024:
        assert k1.glob_bytes(1024, 8, True) == 64 * 768 * 2 + 4 * 9 * 64 * 32 + 4 * 2 * 4 * 1024
        assert k1.glob_bytes(1024, 8, False) == 64 * 768 * 2
        q_ldx, q_xyz, q_dir = 1024 + 64 + 16, 64, 32
        k4_rest = 144 + 64 * 512 + 64 * q_ldx + 64 * q_xyz + q_dir + 4 * (8 + 192 * 4)
        assert (smem - k4_rest) // (520 * 64) >= 2
    else:
        assert k1.glob_bytes(512, 8, True) == k1.glob_bytes(512, 8, False) == 0


@pytest.mark.parametrize("hidden", [513, 1000, 1024, 1025])
def test_kernel_width_at_1024_and_beyond(hidden):
    """Both instantiation lists end at 1024: a model of 513-1024 units runs
    on the 1024 kernels (bf16 wgmma and K4), 1025 raises
    NotImplementedError naming the limit and ROADMAP.md queue 2 A3."""
    for widths in (k1.WG_HIDDEN, k4.K4_HIDDEN):
        if hidden <= 1024:
            assert k1.kernel_width(hidden, widths) == 1024
        else:
            with pytest.raises(NotImplementedError, match=r"up to 1024.*ROADMAP.md queue 2 A3"):
                k1.kernel_width(hidden, widths)


def _cluster_walk(ntiles, grid, cluster=k1.CLUSTER):
    """The tiles each block of a grid-strided split-tile kernel walks
    (``nerf_wgmlp.cuh: walk_steps``): block ``b`` takes ``b``, ``b +
    grid``, ... for as many steps as the first block of its cluster, so
    both blocks of a cluster consume the same weight stages; a step past
    the last tile is a phantom (``None``) that only drains them."""
    walks = []
    for b in range(grid):
        first = b - b % cluster
        steps = -(-(ntiles - first) // grid) if ntiles > first else 0
        walks.append([t if t < ntiles else None for t in range(b, b + steps * grid, grid)])
    return walks


def _chunk_grid(grid, ntiles):
    """The blocks of one launch of a grid-strided split-tile kernel
    (``nerf_wgmlp.cuh: split_grid`` once the card's clusters are taken):
    the grid, or the chunk's tiles rounded up to a whole cluster."""
    return -(-min(grid, ntiles) // k1.CLUSTER) * k1.CLUSTER


@pytest.mark.parametrize("sms", [132, 8])
@pytest.mark.parametrize("ntiles", [1, 2, 3, 5, 8, 131, 132, 133, 264, 527, 528])
def test_cluster_walk_covers_every_tile_once(ntiles, sms):
    """The split tile's clusters of two blocks: the rows kernel's grid is
    whole clusters within one block per SM; in every launch of it (a
    chunk of ``ntiles`` 64-row tiles, or fewer) each tile is walked by
    exactly one block, the two blocks of a cluster walk as many steps, and
    the steps past a block's tiles (phantoms, which only drain the ring)
    are the second block's, one at most."""
    grid = k1.cluster_grid(ntiles, sms)
    assert grid % k1.CLUSTER == 0 and k1.CLUSTER <= grid <= max(k1.CLUSTER, sms)
    assert grid <= ntiles + 1
    for chunk_tiles in sorted({ntiles, max(1, ntiles // 3), 1}):
        g = _chunk_grid(grid, chunk_tiles)
        walks = _cluster_walk(chunk_tiles, g)
        assert len(walks) == g
        walked = sorted(t for w in walks for t in w if t is not None)
        assert walked == list(range(chunk_tiles))
        for b in range(0, g, k1.CLUSTER):
            first, second = walks[b], walks[b + 1]
            assert len(first) == len(second) >= 1
            assert None not in first
            assert second.count(None) <= 1 and (None not in second or second[-1] is None)


def test_cluster_grid_at_the_wide1024_phase():
    """K2 at 8 x 1024, B = 4,096, S = 192 on an H100: chunks of 88 rays
    (39,296 B a sample), 47 of them, 264 64-row tiles each on 132 blocks,
    two tiles a block."""
    plan = k1.chunk_plan(4096, 192, 39_296)
    assert plan[0][1] == 88 and len(plan) == 47 and plan[-1][1] == 4096 - 88 * 46
    tiles = -(-plan[0][1] * 192 // k1.SPLIT_ROWS)
    grid = k1.cluster_grid(tiles, 132)
    assert (tiles, grid) == (264, 132)
    assert {len(w) for w in _cluster_walk(tiles, grid)} == {2}


def test_cluster_grid_at_the_wide_phase():
    """K2 at 8 x 512, B = 4,096, S = 192 on an H100 (132 SMs): chunks of
    176 rays (``chunk_plan``, 19,840 B a sample), 528 64-row tiles each;
    66 clusters, every block four tiles a chunk, the last chunk's 144
    tiles on 132 blocks."""
    plan = k1.chunk_plan(4096, 192, 19_840)
    assert plan[0][1] == 176 and plan[-1][1] == 4096 - 176 * 23
    tiles = -(-plan[0][1] * 192 // k1.SPLIT_ROWS)
    grid = k1.cluster_grid(tiles, 132)
    assert (tiles, grid) == (528, 132)
    assert {len(w) for w in _cluster_walk(tiles, grid)} == {4}
    last = -(-plan[-1][1] * 192 // k1.SPLIT_ROWS)
    assert _chunk_grid(grid, last) == 132
    assert sorted(len(w) for w in _cluster_walk(last, 132))[-1] == 2


@pytest.mark.parametrize("hidden", WIDE)
def test_every_stage_halves_for_multicast(hidden):
    """Each producer of a cluster brings half of every weight stage
    (``produce_layer``): a stage of the forward and transposed packs at
    the split tile's 32-deep k is a multiple of 256 bytes, so each half is
    a contiguous run of the pack starting on a 16-byte boundary, as
    ``cp.async.bulk`` needs."""
    mlp = _mlp(hidden, 4, 2, 10, 4)
    for pack in (k1.pack_weights_wg(mlp, CPU), k1.pack_weights_bwd_wg(mlp, CPU)):
        for k_pad, _, n_pad, w_off, _ in pack.desc:
            assert (w_off * 2) % 16 == 0
            c0 = 0
            for pw in k1.pass_widths(int(n_pad), k1.wg_pass_cols(k1.kernel_width(hidden))):
                for k0 in range(0, int(k_pad), k1.WG_KS_NARROW):
                    kw = min(k1.WG_KS_NARROW, int(k_pad) - k0)
                    stage = pw * kw * 2
                    assert stage % 256 == 0
                    assert ((int(k_pad) * c0 + k0 * pw) * 2) % 16 == 0
                c0 += pw


def _q_part_address(n_pad, k_pad, kq, n0, width):
    """Byte offsets of columns [n0, n0 + width) of a layer in K4's int8
    pack from a warpgroup's descriptor (``q_product``): kq-deep stages,
    k32 steps 2 * n_pad * 16 bytes apart, LBO n_pad * 16, SBO 128, 16 k
    per core-matrix row."""
    j = np.arange(width)[:, None]
    k = np.arange(k_pad)[None, :]
    s, q, kk = k // kq, k % kq // 32, k % 32
    return (s * kq * n_pad + n0 * 16 + q * 2 * n_pad * 16 + (j // 8) * 128
            + (kk // 16) * n_pad * 16 + (j % 8) * 16 + kk % 16)


@pytest.mark.parametrize("hidden", WIDE)
def test_k4_wide_tables(hidden):
    """K4 at 320, 640 and 960 (padded) and 512 and 1024: the int8 MLP on
    ``pad_qparams``' tables equals the unpadded one bit for bit; the pack
    has K4's widths; each warpgroup part's int8 columns lie where the
    64-deep stages' descriptor addresses them in its column pass and its
    f32 rows (scale, bias, requant) at f_off + c0 + n0."""
    mlp = _mlp(hidden, num_layers=8, skip=4, l_xyz=10, l_dir=4)
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.normal(size=(64, mlp.xyz_dim)), dtype=torch.float32)
    d = torch.tensor(rng.normal(size=(64, mlp.dir_dim)), dtype=torch.float32)
    tree = quant.mlp_tree(mlp)
    qp = quant.quantize_mlp(tree, quant.mlp_calibration_absmax(tree, x, d, 4), 4)
    hq = k1.kernel_width(hidden, k4.K4_HIDDEN)
    assert hq == (512 if hidden <= 512 else 1024)
    padded = k4.pad_qparams(qp, 4, hq)
    assert torch.equal(quant.apply_nerf_mlp_quant(padded, x, d, skip_layer=4),
                       quant.apply_nerf_mlp_quant(qp, x, d, skip_layer=4))
    pack = k4.pack_qparams(padded, CPU)
    assert [int(n) for n in pack.desc[:8, 2]] == [hq] * 8
    assert (pack.desc[8, 1], pack.desc[8, 2], pack.desc[9, 2], pack.desc[10, 2]) == (
        hq + 1, hq + 8, hq // 2, 8)
    w = pack.w.numpy()
    f = pack.f.numpy()
    for (wq, scale, b, inv), (k_pad, n, n_pad, w_off, f_off) in zip(k4._layers(padded),
                                                                     pack.desc):
        want = np.zeros((n_pad, k_pad), np.int8)
        want[:n, :wq.shape[0]] = wq.T.numpy()
        # The pack's layout does not depend on the stage depth.
        for c0, pw, _, _ in _pass_parts(n_pad):
            np.testing.assert_array_equal(k4.q_layout(n_pad, k_pad)[c0:c0 + pw],
                                          k_pad * c0 + _q_part_address(pw, k_pad, 64, 0, pw))
        for c0, pw, n0, width in _pass_parts(n_pad):
            addr = k_pad * c0 + _q_part_address(pw, k_pad, 64, n0, width)
            np.testing.assert_array_equal(w[w_off + addr], want[c0 + n0:c0 + n0 + width])
        parts = {(c0 + p0, pw_) for c0, pw, _, _ in _pass_parts(n_pad)
                 for p0, pw_ in zip((0, _split(pw)[0]), _split(pw))}
        for n0, width in sorted(parts):
            cols = np.arange(n0, n0 + max(0, min(width, n - n0)))
            np.testing.assert_array_equal(f[f_off + cols], scale.reshape(-1)[cols].numpy())
            np.testing.assert_array_equal(f[f_off + n_pad + cols], b.reshape(-1)[cols].numpy())
            if inv is not None:
                have = cols[cols < inv.numel()]
                np.testing.assert_array_equal(f[f_off + 2 * n_pad + have],
                                              inv.reshape(-1)[have].numpy())


@pytest.mark.parametrize("hidden", [320, 448, 640, 960])
@pytest.mark.parametrize("offset", ["sigma", "skip", "branch", "rgb"])
def test_layer_maps_at_512(offset, hidden):
    """The four offsets the padding to 512 (and to 1024, its name
    notwithstanding) moves, against the padded matrices: sigma at head
    column hp, the skip layer's x_enc rows at hp, the branch's d_enc rows
    at hp, the rgb input hp / 2 wide."""
    mlp = _mlp(hidden, num_layers=5, skip=2)
    hp = k1.kernel_width(hidden)
    assert hp == (512 if hidden <= 512 else 1024)
    layers = k1._dense_layers(mlp, hp)
    maps = k1.layer_maps(mlp, hp)
    nl, xd, dd = mlp.num_layers, mlp.xyz_dim, mlp.dir_dim
    if offset == "sigma":
        w, b = layers[nl]
        assert maps[nl][1].tolist() == list(range(hidden)) + [hp] and maps[nl][3] == hp + 1
        assert torch.equal(w[hp, maps[nl][0]], mlp.sigma.weight[0])
        assert float(b.detach()[hp]) == float(mlp.sigma.bias.detach()[0])
        assert not w[hidden:hp].any() and not b[hidden:hp].any()
    elif offset == "skip":
        i = next(i for i in range(1, nl) if is_skip(i - 1, mlp.skip_layer))
        in_idx, _, k, n = maps[i]
        assert (k, n) == (hp + xd, hp) and in_idx[hidden:].tolist() == list(range(hp, hp + xd))
        w, _ = layers[i]
        assert torch.equal(w[:hidden, hp:], mlp.trunk[i].weight[:, hidden:])
        assert not w[:, hidden:hp].any() and not w[hidden:].any()
    elif offset == "branch":
        in_idx, out_idx, k, n = maps[nl + 1]
        assert (k, n) == (hp + dd, hp // 2)
        assert in_idx[hidden:].tolist() == list(range(hp, hp + dd))
        w, _ = layers[nl + 1]
        assert torch.equal(w[:hidden // 2, hp:], mlp.branch.weight[:, hidden:])
        assert not w[:, hidden:hp].any() and not w[hidden // 2:].any()
    else:
        _, _, k, n = maps[nl + 2]
        w, b = layers[nl + 2]
        assert (k, n) == (hp // 2, 3) and w.shape == (3, hp // 2)
        assert torch.equal(w[:, :hidden // 2], mlp.rgb.weight) and not w[:, hidden // 2:].any()
        assert torch.equal(b, mlp.rgb.bias)


def _store_ws_offset(r, c, width):
    """csrc/nerf_wgmlp.cuh: store_ws, element (r, c) of a layer's workspace."""
    return (r // 64) * 64 * width + (c // 8) * 512 + (r % 64) * 8 + c % 8


DW_WIDTHS = (16, 32, 64, 80, 128, 144, 256, 264, 272)  # nerf_dw.cuh: dw_width_ok


def _wide_layout(hidden):
    mlp = _mlp(hidden, num_layers=8, skip=4, l_xyz=10, l_dir=4)
    return k1.workspace_layout(k1.pack_weights_wg(mlp, CPU), k1.pack_weights_bwd_wg(mlp, CPU))


@pytest.mark.parametrize("hidden", [256, 512, 1024])
def test_dw_column_tiles(hidden):
    """The dW product's tiles at 8x256, 8x512 and 8x1024: at 256
    (nerf_dw.cuh: dw_plan) one tile of each layer's d_width, an
    instantiated width, its output rows at m * d_width; above 256
    (mlp_dw_window_kernel) the columns of ``dw_units`` (runs of 256 from
    column 0: two a trunk layer at 512, four at 1024): each unit's parts
    (of 128 columns) from a strip boundary, one contiguous run of a
    64-row workspace stage, their written columns covering [0, d_width)
    once, no part reading past the slack that ``DwBuffers`` adds after the
    last layer."""
    layout = _wide_layout(hidden)
    split_layers = 0
    r = np.arange(64)[:, None]
    units = k1.dw_units(layout, 1) if hidden > 256 else None
    for i, (_, a_w, d_col, d_w, _) in enumerate(layout.tolist()):
        if hidden == 256:
            assert d_w <= k1.DW_MAX_N and d_w in DW_WIDTHS
            continue
        mine = [u for u in units.tolist() if u[0] == i and u[1] == 0]
        split_layers += len(mine) > 1
        assert len(mine) == -(-d_w // k1.DW_UNIT_N)
        written = np.zeros(d_w, dtype=int)
        for _, _, n0, c_hi, _ in mine:
            assert n0 % 8 == 0 and 0 < c_hi <= k1.DW_UNIT_N and c_hi % 8 == 0
            written[n0:n0 + c_hi] += 1
            width = -(-c_hi // k1.DW_PART_N) * k1.DW_PART_N  # the columns its parts compute
            # The unit's columns of a stage: strips n0/8.. of it, one run of
            # width * 64 elements from (n0 / 8) * 512.
            c = n0 + np.arange(width)[None, :]
            local = _store_ws_offset(r, c - n0, width)
            inside = c < d_w
            np.testing.assert_array_equal(
                np.where(inside, _store_ws_offset(r, c, d_w), -1),
                np.where(inside, (n0 // 8) * 512 + local, -1))
            end = (n0 // 8) * 512 + width * 64  # elements past the stage's start
            if i == len(layout) - 1:
                assert end - 64 * d_w <= k1.DW_UNIT_N * 64
        np.testing.assert_array_equal(written, 1)
    # The trunk and the merged head (512 and 528 wide) take two units at
    # 8x512; at 8x1024 four, and the branch (512 wide) two.
    assert split_layers == {256: 0, 512: 9, 1024: 10}[hidden]


@pytest.mark.parametrize("hidden", [320, 512, 640, 1024])
def test_dw_tiles_cover_each_layer_once(hidden):
    """``dw_units`` at 8x512 and 8x1024 (and 320 and 640, padded to them):
    every (sample range, layer, 128-row tile, column) once, range by range
    and layer by layer, each unit at most DW_UNIT_N columns.  The sample
    ranges are the window tiles' (``dw_tile_count``: 75 at 512, which split
    the ``wide`` phase's chunk into 4 ranges on 132 SMs, and 286 at 1024,
    one range of the ``wide1024`` phase's chunk of 264 stages), so each
    element's sums are theirs."""
    layout = _wide_layout(hidden)
    tiles = k1.dw_tile_count(layout)
    nst = 528 if hidden <= 512 else 264
    nsplit = k1.dw_splits(tiles, 132, nst * 64)
    assert (tiles, nsplit) == ((75, 4) if hidden <= 512 else (286, 1))
    units = k1.dw_units(layout, nsplit)
    assert list(map(tuple, units[:, [4, 0]].tolist())) == sorted(map(tuple, units[:, [4, 0]].tolist()))
    assert int(units[:, 3].max()) <= k1.DW_UNIT_N
    for y in range(nsplit):
        out = np.zeros(int((layout[:, 1] * layout[:, 3]).sum()), dtype=int)
        for li, m0, n0, c_hi, _ in units[units[:, 4] == y].tolist():
            _, a_w, _, d_w, off = layout[li].tolist()
            m = np.arange(m0, min(m0 + 128, a_w))[:, None]
            np.add.at(out, (off + m * d_w + np.arange(n0, n0 + c_hi)[None, :]).ravel(), 1)
        np.testing.assert_array_equal(out, 1)


def _dw_walk(lists, nsplit: int, nst: int):
    """csrc/nerf_dw.cuh's walk of one chunk of ``nst`` stages
    (mlp_dw_window_kernel): block b takes its units in order, each over the
    stages [s0, s1) of its range."""
    per = -(-nst // nsplit)
    return [[(u, min(nst, u[4] * per), min(nst, min(nst, u[4] * per) + per)) for u in mine]
            for mine in lists]


@pytest.mark.parametrize("sms", [132, 120, 26, 2])
@pytest.mark.parametrize("nst", [528, 144, 37, 1])
def test_dw_grid_covers_every_product_once(nst, sms):
    """The split tile's dW walk at 8x512 (``dw_schedule``, ``_dw_walk``): at
    the ``wide`` phase's first chunk (528 stages of 64 samples) and its
    ragged last (144), and at other chunk sizes and SM counts, every (layer,
    row, column) of each range's slab comes from one unit, whose stages
    cover its range once and in order, the ranges covering [0, nst)."""
    layout = _wide_layout(512)
    nsplit = k1.dw_splits(k1.dw_tile_count(layout), sms, 528 * 64)
    walk = _dw_walk(k1.dw_schedule(k1.dw_units(layout, nsplit), sms), nsplit, nst)
    assert len(walk) <= sms
    total = int((layout[:, 1] * layout[:, 3]).sum())
    out = np.zeros((nsplit, total), dtype=int)
    stages = np.zeros((nsplit, nst), dtype=int)
    for mine in walk:
        for (li, m0, n0, c_hi, y), s0, s1 in mine:
            _, a_w, _, d_w, off = layout[li].tolist()
            m = np.arange(m0, min(m0 + 128, a_w))[:, None]
            np.add.at(out[y], (off + m * d_w + np.arange(n0, n0 + c_hi)[None, :]).ravel(), 1)
            if (li, m0, n0) == (0, 0, 0):
                stages[y, s0:s1] += 1
    np.testing.assert_array_equal(out, 1)
    np.testing.assert_array_equal(stages.sum(axis=0), 1)


@pytest.mark.parametrize("sms", [132, 131, 120, 26, 7])
@pytest.mark.parametrize("hidden", [320, 512, 640, 1024])
def test_dw_schedule_spreads_parts_evenly(hidden, sms):
    """``dw_schedule`` at the 8x320, 8x512 and 8x1024 layouts (640 padded to
    1024) and at odd SM counts: every (range, layer, row, column) of the dW
    in exactly one block's units, at most ``sms`` blocks, each block's parts
    of 128 columns within one of every other's (at 8x1024 on 132 SMs: 4 or
    5 parts where the window tiles took three waves of 264 columns), the
    widest units first, and no unit cut inside a part."""
    layout = _wide_layout(hidden)
    nsplit = k1.dw_splits(k1.dw_tile_count(layout), sms, (528 if hidden <= 512 else 264) * 64)
    units = k1.dw_units(layout, nsplit)
    lists = k1.dw_schedule(units, sms)
    cost = lambda u: -(-u[3] // k1.DW_PART_N)  # noqa: E731
    loads = [sum(map(cost, mine)) for mine in lists]
    assert len(lists) == min(sms, sum(map(cost, units.tolist())))
    assert max(loads) - min(loads) <= 1 and all(loads)
    total = int((layout[:, 1] * layout[:, 3]).sum())
    out = np.zeros((nsplit, total), dtype=int)
    for mine in lists:
        for li, m0, n0, c_hi, y in mine:
            _, a_w, _, d_w, off = layout[li].tolist()
            assert n0 % 8 == 0 and c_hi % 8 == 0 and 0 < c_hi <= k1.DW_UNIT_N
            assert n0 + c_hi == d_w or c_hi % k1.DW_PART_N == 0  # cut between parts only
            m = np.arange(m0, min(m0 + 128, a_w))[:, None]
            np.add.at(out[y], (off + m * d_w + np.arange(n0, n0 + c_hi)[None, :]).ravel(), 1)
    np.testing.assert_array_equal(out, 1)
    if (hidden, sms) == (1024, 132):
        assert sorted(set(loads)) == [4, 5] and loads.count(5) == 576 - 4 * 132
        assert all(cost(mine[0]) == 2 for mine in lists)  # the first round: whole units


def test_dw_schedule_array_is_what_the_kernel_reads():
    """``dw_schedule_array`` as csrc/nerf_dw.cuh's mlp_dw_window_kernel reads
    it: block b's units at [sched[b], sched[b + 1]) of the four-int words
    after the blocks + 1 offsets (padded to a multiple of 4), each word
    ``layer | m0 << 8, n0, c_hi, y``."""
    lists = k1.dw_schedule(k1.dw_units(_wide_layout(1024), 1), 7)
    arr = k1.dw_schedule_array(lists)
    assert arr.dtype == np.int32
    base = -(-(len(lists) + 1) // 4) * 4
    words = arr[base:].reshape(-1, 4)
    for b, mine in enumerate(lists):
        got = words[arr[b]:arr[b + 1]].tolist()
        assert got == [[li | m0 << 8, n0, c_hi, y] for li, m0, n0, c_hi, y in mine]
    assert arr[len(lists)] == len(words) == sum(map(len, lists))


def _rays_per_group(s: int, rows: int) -> int:
    """csrc/nerf_wgmlp.cuh: wg_rays_per_block, whole rays filling whole
    tiles of ``rows`` rows, at most 640 samples."""
    if s >= 640:
        return 1
    r, cap = rows // math.gcd(s, rows), 640 // s
    return r if r < cap else max(cap, 1)


def _k4_walk(b: int, s: int, hidden: int, sms: int,
             max_clusters: int = 66) -> list[list[range]]:
    """For each of K4's blocks, the rays of its groups in order
    (csrc/quant_render_fwd.cu: nkt_quant_render_fwd launches a block per
    group of rays, above 256 clusters of two, no more blocks than ``sms``
    nor than ``max_clusters`` clusters (nerf_wgmlp.cuh: split_grid), and
    quant_render_wide_kernel strides over the groups by the grid; a step
    past the last group is a phantom group, no rays)."""
    r = _rays_per_group(s, 64 if hidden > 256 else 128)
    groups = -(-b // r)
    if hidden <= 256:
        return [[range(g * r, min(b, g * r + r))] for g in range(groups)]
    grid = min(-(-min(sms, groups) // 2) * 2, 2 * max_clusters)
    first = lambda blk: blk & ~1  # noqa: E731
    steps = lambda blk: -(-(groups - first(blk)) // grid) if groups > first(blk) else 0  # noqa: E731
    return [[range(min(b, g * r), min(b, g * r + r))
             for g in range(blk, blk + steps(blk) * grid, grid)] for blk in range(grid)]


def _k4_tiles(rays: range, s: int) -> int:
    """A group's 64-row tiles (quant_render_wide_kernel: group_tiles)."""
    return -(-len(rays) * s // 64)


@pytest.mark.parametrize("hidden", [256, 512, 1024])
@pytest.mark.parametrize("b,s", [(1, 192), (7, 64), (131, 192), (132, 192), (133, 192),
                                 (300, 100), (16384, 192), (16385, 64)])
def test_k4_walk_covers_every_ray_once(hidden, b, s):
    """K4's blocks (``_k4_walk``): at hidden 512 and 1024 clusters of two,
    at most the card's 132 SMs, each striding over groups of whole rays,
    below, at and above the SM count; at 256 one group a block, as before.
    Every ray once, each group whole rays in order."""
    walk = _k4_walk(b, s, hidden, 132)
    groups = -(-b // _rays_per_group(s, 64 if hidden > 256 else 128))
    if hidden == 256:
        assert len(walk) == groups and all(len(mine) == 1 for mine in walk)
    else:
        assert len(walk) == -(-min(groups, 132) // 2) * 2
    rays = [r for mine in walk for g in mine for r in g]
    assert sorted(rays) == list(range(b))


@pytest.mark.parametrize("hidden", [512, 1024])
@pytest.mark.parametrize("b,s,max_clusters", [
    (1, 192, 66),      # one group: the second block only drains
    (1, 64, 66),
    (3, 192, 66),      # fewer groups than the grid, odd
    (257, 100, 66),    # 43 groups of six rays, the last of five
    (1000, 24, 66),    # 125 groups of eight rays
    (16384, 192, 66),  # the server's chunk
    (16384, 192, 63),  # fewer clusters on the card than SMs / 2
    (16385, 64, 1),    # one cluster
])
def test_k4_cluster_walk_drains_what_its_peer_computes(hidden, b, s, max_clusters):
    """The two blocks of a K4 cluster consume the same weight stages: each
    walks its cluster's first block's steps, and each step as many tiles as
    the first block's group (the kernel's ``group_tiles``), draining the
    tiles its own group lacks (a phantom group past the last, or the last,
    shorter group).  Every ray once, phantom groups included; the first
    block's group is never shorter than its peer's."""
    walk = _k4_walk(b, s, hidden, 132, max_clusters)
    assert len(walk) % 2 == 0 and len(walk) <= min(132, 2 * max_clusters)
    rays = [r for mine in walk for g in mine for r in g]
    assert sorted(rays) == list(range(b))
    for c in range(0, len(walk), 2):
        first, second = walk[c], walk[c + 1]
        assert len(first) == len(second)  # the same steps, phantom groups included
        for g1, g2 in zip(first, second):
            stage_tiles = _k4_tiles(g1, s)  # what both producers stream this step
            assert stage_tiles >= _k4_tiles(g2, s) and (len(g1) > 0 or len(g2) == 0)


JAX_WIDE = [(h, 4, 2) for h in (320, 512, 1024)]


@pytest.mark.parametrize("hidden,l_xyz,l_dir", JAX_WIDE)
def test_render_rays_fused_matches_jax_wide(hidden, l_xyz, l_dir):
    """K1/K2's module at 320, 512 and 1024: rgb, weights and the residual
    backward's gradients."""
    params = _jax_params(hidden, l_xyz, l_dir)
    o, d, t, target = _rays(hidden + l_xyz)

    def jloss(p):
        rgb, w = jax_render(p, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t), l_xyz=l_xyz,
                            l_dir=l_dir, compute_dtype=jnp.float32, skip_layer=2,
                            max_tile_fwd=8 * 16, max_tile_bwd=8 * 16, bwd_mode="residual")
        return jnp.mean((rgb - jnp.asarray(target)) ** 2), (rgb, w)

    (_, (rgb_j, w_j)), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    mlp = NeRFMLP.from_jax_params(params, skip_layer=2, compute_dtype=torch.float32)
    assert mlp.hidden_dim == hidden
    rgb, w = k1.render_rays_fused(mlp, *(torch.as_tensor(v) for v in (o, d, t)), l_xyz=l_xyz,
                                  l_dir=l_dir, skip_layer=2)
    errs = (float(np.abs(rgb.detach().numpy() - np.asarray(rgb_j)).max()),
            float(np.abs(w.numpy() - np.asarray(w_j)).max()))
    ((rgb - torch.as_tensor(target)) ** 2).mean().backward()
    gerr = _leaf_err(mlp.to_jax_params(grad=True), jg)
    assert max(errs) <= JAX_VAL_TOL and gerr <= JAX_GRAD_TOL, (errs, gerr)


@pytest.mark.parametrize("hidden,l_xyz,l_dir", JAX_WIDE)
def test_apply_nerf_render_matches_jax_wide(hidden, l_xyz, l_dir):
    """K6's module at 320, 512 and 1024: rgb, weights and the rgb loss's
    gradients."""
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


@pytest.mark.parametrize("need_input_grads", [False, True])
@pytest.mark.parametrize("hidden,l_xyz,l_dir", JAX_WIDE)
def test_apply_nerf_mlp_matches_jax_wide(hidden, l_xyz, l_dir, need_input_grads):
    """K5's module at 320, 512 and 1024, without input gradients (the card's path
    there) and with them (the plain version on the CPU; the card raises
    above 256): predictions, parameter and encoding gradients (N = 70, a
    ragged last tile on the JAX side)."""
    params = _jax_params(hidden, l_xyz, l_dir, seed=2)
    rng = np.random.default_rng(hidden + 1)
    n = 70
    x = rng.normal(size=(n, 3 + 6 * l_xyz)).astype(np.float32)
    d = rng.normal(size=(n, 3 + 6 * l_dir)).astype(np.float32)
    g = rng.normal(size=(n, 4)).astype(np.float32)

    def jloss(p, xx, dd):
        out = apply_nerf_mlp_pallas(p, xx, dd, compute_dtype=jnp.float32, skip_layer=2,
                                    tile=64, bwd_tile=64, need_input_grads=need_input_grads)
        return jnp.sum(out * jnp.asarray(g)), out

    argnums = (0, 1, 2) if need_input_grads else (0,)
    (_, out_j), jgrads = jax.value_and_grad(jloss, argnums=argnums, has_aux=True)(
        params, jnp.asarray(x), jnp.asarray(d))
    mlp = NeRFMLP.from_jax_params(params, skip_layer=2, compute_dtype=torch.float32)
    xt = torch.as_tensor(x).requires_grad_(need_input_grads)
    dt = torch.as_tensor(d).requires_grad_(need_input_grads)
    out = k5.apply_nerf_mlp_fused(mlp, xt, dt, need_input_grads=need_input_grads)
    assert float(np.abs(out.detach().numpy() - np.asarray(out_j)).max()) <= JAX_VAL_TOL
    (out * torch.as_tensor(g)).sum().backward()
    assert _leaf_err(mlp.to_jax_params(grad=True), jgrads[0]) <= JAX_GRAD_TOL
    if need_input_grads:
        assert _leaf_err([xt.grad.numpy(), dt.grad.numpy()], jgrads[1:]) <= JAX_GRAD_TOL


@pytest.mark.parametrize("hidden", [320, 512, 1024])
def test_k4_plain_matches_jax_kernel_wide(hidden):
    """K4's module at 320, 512 and 1024 (its plain version on the CPU) against the
    JAX kernel in interpret mode on the JAX qparams and the same rays."""
    l_xyz, l_dir = 4, 2
    params = _jax_params(hidden, l_xyz, l_dir, seed=3)
    rng = np.random.default_rng(hidden)
    b, s = 8, 16
    origins = jnp.asarray(rng.uniform(-0.1, 0.1, (b, 3)) + [0, 0, 4], jnp.float32)
    dirs = jnp.asarray(rng.normal(size=(b, 3)) * 0.2 + [0, 0, -1], jnp.float32)
    t_vals = jnp.asarray(np.sort(rng.uniform(2.0, 6.0, (b, s)), axis=-1).astype(np.float32))
    pts, ds = sample_rays(origins, dirs, t_vals)
    x_enc, d_enc = encode_position(pts, l_xyz), encode_position(ds, l_dir)
    qp = jq.quantize_mlp(params, jq.mlp_calibration_absmax(params, x_enc, d_enc, 2), 2)
    rgb_j, w_j = jax_k4(qp, origins, dirs, t_vals, l_xyz=l_xyz, l_dir=l_dir, skip_layer=2)
    before = k4.launches
    qpt = quant.qparams_from_jax(jax.tree_util.tree_map(np.asarray, jax.device_get(qp)))
    rgb_p, w_p = k4.render_rays_fused_quant(
        qpt, *(torch.tensor(np.asarray(v)) for v in (origins, dirs, t_vals)),
        l_xyz=l_xyz, l_dir=l_dir, skip_layer=2)
    assert k4.launches == before  # the CPU takes the plain version
    np.testing.assert_allclose(rgb_p.numpy(), np.asarray(rgb_j), atol=JAX_VAL_TOL, rtol=0)
    np.testing.assert_allclose(w_p.numpy(), np.asarray(w_j), atol=JAX_VAL_TOL, rtol=0)


def test_parity_step_and_frame_match_jax_at_512(monkeypatch):
    """The slice at hidden 512: one parity step of the port's ``Trainer``
    (metrics and every gradient leaf before Adam) against the JAX step with
    its draws replayed, then one frame's rays through both render
    functions on the stepped weights."""
    cfg = _cfg(hidden_dim=512)
    st = _jax_state(cfg, 3)
    key = jax.random.PRNGKey(13)
    batch = _batch(7, cfg.batch_size)
    jbatch = tuple(jnp.asarray(x) for x in batch)
    new_st, jm = jstep.make_train_step(cfg, NEAR, FAR)(st, jbatch, key)
    with monkeypatch.context() as m:
        m.setattr(jstep, "make_optimizer", lambda c: _grab_grads())
        grads = jstep.make_train_step(cfg, NEAR, FAR)(
            st._replace(opt_state=_grab_grads().init(st.params)), jbatch, key)[0].opt_state
    tr = _port(cfg, st)
    pm = tr.train_step(batch, draws=_draws(cfg, key, 3, cfg.batch_size))
    merr = max(abs(float(pm[k]) / float(jm[k]) - 1.0) for k in ("loss_coarse", "loss", "psnr"))
    assert merr <= 5e-4, merr
    jg, pg = _leaves(grads), _leaves(tr.params_tree(grad=True))
    assert len(jg) == len(pg) and tr.params["fine"].hidden_dim == 512
    gerr = [float(np.abs(c - a).max() / max(np.abs(a).max(), 1e-12)) for a, c in zip(jg, pg)]
    assert max(gerr) <= GRAD_TOL, gerr

    _, o, d = _batch(8, 36)  # a 6 x 6 frame's rays
    ref = jstep.make_render_fn(cfg, NEAR, FAR)(new_st, jnp.asarray(o), jnp.asarray(d))
    tr.replace_params(jax.tree_util.tree_map(np.asarray, new_st.params))
    with torch.no_grad():
        out = pstep.make_render_fn(cfg, NEAR, FAR)(tr.params, torch.as_tensor(o),
                                                   torch.as_tensor(d))
    for k in ("rgb_fine", "depth_fine", "rgb_coarse"):
        want = np.asarray(ref[k])
        atol = 1e-3 if k.startswith("depth") else 1e-4
        np.testing.assert_allclose(out[k].numpy(), want, rtol=0, atol=atol, err_msg=k)


def _adversarial_reaches_the_bound(hidden):
    qp, o, d, t = k4_adversarial.adversarial_case(CPU, hidden=hidden)
    seen = k4_adversarial.max_accumulators(qp, o, d, t)
    skip_k, branch_k = hidden + 63, hidden + 27
    assert seen[skip_k] == skip_k * 127 ** 2 and seen[branch_k] == branch_k * 127 ** 2
    assert seen[hidden] > 1 << 22
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


def test_k4_adversarial_case_at_512_reaches_the_bound():
    """``k4_adversarial.adversarial_case(hidden=512)``, which the card test
    holds K4 to: every layer whose padded k exceeds 256 (each trunk layer
    after the first, the head, the branch) accumulates beyond 2^22, where
    K4 converts; the layer after the skip and the branch exactly k *
    127^2; a K4 that took the magic number everywhere would miss K4's
    gates (max 1e-3, mean 1e-5) by 10x or more."""
    _adversarial_reaches_the_bound(512)


def test_k4_adversarial_case_at_1024_reaches_the_bound():
    """The same at hidden 1024 (``adversarial_case(hidden=1024)``, the card
    test's 1024 case): the layer after the skip at k = 1,087 and the branch
    at 1,051 exactly k * 127^2."""
    _adversarial_reaches_the_bound(1024)


def test_from_jax_params_round_trip_at_1024():
    """An 8 x 1024 JAX parameter tree through ``NeRFMLP.from_jax_params``
    and back, bit for bit, and the port's kernel packs of it at the
    kernels' widths (no padding: 1024 is an instantiation)."""
    params = jax.tree_util.tree_map(np.asarray, init_nerf_params(
        jax.random.PRNGKey(4), num_layers=8, hidden_dim=1024, skip_layer=4, l_xyz=10, l_dir=4))
    mlp = NeRFMLP.from_jax_params(params, skip_layer=4, compute_dtype=torch.float32)
    assert mlp.hidden_dim == 1024 and k1.kernel_width(mlp.hidden_dim) == 1024
    back = mlp.to_jax_params()
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    pack = k1.pack_weights_wg(mlp, CPU)
    assert [int(n) for n in pack.desc[:, 2]] == [1024] * 8 + [1032, 512, 8]
