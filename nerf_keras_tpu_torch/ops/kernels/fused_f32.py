"""The float32 kernels: K1, K2, K3, K5 and K6 for ``COMPUTE_DTYPE=float32``.

Counterparts of the JAX package's Pallas kernels in their float32
instantiation, where every product runs at ``Precision.HIGHEST``
(``nerf_keras_tpu/ops/pallas/fused_mlp.py``: "COMPUTE_DTYPE=float32 must
mean true f32").  Hopper has no f32 tensor-core product and TF32 stays off
(the port's precision rule), so ``csrc/fused_render_f32.cu`` multiplies
on the CUDA cores in f32 FMAs: one forward for K1 (over rays, with the
optional f32 x_enc residual), K6 (encodings in) and K5's forward (no
compositing), and one backward for K2, K3, K6 and K5 (with the input
gradients), whose weight gradients are an f32 product over the chunks of
:func:`fused_render.chunk_plan`.  Nothing is rounded to bf16: not the
encodings, not the activations, not the residual (252 B a sample at
L_XYZ 10), not the weight gradients.  The source note says what bounds
the kernels and how the design answers.

The wrappers here are called by ``fused_render``'s and ``fused_mlp``'s
(their ``launch_*`` functions route a float32 MLP here; see
:func:`fused_render.kernel_route`), which check the inputs; the plain
versions are theirs (``render_rays_reference``, ``apply_nerf_render_
reference``, ``NeRFMLP.forward`` and their VJPs), dtype-generic.  Each
launch adds one to its own counter, beside the bf16 kernels':
:data:`launches` (K1, both modes; in training mode also
:data:`train_launches`), :data:`bwd_launches` (K2),
:data:`recompute_launches` (K3), :data:`enc_launches` and
:data:`enc_bwd_launches` (K6), :data:`mlp_launches` and
:data:`mlp_bwd_launches` (K5).

The pack is built at the model's own widths (any hidden width up to 256):
per layer the forward matrix ``(k, round64(n))`` and the transposed one
``(n, round64(k))``, row-major f32, then every bias.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from nerf_keras_tpu_torch.models.mlp import NeRFMLP
from nerf_keras_tpu_torch.ops.kernels import _build
from nerf_keras_tpu_torch.ops.kernels import fused_render as fr

# Kernel launches in this process (one per successful launch).
launches = 0            # K1, both modes
train_launches = 0      # K1 in training mode, also in `launches`
bwd_launches = 0        # K2
recompute_launches = 0  # K3
enc_launches = 0        # K6 forward
enc_bwd_launches = 0    # K6 backward
mlp_launches = 0        # K5 forward
mlp_bwd_launches = 0    # K5 backward

ROWS = 64  # samples per tile of the rows kernel (csrc/fused_render_f32.cu: kRows)
# The dW product's output tile, (k, n) (csrc/fused_render_f32.cu: kDwBM,
# kDwBN), the blocks an SM holds at once (f32_dw_kernel's launch bounds) and
# a block's fixed cost in 64-sample tiles (its ring's fill, its slab write).
DW_TILE = (128, 128)
DW_BLOCKS_PER_SM = 1
DW_BLOCK_COST = 2
# The rows kernel's modes (csrc/fused_render_f32.cu, as fused_render_bwd.cu's).
_K2, _K3, _K6, _K5 = 0, 1, 2, 3


class F32Pack(NamedTuple):
    """An MLP's f32 matrices and biases as the f32 kernels read them."""

    data: torch.Tensor  # f32: per layer F (k, round64(n)), T (n, round64(k)); then the biases
    desc: np.ndarray    # int32 (n_dense, 5): k, n, f_off, t_off, b_off
    b0: int             # the first bias (db's origin)
    total_b: int        # the biases' floats (each padded to 4)


def _ld64(x: int) -> int:
    return -(-x // 64) * 64


@torch.no_grad()
def pack_f32(mlp: NeRFMLP, device: torch.device) -> F32Pack:
    """Every kernel layer (trunk, merged feature+sigma head, branch, rgb)
    as the forward matrix ``W (k, n)`` and its transpose, zero-padded to 64
    columns, then the biases, each padded to 4 floats."""
    layers = fr._dense_layers(mlp)
    parts, desc, off = [], [], 0
    for wt, _ in layers:
        n, k = wt.shape
        f = torch.zeros((k, _ld64(n)), dtype=torch.float32, device=device)
        f[:, :n] = wt.T.to(device=device, dtype=torch.float32)
        t = torch.zeros((n, _ld64(k)), dtype=torch.float32, device=device)
        t[:, :k] = wt.to(device=device, dtype=torch.float32)
        parts += [f.reshape(-1), t.reshape(-1)]
        desc.append([k, n, off, off + f.numel(), 0])
        off += f.numel() + t.numel()
    b0 = off
    for row, (wt, b) in zip(desc, layers):
        n = wt.shape[0]
        bp = torch.zeros((-(-n // 4) * 4,), dtype=torch.float32, device=device)
        bp[:n] = b.to(device=device, dtype=torch.float32)
        row[4] = off
        parts.append(bp)
        off += bp.numel()
    return F32Pack(torch.cat(parts).contiguous(),
                   np.ascontiguousarray(np.asarray(desc, dtype=np.int32)), b0, off - b0)


def kernel_pack_f32(mlp: NeRFMLP, device: torch.device) -> F32Pack:
    """The f32 pack of ``mlp`` for ``device``, built once per installed set
    of weights (``fused_render._cached``)."""
    return fr._cached(mlp, device, "_f32_pack", pack_f32)


def workspace_layout(pack: F32Pack) -> np.ndarray:
    """The backward's workspace and output layout, int32 (n_dense, 5):
    ``a_col, a_width`` (the layer input, k), ``d_col, d_width`` (its dPre,
    n), ``out_off`` of its (k, n) f32 dW; a layer's workspace starts at
    ``rows * col`` and holds 64-sample tiles, each k-major."""
    k = pack.desc[:, 0].astype(np.int64)
    n = pack.desc[:, 1].astype(np.int64)
    cols = lambda w: np.concatenate([[0], np.cumsum(w)[:-1]])  # noqa: E731
    out = np.stack([cols(k), k, cols(n), n, cols(k * n)], axis=1)
    return np.ascontiguousarray(out.astype(np.int32))


def bytes_per_sample(pack: F32Pack) -> int:
    """The workspace a sample takes: every layer's input and output, f32."""
    return 4 * int(pack.desc[:, 0].sum() + pack.desc[:, 1].sum())


def dw_tiles(layout: np.ndarray) -> int:
    """The dW product's output tiles over every layer: ceil(k / 128) x
    ceil(n / 128) a layer (``layout``: :func:`workspace_layout`)."""
    k, n = layout[:, 1].astype(np.int64), layout[:, 3].astype(np.int64)
    return int(((-(-k // DW_TILE[0])) * (-(-n // DW_TILE[1]))).sum())


@functools.lru_cache(maxsize=None)
def dw_splits(out_tiles: int, ntiles: int, slots: int) -> int:
    """The sample splits of a chunk's dW product: ``out_tiles`` x splits
    blocks, each over ``ceil(ntiles / splits)`` consecutive 64-sample tiles.
    The count whose whole waves of ``slots`` blocks at once end soonest
    (each block costing its tiles and ``DW_BLOCK_COST``), the fewest on a
    tie; none of the splits is empty."""
    best, best_cost = 1, None
    for q in range(1, min(ntiles, max(1, 8 * slots // out_tiles)) + 1):
        per = -(-ntiles // q)
        if -(-ntiles // per) != q:
            continue
        cost = -(-out_tiles * q // slots) * (per + DW_BLOCK_COST)
        if best_cost is None or cost < best_cost:
            best, best_cost = q, cost
    return best


def dw_blocks(layout: np.ndarray, ntiles: int, nsplit: int) -> list[tuple[int, ...]]:
    """The dW product's blocks in ``f32_dw_kernel``'s grid order (x: layer,
    k tile, n tile; y: split): ``(layer, k0, n0, first tile, end tile)``."""
    per = -(-ntiles // nsplit)
    return [(li, k0, n0, min(s * per, ntiles), min(s * per + per, ntiles))
            for s in range(nsplit)
            for li, (k, n) in enumerate(layout[:, [1, 3]].tolist())
            for k0 in range(0, k, DW_TILE[0]) for n0 in range(0, n, DW_TILE[1])]


def _ptr(x: torch.Tensor | None) -> int | None:
    return None if x is None else x.data_ptr()


def _launch_fwd(mlp: NeRFMLP, b: int, s: int, *, t_vals=None, origins=None, dirs=None,
                x_in=None, d_in=None, emit_xenc=False, composite=True):
    """One launch of ``nkt_f32_fwd``: ``(rgb, weights, x_enc or None,
    preds)``; rgb and weights None without ``composite`` (K5)."""
    device = (x_in if x_in is not None else origins).device
    f32 = dict(dtype=torch.float32, device=device)
    rgb = torch.empty((b, 3), **f32) if composite else None
    weights = torch.empty((b, s), **f32) if composite else None
    x_enc = torch.empty((b * s, mlp.xyz_dim), **f32) if emit_xenc else None
    preds = torch.empty((b * s, 4), **f32)
    if b == 0:
        return rgb, weights, x_enc, preds
    pack = kernel_pack_f32(mlp, device)
    rc = _build.load("fused_render_f32").nkt_f32_fwd(
        _ptr(origins), _ptr(dirs), _ptr(t_vals), _ptr(x_in), _ptr(d_in),
        pack.data.data_ptr(), pack.desc.ctypes.data, pack.desc.shape[0], mlp.num_layers,
        mlp.skip_layer, mlp.hidden_dim, mlp.l_xyz, mlp.l_dir, b, s, _ptr(rgb), _ptr(weights),
        _ptr(x_enc), preds.data_ptr(), fr.device_index(device),
        torch.cuda.current_stream(device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"f32 {'K1' if origins is not None else ('K6' if composite else 'K5')} launch "
            f"failed with CUDA error {rc} (B={b}, S={s}, hidden={mlp.hidden_dim}, "
            f"layers={mlp.num_layers}, residual={emit_xenc})"
        )
    return rgb, weights, x_enc, preds


def launch_k1(mlp, origins, dirs, t_vals, train: bool, emit_xenc: bool = True):
    """One f32 K1 launch: ``(rgb, weights, x_enc, preds)`` as
    ``fused_render.launch_k1``, with the residual ``x_enc`` in f32 (the
    encodings are the MLP's own L_XYZ, L_DIR)."""
    global launches, train_launches
    b, s = t_vals.shape
    rgb, weights, x_enc, preds = _launch_fwd(mlp, b, s, t_vals=t_vals, origins=origins,
                                             dirs=dirs, emit_xenc=train and emit_xenc)
    if b:
        launches += 1
        train_launches += int(train)
    return rgb, weights, x_enc, preds if train else None


def launch_k6_fwd(mlp, x_enc, d_enc, t_vals, train: bool):
    """One f32 K6 forward launch: ``(rgb, weights, preds or None)``."""
    global enc_launches
    b, s = t_vals.shape
    rgb, weights, _, preds = _launch_fwd(mlp, b, s, t_vals=t_vals,
                                         x_in=x_enc.reshape(b * s, -1),
                                         d_in=d_enc.reshape(b * s, -1))
    if b:
        enc_launches += 1
    return rgb, weights, preds if train else None


def launch_k5_fwd(mlp, x_enc, d_enc):
    """One f32 K5 forward launch over ``(N, .)`` f32 encodings: raw
    predictions ``(N, 4)``."""
    global mlp_launches
    n = x_enc.shape[0]
    preds = _launch_fwd(mlp, n, 1, x_in=x_enc, d_in=d_enc, composite=False)[3]
    if n:
        mlp_launches += 1
    return preds


def _launch_rows(mode, mlp, b, s, *, t_vals=None, preds=None, g_rgb=None, g_w=None,
                 x_res=None, origins=None, dirs=None, d_enc=None, g=None, dx=None, dd=None):
    """One ``nkt_f32_bwd``: the compositing VJP (not K5's), the rows
    kernel and the dW product over the chunks of ``chunk_plan``, the
    reduce; gradients in ``mlp.parameters()`` order, all f32."""
    k5 = mode == _K5
    device = (x_res if x_res is not None else origins).device
    n = b * s
    if x_res is not None:
        fr.check_tensor("x_enc", x_res, (n, mlp.xyz_dim), device)
    if d_enc is not None:
        fr.check_tensor("d_enc", d_enc, (n, mlp.dir_dim), device)
    if k5:
        fr.check_tensor("g", g, (n, 4), device)
    else:
        fr.check_tensor("t_vals", t_vals, (b, s), device)
        fr.check_tensor("preds", preds, (n, 4), device)
        fr.check_tensor("g_rgb", g_rgb, (b, 3), device)
        if g_w is not None:
            fr.check_tensor("g_w", g_w, (b, s), device)
    pack = kernel_pack_f32(mlp, device)
    layout = workspace_layout(pack)
    plan = fr.chunk_plan(b, s, bytes_per_sample(pack))
    chunk_rays = plan[0][1]
    tiles = -(-chunk_rays * s // ROWS)
    rows = tiles * ROWS
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    grid = min(tiles, sms)
    total_out = int((layout[:, 1].astype(np.int64) * layout[:, 3]).sum())
    nsplit = dw_splits(dw_tiles(layout), tiles, sms * DW_BLOCKS_PER_SM)
    f32 = dict(dtype=torch.float32, device=device)
    a_cols, d_cols = int(layout[:, 1].sum()), int(layout[:, 3].sum())
    ws_a = torch.empty((rows * a_cols,), **f32)
    ws_d = torch.empty((rows * d_cols,), **f32)
    db_part = torch.empty((grid * pack.total_b,), **f32)
    dw_part = torch.empty((nsplit * total_out,), **f32)
    dw = torch.empty((total_out,), **f32)
    db = torch.empty((pack.total_b,), **f32)
    dpreds = g if k5 else torch.empty((n, 4), **f32)
    rc = _build.load("fused_render_f32").nkt_f32_bwd(
        mode, _ptr(x_res), _ptr(origins), _ptr(dirs), _ptr(d_enc), _ptr(t_vals), _ptr(preds),
        _ptr(g_rgb), _ptr(g_w), pack.data.data_ptr(), pack.desc.ctypes.data,
        layout.ctypes.data, pack.desc.shape[0], mlp.num_layers, mlp.skip_layer,
        mlp.hidden_dim, mlp.l_xyz, mlp.l_dir, b, s, chunk_rays, pack.total_b, total_out,
        dpreds.data_ptr(), ws_a.data_ptr(), ws_d.data_ptr(), db_part.data_ptr(), grid,
        dw_part.data_ptr(), nsplit, dw.data_ptr(), db.data_ptr(), _ptr(dx), _ptr(dd),
        fr.device_index(device), torch.cuda.current_stream(device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"f32 {('K2', 'K3', 'K6 backward', 'K5 backward')[mode]} launch failed with CUDA "
            f"error {rc} (B={b}, S={s}, hidden={mlp.hidden_dim}, layers={mlp.num_layers}, "
            f"chunks of {chunk_rays} rays, input grads={dx is not None}/{dd is not None})"
        )
    return unpack_grads(mlp, pack, layout, dw, db)


def unpack_grads(mlp: NeRFMLP, pack: F32Pack, layout: np.ndarray, dw: torch.Tensor,
                 db: torch.Tensor) -> list[torch.Tensor]:
    """The f32 backward's flat dW/db -> gradients in ``mlp.parameters()``
    order, f32 (the JAX package's ``dv.astype(w.dtype)`` of f32 weights)."""
    per_layer = []
    for (k, n, _, _, b_off), (_, _, _, _, off) in zip(pack.desc, layout):
        w = dw[off:off + k * n].view(k, n).T
        per_layer.append((w, db[b_off - pack.b0:b_off - pack.b0 + n]))
    return fr.split_head_grads(mlp, per_layer, torch.clone)


def launch_k2(mlp, x_enc, dirs, t_vals, preds, g_rgb, g_w):
    """One f32 K2 launch (from K1's f32 residual)."""
    global bwd_launches
    b, s = t_vals.shape
    grads = _launch_rows(_K2, mlp, b, s, t_vals=t_vals, preds=preds, g_rgb=g_rgb, g_w=g_w,
                         x_res=x_enc, dirs=dirs)
    bwd_launches += 1
    return grads


def launch_k3(mlp, origins, dirs, t_vals, preds, g_rgb, g_w):
    """One f32 K3 launch (the position encodings computed again)."""
    global recompute_launches
    b, s = t_vals.shape
    grads = _launch_rows(_K3, mlp, b, s, t_vals=t_vals, preds=preds, g_rgb=g_rgb, g_w=g_w,
                         origins=origins, dirs=dirs)
    recompute_launches += 1
    return grads


def launch_k6_bwd(mlp, x_enc, d_enc, t_vals, preds, g_rgb):
    """One f32 K6 backward launch."""
    global enc_bwd_launches
    b, s = t_vals.shape
    grads = _launch_rows(_K6, mlp, b, s, t_vals=t_vals, preds=preds, g_rgb=g_rgb,
                         x_res=x_enc.reshape(b * s, -1), d_enc=d_enc.reshape(b * s, -1))
    enc_bwd_launches += 1
    return grads


def launch_k5_bwd(mlp, x_enc, d_enc, g, need_dx: bool, need_dd: bool):
    """One f32 K5 backward launch: ``(gradients, dx_enc or None, dd_enc or
    None)``, all f32."""
    global mlp_bwd_launches
    n = x_enc.shape[0]
    dx = torch.empty_like(x_enc) if need_dx else None
    dd = torch.empty_like(d_enc) if need_dd else None
    if n == 0:
        return [torch.zeros_like(p) for p in mlp.parameters()], dx, dd
    grads = _launch_rows(_K5, mlp, n, 1, x_res=x_enc, d_enc=d_enc, g=g, dx=dx, dd=dd)
    mlp_bwd_launches += 1
    return grads, dx, dd
