"""K1, K2 and K3, the ray megakernel and its two backwards; K6, the same
over encodings.

Counterpart of ``render_rays_fused`` and ``apply_nerf_render_pallas`` in
``nerf_keras_tpu/ops/pallas/fused_render.py``: the forward
(``_fwd_encode_kernel``, with its ``emit_enc`` training residual), the
backwards ``_bwd_xres_kernel`` (``bwd_mode="residual"``) and
``_bwd_encode_kernel`` (``"recompute"``), and the encodings-in pair
``_fwd_kernel``/``_bwd_kernel``.  The CUDA kernels are
``csrc/fused_render_fwd.cu`` (K1, K6's forward) and
``csrc/fused_render_bwd.cu`` (K2, K3, K6's backward, and K5's:
``fused_mlp.py`` launches it through :func:`launch_rows`), on Hopper's
wgmma (``csrc/nerf_wgmlp.cuh``, weights in :func:`pack_weights_wg`'s
layout); their source notes say what bounds them and how the designs
answer.  The backward runs its rows kernel and dW product over the chunks
of whole rays of :func:`chunk_plan`, so its workspace holds one chunk
(``DW_CHUNK_BYTES``), not the batch.

* :func:`render_rays_reference` is the plain PyTorch K1: encode ->
  :class:`NeRFMLP` -> ``volume_render``, with the bf16 rounding where the
  kernel has it.  Plain autograd differentiates it;
  :func:`render_rays_reference_vjp` is that gradient, the plain version of
  K2 and K3.  :func:`apply_nerf_render_reference` and its VJP are K6's.
* :func:`render_rays_fused` and :func:`apply_nerf_render_fused` take the
  plain version for a tensor on the CPU, and only then.  For a CUDA tensor
  they launch the kernels or raise; nothing falls back.  With grad enabled
  for the MLP each is a ``torch.autograd.Function``.  ``render_rays_fused``
  runs K1 in training mode forward, then K2 (``bwd_mode="residual"``: K1
  also writes the bf16 position encodings, 126 B per sample) or K3
  (``"recompute"``: K1 writes only its f32 predictions, 16 B per sample,
  and K3 encodes the points again).  Counters, one per launch:
  :data:`launches` (K1; in training mode also :data:`train_launches`),
  :data:`bwd_launches` (K2), :data:`recompute_launches` (K3),
  :data:`enc_launches` and :data:`enc_bwd_launches` (K6).

As in the JAX package, the weights output carries no gradient unless
``weights_grad=True`` (never for K6); origins, directions, t-values and
encodings never get one.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from nerf_keras_tpu_torch.models.mlp import NeRFMLP
from nerf_keras_tpu_torch.ops.encoding import encode_position
from nerf_keras_tpu_torch.ops.kernels import _build
from nerf_keras_tpu_torch.ops.rays import sample_rays
from nerf_keras_tpu_torch.ops.volume import volume_render

# Kernel launches in this process (one per successful launch).
launches = 0            # K1, both modes
train_launches = 0      # K1 in training mode (with residuals), also in `launches`
bwd_launches = 0        # K2
recompute_launches = 0  # K3
enc_launches = 0        # K6 forward
enc_bwd_launches = 0    # K6 backward

BWD_MODES = ("residual", "recompute")
# The rows kernel's modes (csrc/fused_render_bwd.cu).
_ROWS_K2, _ROWS_K3, _ROWS_K6, _ROWS_K5 = 0, 1, 2, 3

# Within every 16-wide k-group, the interleaved pack (:func:`_pack`, the
# layout the first, mma.sync kernels read: a thread's B fragment k = 2t,
# 2t+1, 2t+8, 2t+9 is one 8-byte load) stores rows in this order.
_K_INTERLEAVE = torch.tensor([0, 1, 8, 9, 2, 3, 10, 11, 4, 5, 12, 13, 6, 7, 14, 15])


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


class KernelPack(NamedTuple):
    """Matrices as the kernels read them."""

    w: torch.Tensor      # bf16, every layer's padded, interleaved matrix
    b: torch.Tensor      # f32, every layer's padded bias (zeros without one)
    desc: np.ndarray     # int32 (n_dense, 5): k_pad, n, n_pad, w_off, b_off


def _dense_layers(mlp: NeRFMLP) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """``(W^T (out, in), b)`` per kernel layer: the trunk, the merged
    feature+sigma head (feature columns first, sigma last), branch, rgb."""
    layers = [(layer.weight, layer.bias) for layer in mlp.trunk]
    layers.append((
        torch.cat([mlp.feature.weight, mlp.sigma.weight], dim=0),
        torch.cat([mlp.feature.bias, mlp.sigma.bias], dim=0),
    ))
    layers += [(mlp.branch.weight, mlp.branch.bias),
               (mlp.rgb.weight, mlp.rgb.bias)]
    return layers


@torch.no_grad()
def _pack(layers: list[tuple[torch.Tensor, torch.Tensor | None]],
          device: torch.device) -> KernelPack:
    """Pad each ``(M (rows=output columns, k), bias)`` to (round8, round16)
    and interleave its k-groups."""
    ws, bs, desc = [], [], []
    w_off = b_off = 0
    for mat, b in layers:
        n, k = mat.shape
        k_pad, n_pad = _round_up(k, 16), _round_up(n, 8)
        wp = torch.zeros((n_pad, k_pad), dtype=torch.float32, device=device)
        wp[:n, :k] = mat.to(device=device, dtype=torch.float32)
        wp = wp.reshape(n_pad, k_pad // 16, 16)[..., _K_INTERLEAVE.to(device)]
        bp = torch.zeros((n_pad,), dtype=torch.float32, device=device)
        if b is not None:
            bp[:n] = b.to(device=device, dtype=torch.float32)
        ws.append(wp.reshape(-1).to(torch.bfloat16))
        bs.append(bp)
        desc.append((k_pad, n, n_pad, w_off, b_off))
        w_off += n_pad * k_pad
        b_off += n_pad
    return KernelPack(
        w=torch.cat(ws).contiguous(), b=torch.cat(bs).contiguous(),
        desc=np.ascontiguousarray(np.asarray(desc, dtype=np.int32)),
    )


def pack_weights(mlp: NeRFMLP, device: torch.device) -> KernelPack:
    """Every layer's W^T (row = output column) in the interleaved layout.
    No kernel reads it since every bf16 kernel runs on wgmma; the tests
    hold :func:`pack_weights_wg`'s descriptors to its."""
    return _pack(_dense_layers(mlp), device)


WG_KS = 64  # k per weight stage of the wgmma kernels (csrc/nerf_wgmlp.cuh: kKs)
WG_HIDDEN = (64, 128, 256)  # their instantiations (csrc/nerf_wgmlp.cuh: wg_hidden_ok)


def wg_layout(n_pad: int, k_pad: int) -> np.ndarray:
    """Where element ``(n, k)`` of a padded ``(n_pad, k_pad)`` matrix lies
    in its wgmma pack, as an ``(n_pad, k_pad)`` array of element offsets:
    k-slices of ``WG_KS`` (the last a multiple of 16 up to it), each in the K-major
    core-matrix layout, ``slice_start + ((k % WG_KS) // 8 * n_pad + n) * 8
    + k % 8``."""
    n = np.arange(n_pad)[:, None]
    k = np.arange(k_pad)[None, :]
    slice_start = (k // WG_KS) * WG_KS * n_pad
    return slice_start + ((k % WG_KS) // 8 * n_pad + n) * 8 + k % 8


@torch.no_grad()
def _pack_wg(layers: list[tuple[torch.Tensor, torch.Tensor | None]],
             device: torch.device) -> KernelPack:
    """Pad each ``(M (rows=output columns, k), bias)`` to (round8, round16)
    and lay it out for the wgmma kernels (:func:`wg_layout`): a producer
    copies one k-slice per shared-memory stage, which wgmma's descriptor
    reads as is.  Same descriptors as :func:`_pack`."""
    ws, bs, desc = [], [], []
    w_off = b_off = 0
    for mat, b in layers:
        n, k = mat.shape
        k_pad, n_pad = _round_up(k, 16), _round_up(n, 8)
        wp = torch.zeros((n_pad, k_pad), dtype=torch.float32, device=device)
        wp[:n, :k] = mat.to(device=device, dtype=torch.float32)
        slices = [wp[:, k0:k0 + WG_KS].reshape(n_pad, -1, 8).permute(1, 0, 2).reshape(-1)
                  for k0 in range(0, k_pad, WG_KS) if n_pad]
        bp = torch.zeros((n_pad,), dtype=torch.float32, device=device)
        if b is not None:
            bp[:n] = b.to(device=device, dtype=torch.float32)
        ws.append(torch.cat(slices).to(torch.bfloat16) if slices
                  else torch.zeros((0,), dtype=torch.bfloat16, device=device))
        bs.append(bp)
        desc.append((k_pad, n, n_pad, w_off, b_off))
        w_off += n_pad * k_pad
        b_off += n_pad
    return KernelPack(
        w=torch.cat(ws).contiguous(), b=torch.cat(bs).contiguous(),
        desc=np.ascontiguousarray(np.asarray(desc, dtype=np.int32)),
    )


def pack_weights_wg(mlp: NeRFMLP, device: torch.device) -> KernelPack:
    """K1's (and K6's, K2's recompute) pack: every layer's W^T in wgmma's
    layout."""
    return _pack_wg(_dense_layers(mlp), device)


def pack_weights_bwd(mlp: NeRFMLP, device: torch.device,
                     input_grads: bool = False) -> KernelPack:
    """The matrices of :func:`pack_weights_bwd_wg` in the interleaved
    layout of :func:`pack_weights`."""
    return _pack(_bwd_layers(mlp, input_grads), device)


def _bwd_layers(mlp: NeRFMLP, input_grads: bool = False) -> list[tuple[torch.Tensor, None]]:
    """The transposed matrices ``W`` (row = layer input column, k = layer
    output): K2's cut to the hidden input columns, or with ``input_grads``
    every input column."""
    mats = [wt.T for wt, _ in _dense_layers(mlp)]
    if input_grads:
        return [(m, None) for m in mats]
    hid = mlp.hidden_dim
    rows = [0] + [hid] * (mlp.num_layers - 1) + [hid, hid, hid // 2]
    return [(m[:r], None) for m, r in zip(mats, rows)]


def pack_weights_bwd_wg(mlp: NeRFMLP, device: torch.device,
                        input_grads: bool = False) -> KernelPack:
    """The pack for the dX products ``dX = dPre W^T`` in wgmma's layout:
    per layer the matrix W (row = input column, k = output column).  K2's
    (and K3's, K6's, K5's without input gradients) is cut to the input
    columns whose gradient feeds the walk: the hidden part of each trunk
    input (none for layer 0, whose input is the encoding), of the head
    input and of the branch input; all of the rgb head's.  With
    ``input_grads`` (K5) every layer keeps all its input columns, so the
    products also give the gradients of the position encodings (layer 0
    and the skip concats) and of the direction encodings (the branch)."""
    return _pack_wg(_bwd_layers(mlp, input_grads), device)


def _cached(mlp: NeRFMLP, device: torch.device, attr: str, build) -> KernelPack:
    """The pack of ``mlp`` for ``device``, built once per installed set of
    weights (a parameter written in place -- an optimizer step -- or
    replaced, or another device, builds a new one), not once per launch."""
    key = (str(device), tuple((p.data_ptr(), p._version) for p in mlp.parameters()))
    cached = getattr(mlp, attr, None)
    if cached is None or cached[0] != key:
        cached = (key, build(mlp, device))
        setattr(mlp, attr, cached)
    return cached[1]


def kernel_pack(mlp: NeRFMLP, device: torch.device) -> KernelPack:
    """The forward pack every bf16 kernel reads (K1, K5, K6, and the
    backwards' recompute)."""
    return _cached(mlp, device, "_k1_pack", pack_weights_wg)


def kernel_pack_bwd(mlp: NeRFMLP, device: torch.device,
                    input_grads: bool = False) -> KernelPack:
    """The dX products' pack: K2's cut one, or K5's with input gradients
    under an attribute of its own (the cache keys only on the weights)."""
    if input_grads:
        return _cached(mlp, device, "_k5_pack",
                       lambda m, d: pack_weights_bwd_wg(m, d, input_grads=True))
    return _cached(mlp, device, "_k2_pack", pack_weights_bwd_wg)


def workspace_layout(fwd: KernelPack, bwd: KernelPack) -> np.ndarray:
    """The backward's per-layer workspace and output layout, int32
    (n_dense, 5): ``a_col, a_width`` (the layer input, width = the forward
    k_pad), ``d_col, d_width`` (its dPre, width = round16(outputs)): a
    layer's workspace starts at ``rows * col`` of the bf16 workspaces and
    holds ``rows`` samples in nerf_dw.cuh's tiled layout; ``out_off`` of
    its (a_width, d_width) f32 dW in the output."""
    a_w = fwd.desc[:, 0].astype(np.int64)
    d_w = bwd.desc[:, 0].astype(np.int64)
    cols = lambda w: np.concatenate([[0], np.cumsum(w)[:-1]])  # noqa: E731
    out = np.stack([cols(a_w), a_w, cols(d_w), d_w, cols(a_w * d_w)], axis=1)
    return np.ascontiguousarray(out.astype(np.int32))


# The dW workspace of K2, K3 and K6 holds one chunk of whole rays at most
# this many bytes (csrc/fused_render_bwd.cu runs the rows kernel and the dW
# product chunk by chunk); about 66K samples at 8x256.
DW_CHUNK_BYTES = 640 << 20


def chunk_plan(b: int, s: int, bytes_per_sample: int,
               budget: int | None = None) -> list[tuple[int, int]]:
    """``[(first ray, rays)]``: the chunks of whole rays the backward walks
    in order.  Each chunk's workspace (its samples padded to 128-row tiles,
    ``bytes_per_sample`` each) fits ``budget`` (``DW_CHUNK_BYTES``) unless
    one ray alone does not; the last chunk may be short; one chunk when
    the batch fits."""
    budget = DW_CHUNK_BYTES if budget is None else budget
    rows = budget // bytes_per_sample // 128 * 128
    rays = max(1, rows // s)
    return [(r, min(rays, b - r)) for r in range(0, b, rays)]


def _tiles(n: int) -> int:
    return -(-n // 128)


class DwBuffers(NamedTuple):
    """The workspaces and outputs of a backward (K2, K5) whose weight
    gradients go through ``nerf_dw.cuh``: the layer inputs (A) and dPre
    (D), bf16, of ``rows`` samples (one chunk), the per-block bias rows,
    the dW slabs, and the summed dW/db.  Freed on return to PyTorch's
    caching allocator, which hands their memory out again only to work
    queued after the kernels on this stream."""

    layout: np.ndarray
    ws_a: torch.Tensor
    ws_d: torch.Tensor
    db_part: torch.Tensor
    dw_part: torch.Tensor
    nsplit: int
    dw: torch.Tensor
    db: torch.Tensor

    @staticmethod
    def bytes_per_sample(fwd: KernelPack, bwd: KernelPack) -> int:
        layout = workspace_layout(fwd, bwd)
        return 2 * int(layout[:, 1].sum() + layout[:, 3].sum())

    @classmethod
    def allocate(cls, fwd: KernelPack, bwd: KernelPack, rows: int, nblk: int,
                 device: torch.device) -> "DwBuffers":
        """For ``rows`` workspace rows (a multiple of 64) and ``nblk``
        rows-kernel blocks; the dW product splits its 64-row stages so
        that about two waves of blocks (one per SM) are in flight."""
        layout = workspace_layout(fwd, bwd)
        a_cols, d_cols = int(layout[:, 1].sum()), int(layout[:, 3].sum())
        total_out = int((layout[:, 1] * layout[:, 3]).sum())
        total_b = fwd.b.numel()
        tiles = int(sum(-(-int(a) // 128) for a in layout[:, 1]))
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        nsplit = max(1, min(-(-2 * sms // tiles), rows // 64 // 8))
        f32 = dict(dtype=torch.float32, device=device)
        return cls(
            layout=layout,
            ws_a=torch.empty((rows * a_cols,), dtype=torch.bfloat16, device=device),
            ws_d=torch.empty((rows * d_cols,), dtype=torch.bfloat16, device=device),
            db_part=torch.empty((nblk * total_b,), **f32),
            dw_part=torch.empty((nsplit * total_out,), **f32),
            nsplit=nsplit,
            dw=torch.empty((total_out,), **f32),
            db=torch.empty((total_b,), **f32),
        )


def refuse_batch_norm(mlp: NeRFMLP) -> None:
    """K1-K6 and their plain versions have no BatchNorm: a BN model must
    take ``NeRFMLP.forward`` (``engine/step.py`` routes it there)."""
    if getattr(mlp, "batch_norm", False):
        raise ValueError("the ray and MLP kernels have no BatchNorm variant; "
                         "BATCH_NORM models run the plain MLP")


def _check_args(mlp: NeRFMLP, l_xyz: int, l_dir: int, skip_layer: int) -> None:
    if (l_xyz, l_dir, skip_layer) != (mlp.l_xyz, mlp.l_dir, mlp.skip_layer):
        raise ValueError(
            f"l_xyz/l_dir/skip_layer = {(l_xyz, l_dir, skip_layer)} do not "
            f"match the MLP's {(mlp.l_xyz, mlp.l_dir, mlp.skip_layer)}"
        )


def render_rays_reference(
    mlp: NeRFMLP,
    origins: torch.Tensor,
    dirs: torch.Tensor,
    t_vals: torch.Tensor,
    *,
    l_xyz: int = 10,
    l_dir: int = 4,
    skip_layer: int = 4,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K1: ``(rgb (B, 3), weights (B, S))`` float32,
    differentiable by plain autograd."""
    _check_args(mlp, l_xyz, l_dir, skip_layer)
    b, s = t_vals.shape
    points, _ = sample_rays(origins, dirs, t_vals)
    x_enc = encode_position(points, l_xyz)
    d_enc = encode_position(dirs, l_dir)[:, None, :].expand(b, s, -1)
    preds = mlp(x_enc, d_enc)
    rgb, _, weights = volume_render(preds, t_vals)
    return rgb, weights


def render_rays_reference_vjp(
    mlp: NeRFMLP,
    origins: torch.Tensor,
    dirs: torch.Tensor,
    t_vals: torch.Tensor,
    g_rgb: torch.Tensor,
    g_w: torch.Tensor | None = None,
    *,
    l_xyz: int = 10,
    l_dir: int = 4,
    skip_layer: int = 4,
) -> list[torch.Tensor]:
    """Plain K2: the gradients of ``<rgb, g_rgb> + <weights, g_w>`` with
    respect to ``mlp.parameters()`` (in that order), by autograd of
    :func:`render_rays_reference`."""
    params = list(mlp.parameters())
    with torch.enable_grad():
        rgb, w = render_rays_reference(mlp, origins, dirs, t_vals, l_xyz=l_xyz,
                                       l_dir=l_dir, skip_layer=skip_layer)
        outs, cots = [rgb], [g_rgb]
        if g_w is not None:
            outs.append(w)
            cots.append(g_w)
        return list(torch.autograd.grad(outs, params, cots))


def check_tensor(name: str, x: torch.Tensor, shape: tuple, device,
                  dtype=torch.float32) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def device_index(device: torch.device) -> int:
    return device.index if device.index is not None else torch.cuda.current_device()


def _check_cuda_call(mlp, origins, dirs, t_vals, l_xyz, l_dir, skip_layer) -> None:
    if origins.device.type != "cuda":
        raise ValueError(f"K1/K2 run on cuda or cpu tensors, got {origins.device}")
    _check_args(mlp, l_xyz, l_dir, skip_layer)
    if mlp.compute_dtype != torch.bfloat16:
        raise NotImplementedError(
            f"K1/K2 on CUDA run bf16 MLPs only; COMPUTE_DTYPE="
            f"{mlp.compute_dtype} is not ported to the kernels yet"
        )
    device = origins.device
    if t_vals.dim() != 2:
        raise ValueError(f"t_vals must be (B, S), got {tuple(t_vals.shape)}")
    b, s = t_vals.shape
    check_tensor("origins", origins, (b, 3), device)
    check_tensor("dirs", dirs, (b, 3), device)
    check_tensor("t_vals", t_vals, (b, s), device)
    for p in mlp.parameters():
        if p.device != device:
            raise ValueError(f"MLP parameters are on {p.device}, rays on {device}")
    _check_hidden(mlp)


def _check_hidden(mlp: NeRFMLP) -> None:
    if mlp.hidden_dim not in WG_HIDDEN:
        raise NotImplementedError(
            f"K1/K2/K3/K5/K6 on CUDA take hidden widths {WG_HIDDEN}; "
            f"hidden_dim={mlp.hidden_dim} has no kernel instantiation"
        )


def _ptr(x: torch.Tensor | None) -> int | None:
    """A tensor's device address for ctypes, None for an absent input."""
    return None if x is None else x.data_ptr()


def _launch_fwd(mlp, t_vals, l_xyz, l_dir, *, origins=None, dirs=None,
                x_in=None, d_in=None, emit_xenc=False, emit_preds=False):
    """One launch of ``nkt_fused_render_fwd``: K1 over rays (``origins``,
    ``dirs``) or K6 over encodings (``x_in``, ``d_in``, (B*S, .) bf16).
    Returns ``(rgb, weights, x_enc or None, preds or None)``."""
    device = t_vals.device
    b, s = t_vals.shape
    rgb = torch.empty((b, 3), dtype=torch.float32, device=device)
    weights = torch.empty((b, s), dtype=torch.float32, device=device)
    x_enc = preds = None
    if emit_xenc:
        x_enc = torch.empty((b * s, 3 + 6 * l_xyz), dtype=torch.bfloat16, device=device)
    if emit_preds:
        preds = torch.empty((b * s, 4), dtype=torch.float32, device=device)
    if b == 0:
        return rgb, weights, x_enc, preds
    pack = kernel_pack(mlp, device)
    rc = _build.load("fused_render_fwd").nkt_fused_render_fwd(
        _ptr(origins), _ptr(dirs), t_vals.data_ptr(), _ptr(x_in), _ptr(d_in),
        pack.w.data_ptr(), pack.b.data_ptr(), pack.desc.ctypes.data,
        pack.desc.shape[0], mlp.num_layers, mlp.skip_layer, mlp.hidden_dim,
        l_xyz, l_dir, b, s, rgb.data_ptr(), weights.data_ptr(), _ptr(x_enc), _ptr(preds),
        device_index(device), torch.cuda.current_stream(device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"{'K6' if x_in is not None else 'K1'} launch failed with CUDA error {rc} "
            f"(B={b}, S={s}, hidden={mlp.hidden_dim}, layers={mlp.num_layers}, "
            f"residuals={emit_xenc}/{emit_preds})"
        )
    return rgb, weights, x_enc, preds


def launch_k1(mlp, origins, dirs, t_vals, l_xyz, l_dir, train: bool,
              emit_xenc: bool = True):
    """One K1 launch: ``(rgb, weights, x_enc, preds)``.  With ``train`` it
    writes the residuals: ``preds (B*S, 4) f32`` and, with ``emit_xenc``
    (K2's; K3 needs none), ``x_enc (B*S, 3+6L) bf16``; else they are
    None."""
    global launches, train_launches
    out = _launch_fwd(mlp, t_vals, l_xyz, l_dir, origins=origins, dirs=dirs,
                      emit_xenc=train and emit_xenc, emit_preds=train)
    if t_vals.shape[0]:
        launches += 1
        train_launches += int(train)
    return out


def unpack_grads(mlp: NeRFMLP, fwd: KernelPack, layout: np.ndarray,
                  dw: torch.Tensor, db: torch.Tensor) -> list[torch.Tensor]:
    """A backward's flat dW/db -> gradients in ``mlp.parameters()`` order, as the
    JAX package returns them: weight gradients rounded to bf16 (the TPU
    kernel returns ``dv.astype(w.dtype)`` of bf16-cast weights), biases
    f32; the merged head's gradient split into feature and sigma."""
    bf = lambda g: g.to(torch.bfloat16).to(torch.float32)  # noqa: E731
    per_layer = []
    for (wt, _), (_, n, _, _, b_off), (_, a_w, _, d_w, off) in zip(
            _dense_layers(mlp), fwd.desc, layout):
        k = wt.shape[1]
        w = dw[off:off + a_w * d_w].view(a_w, d_w)[:k, :n].T
        per_layer.append((w, db[b_off:b_off + n]))
    grads = []
    for w, b in per_layer[:mlp.num_layers]:
        grads += [bf(w), b.clone()]
    (w_fs, b_fs), (w_br, b_br), (w_rgb, b_rgb) = per_layer[mlp.num_layers:]
    hid = mlp.hidden_dim
    # parameters() order: trunk..., sigma, feature, branch, rgb.
    grads += [bf(w_fs[hid:]), b_fs[hid:].clone(), bf(w_fs[:hid]), b_fs[:hid].clone()]
    grads += [bf(w_br), b_br.clone(), bf(w_rgb), b_rgb.clone()]
    return grads


def launch_rows(mode, mlp, t_vals, preds, g_rgb, g_w, l_xyz, l_dir, *,
                x_res=None, origins=None, dirs=None, d_enc=None, g=None, dx=None, dd=None):
    """One backward in ``mode`` (``_ROWS_K2``: ``x_res`` and ``dirs``;
    ``_ROWS_K3``: ``origins`` and ``dirs``; ``_ROWS_K6``: ``x_res`` = x_enc
    and ``d_enc``, (B*S, .) bf16; ``_ROWS_K5``: ``x_res`` = x_enc, ``d_enc``
    and the predictions' cotangent ``g`` (N, 4), with t_vals, preds and
    g_rgb None, and where given ``dx``/``dd`` (bf16, like the encodings)
    to receive their gradients): the compositing VJP (not K5's), then the
    rows kernel and the dW product over the chunks of :func:`chunk_plan`
    (K5's of samples), then the reduce.  Returns ``(forward pack,
    DwBuffers)``: the summed f32 dW/db are in ``ws.dw``/``ws.db``
    (:func:`unpack_grads` maps them to the parameters)."""
    k5 = mode == _ROWS_K5
    device = x_res.device if k5 else t_vals.device
    b, s = (x_res.shape[0], 1) if k5 else t_vals.shape
    n = b * s
    if x_res is not None:
        check_tensor("x_enc", x_res, (n, 3 + 6 * l_xyz), device, torch.bfloat16)
    if d_enc is not None:
        check_tensor("d_enc", d_enc, (n, 3 + 6 * l_dir), device, torch.bfloat16)
    if k5:
        check_tensor("g", g, (n, 4), device)
    else:
        check_tensor("preds", preds, (n, 4), device)
        check_tensor("g_rgb", g_rgb, (b, 3), device)
    if g_w is not None:
        check_tensor("g_w", g_w, (b, s), device)
    _check_hidden(mlp)
    fwd = kernel_pack(mlp, device)
    bwd = kernel_pack_bwd(mlp, device, input_grads=dx is not None or dd is not None)
    plan = chunk_plan(b, s, DwBuffers.bytes_per_sample(fwd, bwd))
    chunk_rays = plan[0][1]
    rows = _tiles(chunk_rays * s) * 128
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    grid = min(_tiles(chunk_rays * s), sms)
    ws = DwBuffers.allocate(fwd, bwd, rows, grid, device)
    dpreds = g if k5 else torch.empty((n, 4), dtype=torch.float32, device=device)
    rc = _build.load("fused_render_bwd").nkt_fused_render_bwd(
        mode, _ptr(x_res), _ptr(origins), _ptr(dirs), _ptr(d_enc), _ptr(t_vals),
        _ptr(preds), _ptr(g_rgb), _ptr(g_w),
        fwd.w.data_ptr(), fwd.b.data_ptr(), fwd.desc.ctypes.data,
        bwd.w.data_ptr(), bwd.desc.ctypes.data, ws.layout.ctypes.data,
        fwd.desc.shape[0], mlp.num_layers, mlp.skip_layer, mlp.hidden_dim,
        l_xyz, l_dir, b, s, chunk_rays, ws.db.numel(), ws.dw.numel(), dpreds.data_ptr(),
        ws.ws_a.data_ptr(), ws.ws_d.data_ptr(), ws.db_part.data_ptr(), grid,
        ws.dw_part.data_ptr(), ws.nsplit, ws.dw.data_ptr(), ws.db.data_ptr(),
        _ptr(dx), _ptr(dd), device_index(device), torch.cuda.current_stream(device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"{('K2', 'K3', 'K6 backward', 'K5 backward')[mode]} launch failed with CUDA "
            f"error {rc} (B={b}, S={s}, hidden={mlp.hidden_dim}, layers={mlp.num_layers}, "
            f"chunks of {chunk_rays} rays, input grads={dx is not None}/{dd is not None})"
        )
    return fwd, ws


def launch_k2(mlp, x_enc, dirs, t_vals, preds, g_rgb, g_w, l_xyz, l_dir):
    """One K2 launch: gradients in ``mlp.parameters()`` order."""
    global bwd_launches
    fwd, ws = launch_rows(_ROWS_K2, mlp, t_vals, preds, g_rgb, g_w, l_xyz, l_dir,
                          x_res=x_enc, dirs=dirs)
    bwd_launches += 1
    return unpack_grads(mlp, fwd, ws.layout, ws.dw, ws.db)


def launch_k3(mlp, origins, dirs, t_vals, preds, g_rgb, g_w, l_xyz, l_dir):
    """One K3 launch (K2 with the position encodings computed again from
    the rays): gradients in ``mlp.parameters()`` order."""
    global recompute_launches
    fwd, ws = launch_rows(_ROWS_K3, mlp, t_vals, preds, g_rgb, g_w, l_xyz, l_dir,
                          origins=origins, dirs=dirs)
    recompute_launches += 1
    return unpack_grads(mlp, fwd, ws.layout, ws.dw, ws.db)


class _FusedRender(torch.autograd.Function):
    """K1 with residuals forward; K2 (``residual``) or K3 (``recompute``)
    backward.  The parameters are inputs only so that autograd routes
    their gradients."""

    @staticmethod
    def forward(ctx, mlp, l_xyz, l_dir, bwd_mode, origins, dirs, t_vals, *params):
        recompute = bwd_mode == "recompute"
        rgb, weights, x_enc, preds = launch_k1(mlp, origins, dirs, t_vals, l_xyz, l_dir,
                                                train=True, emit_xenc=not recompute)
        ctx.mlp, ctx.l_xyz, ctx.l_dir, ctx.recompute = mlp, l_xyz, l_dir, recompute
        # K3 holds the rays; K2 the position encodings (it needs no origins).
        ctx.save_for_backward(origins if recompute else x_enc, preds, dirs, t_vals)
        ctx.set_materialize_grads(False)
        return rgb, weights

    @staticmethod
    def backward(ctx, g_rgb, g_w):
        held, preds, dirs, t_vals = ctx.saved_tensors
        if g_rgb is None:
            g_rgb = torch.zeros((t_vals.shape[0], 3), dtype=torch.float32,
                                device=t_vals.device)
        launch = launch_k3 if ctx.recompute else launch_k2
        grads = launch(
            ctx.mlp, held, dirs, t_vals, preds, g_rgb.contiguous(),
            None if g_w is None else g_w.contiguous(), ctx.l_xyz, ctx.l_dir,
        )
        return (None,) * 7 + tuple(grads)


def render_rays_fused(
    mlp: NeRFMLP,
    origins: torch.Tensor,
    dirs: torch.Tensor,
    t_vals: torch.Tensor,
    *,
    l_xyz: int = 10,
    l_dir: int = 4,
    skip_layer: int = 4,
    weights_grad: bool = False,
    bwd_mode: str = "residual",
) -> tuple[torch.Tensor, torch.Tensor]:
    """K1 over raw rays: ``origins``/``dirs`` ``(B, 3)``, ``t_vals``
    ``(B, S)`` ascending -> ``(rgb (B, 3), weights (B, S))`` float32,
    differentiable in the MLP's parameters (the weights only with
    ``weights_grad``).  ``bwd_mode`` picks the backward: ``"residual"``
    (K2, from K1's stored position encodings) or ``"recompute"`` (K3,
    which encodes the points again and so holds 16 B per sample between
    forward and backward instead of 142 B); the gradients are the same.

    CPU tensors take :func:`render_rays_reference`.  CUDA tensors launch
    the kernels (bf16 MLPs only) or raise.
    """
    if bwd_mode not in BWD_MODES:
        raise ValueError(f"unknown bwd_mode: {bwd_mode!r}")
    refuse_batch_norm(mlp)
    if origins.device.type == "cpu":
        rgb, weights = render_rays_reference(
            mlp, origins, dirs, t_vals,
            l_xyz=l_xyz, l_dir=l_dir, skip_layer=skip_layer,
        )
    else:
        _check_cuda_call(mlp, origins, dirs, t_vals, l_xyz, l_dir, skip_layer)
        params = list(mlp.parameters())
        if torch.is_grad_enabled() and any(p.requires_grad for p in params):
            rgb, weights = _FusedRender.apply(mlp, l_xyz, l_dir, bwd_mode, origins,
                                              dirs, t_vals, *params)
        else:
            rgb, weights, _, _ = launch_k1(mlp, origins, dirs, t_vals, l_xyz,
                                            l_dir, train=False)
    return rgb, weights if weights_grad else weights.detach()


# ---------------------------------------------------------------------------
# K6: the MLP and the compositing over precomputed encodings.

def apply_nerf_render_reference(
    mlp: NeRFMLP,
    x_enc: torch.Tensor,
    d_enc: torch.Tensor,
    t_vals: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain K6: :class:`NeRFMLP` over ``x_enc (B, S, 3+6 L_XYZ)`` and
    ``d_enc (B, S, 3+6 L_DIR)``, then ``volume_render`` over ``t_vals (B,
    S)`` -> ``(rgb (B, 3), weights (B, S))`` float32; rgb differentiable in
    the MLP's parameters, the weights detached (the JAX entry's
    stop-gradient)."""
    rgb, _, weights = volume_render(mlp(x_enc, d_enc), t_vals)
    return rgb, weights.detach()


def apply_nerf_render_reference_vjp(
    mlp: NeRFMLP,
    x_enc: torch.Tensor,
    d_enc: torch.Tensor,
    t_vals: torch.Tensor,
    g_rgb: torch.Tensor,
) -> list[torch.Tensor]:
    """Plain K6 backward: the gradients of ``<rgb, g_rgb>`` with respect to
    ``mlp.parameters()`` (in that order), by autograd of
    :func:`apply_nerf_render_reference`."""
    with torch.enable_grad():
        rgb, _ = apply_nerf_render_reference(mlp, x_enc, d_enc, t_vals)
        return list(torch.autograd.grad([rgb], list(mlp.parameters()), [g_rgb]))


def _check_enc_call(mlp, x_enc, d_enc, t_vals) -> None:
    device = x_enc.device
    if device.type != "cuda":
        raise ValueError(f"K6 runs on cuda or cpu tensors, got {device}")
    if mlp.compute_dtype != torch.bfloat16:
        raise NotImplementedError(
            f"K6 on CUDA runs bf16 MLPs only; COMPUTE_DTYPE={mlp.compute_dtype} "
            "is not ported to the kernels yet"
        )
    if t_vals.dim() != 2:
        raise ValueError(f"t_vals must be (B, S), got {tuple(t_vals.shape)}")
    b, s = t_vals.shape
    check_tensor("x_enc", x_enc, (b, s, mlp.xyz_dim), device, torch.bfloat16)
    check_tensor("d_enc", d_enc, (b, s, mlp.dir_dim), device, torch.bfloat16)
    check_tensor("t_vals", t_vals, (b, s), device)
    for p in mlp.parameters():
        if p.device != device:
            raise ValueError(f"MLP parameters are on {p.device}, encodings on {device}")
    _check_hidden(mlp)


def launch_k6_fwd(mlp, x_enc, d_enc, t_vals, train: bool):
    """One K6 forward launch over ``(B, S, .)`` bf16 encodings: ``(rgb,
    weights, preds)``, ``preds (B*S, 4) f32`` with ``train`` (K6's
    backward reads them), else None."""
    global enc_launches
    _check_enc_call(mlp, x_enc, d_enc, t_vals)
    rgb, weights, _, preds = _launch_fwd(mlp, t_vals, mlp.l_xyz, mlp.l_dir,
                                         x_in=x_enc, d_in=d_enc, emit_preds=train)
    if t_vals.shape[0]:
        enc_launches += 1
    return rgb, weights, preds


def launch_k6_bwd(mlp, x_enc, d_enc, t_vals, preds, g_rgb):
    """One K6 backward launch: gradients in ``mlp.parameters()`` order
    (none for the encodings, as in the JAX kernel)."""
    global enc_bwd_launches
    b, s = t_vals.shape
    fwd, ws = launch_rows(_ROWS_K6, mlp, t_vals, preds, g_rgb, None, mlp.l_xyz, mlp.l_dir,
                          x_res=x_enc.reshape(b * s, -1), d_enc=d_enc.reshape(b * s, -1))
    enc_bwd_launches += 1
    return unpack_grads(mlp, fwd, ws.layout, ws.dw, ws.db)


class _FusedRenderEnc(torch.autograd.Function):
    """K6's forward (writing its predictions), K6's backward; the weights
    output is not differentiable."""

    @staticmethod
    def forward(ctx, mlp, x_enc, d_enc, t_vals, *params):
        rgb, weights, preds = launch_k6_fwd(mlp, x_enc, d_enc, t_vals, train=True)
        ctx.mlp = mlp
        ctx.save_for_backward(x_enc, d_enc, t_vals, preds)
        ctx.mark_non_differentiable(weights)
        return rgb, weights

    @staticmethod
    def backward(ctx, g_rgb, _g_weights):
        x_enc, d_enc, t_vals, preds = ctx.saved_tensors
        grads = launch_k6_bwd(ctx.mlp, x_enc, d_enc, t_vals, preds, g_rgb.contiguous())
        return (None,) * 4 + tuple(grads)


def apply_nerf_render_fused(
    mlp: NeRFMLP,
    x_enc: torch.Tensor,
    d_enc: torch.Tensor,
    t_vals: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K6, the MLP and compositing over encodings: ``x_enc (B, S, 3+6
    L_XYZ)`` and ``d_enc (B, S, 3+6 L_DIR)`` (per sample; bf16 on CUDA),
    ``t_vals (B, S)`` ascending -> ``(rgb (B, 3), weights (B, S))``
    float32.  rgb is differentiable in the MLP's parameters; the weights
    and the encodings get no gradient, as in the JAX
    ``apply_nerf_render_pallas``.

    CPU tensors take :func:`apply_nerf_render_reference`.  CUDA tensors
    launch the kernels (bf16 MLPs only) or raise.
    """
    refuse_batch_norm(mlp)
    if x_enc.device.type == "cpu":
        return apply_nerf_render_reference(mlp, x_enc, d_enc, t_vals)
    params = list(mlp.parameters())
    if torch.is_grad_enabled() and any(p.requires_grad for p in params):
        rgb, weights = _FusedRenderEnc.apply(mlp, x_enc, d_enc, t_vals, *params)
    else:
        rgb, weights, _ = launch_k6_fwd(mlp, x_enc, d_enc, t_vals, train=False)
    return rgb, weights.detach()
