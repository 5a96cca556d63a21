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

Any bf16 hidden width up to 1024 (float32 up to 256; K5 with input
gradients up to 256) and any encoding up to 128 position and 64 direction
columns (L_XYZ 20, L_DIR 10) runs on the kernels.  The bf16 kernels are
instantiated at hidden 64, 128, 256, 512 and 1024 (512 and 1024 on 64-row
tiles whose two warpgroups split each layer's columns, each layer's sums
made of fresh wgmma sums of a fixed depth, 1024 in column passes of 256:
``csrc/nerf_wgmlp.cuh``); another
width runs on packs zero-padded to the next (:func:`kernel_width`,
:func:`layer_maps`): exact, since a zero unit's ReLU is 0, feeds zeros
forward and passes no gradient back.  Only the packs are padded;
:func:`unpack_grads` returns the model's real shapes, and checkpoints,
digests and exports never see a padded weight.  A float32 MLP runs the f32
kernels instead (``fused_f32.py``: true f32 products, at the model's own
widths), with counters of their own; :func:`kernel_route` is the dispatch.
Beyond these limits the wrappers raise ``NotImplementedError`` naming
them.

As in the JAX package, the weights output carries no gradient unless
``weights_grad=True`` (never for K6); origins, directions, t-values and
encodings never get one.
"""

from __future__ import annotations

import functools
import heapq
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import torch

from nerf_keras_tpu_torch.models.mlp import NeRFMLP
from nerf_keras_tpu_torch.ops.encoding import encode_position
from nerf_keras_tpu_torch.ops.kernels import _build, fused_f32
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
# The rows kernel's modes (csrc/nerf_rows.cuh).
_ROWS_K2, _ROWS_K3, _ROWS_K6, _ROWS_K5 = 0, 1, 2, 3
# The rows kernel's library by kernel width (the others: fused_render_bwd).
ROWS_LIBRARY = {512: "fused_render_bwd_512", 1024: "fused_render_bwd_1024"}

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


# The bf16 kernels' instantiations (csrc/nerf_wgmlp.cuh: wg_hidden_ok); the
# widest is their limit (wider needs a design of its own).
WG_HIDDEN = (64, 128, 256, 512, 1024)
MAX_HIDDEN_F32 = 256  # the float32 kernels (csrc/fused_render_f32.cu)
MAX_HIDDEN_IG = 256   # K5 with input gradients (its 128-row tiles: nerf_wgmlp.cuh)
MAX_ENC = (128, 64)  # position and direction encoding columns the kernels take
WIDE_QUEUE = "ROADMAP.md queue 2 A3"  # where the wider kernels are queued


def kernel_width(hidden: int, widths: tuple[int, ...] = WG_HIDDEN) -> int:
    """The instantiation a model of ``hidden`` units runs on: the least of
    ``widths`` that holds it; the model is zero-padded to it
    (:func:`padded_layers`).  ``NotImplementedError`` above the widest."""
    for w in widths:
        if hidden <= w:
            return w
    raise NotImplementedError(
        f"hidden_dim={hidden}: the CUDA kernels take hidden widths up to {widths[-1]}; "
        f"wider MLPs need a kernel design of their own ({WIDE_QUEUE})"
    )


def check_encodings(l_xyz: int, l_dir: int) -> None:
    """``NotImplementedError`` for encodings wider than the kernels' tiles
    (128 position and 64 direction columns: L_XYZ 20, L_DIR 10)."""
    x, d = 3 + 6 * l_xyz, 3 + 6 * l_dir
    if x > MAX_ENC[0] or d > MAX_ENC[1]:
        raise NotImplementedError(
            f"L_XYZ={l_xyz}, L_DIR={l_dir}: the CUDA kernels take encodings up to "
            f"{MAX_ENC[0]} position and {MAX_ENC[1]} direction columns (L_XYZ <= 20, "
            f"L_DIR <= 10; {WIDE_QUEUE})"
        )


def kernel_route(compute_dtype: torch.dtype, hidden: int, device_type: str) -> tuple[str, int]:
    """Which kernels run an MLP, and at what hidden width: ``("plain",
    hidden)`` for tensors on the CPU, ``("f32", hidden)`` for a float32 MLP
    on CUDA (``csrc/fused_render_f32.cu``, at the model's own widths),
    ``("wgmma", kernel_width(hidden))`` for a bf16 one (the wgmma kernels on
    the zero-padded pack).  ``NotImplementedError`` on CUDA above
    ``MAX_HIDDEN_F32`` for float32 and above ``WG_HIDDEN[-1]`` for bf16."""
    if device_type == "cpu":
        return "plain", hidden
    if compute_dtype == torch.float32:
        if hidden > MAX_HIDDEN_F32:
            raise NotImplementedError(
                f"hidden_dim={hidden}: the float32 CUDA kernels take hidden widths up to "
                f"{MAX_HIDDEN_F32}; wider float32 MLPs need a kernel design of their own "
                f"({WIDE_QUEUE})")
        return "f32", hidden
    if compute_dtype != torch.bfloat16:
        raise NotImplementedError(f"the CUDA kernels run bf16 or float32 MLPs, got {compute_dtype}")
    return "wgmma", kernel_width(hidden)


def check_input_grads(mlp: NeRFMLP) -> None:
    """``NotImplementedError`` for K5 with input gradients on a bf16 MLP
    wider than ``MAX_HIDDEN_IG`` on CUDA: its products keep the encodings'
    gradient columns beside a layer's on the 128-row tile."""
    route, _ = kernel_route(mlp.compute_dtype, mlp.hidden_dim, "cuda")
    if route == "wgmma" and mlp.hidden_dim > MAX_HIDDEN_IG:
        raise NotImplementedError(
            f"hidden_dim={mlp.hidden_dim}: K5 with input gradients (STOP_PDF_GRADIENT="
            f"false) takes hidden widths up to {MAX_HIDDEN_IG} on the CUDA kernels "
            f"({WIDE_QUEUE})")


def _dense_layers(mlp: NeRFMLP, hp: int | None = None) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """``(W^T (out, in), b)`` per kernel layer: the trunk, the merged
    feature+sigma head (feature columns first, sigma last), branch, rgb;
    with ``hp`` zero-padded to ``hp`` hidden units (:func:`padded_layers`)."""
    layers = [(layer.weight, layer.bias) for layer in mlp.trunk]
    layers.append((
        torch.cat([mlp.feature.weight, mlp.sigma.weight], dim=0),
        torch.cat([mlp.feature.bias, mlp.sigma.bias], dim=0),
    ))
    layers += [(mlp.branch.weight, mlp.branch.bias),
               (mlp.rgb.weight, mlp.rgb.bias)]
    if hp is None or hp == mlp.hidden_dim:
        return layers
    return padded_layers(mlp, layers, hp)


def layer_maps(mlp: NeRFMLP, hp: int) -> list[tuple[torch.Tensor, torch.Tensor, int, int]]:
    """Per kernel layer of a model (``mlp``: anything with its
    ``hidden_dim``, ``num_layers``, ``skip_layer``, ``xyz_dim`` and
    ``dir_dim``) padded from ``H = mlp.hidden_dim`` to ``hp`` hidden units: ``(in_idx, out_idx, k, n)``, where the model's
    input column ``c`` of the layer sits at column ``in_idx[c]`` of the
    padded input (``k`` wide) and its output column ``j`` at ``out_idx[j]``
    of the padded output (``n`` wide).  The moved offsets: a skip layer's
    and the head's ``x_enc`` columns start at ``hp``, the branch's ``d_enc``
    columns at ``hp``, sigma sits at head column ``hp``, the branch is
    ``hp // 2`` wide and so is the rgb layer's input."""
    hid, nl, skip = mlp.hidden_dim, mlp.num_layers, mlp.skip_layer
    xd, dd = mlp.xyz_dim, mlp.dir_dim
    ar = torch.arange

    def trunk_in(i):  # the input of trunk layer i (i == nl: the head)
        if i == 0:
            return ar(xd), xd
        if i - 1 > 0 and (i - 1) % skip == 0:
            return torch.cat([ar(hid), hp + ar(xd)]), hp + xd
        return ar(hid), hp

    maps = []
    for i in range(nl):
        in_idx, k = trunk_in(i)
        maps.append((in_idx, ar(hid), k, hp))
    head_in, head_k = trunk_in(nl)
    maps.append((head_in, torch.cat([ar(hid), torch.tensor([hp])]), head_k, hp + 1))
    maps.append((torch.cat([ar(hid), hp + ar(dd)]), ar(hid // 2), hp + dd, hp // 2))
    maps.append((ar(hid // 2), ar(3), hp // 2, 3))
    return maps


def _runs(idx: torch.Tensor) -> tuple[tuple[int, int, int], ...]:
    """An increasing index map as its contiguous runs ``(real start, padded
    start, length)``."""
    runs = []
    for real, padded in enumerate(idx.tolist()):
        if runs and runs[-1][1] + runs[-1][2] == padded:
            runs[-1][2] += 1
        else:
            runs.append([real, padded, 1])
    return tuple(tuple(r) for r in runs)


@functools.lru_cache(maxsize=None)
def _cached_runs(hidden: int, num_layers: int, skip_layer: int, xyz_dim: int, dir_dim: int,
                 hp: int) -> tuple:
    shape = SimpleNamespace(hidden_dim=hidden, num_layers=num_layers, skip_layer=skip_layer,
                            xyz_dim=xyz_dim, dir_dim=dir_dim)
    return tuple((_runs(i), _runs(o), k, n) for i, o, k, n in layer_maps(shape, hp))


def layer_runs(mlp: NeRFMLP, hp: int) -> tuple:
    """:func:`layer_maps` as contiguous runs, ``(in runs, out runs, k, n)``
    per layer (a block copy per pair of runs: no index tensor reaches the
    device)."""
    return _cached_runs(mlp.hidden_dim, mlp.num_layers, mlp.skip_layer, mlp.xyz_dim,
                        mlp.dir_dim, hp)


def _cat(parts: list[torch.Tensor], dim: int) -> torch.Tensor:
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim)


def padded_layers(mlp: NeRFMLP, layers: list, hp: int) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """``layers`` (:func:`_dense_layers`' real ones) scattered into zero
    matrices and biases of ``hp`` hidden units by :func:`layer_maps`.
    Exact: a zero unit's pre-activation is 0, its ReLU 0, it feeds zeros
    forward, and its mask passes no gradient back."""
    out = []
    for (wt, b), (in_runs, out_runs, k, n) in zip(layers, layer_runs(mlp, hp)):
        m = wt.new_zeros((n, k))
        bp = b.new_zeros((n,))
        for ro, po, lo in out_runs:
            bp[po:po + lo] = b[ro:ro + lo]
            for ri, pi, li in in_runs:
                m[po:po + lo, pi:pi + li] = wt[ro:ro + lo, ri:ri + li]
        out.append((m, bp))
    return out


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
WG_KS_NARROW = 32  # k per stage of the wide input-gradient packs (kKsNarrow)


PASS_COLS = 512  # K4's column passes (csrc/nerf_wgmlp.cuh: kPassCols)
WG_PASS_COLS = 256  # the bf16 kernels' column passes at hidden 1024 (kWgPassCols)


def wg_pass_cols(hp: int) -> int | None:
    """The bf16 kernels' pass width at kernel width ``hp``
    (csrc/nerf_wgmlp.cuh: wg_pass_cols): WG_PASS_COLS at 1024, else None
    (every layer in one pass)."""
    return WG_PASS_COLS if hp > PASS_COLS else None


def pass_widths(n_pad: int, cols: int | None = PASS_COLS) -> list[int]:
    """A layer's column passes (csrc/nerf_wgmlp.cuh: n_passes, pass_width):
    one up to ``cols`` + 8 columns (or with ``cols`` None), else passes of
    ``cols``, the last taking the rest (K4's at hidden 1024, 512 + 520 of
    the merged head; the bf16 kernels' at 1024, WG_PASS_COLS: 3 x 256 +
    264)."""
    if cols is None or n_pad <= cols + 8:
        return [n_pad]
    n = n_pad // cols
    return [cols] * (n - 1) + [n_pad - cols * (n - 1)]


def wg_layout(n_pad: int, k_pad: int, ks: int = WG_KS,
              cols: int | None = None) -> np.ndarray:
    """Where element ``(n, k)`` of a padded ``(n_pad, k_pad)`` matrix lies
    in its wgmma pack, as an ``(n_pad, k_pad)`` array of element offsets:
    each column pass (:func:`pass_widths` of ``cols``, :func:`wg_pass_cols`:
    one pass unless at hidden 1024) a block of its own, ``k_pad * c0``
    from the start for the pass from column ``c0``, ``w`` wide, in k-slices
    of ``ks`` (the last a multiple of 16 up to it), each in the K-major
    core-matrix layout, ``slice_start + ((k % ks) // 8 * w + n - c0) * 8 +
    k % 8``."""
    out = np.empty((n_pad, k_pad), dtype=np.int64)
    k = np.arange(k_pad)[None, :]
    c0 = 0
    for w in pass_widths(n_pad, cols):
        n = np.arange(w)[:, None]
        out[c0:c0 + w] = k_pad * c0 + (k // ks) * ks * w + ((k % ks) // 8 * w + n) * 8 + k % 8
        c0 += w
    return out


def ig_cols(xyz_dim: int, dir_dim: int) -> tuple[int, int, int]:
    """K5's input-gradient products (csrc/nerf_wgmlp.cuh: ig_xcols,
    ig_dcols, ig_ks): the x_enc and d_enc gradient columns they compute
    (64 or 128; 32 or 64) and the k per stage of their transposed pack."""
    kx = 64 if xyz_dim <= 64 else 128
    kd = 32 if dir_dim <= 32 else 64
    return kx, kd, WG_KS if (kx, kd) == (64, 32) else WG_KS_NARROW


@torch.no_grad()
def _pack_wg(layers: list[tuple[torch.Tensor, torch.Tensor | None]],
             device: torch.device, ks: int = 64,
             n_pads: list[int] | None = None, cols: int | None = None) -> KernelPack:
    """Pad each ``(M (rows=output columns, k), bias)`` to (round8, round16)
    (or to ``n_pads`` rows) and lay it out for the wgmma kernels
    (:func:`wg_layout`, ``ks`` k per slice, column pass by column pass of
    ``cols``): a
    producer copies one k-slice of a pass per shared-memory stage, which
    wgmma's descriptor reads as is.  Same descriptors as :func:`_pack`."""
    ws, bs, desc = [], [], []
    w_off = b_off = 0
    for j, (mat, b) in enumerate(layers):
        n, k = mat.shape
        k_pad, n_pad = _round_up(k, 16), _round_up(n, 8) if n_pads is None else n_pads[j]
        wp = torch.zeros((n_pad, k_pad), dtype=torch.float32, device=device)
        wp[:n, :k] = mat.to(device=device, dtype=torch.float32)
        bounds = np.cumsum([0] + pass_widths(n_pad, cols)).tolist() if n_pad else [0]
        slices = [wp[c0:c1, k0:k0 + ks].reshape(c1 - c0, -1, 8).permute(1, 0, 2).reshape(-1)
                  for c0, c1 in zip(bounds[:-1], bounds[1:]) for k0 in range(0, k_pad, ks)]
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
    layout, zero-padded to the kernel width (:func:`kernel_width`)."""
    hp = kernel_width(mlp.hidden_dim)
    return _pack_wg(_dense_layers(mlp, hp), device, cols=wg_pass_cols(hp))


def pack_weights_bwd(mlp: NeRFMLP, device: torch.device,
                     input_grads: bool = False) -> KernelPack:
    """The matrices of :func:`pack_weights_bwd_wg` in the interleaved
    layout of :func:`pack_weights`."""
    return _pack(_bwd_layers(mlp, input_grads), device)


def _bwd_layers(mlp: NeRFMLP, input_grads: bool = False,
                hp: int | None = None) -> list[tuple[torch.Tensor, None]]:
    """The transposed matrices ``W`` (row = layer input column, k = layer
    output), of the model padded to ``hp`` hidden units where given: K2's
    cut to the hidden input columns, or with ``input_grads`` every input
    column."""
    mats = [wt.T for wt, _ in _dense_layers(mlp, hp)]
    if input_grads:
        return [(m, None) for m in mats]
    hid = hp or mlp.hidden_dim
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
    and the skip concats) and of the direction encodings (the branch); the
    x_enc part of each such layer padded to the products' ``kx`` columns,
    the d_enc part to ``kd`` (:func:`ig_cols`).  Padded to the kernel
    width as :func:`pack_weights_wg`."""
    hp = kernel_width(mlp.hidden_dim)
    layers = _bwd_layers(mlp, input_grads, hp)
    if not input_grads:
        return _pack_wg(layers, device, cols=wg_pass_cols(hp))
    check_encodings(mlp.l_xyz, mlp.l_dir)
    kx, kd, ks = ig_cols(mlp.xyz_dim, mlp.dir_dim)
    skip = lambda i: i > 0 and i % mlp.skip_layer == 0  # noqa: E731
    n_pads = ([kx] + [hp + kx if skip(i - 1) else hp for i in range(1, mlp.num_layers + 1)]
              + [hp + kd, hp // 2])
    return _pack_wg(layers, device, ks, n_pads)


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
# product chunk by chunk); about 66K samples at 8x256 (10,112 B each), 33K
# at 8x512 (19,840 B each) and 17K at 8x1024 (39,296 B each).
DW_CHUNK_BYTES = 640 << 20
DW_MAX_N = 272  # the widest layer of the 128-row tile's dW (csrc/nerf_dw.cuh: kDwMaxN)


def chunk_plan(b: int, s: int, bytes_per_sample: int,
               budget: int | None = None) -> list[tuple[int, int]]:
    """``[(first ray, rays)]``: the chunks of whole rays the backward walks
    in order.  Each chunk's workspace (its samples padded to 128 rows,
    ``bytes_per_sample`` each) fits ``budget`` (``DW_CHUNK_BYTES``) unless
    one ray alone does not; the last chunk may be short; one chunk when
    the batch fits."""
    budget = DW_CHUNK_BYTES if budget is None else budget
    rows = budget // bytes_per_sample // 128 * 128
    rays = max(1, rows // s)
    return [(r, min(rays, b - r)) for r in range(0, b, rays)]


# The split tile's dW product (csrc/nerf_dw.cuh: mlp_dw_window_kernel): a
# persistent walk over units of up to 128 rows of a layer's dW by up to
# DW_UNIT_N of its D columns and a sample range, computed in parts of
# DW_PART_N columns (the kernel's kDwPartN).  The sample ranges are those of
# the window tiles of DW_WIN_N columns that came before the walk
# (:func:`dw_tile_count`), so each element's sums stay theirs.
DW_UNIT_N, DW_PART_N, DW_WIN_N = 256, 128, 264


def dw_tile_count(layout: np.ndarray) -> int:
    """The window tiles of DW_WIN_N D columns by 128 rows that the split
    tile's dW product took before its walk (75 at 8x512, 286 at 8x1024):
    :func:`dw_splits` cuts the samples by their count."""
    return sum(-(-int(a_w) // 128) * -(-int(d_w) // DW_WIN_N) for _, a_w, _, d_w, _ in layout)


def dw_units(layout: np.ndarray, nsplit: int) -> np.ndarray:
    """The split tile's dW work: (units, 5) int32 rows ``layer, m0, n0,
    c_hi, y``, columns n0 .. n0 + c_hi of rows m0 .. m0 + 128 of a layer's
    dW over sample range y; every (range, layer, 128-row tile) with its
    columns cut from column 0 into runs of DW_UNIT_N (the last the rest),
    range by range, layer by layer."""
    units = [(li, m0, n0, min(DW_UNIT_N, d_w - n0), y) for y in range(nsplit)
             for li, (_, a_w, _, d_w, _) in enumerate(layout.tolist())
             for m0 in range(0, a_w, 128) for n0 in range(0, d_w, DW_UNIT_N)]
    return np.ascontiguousarray(np.array(units, dtype=np.int32).reshape(-1, 5))


def dw_schedule(units: np.ndarray, sms: int) -> list[list[tuple]]:
    """Each block's units, in order, on a persistent grid of at most ``sms``
    blocks.  A unit costs its parts of DW_PART_N columns, and the blocks'
    parts differ by at most one (block b gets floor(parts / blocks), one
    more for the first parts % blocks): the widest units first, each to the
    block with the most parts left to take (so in the first rounds block b
    takes the b-th unit of each round and the blocks stream the same stages
    at the same time), a unit wider than what its block has left cut
    between two parts, the rest to the next block."""
    cost = lambda u: -(-u[3] // DW_PART_N)  # noqa: E731
    queue = sorted(map(tuple, units.tolist()), key=lambda u: -cost(u))
    total = sum(map(cost, queue))
    blocks = max(1, min(sms, total))
    lists = [[] for _ in range(blocks)]
    heap = [(-(total // blocks + (b < total % blocks)), b) for b in range(blocks)]
    i = 0
    while i < len(queue):
        li, m0, n0, c_hi, y = queue[i]
        room, b = heapq.heappop(heap)
        cols = -room * DW_PART_N
        if c_hi <= cols:
            lists[b].append(queue[i])
            i += 1
        else:  # the first parts here, the rest to the next block
            lists[b].append((li, m0, n0, cols, y))
            queue[i] = (li, m0, n0 + cols, c_hi - cols, y)
        heapq.heappush(heap, (room + cost(lists[b][-1]), b))
    return lists


def dw_schedule_array(lists: list[list[tuple]]) -> np.ndarray:
    """:func:`dw_schedule` as the kernel reads it (csrc/nerf_dw.cuh:
    DwWinPlan.sched): the blocks' first units (blocks + 1 offsets, padded to
    a multiple of 4 ints), then each unit as ``layer | m0 << 8, n0, c_hi,
    y``."""
    starts = np.cumsum([0] + [len(mine) for mine in lists])
    pad = -len(starts) % 4
    words = [(li | m0 << 8, n0, c_hi, y) for mine in lists for li, m0, n0, c_hi, y in mine]
    return np.concatenate([starts, np.zeros(pad, dtype=np.int64),
                           np.array(words, dtype=np.int64).reshape(-1)]).astype(np.int32)


@functools.lru_cache(maxsize=64)
def _dw_sched(units: bytes, sms: int, device: torch.device) -> tuple:
    lists = dw_schedule(np.frombuffer(units, dtype=np.int32).reshape(-1, 5), sms)
    return torch.as_tensor(dw_schedule_array(lists), device=device), len(lists)


def dw_splits(tiles: int, sms: int, rows: int) -> int:
    """The sample ranges each dW tile's sums split into: about two waves
    of ``tiles`` blocks a range on ``sms`` SMs (one block an SM), no more
    than a range per 8 of the chunk's 64-sample stages (``rows`` / 64)."""
    return max(1, min(-(-2 * sms // tiles), rows // 64 // 8))


def _tiles(n: int, rows: int = 128) -> int:
    return -(-n // rows)


# The split tile's kernels (hidden above SPLIT_ABOVE: tiles of SPLIT_ROWS
# rows) run in clusters of CLUSTER blocks that share each weight stage
# (csrc/nerf_wgmlp.cuh: kSplitAbove, kCluster).
SPLIT_ABOVE, SPLIT_ROWS, CLUSTER = 256, 64, 2


def cluster_grid(tiles: int, sms: int) -> int:
    """The rows kernel's blocks on the split tile: whole clusters, at most
    one block per SM and no more than the first chunk's ``tiles`` rounded
    up to a cluster (the kernel's host code lowers it further to the
    clusters the card holds at once: ``nerf_wgmlp.cuh: split_grid``)."""
    return max(CLUSTER, min(-(-tiles // CLUSTER) * CLUSTER, sms // CLUSTER * CLUSTER))


def glob_bytes(hidden: int, num_layers: int, rows: bool) -> int:
    """The global scratch a block needs at kernel width ``hidden``
    (csrc/nerf_wgmlp.cuh: wg_glob_bytes): above PASS_COLS the park of the
    column passes (64 rows x every pass of a layer but the last, 768
    columns, bf16) and, for the rows kernel (``rows``), its ReLU bits and
    column-sum scratch; else none."""
    if hidden <= PASS_COLS:
        return 0
    park = 64 * (hidden - WG_PASS_COLS) * 2
    return park + 4 * (num_layers + 1) * 64 * (hidden // 32) + 4 * 2 * 4 * hidden if rows else park


def park_buffer(mlp: NeRFMLP, blocks: int, rows: bool, device: torch.device):
    """``blocks`` blocks' global scratch (:func:`glob_bytes`), or None
    where the kernel width needs none."""
    n = glob_bytes(kernel_width(mlp.hidden_dim), mlp.num_layers, rows)
    return torch.empty((blocks * n,), dtype=torch.uint8, device=device) if n else None


def cuda_error(rc: int) -> str:
    """A launch's error code in words; the split tile's kernels answer 912
    (cudaErrorInvalidClusterSize) when not one cluster can be scheduled."""
    if rc == 912:
        return (f"CUDA error {rc}: a cluster of {CLUSTER} blocks cannot be scheduled "
                f"(the split tile's kernels run only as clusters)")
    return f"CUDA error {rc}"


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
    units: np.ndarray | None  # the split tile's dW units (dw_units), else None

    @staticmethod
    def bytes_per_sample(fwd: KernelPack, bwd: KernelPack) -> int:
        layout = workspace_layout(fwd, bwd)
        return 2 * int(layout[:, 1].sum() + layout[:, 3].sum())

    @classmethod
    def allocate(cls, fwd: KernelPack, bwd: KernelPack, rows: int, nblk: int,
                 device: torch.device) -> "DwBuffers":
        """For ``rows`` workspace rows (a multiple of 64) and ``nblk``
        rows-kernel blocks.  The dW product's blocks are 128 rows of a
        layer by its d_width (csrc/nerf_dw.cuh), or on the split tile (a
        d_width above 272) the walk of :func:`dw_units` (whose parts read
        up to DW_UNIT_N x 64 elements past the last layer's D: slack); its
        64-row stages split into :func:`dw_splits` ranges."""
        layout = workspace_layout(fwd, bwd)
        a_cols, d_cols = int(layout[:, 1].sum()), int(layout[:, 3].sum())
        total_out = int((layout[:, 1] * layout[:, 3]).sum())
        total_b = fwd.b.numel()
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        split = int(layout[:, 3].max()) > DW_MAX_N
        if split:
            blocks, slack = dw_tile_count(layout), DW_UNIT_N * 64
        else:
            blocks, slack = int(sum(-(-int(a) // 128) for a in layout[:, 1])), 0
        nsplit = dw_splits(blocks, sms, rows)
        f32 = dict(dtype=torch.float32, device=device)
        return cls(
            layout=layout,
            ws_a=torch.empty((rows * a_cols,), dtype=torch.bfloat16, device=device),
            ws_d=torch.empty((rows * d_cols + slack,), dtype=torch.bfloat16, device=device),
            db_part=torch.empty((nblk * total_b,), **f32),
            dw_part=torch.empty((nsplit * total_out,), **f32),
            nsplit=nsplit,
            dw=torch.empty((total_out,), **f32),
            db=torch.empty((total_b,), **f32),
            units=dw_units(layout, nsplit) if split else None,
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
    kernel_route(mlp.compute_dtype, mlp.hidden_dim, "cuda")
    check_encodings(l_xyz, l_dir)
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


def is_f32(mlp: NeRFMLP) -> bool:
    """The f32 kernels (``fused_f32``) run ``mlp`` on CUDA
    (:func:`kernel_route`)."""
    return kernel_route(mlp.compute_dtype, mlp.hidden_dim, "cuda")[0] == "f32"


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
    # At hidden 1024 at most a block an SM, each walking groups of rays
    # with its own park (csrc/fused_render_fwd.cu).
    blocks = torch.cuda.get_device_properties(device).multi_processor_count // CLUSTER * CLUSTER
    park = park_buffer(mlp, blocks, False, device)
    rc = _build.load("fused_render_fwd").nkt_fused_render_fwd(
        _ptr(origins), _ptr(dirs), t_vals.data_ptr(), _ptr(x_in), _ptr(d_in),
        pack.w.data_ptr(), pack.b.data_ptr(), pack.desc.ctypes.data,
        pack.desc.shape[0], mlp.num_layers, mlp.skip_layer, kernel_width(mlp.hidden_dim),
        l_xyz, l_dir, b, s, rgb.data_ptr(), weights.data_ptr(), _ptr(x_enc), _ptr(preds),
        _ptr(park), blocks, device_index(device), torch.cuda.current_stream(device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"{'K6' if x_in is not None else 'K1'} launch failed with {cuda_error(rc)} "
            f"(B={b}, S={s}, hidden={mlp.hidden_dim}, layers={mlp.num_layers}, "
            f"residuals={emit_xenc}/{emit_preds})"
        )
    return rgb, weights, x_enc, preds


def launch_k1(mlp, origins, dirs, t_vals, l_xyz, l_dir, train: bool,
              emit_xenc: bool = True):
    """One K1 launch: ``(rgb, weights, x_enc, preds)``.  With ``train`` it
    writes the residuals: ``preds (B*S, 4) f32`` and, with ``emit_xenc``
    (K2's; K3 needs none), ``x_enc (B*S, 3+6L) bf16``; else they are
    None.  A float32 MLP runs the f32 K1 (``fused_f32.launch_k1``: f32
    x_enc, its own counters)."""
    global launches, train_launches
    if is_f32(mlp):
        return fused_f32.launch_k1(mlp, origins, dirs, t_vals, train, emit_xenc)
    out = _launch_fwd(mlp, t_vals, l_xyz, l_dir, origins=origins, dirs=dirs,
                      emit_xenc=train and emit_xenc, emit_preds=train)
    if t_vals.shape[0]:
        launches += 1
        train_launches += int(train)
    return out


def unpack_grads(mlp: NeRFMLP, fwd: KernelPack, layout: np.ndarray,
                  dw: torch.Tensor, db: torch.Tensor) -> list[torch.Tensor]:
    """A backward's flat dW/db (of the pack padded to the kernel width) ->
    gradients of the model's real shapes in ``mlp.parameters()`` order, as
    the JAX package returns them: weight gradients rounded to bf16 (the TPU
    kernel returns ``dv.astype(w.dtype)`` of bf16-cast weights), biases
    f32; the merged head's gradient split into feature and sigma."""
    bf = lambda g: g.to(torch.bfloat16).to(torch.float32)  # noqa: E731
    per_layer = []
    for (in_runs, out_runs, _, _), (_, _, _, _, b_off), (_, a_w, _, d_w, off) in zip(
            layer_runs(mlp, kernel_width(mlp.hidden_dim)), fwd.desc, layout):
        slab = dw[off:off + a_w * d_w].view(a_w, d_w)
        rows = _cat([slab[pi:pi + li] for _, pi, li in in_runs], 0)
        w = _cat([rows[:, po:po + lo] for _, po, lo in out_runs], 1)
        per_layer.append((w.T, _cat([db[b_off + po:b_off + po + lo] for _, po, lo in out_runs], 0)))
    return split_head_grads(mlp, per_layer, bf)


def split_head_grads(mlp: NeRFMLP, per_layer: list, cast) -> list[torch.Tensor]:
    """Per kernel layer ``(dW (out, in), db)`` -> ``mlp.parameters()``
    order (trunk..., sigma, feature, branch, rgb), the weight gradients
    through ``cast``."""
    grads = []
    for w, b in per_layer[:mlp.num_layers]:
        grads += [cast(w), b.clone()]
    (w_fs, b_fs), (w_br, b_br), (w_rgb, b_rgb) = per_layer[mlp.num_layers:]
    hid = mlp.hidden_dim
    grads += [cast(w_fs[hid:]), b_fs[hid:].clone(), cast(w_fs[:hid]), b_fs[:hid].clone()]
    grads += [cast(w_br), b_br.clone(), cast(w_rgb), b_rgb.clone()]
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
    check_encodings(l_xyz, l_dir)
    hp = kernel_width(mlp.hidden_dim)
    fwd = kernel_pack(mlp, device)
    bwd = kernel_pack_bwd(mlp, device, input_grads=dx is not None or dd is not None)
    plan = chunk_plan(b, s, DwBuffers.bytes_per_sample(fwd, bwd))
    chunk_rays = plan[0][1]
    rows = _tiles(chunk_rays * s) * 128
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    split = hp > SPLIT_ABOVE
    if split:
        grid = cluster_grid(_tiles(chunk_rays * s, SPLIT_ROWS), sms)
    else:
        grid = min(_tiles(chunk_rays * s), sms)
    # On the split tile each block has a second row of bias sums: its sums
    # of one launch (csrc/fused_render_bwd.cu: db_blk).
    ws = DwBuffers.allocate(fwd, bwd, rows, grid * (2 if split else 1), device)
    dpreds = g if k5 else torch.empty((n, 4), dtype=torch.float32, device=device)
    sched, dw_blocks = (None, 0) if ws.units is None else _dw_sched(ws.units.tobytes(), sms,
                                                                   device)
    stem = ROWS_LIBRARY.get(hp, "fused_render_bwd")
    rc = getattr(_build.load(stem), f"nkt_{stem}")(
        mode, _ptr(x_res), _ptr(origins), _ptr(dirs), _ptr(d_enc), _ptr(t_vals),
        _ptr(preds), _ptr(g_rgb), _ptr(g_w),
        fwd.w.data_ptr(), fwd.b.data_ptr(), fwd.desc.ctypes.data,
        bwd.w.data_ptr(), bwd.desc.ctypes.data, ws.layout.ctypes.data,
        fwd.desc.shape[0], mlp.num_layers, mlp.skip_layer, hp,
        l_xyz, l_dir, b, s, chunk_rays, ws.db.numel(), ws.dw.numel(), dpreds.data_ptr(),
        ws.ws_a.data_ptr(), ws.ws_d.data_ptr(), ws.db_part.data_ptr(), grid,
        ws.dw_part.data_ptr(), ws.nsplit,
        _ptr(sched), dw_blocks,
        ws.dw.data_ptr(), ws.db.data_ptr(),
        _ptr(dx), _ptr(dd), _ptr(park_buffer(mlp, grid, True, device)), device_index(device),
        torch.cuda.current_stream(device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"{('K2', 'K3', 'K6 backward', 'K5 backward')[mode]} launch failed with "
            f"{cuda_error(rc)} (B={b}, S={s}, hidden={mlp.hidden_dim} as {hp}, layers="
            f"{mlp.num_layers}, chunks of {chunk_rays} rays, input grads={dx is not None}/"
            f"{dd is not None})"
        )
    return fwd, ws


def launch_k2(mlp, x_enc, dirs, t_vals, preds, g_rgb, g_w, l_xyz, l_dir):
    """One K2 launch: gradients in ``mlp.parameters()`` order (the f32 K2
    for a float32 MLP)."""
    global bwd_launches
    if is_f32(mlp):
        return fused_f32.launch_k2(mlp, x_enc, dirs, t_vals, preds, g_rgb, g_w)
    fwd, ws = launch_rows(_ROWS_K2, mlp, t_vals, preds, g_rgb, g_w, l_xyz, l_dir,
                          x_res=x_enc, dirs=dirs)
    bwd_launches += 1
    return unpack_grads(mlp, fwd, ws.layout, ws.dw, ws.db)


def launch_k3(mlp, origins, dirs, t_vals, preds, g_rgb, g_w, l_xyz, l_dir):
    """One K3 launch (K2 with the position encodings computed again from
    the rays): gradients in ``mlp.parameters()`` order (the f32 K3 for a
    float32 MLP)."""
    global recompute_launches
    if is_f32(mlp):
        return fused_f32.launch_k3(mlp, origins, dirs, t_vals, preds, g_rgb, g_w)
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
    the kernels (:func:`kernel_route`: the wgmma kernels for a bf16 MLP,
    the f32 ones for a float32 MLP) or raise.
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
    kernel_route(mlp.compute_dtype, mlp.hidden_dim, "cuda")
    check_encodings(mlp.l_xyz, mlp.l_dir)
    if t_vals.dim() != 2:
        raise ValueError(f"t_vals must be (B, S), got {tuple(t_vals.shape)}")
    b, s = t_vals.shape
    dt = mlp.compute_dtype
    check_tensor("x_enc", x_enc, (b, s, mlp.xyz_dim), device, dt)
    check_tensor("d_enc", d_enc, (b, s, mlp.dir_dim), device, dt)
    check_tensor("t_vals", t_vals, (b, s), device)
    for p in mlp.parameters():
        if p.device != device:
            raise ValueError(f"MLP parameters are on {p.device}, encodings on {device}")


def launch_k6_fwd(mlp, x_enc, d_enc, t_vals, train: bool):
    """One K6 forward launch over ``(B, S, .)`` encodings in the compute
    dtype: ``(rgb, weights, preds)``, ``preds (B*S, 4) f32`` with
    ``train`` (K6's backward reads them), else None."""
    global enc_launches
    _check_enc_call(mlp, x_enc, d_enc, t_vals)
    if is_f32(mlp):
        return fused_f32.launch_k6_fwd(mlp, x_enc, d_enc, t_vals, train)
    rgb, weights, _, preds = _launch_fwd(mlp, t_vals, mlp.l_xyz, mlp.l_dir,
                                         x_in=x_enc, d_in=d_enc, emit_preds=train)
    if t_vals.shape[0]:
        enc_launches += 1
    return rgb, weights, preds


def launch_k6_bwd(mlp, x_enc, d_enc, t_vals, preds, g_rgb):
    """One K6 backward launch: gradients in ``mlp.parameters()`` order
    (none for the encodings, as in the JAX kernel)."""
    global enc_bwd_launches
    if is_f32(mlp):
        return fused_f32.launch_k6_bwd(mlp, x_enc, d_enc, t_vals, preds, g_rgb)
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
    L_XYZ)`` and ``d_enc (B, S, 3+6 L_DIR)`` (per sample; in the compute dtype on CUDA),
    ``t_vals (B, S)`` ascending -> ``(rgb (B, 3), weights (B, S))``
    float32.  rgb is differentiable in the MLP's parameters; the weights
    and the encodings get no gradient, as in the JAX
    ``apply_nerf_render_pallas``.

    CPU tensors take :func:`apply_nerf_render_reference`.  CUDA tensors
    launch the kernels (:func:`kernel_route`) or raise.
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
