"""K4, the int8 ray megakernel (forward only).

Counterpart of ``render_rays_fused_quant`` in
``nerf_keras_tpu/ops/pallas/quant_render.py``: raw rays -> points -> f32
encode -> the int8 MLP of ``ops/quant.py`` -> compositing, with the MLP's
products int8 x int8 -> int32.  The CUDA kernel is
``csrc/quant_render_fwd.cu``, on Hopper's int8 ``wgmma`` (weights in
:func:`pack_qparams`'s layout); its source note says what bounds it and
how the design answers.

* :func:`render_rays_reference_quant` is the plain PyTorch K4:
  ``sample_rays`` -> ``encode_position`` (f32) -> ``apply_nerf_mlp_quant``
  -> ``volume_render``.
* :func:`render_rays_fused_quant` takes the plain version for a tensor on
  the CPU, and only then.  For a CUDA tensor it launches K4 or raises;
  nothing falls back.  Each launch adds one to :data:`launches`.

No gradients: quantization is inference-only.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import torch

from nerf_keras_tpu_torch.ops.encoding import encode_position
from nerf_keras_tpu_torch.ops.kernels import _build
from nerf_keras_tpu_torch.ops.kernels.fused_render import (
    check_encodings,
    check_tensor,
    cuda_error,
    device_index,
    kernel_width,
    layer_runs,
    pass_widths,
)
from nerf_keras_tpu_torch.ops.quant import QuantParams, apply_nerf_mlp_quant, flatten_qparams
from nerf_keras_tpu_torch.ops.rays import sample_rays
from nerf_keras_tpu_torch.ops.volume import volume_render

launches = 0  # K4 launches in this process (one per successful launch)

# k per slice of the pack (csrc/quant_render_fwd.cu: kQKs, the k per weight
# stage up to hidden 256; hidden 512 and 1024 stream 64-deep stages of the
# same pack, whose layout does not depend on the slice depth: q_layout)
K4_KS = 128
K4_HIDDEN = (32, 64, 128, 256, 512, 1024)  # its instantiations (quant_render_fwd.cu:
# q_hidden_ok); a model of another width up to 1024 runs zero-padded to the
# next (pad_qparams)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def q_layout(n_pad: int, k_pad: int) -> np.ndarray:
    """Where element ``(n, k)`` of a padded ``(n_pad, k_pad)`` int8 matrix
    lies in K4's pack, as an ``(n_pad, k_pad)`` array of byte offsets: each
    column pass (``fused_render.pass_widths``: all of it up to 520 columns)
    a block of its own, ``k_pad * c0`` from the start for the pass from
    column ``c0``, ``w`` wide, in k-slices of ``K4_KS`` (the last a multiple
    of 32 up to it), each in wgmma's K-major core-matrix layout with 16 k
    per 16-byte row, ``slice_start + ((k % K4_KS) // 16 * w + n - c0) * 16
    + k % 16``."""
    out = np.empty((n_pad, k_pad), dtype=np.int64)
    k = np.arange(k_pad)[None, :]
    c0 = 0
    for w in pass_widths(n_pad):
        n = np.arange(w)[:, None]
        out[c0:c0 + w] = (k_pad * c0 + (k // K4_KS) * K4_KS * w
                          + ((k % K4_KS) // 16 * w + n) * 16 + k % 16)
        c0 += w
    return out


class QuantPack(NamedTuple):
    """One MLP's qparams as K4 reads them."""

    w: torch.Tensor     # int8, every layer's padded W^T in :func:`q_layout`
    f: torch.Tensor     # f32, per layer scale, bias, inv rows (n_pad each); inv_x; inv_d
    desc: np.ndarray    # int32 (n_dense, 5): k_pad, n, n_pad, w_off, f_off
    x_off: int          # inv_x in f (padded to 32 with zeros)
    d_off: int          # inv_d in f (padded to 32 with zeros), the last row


def _layers(qp: QuantParams) -> list[tuple]:
    """``(wq (in, out), scale, b, inv or None)`` per kernel layer: the
    trunk, the merged feature+sigma head (its inv row covers the feature
    columns; sigma's slot stays 0), branch, rgb."""
    layers = [(lyr["wq"], lyr["scale"], lyr["b"], inv)
              for lyr, inv in zip(qp["trunk"], qp["inv_h"])]
    layers.append((qp["fs"]["wq"], qp["fs"]["scale"], qp["fs"]["b"], qp["inv_feat"]))
    layers.append((qp["branch"]["wq"], qp["branch"]["scale"], qp["branch"]["b"],
                   qp["inv_h2"]))
    layers.append((qp["rgb"]["wq"], qp["rgb"]["scale"], qp["rgb"]["b"], None))
    return layers


def pad_qparams(qp: QuantParams, skip_layer: int, hq: int) -> QuantParams:
    """One MLP's qparams zero-padded to ``hq`` hidden units, by
    ``fused_render.layer_runs`` (the skip layer's and the head's x_enc
    rows, the branch's d_enc rows and sigma's column move to ``hq``).  A
    padded column has weights 0, bias 0, scale 1 and requant ``inv`` 1:
    its accumulator is 0, it dequantizes to 0 and quantizes to 0, and no
    scale is 0 or NaN.  ``qp`` itself when it already has ``hq`` units."""
    hid = qp["trunk"][0]["wq"].shape[1]
    if hid == hq:
        return qp
    shape = SimpleNamespace(hidden_dim=hid, num_layers=len(qp["trunk"]), skip_layer=skip_layer,
                            xyz_dim=qp["inv_x"].numel(), dir_dim=qp["inv_d"].numel())

    def row(x, runs, n, fill):
        out = torch.full((1, n), fill, dtype=torch.float32, device=x.device)
        for ro, po, lo in runs:
            out[0, po:po + lo] = x.reshape(-1)[ro:ro + lo]
        return out

    dense = []
    for (wq, scale, b, _), (in_runs, out_runs, k, n) in zip(_layers(qp), layer_runs(shape, hq)):
        wp = torch.zeros((k, n), dtype=torch.int8, device=wq.device)
        for ro, po, lo in out_runs:
            for ri, pi, li in in_runs:
                wp[pi:pi + li, po:po + lo] = wq[ri:ri + li, ro:ro + lo]
        dense.append({"wq": wp, "scale": row(scale, out_runs, n, 1.0),
                      "b": row(b, out_runs, n, 0.0)})
    nl = len(qp["trunk"])
    inv = lambda x, n: row(x, ((0, 0, x.numel()),), n, 1.0)  # noqa: E731
    return {"trunk": dense[:nl], "inv_h": [inv(x, hq) for x in qp["inv_h"]],
            "fs": dense[nl], "inv_feat": inv(qp["inv_feat"], hq),
            "branch": dense[nl + 1], "inv_h2": inv(qp["inv_h2"], hq // 2),
            "rgb": dense[nl + 2], "inv_x": qp["inv_x"], "inv_d": qp["inv_d"]}


def _padded_row(x: torch.Tensor, width: int, device) -> torch.Tensor:
    row = torch.zeros((width,), dtype=torch.float32, device=device)
    row[:x.numel()] = x.reshape(-1).to(device=device, dtype=torch.float32)
    return row


@torch.no_grad()
def pack_qparams(qp: QuantParams, device: torch.device) -> QuantPack:
    """Pad each layer to (round8 outputs, round32 inputs), transpose to one
    row per output column and lay it out for K4's wgmma
    (:func:`q_layout`): the producer copies one k-slice of a column pass per
    shared-memory stage, which the descriptor reads as is.  Gather the f32 rows.  Raises
    ``ValueError`` for a weight of -128: the kernel's exact dequantization
    takes |acc| <= k * 127^2."""
    ws, fs, desc = [], [], []
    w_off = f_off = 0
    for wq, scale, b, inv in _layers(qp):
        if bool((wq == -128).any()):
            raise ValueError("int8 weights must lie in [-127, 127] (quantize_mlp's range)")
        k, n = wq.shape
        k_pad, n_pad = _round_up(k, 32), _round_up(n, 8)
        wp = torch.zeros((n_pad, k_pad), dtype=torch.int8, device=device)
        wp[:n, :k] = wq.T.to(device)
        bounds = np.cumsum([0] + pass_widths(n_pad)).tolist()
        ws += [wp[c0:c1, k0:k0 + K4_KS].reshape(c1 - c0, -1, 16).permute(1, 0, 2).reshape(-1)
               for c0, c1 in zip(bounds[:-1], bounds[1:]) for k0 in range(0, k_pad, K4_KS)]
        rows = [_padded_row(scale, n_pad, device), _padded_row(b, n_pad, device),
                _padded_row(inv if inv is not None else torch.zeros(0), n_pad, device)]
        fs += rows
        desc.append((k_pad, n, n_pad, w_off, f_off))
        w_off += n_pad * k_pad
        f_off += 3 * n_pad
    x_off = f_off
    fs.append(_padded_row(qp["inv_x"], _round_up(qp["inv_x"].numel(), 32), device))
    d_off = x_off + fs[-1].numel()
    fs.append(_padded_row(qp["inv_d"], _round_up(qp["inv_d"].numel(), 32), device))
    return QuantPack(
        w=torch.cat(ws).contiguous(), f=torch.cat(fs).contiguous(),
        desc=np.ascontiguousarray(np.asarray(desc, dtype=np.int32)),
        x_off=x_off, d_off=d_off,
    )


# Packs by id(qparams), built once per installed set of qparams (a tensor
# written in place or replaced, or another device, builds a new one).  An
# entry holds its qparams, so an id is never reused while it is cached.
_packs: dict[int, tuple] = {}
_MAX_PACKS = 8


def kernel_pack(qp: QuantParams, device: torch.device, skip_layer: int = 4) -> QuantPack:
    """K4's pack of ``qp``, zero-padded to its instantiation (``K4_HIDDEN``)
    by :func:`pad_qparams`, built once per installed set of qparams."""
    key = (str(device), skip_layer,
           tuple((t.data_ptr(), t._version) for t in flatten_qparams(qp)))
    hit = _packs.get(id(qp))
    if hit is None or hit[0] is not qp or hit[1] != key:
        _packs.pop(id(qp), None)
        if len(_packs) >= _MAX_PACKS:
            _packs.pop(next(iter(_packs)))
        hq = kernel_width(qp["trunk"][0]["wq"].shape[1], K4_HIDDEN)
        hit = (qp, key, pack_qparams(pad_qparams(qp, skip_layer, hq), device))
        _packs[id(qp)] = hit
    return hit[2]


def _check_widths(qp: QuantParams, l_xyz: int, l_dir: int) -> None:
    widths = (qp["inv_x"].numel(), qp["inv_d"].numel())
    if widths != (3 + 6 * l_xyz, 3 + 6 * l_dir):
        raise ValueError(
            f"l_xyz/l_dir = {(l_xyz, l_dir)} do not match the qparams' encoding "
            f"widths {widths}"
        )


def render_rays_reference_quant(
    qparams: QuantParams,
    origins: torch.Tensor,
    dirs: torch.Tensor,
    t_vals: torch.Tensor,
    *,
    l_xyz: int = 10,
    l_dir: int = 4,
    skip_layer: int = 4,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K4: ``(rgb (B, 3), weights (B, S))`` float32."""
    _check_widths(qparams, l_xyz, l_dir)
    points, dirs_s = sample_rays(origins, dirs, t_vals)
    x_enc = encode_position(points, l_xyz)
    d_enc = encode_position(dirs_s, l_dir)
    preds = apply_nerf_mlp_quant(qparams, x_enc, d_enc, skip_layer=skip_layer)
    rgb, _, weights = volume_render(preds, t_vals)
    return rgb, weights


def launch_k4(qparams: QuantParams, origins, dirs, t_vals, l_xyz: int, l_dir: int,
              skip_layer: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One K4 launch on the caller's stream: ``(rgb, weights)``."""
    global launches
    device = origins.device
    if device.type != "cuda":
        raise ValueError(f"K4 runs on cuda or cpu tensors, got {device}")
    _check_widths(qparams, l_xyz, l_dir)
    check_encodings(l_xyz, l_dir)
    hidden = kernel_width(qparams["trunk"][0]["wq"].shape[1], K4_HIDDEN)
    if t_vals.dim() != 2:
        raise ValueError(f"t_vals must be (B, S), got {tuple(t_vals.shape)}")
    b, s = t_vals.shape
    check_tensor("origins", origins, (b, 3), device)
    check_tensor("dirs", dirs, (b, 3), device)
    check_tensor("t_vals", t_vals, (b, s), device)
    for t in flatten_qparams(qparams):
        if t.device != device:
            raise ValueError(f"qparams are on {t.device}, rays on {device}")
    rgb = torch.empty((b, 3), dtype=torch.float32, device=device)
    weights = torch.empty((b, s), dtype=torch.float32, device=device)
    if b == 0:
        return rgb, weights
    pack = kernel_pack(qparams, device, skip_layer)
    num_layers = len(qparams["trunk"])
    rc = _build.load("quant_render_fwd").nkt_quant_render_fwd(
        origins.data_ptr(), dirs.data_ptr(), t_vals.data_ptr(),
        pack.w.data_ptr(), pack.f.data_ptr(), pack.desc.ctypes.data,
        pack.desc.shape[0], num_layers, skip_layer, hidden, l_xyz, l_dir,
        pack.x_off, pack.d_off, b, s, rgb.data_ptr(), weights.data_ptr(),
        device_index(device), torch.cuda.current_stream(device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"K4 launch failed with {cuda_error(rc)} (B={b}, S={s}, hidden={hidden}, "
            f"layers={num_layers})"
        )
    launches += 1
    return rgb, weights


@torch.no_grad()
def render_rays_fused_quant(
    qparams: QuantParams,
    origins: torch.Tensor,
    directions: torch.Tensor,
    t_vals: torch.Tensor,
    *,
    l_xyz: int = 10,
    l_dir: int = 4,
    skip_layer: int = 4,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K4 over raw rays: one MLP's ``qparams`` (``ops/quant.quantize_mlp``),
    ``origins``/``directions`` ``(B, 3)``, ``t_vals`` ``(B, S)`` ascending
    -> ``(rgb (B, 3), weights (B, S))`` float32.

    CPU tensors take :func:`render_rays_reference_quant`; CUDA tensors
    launch K4 or raise."""
    kw = dict(l_xyz=l_xyz, l_dir=l_dir, skip_layer=skip_layer)
    if origins.device.type == "cpu":
        return render_rays_reference_quant(qparams, origins, directions, t_vals, **kw)
    return launch_k4(qparams, origins, directions, t_vals, **kw)
