"""Post-training int8 quantization for NeRF MLP inference.

Counterpart of ``nerf_keras_tpu/ops/quant.py``; the scheme is the JAX
package's, so its qparams and these share one layout
(:func:`qparams_from_jax` carries them across):

* **Activations**: symmetric int8 with calibrated, static, per-column
  scales, ``q = round(x * 127 / cal[c])`` clipped to [-127, 127], where
  ``cal`` is the column abs-max over a calibration batch.  Rounding is
  half to even (``torch.round``, as ``jnp.round``).
* **Weights**: the per-column input scales are folded into the weight
  rows, ``V[k, j] = cal_in[k] / 127 * W[k, j]``, then quantized per
  output channel (``s[j] = max_k |V[k, j]| / 127``).  The integer product
  dequantizes with one per-column multiply and the bias:
  ``y = float(acc) * s + b``, two roundings.
* **Concats** (``[hq | qx]`` after a skip layer, ``[qfeat | qd]`` into the
  branch) carry heterogeneous per-column scales, which the row folding
  absorbs: the int8 tensors are concatenated as they are.
* The feature and sigma heads are merged into one ``fs`` dense (feature
  columns first, sigma last); the feature is signed and linear (no relu)
  and is requantized for the branch, sigma stays float32.

The integer products of the plain path (:func:`_qdot`) run on int-valued
float tensors, exactly: float32 while ``K * 127^2 < 2^24`` (every width
the repo ships), float64 beyond.  A torch matmul of int8 tensors would
return int8 and wrap.  TF32 is off (``runtime.py``), so the float32
products are exact.

Calibration runs the float MLP in true float32 on the JAX-layout trees
(``{'trunk': [{'w', 'b'}...], 'sigma', 'feature', 'branch', 'rgb'}``,
``w`` as ``(in, out)``), numpy arrays or tensors.  K4, the int8 ray
megakernel, is ``ops/kernels/quant_render.py``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from nerf_keras_tpu_torch.models.mlp import NeRFMLP, is_skip
from nerf_keras_tpu_torch.ops.encoding import encode_position
from nerf_keras_tpu_torch.ops.rays import sample_rays
from nerf_keras_tpu_torch.ops.sampling import generate_t_vals, sample_pdf, sorted_union
from nerf_keras_tpu_torch.ops.volume import volume_render

QMAX = 127.0
# Dead-channel floor for calibrated abs-maxes: a column that never fires in
# calibration would otherwise yield a 0 scale and NaNs.
_CAL_FLOOR = 1e-8

QuantParams = dict[str, Any]


def quantize_activation(x: torch.Tensor, inv_scale: torch.Tensor) -> torch.Tensor:
    """``round(x * inv_scale)`` (half to even) clipped to [-127, 127], as
    int8; ``inv_scale`` is a ``(1, dim)`` row of ``127 / cal``."""
    return torch.clamp(torch.round(x * inv_scale), -QMAX, QMAX).to(torch.int8)


def _qdot(a: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """The exact integer product of int8 ``a (N, K)`` and ``wq (K, M)``,
    as a float32 tensor of integer values (|acc| <= 127^2 K)."""
    k = a.shape[-1]
    dt = torch.float32 if k * 127 * 127 < 2 ** 24 else torch.float64
    return (a.to(dt) @ wq.to(dt)).to(torch.float32)


def _t(x, device=None) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                           device=device)


def mlp_tree(mlp: NeRFMLP) -> dict:
    """A NeRF MLP's parameters as a JAX-layout tree of tensors on its
    device (``w`` as ``(in, out)`` views, no copies)."""
    def dense(layer):
        return {"w": layer.weight.detach().T, "b": layer.bias.detach()}

    tree = {"trunk": [dense(layer) for layer in mlp.trunk]}
    tree.update({k: dense(layer) for k, layer in mlp.heads().items()})
    return tree


def _dense_f32(x: torch.Tensor, layer: dict) -> torch.Tensor:
    """The calibration path's dense in true float32."""
    w = _t(layer["w"], x.device).to(torch.float32)
    b = _t(layer["b"], x.device).to(torch.float32)
    return x @ w + b


def _forward_f32(params: dict, x_enc: torch.Tensor, d_enc: torch.Tensor,
                 skip_layer: int) -> tuple[torch.Tensor, dict]:
    """The float32 MLP on flat encodings: raw ``(N, 4)`` predictions and
    the operands the int8 path quantizes (each trunk layer's post-relu
    output, the linear feature, the branch's post-relu output)."""
    x = x_enc
    hs = []
    for i, layer in enumerate(params["trunk"]):
        h = torch.relu(_dense_f32(x, layer))
        hs.append(h)
        x = torch.cat([h, x_enc], dim=-1) if is_skip(i, skip_layer) else h
    feat = _dense_f32(x, params["feature"])
    sigma = _dense_f32(x, params["sigma"])
    h2 = torch.relu(_dense_f32(torch.cat([feat, d_enc], dim=-1), params["branch"]))
    rgb = _dense_f32(h2, params["rgb"])
    return torch.cat([rgb, sigma], dim=-1), {"h": hs, "feat": feat, "h2": h2}


def _col_absmax(x: torch.Tensor) -> torch.Tensor:
    return torch.amax(torch.abs(x), dim=0)


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1]).to(torch.float32)


def mlp_calibration_absmax(params: dict, x_enc, d_enc, skip_layer: int = 4) -> dict:
    """Per-column abs-max of every quantized operand of one MLP:
    ``{'x_enc', 'd_enc', 'h': [per trunk layer], 'feat', 'h2'}`` float32
    vectors, from the float32 forward on ``x_enc``/``d_enc`` (any leading
    shape).  Chunked calibration folds calls with :func:`merge_absmax`."""
    x_enc, d_enc = _flat(_t(x_enc)), _flat(_t(d_enc))
    _, acts = _forward_f32(params, x_enc, d_enc, skip_layer)
    return {
        "x_enc": _col_absmax(x_enc), "d_enc": _col_absmax(d_enc),
        "h": [_col_absmax(h) for h in acts["h"]],
        "feat": _col_absmax(acts["feat"]), "h2": _col_absmax(acts["h2"]),
    }


def merge_absmax(a, b):
    """Elementwise max of two calibration-stat trees."""
    if isinstance(a, dict):
        return {k: merge_absmax(a[k], b[k]) for k in a}
    if isinstance(a, list):
        return [merge_absmax(x, y) for x, y in zip(a, b)]
    return torch.maximum(a, b)


def _floor_cal(c: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(c, _CAL_FLOOR)


def _quantize_dense(w, b, cal_in: torch.Tensor) -> dict:
    """Fold the per-row input scales into ``w (in, out)``, then quantize
    per output column: ``{'wq' int8 (in, out), 'scale', 'b' (1, out)}``."""
    dev = cal_in.device
    w = _t(w, dev).to(torch.float32)
    v = w * (_floor_cal(cal_in)[:, None] / QMAX)
    s = torch.clamp_min(torch.amax(torch.abs(v), dim=0), _CAL_FLOOR) / QMAX
    wq = torch.clamp(torch.round(v / s), -QMAX, QMAX).to(torch.int8)
    return {"wq": wq, "scale": s.reshape(1, -1),
            "b": _t(b, dev).to(torch.float32).reshape(1, -1)}


def _inv_row(cal: torch.Tensor) -> torch.Tensor:
    return (QMAX / _floor_cal(cal)).reshape(1, -1)


def quantize_mlp(params: dict, stats: dict, skip_layer: int = 4) -> QuantParams:
    """int8 inference parameters of one NeRF MLP: per trunk layer ``wq``,
    ``scale``, ``b`` and the requant row ``inv_h``; the merged ``fs`` head
    with ``inv_feat``; the branch with ``inv_h2``; the rgb head; ``inv_x``
    and ``inv_d`` for the encodings."""
    num_layers = len(params["trunk"])
    cal_x, cal_d = stats["x_enc"], stats["d_enc"]
    qp: QuantParams = {"inv_x": _inv_row(cal_x), "inv_d": _inv_row(cal_d)}
    trunk, inv_h = [], []
    for i, layer in enumerate(params["trunk"]):
        if i == 0:
            cal_in = cal_x
        elif is_skip(i - 1, skip_layer):
            cal_in = torch.cat([stats["h"][i - 1], cal_x])
        else:
            cal_in = stats["h"][i - 1]
        trunk.append(_quantize_dense(layer["w"], layer["b"], cal_in))
        inv_h.append(_inv_row(stats["h"][i]))
    qp["trunk"], qp["inv_h"] = trunk, inv_h
    last = num_layers - 1
    cal_last = (torch.cat([stats["h"][last], cal_x]) if is_skip(last, skip_layer)
                else stats["h"][last])
    dev = cal_x.device
    w_fs = torch.cat([_t(params["feature"]["w"], dev), _t(params["sigma"]["w"], dev)], dim=-1)
    b_fs = torch.cat([_t(params["feature"]["b"], dev), _t(params["sigma"]["b"], dev)], dim=-1)
    qp["fs"] = _quantize_dense(w_fs, b_fs, cal_last)
    qp["inv_feat"] = _inv_row(stats["feat"])
    qp["branch"] = _quantize_dense(params["branch"]["w"], params["branch"]["b"],
                                   torch.cat([stats["feat"], cal_d]))
    qp["inv_h2"] = _inv_row(stats["h2"])
    qp["rgb"] = _quantize_dense(params["rgb"]["w"], params["rgb"]["b"], stats["h2"])
    return qp


class _QPIdx:
    """Positional layout of :func:`flatten_qparams`: per trunk layer
    (wq, scale, b, inv_h), then fs (wq, scale, b) + inv_feat, branch
    (wq, scale, b) + inv_h2, rgb (wq, scale, b), inv_x, inv_d."""

    def __init__(self, num_layers: int):
        base = 4 * num_layers
        self.fs_wq, self.fs_scale, self.fs_b = base, base + 1, base + 2
        self.inv_feat = base + 3
        self.br_wq, self.br_scale, self.br_b = base + 4, base + 5, base + 6
        self.inv_h2 = base + 7
        self.rgb_wq, self.rgb_scale, self.rgb_b = base + 8, base + 9, base + 10
        self.inv_x = base + 11
        self.inv_d = base + 12

    @staticmethod
    def trunk(i: int) -> tuple[int, int, int, int]:
        """(wq, scale, b, inv_h) of trunk layer ``i``."""
        return 4 * i, 4 * i + 1, 4 * i + 2, 4 * i + 3


def n_flat_qparams(num_layers: int) -> int:
    return 4 * num_layers + 13


def flatten_qparams(qp: QuantParams) -> list[torch.Tensor]:
    """The deterministic flat order of :class:`_QPIdx`."""
    flat: list[torch.Tensor] = []
    for i, lyr in enumerate(qp["trunk"]):
        flat += [lyr["wq"], lyr["scale"], lyr["b"], qp["inv_h"][i]]
    flat += [qp["fs"]["wq"], qp["fs"]["scale"], qp["fs"]["b"], qp["inv_feat"]]
    flat += [qp["branch"]["wq"], qp["branch"]["scale"], qp["branch"]["b"], qp["inv_h2"]]
    flat += [qp["rgb"]["wq"], qp["rgb"]["scale"], qp["rgb"]["b"]]
    flat += [qp["inv_x"], qp["inv_d"]]
    return flat


def quant_forward_tile(qp_flat: list, num_layers: int, skip_layer: int,
                       x_enc: torch.Tensor, qd: torch.Tensor) -> torch.Tensor:
    """The int8 MLP on ``(T, xyz)`` float32 encodings and ``(T, dir)``
    int8 directions: ``(T, 4)`` float32 ``[rgb_logits, sigma]``."""
    idx = _QPIdx(num_layers)

    def dense(a, wq, scale, b):
        return _qdot(a, qp_flat[wq]) * qp_flat[scale] + qp_flat[b]

    hidden = qp_flat[0].shape[1]
    qx = quantize_activation(x_enc, qp_flat[idx.inv_x])
    x = qx
    for i in range(num_layers):
        wq, scale, b, inv = _QPIdx.trunk(i)
        hq = quantize_activation(torch.relu(dense(x, wq, scale, b)), qp_flat[inv])
        x = torch.cat([hq, qx], dim=-1) if is_skip(i, skip_layer) else hq
    fs = dense(x, idx.fs_wq, idx.fs_scale, idx.fs_b)
    feat, sigma = fs[:, :hidden], fs[:, hidden:]
    qfeat = quantize_activation(feat, qp_flat[idx.inv_feat])
    h2 = torch.relu(dense(torch.cat([qfeat, qd], dim=-1), idx.br_wq, idx.br_scale, idx.br_b))
    qh2 = quantize_activation(h2, qp_flat[idx.inv_h2])
    rgb = dense(qh2, idx.rgb_wq, idx.rgb_scale, idx.rgb_b)
    return torch.cat([rgb, sigma], dim=-1)


def apply_nerf_mlp_quant(qp: QuantParams, x_enc: torch.Tensor, d_enc: torch.Tensor,
                         skip_layer: int = 4) -> torch.Tensor:
    """The plain int8 forward on encodings of any leading shape:
    ``(..., 4)`` float32."""
    lead = x_enc.shape[:-1]
    qd = quantize_activation(_flat(d_enc), qp["inv_d"])
    preds = quant_forward_tile(flatten_qparams(qp), len(qp["trunk"]), skip_layer,
                               _flat(x_enc), qd)
    return preds.reshape(*lead, 4)


def _rays(origins, directions) -> tuple[torch.Tensor, torch.Tensor]:
    return (_t(origins).to(torch.float32).reshape(-1, 3),
            _t(directions).to(torch.float32).reshape(-1, 3))


def _encodings(cfg, origins, directions, t_vals):
    points, dirs = sample_rays(origins, directions, t_vals)
    return encode_position(points, cfg.l_xyz), encode_position(dirs, cfg.l_dir)


def calibrate_render(params: dict, cfg, near: float, far: float,
                     origins, directions) -> dict:
    """Calibration stats of the coarse and fine MLPs along real rays, as
    the deterministic render places samples: the coarse pass at centred
    t-values, the fine pass at the t-union its float coarse pass gives
    (midpoint inverse-CDF draws).  ``params``: ``{'coarse', 'fine'}``
    JAX-layout trees; ``origins``/``directions``: ``(N, 3)`` calibration
    rays.  Returns ``{'coarse': stats, 'fine': stats}``."""
    origins, directions = _rays(origins, directions)
    t_vals = generate_t_vals(near, far, (origins.shape[0],), cfg.ns_coarse, "center",
                             device=origins.device)
    x_enc, d_enc = _encodings(cfg, origins, directions, t_vals)
    stats_c = mlp_calibration_absmax(params["coarse"], x_enc, d_enc, cfg.skip_layer)
    preds_c, _ = _forward_f32(params["coarse"], _flat(x_enc), _flat(d_enc), cfg.skip_layer)
    _, _, weights_c = volume_render(preds_c.reshape(*t_vals.shape, 4), t_vals)
    t_mid = 0.5 * (t_vals[..., 1:] + t_vals[..., :-1])
    t_fine = sample_pdf(t_mid, weights_c, cfg.ns_fine, deterministic=True)
    t_all = sorted_union(t_vals, t_fine)
    xf_enc, df_enc = _encodings(cfg, origins, directions, t_all)
    stats_f = mlp_calibration_absmax(params["fine"], xf_enc, df_enc, cfg.skip_layer)
    return {"coarse": stats_c, "fine": stats_f}


def calibrate_render_proposal(params: dict, cfg, near: float, far: float,
                              origins, directions) -> dict:
    """Calibration stats for a ``TRAIN_SAMPLER=proposal`` model: the fine
    MLP at the t-union the float proposal chain places.  ``params``:
    ``{'proposal': the port's proposal module, 'fine': JAX-layout tree}``.
    The proposal nets stay float.  Returns ``{'fine': stats}``."""
    from nerf_keras_tpu_torch.ops.proposal import make_chain_sampler

    origins, directions = _rays(origins, directions)
    t_vals = generate_t_vals(near, far, (origins.shape[0],), cfg.ns_coarse, "center",
                             device=origins.device)
    chain = make_chain_sampler(cfg, cfg.prop_l_xyz, cfg.prop_union, cfg.prop_levels,
                               cfg.prop_samples, train=False)
    t_all, _ = chain(params["proposal"], origins, directions, t_vals)
    xf_enc, df_enc = _encodings(cfg, origins, directions, t_all)
    return {"fine": mlp_calibration_absmax(params["fine"], xf_enc, df_enc, cfg.skip_layer)}


def quantize_render_params(params: dict, stats: dict, skip_layer: int = 4) -> dict:
    """Quantize the models present in the calibration stats (coarse and
    fine, or fine only for proposal-trained models)."""
    return {name: quantize_mlp(params[name], stats[name], skip_layer) for name in stats}


def qparams_from_jax(tree, device=None):
    """JAX qparams (numpy leaves of ``jax.device_get(quantize_mlp(...))``
    or of ``quantize_render_params``) as the port's tensors on ``device``;
    int8 stays int8, everything else float32."""
    if isinstance(tree, dict):
        return {k: qparams_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [qparams_from_jax(v, device) for v in tree]
    arr = np.asarray(tree)
    dtype = torch.int8 if arr.dtype == np.int8 else torch.float32
    return torch.tensor(arr, device=device).to(dtype)
