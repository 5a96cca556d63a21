"""An int8 MLP whose accumulators reach k * 127^2 where K4 must convert
them exactly (not a test module: ``test_torch_wg_pack.py`` checks on the
CPU that the case can see a wrong conversion, ``test_torch_cuda.py`` holds
K4 to its plain version on it).

K4 dequantizes an accumulator by a magic number (exact for |acc| <= 2^22)
on every layer whose padded k is at most 256, and by a conversion on every
other layer: at hidden 256 the layer after the skip (k 319) and the branch
(k 283), at hidden 512 every trunk layer after the first, the head and the
branch, whose |acc| can reach k * 127^2 > 2^22.  Here every input of the
layer after the skip and of the branch is +-127 and every weight is 127
with the input's sign, so their accumulators are exactly (hidden + 63) *
127^2 and (hidden + 27) * 127^2.  The rays stay in a box so small that no
column of the position or direction encoding changes sign, and the
encodings' inverse scales are so large that every column quantizes to
+-127.  The layers after them are not saturated, so the conversion shows
in sigma (through the trunk) and in the rgb logits (through the branch).
"""

import numpy as np
import torch

from nerf_keras_tpu_torch.ops import quant
from nerf_keras_tpu_torch.ops.encoding import encode_position

NUM_LAYERS, HIDDEN, SKIP, L_XYZ, L_DIR = 8, 256, 4, 10, 4
BOX = 1e-3  # the points' box edge
INV_ENC = 1e6  # every |encoding| >= 1.3e-4 quantizes to +-127


def _center(rng) -> np.ndarray:
    """A point whose box keeps every sin/cos column of the position
    encoding away from zero (by 1e-3 rad at every octave)."""
    quarter = np.pi / 2
    for _ in range(10_000):
        c = rng.uniform(0.2, 1.2, 3)
        ok = True
        for octave in range(L_XYZ):
            lo, hi = 2.0 ** octave * (c - BOX), 2.0 ** octave * (c + BOX)
            if np.any(np.floor((lo - 1e-3) / quarter) != np.floor((hi + 1e-3) / quarter)):
                ok = False
                break
        if ok:
            return c
    raise RuntimeError("no center found")


def _row(values, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(values, np.float32), device=device).reshape(1, -1)


def _dense(wq: np.ndarray, scale, b, device) -> dict:
    n = wq.shape[1]
    return {"wq": torch.as_tensor(wq.astype(np.int8), device=device),
            "scale": _row(np.broadcast_to(scale, (n,)), device),
            "b": _row(np.broadcast_to(b, (n,)), device)}


def adversarial_case(device, b: int = 64, s: int = 32, seed: int = 0, hidden: int = HIDDEN):
    """``(qparams, origins (b, 3), dirs (b, 3), t (b, s))`` on ``device``
    for an 8 x ``hidden`` (256 or 512) skip-4 MLP with L_XYZ 10, L_DIR 4.
    The scales and biases after the two saturating layers are set from
    ``hidden`` so that the activations equal hidden 256's: the layer after
    the skip outputs 16..31, sigma ~ 5e3, the rgb logits near 0."""
    rng = np.random.default_rng(seed)
    c = _center(rng)
    d = np.array([0.3, 0.5, 0.8])
    d = d / np.linalg.norm(d)
    o32 = torch.as_tensor(c + rng.uniform(-BOX / 4, BOX / 4, (b, 3)), dtype=torch.float32)
    t32 = torch.as_tensor(np.sort(rng.uniform(0.0, BOX / 4, (b, s)), axis=1), dtype=torch.float32)
    d32 = torch.as_tensor(d, dtype=torch.float32).expand(b, 3).contiguous()
    pts = o32[:, None, :] + d32[:, None, :] * t32[..., None]
    x_enc = encode_position(pts, L_XYZ).reshape(-1, 63)
    d_enc = encode_position(d32[0], L_DIR)
    sx = torch.sign(x_enc[0]).numpy()
    if not (torch.all(torch.sign(x_enc) == x_enc[0].sign()) and
            float(x_enc.abs().min()) * INV_ENC > 127.5 and
            float(d_enc.abs().min()) * INV_ENC > 127.5):
        raise RuntimeError("the encodings change sign in the box")
    sd = torch.sign(d_enc).numpy()
    h = hidden
    r = HIDDEN / h  # the scales of hidden 256, per input column
    cols = np.arange(h)
    full = np.full((h, h), 127)
    trunk = [_dense(np.repeat(127 * sx[:, None], h, 1), 1e-4, 0.0, device)]  # -> 127
    trunk += [_dense(full, 1e-4, 0.0, device) for _ in range(1, SKIP + 1)]  # 256 * 127^2 -> 127
    # After the skip: [h4 = 127 | qx = 127 sx] with weights 127 (sx):
    # acc = (h + 63) * 127^2; outputs 16..31, not saturated.
    trunk.append(_dense(np.concatenate([full, np.repeat(127 * sx[:, None], h, 1)]),
                        1e-5 * (HIDDEN + 63) / (h + 63), -20.0 - (cols % 16), device))
    trunk += [_dense(np.ones((h, h)), 0.02 * r, -50.0, device),
              _dense(np.ones((h, h)), 0.01 * r, -100.0, device)]
    # The head: the feature saturates (127) for the branch, sigma ~ 5e3
    # (every h7 is 79).
    fs = _dense(np.concatenate([np.full((h, h), 127), np.ones((h, 1))], axis=1),
                np.concatenate([np.full(h, 1e-3), [1.0]]),
                np.concatenate([np.zeros(h), [-15000.0 - 79.0 * (h - HIDDEN)]]), device)
    # The branch over [qfeat = 127 | qd = 127 sd]: acc = (h + 27) * 127^2.
    branch = _dense(np.concatenate([np.full((h, h // 2), 127),
                                    np.repeat(127 * sd[:, None], h // 2, 1)]),
                    1e-5 * (HIDDEN + 27) / (h + 27), -40.0, device)
    rgb = _dense(np.ones((h // 2, 3)), 1e-3 * r, np.array([-7.0, -7.5, -6.5]), device)
    qp = {"inv_x": _row(np.full(63, INV_ENC), device), "inv_d": _row(np.full(27, INV_ENC), device),
          "trunk": trunk, "inv_h": [_row(np.full(h, v), device) for v in (10, 1, 1, 1, 1, 1, 1, 1)],
          "fs": fs, "inv_feat": _row(np.full(h, 10.0), device), "branch": branch,
          "inv_h2": _row(np.full(h // 2, 10.0), device), "rgb": rgb}
    return qp, o32.to(device), d32.to(device), t32.to(device)


def magic_qdot(a: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """``quant._qdot`` as a K4 that took the magic-number conversion on
    every layer would compute it (wrong beyond |acc| = 2^22)."""
    acc = (a.to(torch.float64) @ wq.to(torch.float64)).to(torch.int64)
    bits = (acc + 0x4B400000).to(torch.int32)
    return bits.view(torch.float32) - np.float32(12582912.0)


def max_accumulators(qp, origins, dirs, t) -> dict[int, int]:
    """The largest |acc| of the plain int8 forward, by the layer's k."""
    seen: dict[int, int] = {}
    exact = quant._qdot

    def spy(a, wq):
        acc = (a.to(torch.float64) @ wq.to(torch.float64)).abs().max()
        seen[a.shape[-1]] = max(seen.get(a.shape[-1], 0), int(acc))
        return exact(a, wq)

    quant._qdot = spy
    try:
        from nerf_keras_tpu_torch.ops.kernels import quant_render as k4
        k4.render_rays_reference_quant(qp, origins, dirs, t)
    finally:
        quant._qdot = exact
    return seen
