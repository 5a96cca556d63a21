"""Procedural synthetic scenes (no files, no network).

Counterpart of ``nerf_keras_tpu/data/synthetic.py``: a diffuse sphere
(``"sphere"``) or four spheres over a checkered disk with cast shadows
(``"spheres"``), rendered analytically by exact ray intersection in
numpy on the port's rays (``ops/rays.get_rays`` on the host).  The same
seed gives the JAX package's views, poses and pixels.
:func:`forward_facing_views` renders the spheres scene from a
forward-facing rig, and :func:`write_forward_facing_capture` writes it as
an LLFF capture on disk for the forward-facing path (``data/llff.py``).
"""

from __future__ import annotations

import os

import numpy as np

from nerf_keras_tpu_torch.data.pipeline import RayDataset, flatten_views, view_rays
from nerf_keras_tpu_torch.ops.rays import pose_spherical
from nerf_keras_tpu_torch.utils.png import encode_png


# Multi-object scene ("spheres"): four spheres of distinct albedo plus a
# checkered ground disk, with hard cast shadows.  Occlusions, multiple
# density modes per ray, and shadow boundaries make it a much harder
# placement problem than the single sphere — used to validate sampler
# recipes (e.g. the proposal-training quality matrix) beyond the trivially
# unimodal scene.  All geometry stays within [near+0.2, far) of every
# orbit camera (radius 4, bounds 2/6).
_SPHERES = (
    # (center, radius, albedo)
    ((0.00, 0.00, 0.10), 0.70, (0.90, 0.45, 0.10)),
    ((1.00, 0.70, 0.20), 0.45, (0.20, 0.40, 0.90)),
    ((-0.90, 0.80, -0.35), 0.40, (0.20, 0.80, 0.30)),
    ((0.20, -1.10, 0.45), 0.35, (0.85, 0.15, 0.50)),
)
_FLOOR_Z = -0.90          # ground disk height
_FLOOR_R = 1.75           # disk radius (keeps every point < far from cameras)
_CHECKER = 0.70           # checker period
_LIGHT = (0.57735, 0.57735, 0.57735)


def _shadow_mask(points: np.ndarray, eps: float = 1e-3) -> np.ndarray:
    """True where the point's view of the light is blocked by a sphere."""
    light = np.asarray(_LIGHT)
    o = points + eps * light
    blocked = np.zeros(points.shape[0], dtype=bool)
    for center, radius, _ in _SPHERES:
        oc = o - np.asarray(center)
        b = oc @ light
        c = np.sum(oc * oc, axis=-1) - radius**2
        disc = b * b - c
        t = -b - np.sqrt(np.maximum(disc, 0.0))
        blocked |= (disc > 0) & (t > eps)
    return blocked


def _render_analytic_spheres(
    origins: np.ndarray, dirs: np.ndarray
) -> np.ndarray:
    """Exact nearest-hit render of the multi-object scene on white."""
    o = origins.reshape(-1, 3).astype(np.float64)
    d = dirs.reshape(-1, 3).astype(np.float64)
    n_rays = o.shape[0]

    best_t = np.full(n_rays, np.inf)
    albedo = np.ones((n_rays, 3))
    normal = np.zeros((n_rays, 3))

    dd = np.sum(d * d, axis=-1)
    for center, radius, color in _SPHERES:
        oc = o - np.asarray(center)
        b = np.sum(oc * d, axis=-1)
        c = np.sum(oc * oc, axis=-1) - radius**2
        disc = b * b - dd * c
        t = np.where(disc > 0, (-b - np.sqrt(np.maximum(disc, 0.0))) / dd, np.inf)
        closer = (t > 1e-6) & (t < best_t)
        point = o + d * np.where(np.isfinite(t), t, 0.0)[:, None]
        n = (point - np.asarray(center)) / radius
        best_t = np.where(closer, t, best_t)
        albedo = np.where(closer[:, None], np.asarray(color), albedo)
        normal = np.where(closer[:, None], n, normal)

    # Ground disk: z = _FLOOR_Z, radius _FLOOR_R, coarse checkerboard.
    denom = d[:, 2]
    t_pl = np.where(
        np.abs(denom) > 1e-8, (_FLOOR_Z - o[:, 2]) / np.where(denom == 0, 1, denom), np.inf
    )
    p_pl = o + d * np.where(np.isfinite(t_pl), t_pl, 0.0)[:, None]
    on_disk = p_pl[:, 0] ** 2 + p_pl[:, 1] ** 2 < _FLOOR_R**2
    closer = (t_pl > 1e-6) & (t_pl < best_t) & on_disk
    check = (
        np.floor(p_pl[:, 0] / _CHECKER) + np.floor(p_pl[:, 1] / _CHECKER)
    ).astype(np.int64) % 2
    floor_col = np.where(check[:, None] == 0, 0.85, 0.50) * np.ones(3)
    best_t = np.where(closer, t_pl, best_t)
    albedo = np.where(closer[:, None], floor_col, albedo)
    normal = np.where(
        closer[:, None], np.asarray([0.0, 0.0, 1.0]), normal
    )

    hit = np.isfinite(best_t)
    point = o + d * np.where(hit, best_t, 0.0)[:, None]
    light = np.asarray(_LIGHT)
    diffuse = np.clip(normal @ light, 0.0, 1.0)
    diffuse = np.where(_shadow_mask(point), 0.0, diffuse)
    rgb = albedo * (0.25 + 0.75 * diffuse[:, None])
    rgb = np.where(hit[:, None], rgb, np.ones(3))
    return rgb.reshape(*origins.shape[:-1], 3).astype(np.float32)


def _render_analytic(
    origins: np.ndarray, dirs: np.ndarray, radius: float = 1.0
) -> np.ndarray:
    """Exact render of a unit-ish sphere: lambertian-shaded orange on white."""
    o = origins.reshape(-1, 3)
    d = dirs.reshape(-1, 3)
    b = np.sum(o * d, axis=-1)
    c = np.sum(o * o, axis=-1) - radius**2
    disc = b * b - np.sum(d * d, axis=-1) * c
    hit = disc > 0
    t = np.where(hit, (-b - np.sqrt(np.maximum(disc, 0.0))) / np.sum(d * d, axis=-1), 0.0)
    hit &= t > 0
    point = o + d * t[:, None]
    normal = point / np.maximum(np.linalg.norm(point, axis=-1, keepdims=True), 1e-8)
    light = np.asarray([0.57735, 0.57735, 0.57735])
    shade = np.clip(normal @ light, 0.0, 1.0)[:, None]
    base = np.asarray([0.9, 0.45, 0.1])
    rgb = np.where(
        hit[:, None], 0.25 * base + 0.75 * base * shade, np.ones(3)
    )
    return rgb.reshape(*origins.shape[:-1], 3).astype(np.float32)


def prepare_synthetic_data(
    target_height: int,
    target_width: int,
    num_views: int = 12,
    seed: int = 0,
    split_ratio: float = 0.8,
    scene: str = "sphere",
    holdout: str | None = None,
) -> tuple[RayDataset, RayDataset, tuple[float, float], float]:
    """Build train/val RayDatasets of a procedural scene.

    ``scene="sphere"`` (default) is the original single diffuse sphere;
    ``scene="spheres"`` is the harder multi-object variant (four spheres +
    checkered ground disk, occlusions and cast shadows) used to validate
    sampler recipes beyond the unimodal case.

    ``holdout`` picks the val views: ``"tail"`` = last 20% by index (the
    reference Lego loader's protocol, lego_data_utils.py:26) — on an
    azimuth-ordered orbit that holds out a contiguous ~72 deg sector, so
    for a non-symmetric scene val measures EXTRAPOLATION into an unseen
    sector (measured: spheres-scene val declines while train climbs);
    ``"interleave"`` spreads the val views over the orbit so val measures
    novel-view interpolation.  Default: "tail" for the rotationally
    symmetric sphere (parity protocol), "interleave" for spheres.

    Returns ``(train, val, (near, far), focal)``, as
    :func:`nerf_keras_tpu_torch.data.lego.prepare_lego_data`.
    """
    renderers = {
        "sphere": _render_analytic,
        "spheres": _render_analytic_spheres,
    }
    if scene not in renderers:
        raise ValueError(
            f"unknown synthetic scene {scene!r}; choose from {sorted(renderers)}"
        )
    render = renderers[scene]
    if holdout is None:
        holdout = "interleave" if scene == "spheres" else "tail"
    if holdout not in ("tail", "interleave"):
        raise ValueError(f"unknown holdout {holdout!r}")
    rng = np.random.default_rng(seed)
    focal = 1.2 * max(target_height, target_width)
    near, far = 2.0, 6.0

    thetas = np.linspace(0.0, 360.0, num_views, endpoint=False)
    phis = rng.uniform(-40.0, -20.0, size=num_views)

    poses = [pose_spherical(float(theta), float(phi), 4.0)
             for theta, phi in zip(thetas, phis)]
    all_oris, all_dirs = view_rays(poses, target_height, target_width, focal)
    images = np.stack([render(o, d) for o, d in zip(all_oris, all_dirs)])

    split = int(num_views * split_ratio)
    n_val = num_views - split
    if holdout == "interleave":
        stride = max(1, num_views // max(n_val, 1))
        val_idx = np.arange(num_views)[stride - 1 :: stride][:n_val]
    else:
        val_idx = np.arange(split, num_views)
    train_idx = np.setdiff1d(np.arange(num_views), val_idx)

    def build(idx: np.ndarray) -> RayDataset:
        px, o, d = flatten_views(images[idx], all_oris[idx], all_dirs[idx])
        return RayDataset(
            pixels=px, origins=o, directions=d,
            near=near, far=far, focal=float(focal),
            height=target_height, width=target_width,
        )

    return build(train_idx), build(val_idx), (near, far), float(focal)


# The minify factor of the written frames and the seed of the camera jitter.
_CAPTURE_FACTOR = 8
_CAPTURE_SEED = 7


def forward_facing_views(
    num_views: int,
    height: int,
    width: int,
    focal: float,
) -> tuple[np.ndarray, np.ndarray]:
    """The spheres scene seen from a forward-facing rig: ``(frames (N, H,
    W, 3) uint8, poses_bounds (N, 17))``, the frames rendered at ``height x
    width`` with ``focal`` (pixels), ``poses_bounds`` in LLFF's raw layout
    ``[down, right, back, t, hwf]`` + bounds, hwf the rendered size.

    The cameras sit around ``(0, 0, 4)`` (x and y jittered by up to 0.45,
    z by 0.15, from a fixed seed) and look at the origin, so every ray has
    ``d_z < 0``; bounds are [2.4, 5.6], the depth range of the scene
    seen from there.  The same ``num_views`` give the same cameras at any
    size.
    """
    rng = np.random.default_rng(_CAPTURE_SEED)
    poses_raw = np.zeros((num_views, 3, 5))
    frames = np.zeros((num_views, height, width, 3), np.uint8)
    for i in range(num_views):
        pos = np.array([*rng.uniform(-0.45, 0.45, 2), 4.0 + rng.uniform(-0.15, 0.15)])
        back = pos / np.linalg.norm(pos)
        right = np.cross([0.0, 1.0, 0.0], back)
        right /= np.linalg.norm(right)
        up = np.cross(back, right)
        c2w = np.stack([right, up, back, pos], axis=1).astype(np.float32)
        o, d = view_rays([c2w], height, width, focal)
        frames[i] = (_render_analytic_spheres(o[0], d[0]) * 255).astype(np.uint8)
        # LLFF's columns are [down, right, back, t, hwf].
        poses_raw[i, :, :4] = np.stack([-up, right, back, pos], axis=1)
        poses_raw[i, :, 4] = height, width, focal
    bds = np.stack([np.full(num_views, 2.4), np.full(num_views, 5.6)], axis=1)
    return frames, np.concatenate([poses_raw.reshape(num_views, -1), bds], axis=1)


def write_forward_facing_capture(
    out_dir: str,
    num_views: int,
    height: int,
    width: int,
    focal: float,
) -> str:
    """Write :func:`forward_facing_views` as an LLFF capture
    (``data/llff.py``) and return ``out_dir``: ``images_8/img_NN.png``
    rendered at ``height x width`` with ``focal`` (pixels), and
    ``poses_bounds.npy`` with hwf at the full size (8 times each), as the
    published captures ship their factor-8 minified frames."""
    img_dir = os.path.join(out_dir, f"images_{_CAPTURE_FACTOR}")
    os.makedirs(img_dir, exist_ok=True)
    frames, poses_bounds = forward_facing_views(num_views, height, width, focal)
    poses_bounds[:, 4:15:5] *= _CAPTURE_FACTOR  # hwf, the 5th column of each row
    for i, rgb in enumerate(frames):
        with open(os.path.join(img_dir, f"img_{i:02d}.png"), "wb") as f:
            f.write(encode_png(rgb))
    np.save(os.path.join(out_dir, "poses_bounds.npy"), poses_bounds)
    return out_dir
