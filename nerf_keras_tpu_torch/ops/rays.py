"""Ray generation and camera-pose math.

Counterpart of ``nerf_keras_tpu/ops/rays.py`` (``get_rays``,
``sample_rays`` and the spherical pose helpers).  Directions stay
unnormalised, as in the reference.  ``ndc_rays`` is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch


def get_rays(
    height: int, width: int, focal: float, pose, device=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel ray origins and directions for a pinhole camera.

    Pixel (u, v) maps to camera-space direction ``((u - W/2)/f,
    -(v - H/2)/f, -1)``, rotated by ``pose[:3, :3]``; the origin is
    ``pose[:3, 3]``.  Returns two ``(H, W, 3)`` float32 tensors.
    """
    pose = torch.as_tensor(np.asarray(pose, np.float32), device=device)
    focal = torch.tensor(float(focal), dtype=torch.float32, device=device)
    u = torch.arange(width, dtype=torch.float32, device=device)[None, :]
    v = torch.arange(height, dtype=torch.float32, device=device)[:, None]
    x = (u - width * 0.5) / focal
    y = -(v - height * 0.5) / focal
    dirs = torch.stack(
        [
            x.expand(height, width),
            y.expand(height, width),
            -torch.ones((height, width), dtype=torch.float32, device=device),
        ],
        dim=-1,
    )
    rot = pose[:3, :3]
    # Broadcast-and-sum, not a matmul, as in the JAX package: the 3x3
    # contraction stays in full float32 on every backend.
    ray_dirs = torch.sum(dirs[..., None, :] * rot, dim=-1)
    ray_oris = pose[:3, -1].expand(ray_dirs.shape)
    return ray_oris, ray_dirs


def sample_rays(
    ray_origins: torch.Tensor, ray_directions: torch.Tensor, t_vals: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Points ``o + d * t``: ``(..., S, 3)`` positions and the direction
    broadcast to the same shape."""
    points = (
        ray_origins[..., None, :]
        + ray_directions[..., None, :] * t_vals[..., :, None]
    )
    dirs = ray_directions[..., None, :].expand(points.shape)
    return points, dirs


# Spherical camera paths: host-side numpy, computed once per frame.


def get_translation_t(t: float) -> np.ndarray:
    """Translation along -z viewing axis by distance ``t``."""
    m = np.eye(4, dtype=np.float32)
    m[2, 3] = t
    return m


def get_rotation_phi(phi: float) -> np.ndarray:
    """Rotation about the x axis by ``phi`` radians."""
    c, s = np.cos(phi), np.sin(phi)
    m = np.eye(4, dtype=np.float32)
    m[1, 1], m[1, 2] = c, -s
    m[2, 1], m[2, 2] = s, c
    return m


def get_rotation_theta(theta: float) -> np.ndarray:
    """Rotation about the y axis by ``theta`` radians."""
    c, s = np.cos(theta), np.sin(theta)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 2] = c, -s
    m[2, 0], m[2, 2] = s, c
    return m


def pose_spherical(theta_deg: float, phi_deg: float, t: float) -> np.ndarray:
    """Camera-to-world matrix on a sphere, with the reference's final
    axis flip, so poses are interchangeable with the JAX package's."""
    c2w = get_translation_t(t)
    c2w = get_rotation_phi(phi_deg / 180.0 * np.pi) @ c2w
    c2w = get_rotation_theta(theta_deg / 180.0 * np.pi) @ c2w
    flip = np.array(
        [[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]],
        dtype=np.float32,
    )
    return flip @ c2w
