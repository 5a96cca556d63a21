"""Ray generation and camera-pose math.

Counterpart of ``nerf_keras_tpu/ops/rays.py`` (``get_rays``,
``sample_rays``, the NDC reparameterization ``ndc_rays`` of
forward-facing rays, and the spherical pose helpers).  Directions stay
unnormalised, as in the reference.
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


# The world-space near plane of the NDC projection, shared by training
# (``data/pipeline.dataset_to_ndc``) and rendering (``Trainer.pose_rays``):
# a mismatch silently shifts where t'=0 lands.  After LLFF's bound
# rescaling (bd_factor 0.75) the closest bound sits at ~1.33.
NDC_NEAR_PLANE = 1.0


def ndc_rays(
    height: int,
    width: int,
    focal: float,
    near: float,
    ray_origins,
    ray_directions,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward-facing rays (``d_z < 0``) into normalized device
    coordinates, where ``t in [0, 1]`` sweeps from the near plane to
    infinity (the original NeRF's appendix C).

    Each origin moves onto the world plane ``z = -near`` along its ray,
    then ``o' = (-f/(W/2) o_x/o_z, -f/(H/2) o_y/o_z, 1 + 2n/o_z)`` and
    ``d' = (-f/(W/2) (d_x/d_z - o_x/o_z), -f/(H/2) (d_y/d_z - o_y/o_z),
    -2n/o_z)``, in float32 with the JAX package's order of operations.
    ``(..., 3)`` tensors or arrays in; ``(origins, directions)`` float32
    tensors on the origins' device out; sample them with bounds [0, 1].
    """
    o = torch.as_tensor(ray_origins, dtype=torch.float32)
    d = torch.as_tensor(ray_directions, dtype=torch.float32, device=o.device)
    focal = torch.tensor(float(focal), dtype=torch.float32, device=o.device)
    near = torch.tensor(float(near), dtype=torch.float32, device=o.device)

    # Shift the origins onto the near plane so that t'=0 starts there.
    t = -(near + o[..., 2]) / d[..., 2]
    o = o + t[..., None] * d

    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    sx = -focal / (0.5 * width)
    sy = -focal / (0.5 * height)
    o_ndc = torch.stack([sx * ox / oz, sy * oy / oz, 1.0 + 2.0 * near / oz], dim=-1)
    d_ndc = torch.stack(
        [sx * (dx / dz - ox / oz), sy * (dy / dz - oy / oz), -2.0 * near / oz], dim=-1)
    return o_ndc, d_ndc


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
