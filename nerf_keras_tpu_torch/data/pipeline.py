"""Ray datasets and the per-epoch batch iterator (numpy, on the host).

Counterpart of ``nerf_keras_tpu/data/pipeline.py``: a dataset is the
flattened per-pixel rows ``(pixels, origins, directions)`` of its views;
an epoch is a full permutation keyed by ``(seed, epoch)`` cut into
batches with the remainder dropped, so the port's batches are the JAX
package's, bit for bit, for the same dataset and seed.  t-values are
drawn per step on the device, never shipped with the batch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterator

import numpy as np

from nerf_keras_tpu_torch.ops.rays import NDC_NEAR_PLANE, get_rays, ndc_rays


@dataclasses.dataclass
class RayDataset:
    """Flattened per-pixel ray rows: pixel rgb, ray origin, ray direction."""

    pixels: np.ndarray  # (N, 3) float32 in [0, 1]
    origins: np.ndarray  # (N, 3) float32
    directions: np.ndarray  # (N, 3) float32
    near: float
    far: float
    focal: float
    height: int
    width: int

    def __post_init__(self):
        n = self.pixels.shape[0]
        if self.origins.shape[0] != n or self.directions.shape[0] != n:
            raise ValueError("pixels/origins/directions row counts differ")

    def __len__(self) -> int:
        return self.pixels.shape[0]

    @property
    def num_images(self) -> int:
        return len(self) // (self.height * self.width)

    def image(self, i: int) -> np.ndarray:
        """Image ``i`` as ``(H, W, 3)``."""
        hw = self.height * self.width
        return self.pixels[i * hw:(i + 1) * hw].reshape(self.height, self.width, 3)

    def image_rays(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        """Image ``i``'s ray origins and directions, ``(H*W, 3)`` each."""
        hw = self.height * self.width
        sl = slice(i * hw, (i + 1) * hw)
        return self.origins[sl], self.directions[sl]

    def process_slice(self, process_index: int, process_count: int) -> "RayDataset":
        """Contiguous shard ``process_index`` of ``process_count``."""
        n = len(self) // process_count
        sl = slice(process_index * n, (process_index + 1) * n)
        return dataclasses.replace(self, pixels=self.pixels[sl],
                                   origins=self.origins[sl],
                                   directions=self.directions[sl])


def iterate_batches(
    dataset: RayDataset,
    batch_size: int,
    *,
    shuffle: bool = True,
    seed: int = 0,
    epoch: int = 0,
    drop_remainder: bool = True,
) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Yield ``(pixels, origins, directions)`` batches for one epoch, in the
    order of ``np.random.default_rng((seed, epoch)).permutation``."""
    n = len(dataset)
    order = (np.random.default_rng((seed, epoch)).permutation(n) if shuffle
             else np.arange(n))
    end = n - (n % batch_size) if drop_remainder else n
    for start in range(0, end, batch_size):
        idx = order[start:start + batch_size]
        yield dataset.pixels[idx], dataset.origins[idx], dataset.directions[idx]


def steps_per_epoch(dataset: RayDataset, batch_size: int) -> int:
    return len(dataset) // batch_size


def flatten_views(
    images: np.ndarray, origins: np.ndarray, directions: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(V, H, W, 3)`` stacks -> float32 rows ``(V*H*W, 3)``."""
    return (
        images.reshape(-1, images.shape[-1]).astype(np.float32),
        origins.reshape(-1, 3).astype(np.float32),
        directions.reshape(-1, 3).astype(np.float32),
    )


def rescale_focal(focal: float, src_h: int, src_w: int, dst_h: int, dst_w: int) -> float:
    """The focal length after resizing ``(src_h, src_w)`` frames to
    ``(dst_h, dst_w)``: scaled by the geometric mean of the two ratios
    (exact for an isotropic resize)."""
    return float(focal) * math.sqrt((dst_h / src_h) * (dst_w / src_w))


def view_rays(poses, height: int, width: int, focal: float) -> tuple[np.ndarray, np.ndarray]:
    """``(V, H, W, 3)`` origins and directions of each pose's pinhole rays,
    computed on the host by the port's ``get_rays``."""
    oris, dirs = [], []
    for pose in poses:
        o, d = get_rays(height, width, focal, pose, device="cpu")
        oris.append(o.numpy())
        dirs.append(d.numpy())
    return np.stack(oris), np.stack(dirs)


def build_ray_dataset(
    images: np.ndarray,
    poses,
    height: int,
    width: int,
    focal: float,
    near: float,
    far: float,
) -> RayDataset:
    """``(V, H, W, 3)`` images and their camera-to-world poses -> a
    flattened :class:`RayDataset`."""
    px, o, d = flatten_views(images, *view_rays(poses, height, width, focal))
    return RayDataset(pixels=px, origins=o, directions=d, near=near, far=far,
                      focal=float(focal), height=height, width=width)


def dataset_to_ndc(ds: RayDataset, near_plane: float | None = None) -> RayDataset:
    """A forward-facing dataset with its rays in NDC (``ops/rays.ndc_rays``,
    ``NDC``).  Bounds become [0, 1]: t'=0 is the world-space ``near_plane``
    (default :data:`NDC_NEAR_PLANE`, which rendering assumes too), t'=1 is
    infinity."""
    if near_plane is None:
        near_plane = NDC_NEAR_PLANE
    o, d = ndc_rays(ds.height, ds.width, ds.focal, near_plane, ds.origins, ds.directions)
    return dataclasses.replace(ds, origins=o.numpy(), directions=d.numpy(), near=0.0,
                               far=1.0)
