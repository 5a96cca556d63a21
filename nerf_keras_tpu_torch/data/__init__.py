"""Datasets and the ray-batch input pipeline of the port (numpy on the
host; counterpart of ``nerf_keras_tpu/data``), LLFF captures included."""

from nerf_keras_tpu_torch.data.blender import prepare_blender_data
from nerf_keras_tpu_torch.data.lego import prepare_lego_data
from nerf_keras_tpu_torch.data.llff import prepare_fern_data
from nerf_keras_tpu_torch.data.pipeline import RayDataset, iterate_batches
from nerf_keras_tpu_torch.data.synthetic import prepare_synthetic_data

__all__ = [
    "RayDataset",
    "iterate_batches",
    "prepare_synthetic_data",
    "prepare_lego_data",
    "prepare_blender_data",
    "prepare_fern_data",
]
