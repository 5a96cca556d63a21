"""Data and tensor parallelism with ``torch.distributed``.

Counterpart of ``nerf_keras_tpu/parallel/``: one process per GPU (NCCL;
gloo on the CPU) on a ``(data, model)`` mesh (``mesh.py``): each data
group holds its rows of the global batch and one gradient all-reduce a
step sums them (``engine/step.make_train_step(mesh=...)``); a model axis
splits the MLPs Megatron style.  ``audit.py`` checks that structure from
the collective counters.
"""

from nerf_keras_tpu_torch.parallel.distributed import (
    maybe_initialize,
    process_info,
    shard_dataset_for_process,
    shutdown,
)
from nerf_keras_tpu_torch.parallel.mesh import Mesh, config_mesh, local_rows, make_mesh

__all__ = [
    "Mesh",
    "config_mesh",
    "local_rows",
    "make_mesh",
    "maybe_initialize",
    "process_info",
    "shard_dataset_for_process",
    "shutdown",
]
