"""Data parallelism over rays with ``torch.distributed``.

Counterpart of ``nerf_keras_tpu/parallel/``: one process per GPU (NCCL;
gloo on the CPU), parameters replicated, each rank holding its rows of
the global batch, one gradient all-reduce per step
(``engine/step.make_train_step(mesh=...)``).  ``audit.py`` checks that
structure from the collective counters.
"""

from nerf_keras_tpu_torch.parallel.distributed import (
    maybe_initialize,
    process_info,
    shard_dataset_for_process,
    shutdown,
)
from nerf_keras_tpu_torch.parallel.mesh import DataMesh, config_mesh, local_rows, make_mesh

__all__ = [
    "DataMesh",
    "config_mesh",
    "local_rows",
    "make_mesh",
    "maybe_initialize",
    "process_info",
    "shard_dataset_for_process",
    "shutdown",
]
