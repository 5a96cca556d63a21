"""Multi-process start-up: one process per GPU, joined by ``torch.distributed``.

Counterpart of ``nerf_keras_tpu/parallel/distributed.py``.  The JAX
package calls ``jax.distributed.initialize()`` once per host, and one
process then drives every local device.  Here one process drives one
GPU, so a host with N cards runs N processes.

Usage (per process, before any other device work)::

    from nerf_keras_tpu_torch.parallel.distributed import maybe_initialize
    maybe_initialize()          # no-op without a launch environment

A launch sets either the JAX package's trio ``NERF_COORDINATOR``
(``host:port`` of rank 0's rendezvous), ``NERF_NUM_PROCESSES`` and
``NERF_PROCESS_ID``, or torchrun's ``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR`` and ``MASTER_PORT`` (the counterpart of JAX's Cloud TPU
pod auto-discovery, which is TPU-only and not ported).  A partial trio
raises.

The backend follows the device: NCCL for ``cuda``, gloo for ``cpu``.
Only an explicit ``backend=`` runs gloo on the card (two ranks sharing
one GPU, which NCCL refuses); an NCCL error is never answered with gloo.
A rank's GPU is ``cuda:{LOCAL_RANK}``, else ``cuda:{rank % device_count}``.
"""

from __future__ import annotations

import contextlib
import os

import torch
import torch.distributed as dist

from nerf_keras_tpu_torch.runtime import resolve_device

TRIO = ("NERF_COORDINATOR", "NERF_NUM_PROCESSES", "NERF_PROCESS_ID")
TORCHRUN = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")

# The device this process's rank drives, set by maybe_initialize.
_rank_device: torch.device | None = None


def launch_env() -> tuple[str, int, int] | None:
    """``(init_method, world_size, rank)`` from the ``NERF_*`` trio or
    torchrun's variables; None when neither is set."""
    trio = tuple(os.environ.get(k) for k in TRIO)
    if any(v is not None for v in trio) and not all(trio):
        # A partial trio is a misconfigured launch: falling back to one
        # process would have every process train the whole dataset and
        # race on the same run dir.
        missing = [name for name, v in zip(TRIO, trio) if not v]
        raise RuntimeError(
            f"partial multi-process configuration: {missing} unset while the "
            "other NERF_* launch variables are set; set all three or none")
    if all(trio):
        coordinator, world, rank = trio
        return f"tcp://{coordinator}", int(world), int(rank)
    if all(os.environ.get(k) for k in TORCHRUN):
        return "env://", int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    return None


def rank_device(device: str | None, rank: int) -> torch.device:
    """The device rank ``rank`` drives: ``device`` (default ``'cuda'``),
    with a CUDA index from ``LOCAL_RANK``, else ``rank % device_count``."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = os.environ.get("LOCAL_RANK")
        index = int(local) if local is not None else rank % torch.cuda.device_count()
        dev = torch.device("cuda", index)
    return dev


def maybe_initialize(device: str | None = None, backend: str | None = None) -> bool:
    """Join the process group when a launch environment is set.

    Returns True iff a process group is (or already was) active; False,
    doing nothing, without a launch environment.  ``device`` is the kind
    of device the ranks drive (default ``'cuda'``); ``backend`` defaults
    to NCCL on CUDA and gloo on the CPU.
    """
    global _rank_device
    if dist.is_initialized():
        return True
    env = launch_env()
    if env is None:
        return False
    init_method, world, rank = env
    dev = rank_device(device, rank)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        if backend == "gloo":
            print(f"[nerf-torch] rank {rank}/{world}: gloo on {dev} (asked for explicitly)",
                  flush=True)
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
    _rank_device = dev
    return True


def initialized_device() -> torch.device:
    """The device :func:`maybe_initialize` chose for this rank."""
    if _rank_device is None:
        raise RuntimeError("no process group: call maybe_initialize() under a launch "
                           "environment (the NERF_* trio or torchrun's) first")
    return _rank_device


def process_info() -> tuple[int, int]:
    """``(rank, world_size)``; ``(0, 1)`` without a process group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def shard_dataset_for_process(dataset, mesh):
    """This rank's contiguous shard of a ``RayDataset``
    (``data/pipeline.RayDataset.process_slice``): its data rank's among
    ``mesh.data`` (``parallel/mesh.Mesh``); the whole dataset on one
    process (``mesh`` None) or one data rank.  Every rank shuffles its
    shard with the shared epoch seed and feeds ``BATCH_SIZE / data`` rows
    of each global batch, so the model ranks of a data group batch the
    same rows."""
    if mesh is None or mesh.data == 1:
        return dataset
    return dataset.process_slice(mesh.data_rank, mesh.data)


@contextlib.contextmanager
def launched(device: str | None = None):
    """The enclosed work as one rank of a launch: joins the process group
    (:func:`maybe_initialize`) when a launch environment is set and leaves
    it at the end; inside a group joined before, it joins and leaves
    nothing.  Yields the device this process drives: the rank's, else
    ``device`` resolved (default ``'cuda'``)."""
    joined = not dist.is_initialized() and maybe_initialize(device)
    try:
        yield initialized_device() if dist.is_initialized() else resolve_device(device)
        if joined:
            barrier()
    finally:
        if joined:
            shutdown()


def barrier() -> None:
    """Wait for every rank (a no-op without a process group).  Call it when
    a launch's work ended well, before :func:`shutdown`: a gloo rank whose
    peer closes its connections while it still talks to a third rank (the
    groups of a model axis) dies in a background thread."""
    if dist.is_initialized():
        dist.barrier()


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    global _rank_device
    if dist.is_initialized():
        dist.destroy_process_group()
    _rank_device = None
