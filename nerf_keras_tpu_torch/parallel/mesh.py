"""Data parallelism over rays, and the collectives the port calls.

Counterpart of ``nerf_keras_tpu/parallel/mesh.py``'s ``data`` axis.  The
JAX package shards the flat ray batch over a device mesh and lets the
partitioner place one gradient all-reduce per step.  The port does the
same by hand: one process per GPU, the parameters replicated on every
rank, each rank holding ``BATCH_SIZE / world`` rows of the global batch
(global row order = rank order, as the JAX ``put_global_batch`` lays it
out), and one all-reduce of the gradients (with the metric numerators)
per step.

Differences from the JAX mesh:

* ``MESH_DATA`` must equal the world size (or be -1, "all ranks").  JAX
  takes a device subset when ``MESH_DATA`` is smaller than the device
  count; a launched rank here has nothing else to do, so a smaller axis
  raises ``ValueError`` as a larger one does.
* ``MESH_MODEL > 1`` (the JAX package's Megatron split of the MLP,
  ``nerf_param_shardings``) raises ``NotImplementedError``: tensor
  parallelism is not ported (ROADMAP.md queue 1 item 7).

Every collective goes through a wrapper here that adds one to
:data:`calls` (and the elements it carries to :data:`elements`) per
call, by kind, as the kernel wrappers count their launches;
``parallel/audit.py`` reads them.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from nerf_keras_tpu_torch.parallel.distributed import initialized_device, process_info

TENSOR_PARALLEL = ("MESH_MODEL > 1 (tensor parallelism) is not ported; the port runs "
                   "data parallelism over rays only (ROADMAP.md queue 1 item 7)")

# Collective calls and the elements they carried, in this process.
calls = {"all_reduce": 0, "all_gather": 0, "broadcast": 0}
elements = {"all_reduce": 0, "all_gather": 0, "broadcast": 0}


def reset_counts() -> None:
    for kind in calls:
        calls[kind] = elements[kind] = 0


def counts() -> dict:
    """``{kind: calls}`` and ``{kind + '_elements': elements}``."""
    return {**calls, **{f"{k}_elements": v for k, v in elements.items()}}


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """The data axis: ``world`` ranks, this process is ``rank`` on
    ``device``; collectives run on the default process group."""

    world: int
    rank: int
    device: torch.device


def check_mesh_shape(data: int, model: int, world: int) -> int:
    """The data axis size for ``MESH_DATA=data``, ``MESH_MODEL=model`` on
    ``world`` ranks; raises for every shape the port cannot run."""
    if model <= 0:
        raise ValueError(f"model axis size must be >= 1, got {model}")
    if model > 1:
        raise NotImplementedError(TENSOR_PARALLEL)
    if data == -1:
        return world
    if data <= 0:
        raise ValueError(f"data axis size must be >= 1 or -1, got {data}")
    if data > world:
        raise ValueError(f"mesh {data}x{model} needs {data} ranks, have {world}")
    if data < world:
        raise ValueError(
            f"mesh {data}x{model} would leave {world - data} of {world} launched ranks "
            f"idle; set MESH_DATA to -1 or {world}")
    return data


def make_mesh(data: int = -1, model: int = 1) -> DataMesh:
    """The mesh of the initialized process group
    (``distributed.maybe_initialize``), with the shape checks of
    :func:`check_mesh_shape`; without a group the world is 1 and, once
    the shape passes, this raises ``RuntimeError``."""
    rank, world = process_info()
    check_mesh_shape(data, model, world)
    return DataMesh(world, rank, initialized_device())


def config_mesh(data: int, model: int) -> DataMesh | None:
    """A config's mesh (``MESH_DATA``, ``MESH_MODEL``): :func:`make_mesh`
    under a process group; without one the shape is checked against a
    world of 1 and None (one process, no collectives) returned."""
    if dist.is_initialized():
        return make_mesh(data, model)
    check_mesh_shape(data, model, 1)
    return None


def local_rows(n: int, mesh: DataMesh) -> slice:
    """This rank's contiguous rows of a global batch of ``n`` rows."""
    if n % mesh.world:
        raise ValueError(f"global batch of {n} rows not divisible by {mesh.world} ranks")
    k = n // mesh.world
    return slice(mesh.rank * k, (mesh.rank + 1) * k)


def _count(kind: str, n: int) -> None:
    calls[kind] += 1
    elements[kind] += n


def all_reduce_flat(tensors: list[torch.Tensor], mesh: DataMesh) -> list[torch.Tensor]:
    """The sums over ranks of ``tensors`` (one dtype), as new tensors of
    their shapes: one flattened buffer, one all-reduce."""
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    _count("all_reduce", flat.numel())
    dist.all_reduce(flat)
    out, start = [], 0
    for t in tensors:
        out.append(flat[start:start + t.numel()].view(t.shape))
        start += t.numel()
    return out


def all_gather_rows(x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) stacked along rows, in rank order."""
    parts = [torch.empty_like(x) for _ in range(mesh.world)]
    _count("all_gather", x.numel() * mesh.world)
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts, dim=0)


@torch.no_grad()
def broadcast_(tensors: list[torch.Tensor], mesh: DataMesh, src: int = 0) -> None:
    """Overwrite ``tensors`` (one dtype) with rank ``src``'s values, in place:
    one flattened buffer, one broadcast."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    _count("broadcast", flat.numel())
    dist.broadcast(flat, src)
    start = 0
    for t in tensors:
        t.copy_(flat[start:start + t.numel()].view(t.shape))
        start += t.numel()


class _AllReduceSum(torch.autograd.Function):
    """A differentiable sum over ranks: each rank's input gets the sum of
    every rank's output cotangent (the summed value feeds every rank's
    loss)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return all_reduce_flat([x], mesh)[0]

    @staticmethod
    def backward(ctx, g):
        return all_reduce_flat([g], ctx.mesh)[0], None


def all_reduce_sum(x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """The sum of ``x`` over ranks, differentiable (one all-reduce forward,
    one backward); BatchNorm's global batch moments use it."""
    return _AllReduceSum.apply(x, mesh)
