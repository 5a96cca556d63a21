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
``parallel/audit.py`` reads them.  A picklable object's broadcast
(:func:`broadcast_object`) counts as ``broadcast_object`` with its
pickled bytes as the elements.

What one process builds from the weights after training (the int8
tables, the distilled proposal net, an ``.infer.npz`` read) is built on
rank 0 alone and handed to every rank by :func:`share_from_main`: one
object broadcast of a header, then :func:`broadcast_tree_`, one
broadcast per dtype of the tensors.  As in the JAX package, which builds
them on one device and replicates them, every rank then holds rank 0's
bits.
"""

from __future__ import annotations

import dataclasses
import pickle
from typing import Any, Callable

import torch
import torch.distributed as dist

from nerf_keras_tpu_torch.parallel.distributed import initialized_device, process_info

TENSOR_PARALLEL = ("MESH_MODEL > 1 (tensor parallelism) is not ported; the port runs "
                   "data parallelism over rays only (ROADMAP.md queue 1 item 7)")

# Collective calls and the elements they carried, in this process.
calls = {"all_reduce": 0, "all_gather": 0, "broadcast": 0, "broadcast_object": 0}
elements = {"all_reduce": 0, "all_gather": 0, "broadcast": 0, "broadcast_object": 0}


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


def is_main(mesh: DataMesh | None) -> bool:
    """True on rank 0, and in one process without a mesh: the rank that
    prints reports and writes files."""
    return mesh is None or mesh.rank == 0


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


def broadcast_object(obj: Any, mesh: DataMesh, src: int = 0) -> Any:
    """Rank ``src``'s picklable ``obj`` on every rank (the others pass
    anything, e.g. None).  NCCL moves it through the rank's own device."""
    box = [obj]
    device = mesh.device if dist.get_backend() == "nccl" else torch.device("cpu")
    dist.broadcast_object_list(box, src, device=device)
    _count("broadcast_object", len(pickle.dumps(box[0])))
    return box[0]


def _leaves(tree) -> list[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def tree_spec(tree):
    """The nested dicts and lists of ``tree`` with each tensor replaced by
    ``(dtype name, shape)``: what a rank needs to receive it."""
    if isinstance(tree, dict):
        return {k: tree_spec(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_spec(v) for v in tree]
    return (str(tree.dtype).removeprefix("torch."), tuple(tree.shape))


def empty_tree(spec, device):
    """Uninitialized tensors on ``device`` in the layout of ``spec``
    (:func:`tree_spec`)."""
    if isinstance(spec, dict):
        return {k: empty_tree(v, device) for k, v in spec.items()}
    if isinstance(spec, list):
        return [empty_tree(v, device) for v in spec]
    dtype, shape = spec
    return torch.empty(shape, dtype=getattr(torch, dtype), device=device)


def broadcast_tree_(tree, mesh: DataMesh, src: int = 0) -> None:
    """Overwrite every tensor of ``tree`` (nested dicts and lists, the same
    layout on every rank) with rank ``src``'s, in place: one
    :func:`broadcast_` per dtype, dtypes in name order."""
    by_dtype: dict[str, list[torch.Tensor]] = {}
    for t in _leaves(tree):
        by_dtype.setdefault(str(t.dtype), []).append(t)
    for name in sorted(by_dtype):
        broadcast_(by_dtype[name], mesh, src)


def share_from_main(build: Callable[[], tuple[Any, Any]], mesh: DataMesh | None):
    """``build()`` -> ``(meta, tree)`` run on rank 0 alone, and its result
    on every rank: ``meta`` (picklable) and the layout of ``tree`` (a
    nested tree of tensors on the rank's device, or None) in one
    :func:`broadcast_object`, then the tensors by :func:`broadcast_tree_`.
    Without a mesh, ``build()``.

    The other ranks wait in the header's broadcast.  When ``build`` raises
    on rank 0, the header says so: rank 0 re-raises its error and every
    other rank raises ``RuntimeError`` naming it, so that no rank waits for
    a broadcast that will not come."""
    if mesh is None:
        return build()
    if mesh.rank == 0:
        try:
            meta, tree = build()
        except Exception as e:
            broadcast_object({"error": f"{type(e).__name__}: {e}"}, mesh)
            raise
        spec = None if tree is None else tree_spec(tree)
        broadcast_object({"meta": meta, "spec": spec}, mesh)
    else:
        head = broadcast_object(None, mesh)
        if "error" in head:
            raise RuntimeError(f"rank 0 failed where this rank waits for its result: "
                               f"{head['error']}")
        meta, spec = head["meta"], head["spec"]
        tree = None if spec is None else empty_tree(spec, mesh.device)
    if tree is not None:
        broadcast_tree_(tree, mesh)
    return meta, tree


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
