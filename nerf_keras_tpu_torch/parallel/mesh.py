"""The ``(data, model)`` mesh of processes, and the collectives the port calls.

Counterpart of ``nerf_keras_tpu/parallel/mesh.py``.  One process drives
one GPU, and the ranks form a 2-D mesh:

* ``data`` shards the flat ray batch.  Each data group holds
  ``BATCH_SIZE / data`` rows of the global batch (global row order = data
  rank order, as the JAX ``put_global_batch`` lays it out) and one
  all-reduce over the data group per step sums the gradients (with the
  metric numerators).
* ``model`` (``MESH_MODEL``, default 1) splits each NeRF MLP Megatron
  style by :func:`param_layout`, the JAX ``nerf_param_shardings`` rules:
  even trunk layers column-split, odd ones row-split, a layer whose split
  dimension does not divide replicated, the sigma head row-split, the
  feature layer column-split, the branch, rgb and proposal nets
  replicated.  ``models/mlp.py`` runs the split with the differentiable
  collectives over the model group below (:func:`copy_to_model`,
  :func:`reduce_from_model`, :func:`gather_from_model`), where the JAX
  package leaves them to the partitioner.

Global rank ``r`` sits at ``(r // model, r % model)``, as JAX reshapes its
device list, so the ranks of one model group are consecutive.  Every
model rank of a data group holds the same rows and the same draws.

Differences from the JAX mesh: ``MESH_DATA * MESH_MODEL`` must equal the
world size (``MESH_DATA = -1``: ``world // model``).  JAX takes a device
subset when the mesh is smaller than the device count; a launched rank
here has nothing else to do, so a smaller mesh raises ``ValueError`` as a
larger one does.  Collectives are all-reduces, all-gathers and
broadcasts only: gloo, which the CPU ranks and ranks sharing one card
run, has no reduce-scatter.

Every collective goes through a wrapper here that adds one to
:data:`calls` (and the elements it carries to :data:`elements`) per
call, by axis (``data``, ``model``, or ``world`` for what rank 0 shares
with every rank) and by kind, as the kernel wrappers count their
launches; ``parallel/audit.py`` reads them (:func:`counts`).  A
picklable object's broadcast (:func:`broadcast_object`) counts as
``broadcast_object`` with its pickled bytes as the elements.

What one process builds from the weights after training (the int8
tables, the distilled proposal net, an ``.infer.npz`` read) is built on
rank 0 alone and handed to every rank by :func:`share_from_main`: one
object broadcast of a header, then :func:`broadcast_tree_`, one
broadcast per dtype of the tensors.  As in the JAX package, which builds
them on one device and replicates them, every rank then holds rank 0's
bits.  Under a model axis ``build`` must not gather (rank 0 runs it
alone): the caller gathers the full weights on every rank first.
"""

from __future__ import annotations

import dataclasses
import pickle
from typing import Any, Callable

import torch
import torch.distributed as dist

from nerf_keras_tpu_torch.parallel.distributed import initialized_device, process_info

AXES = ("data", "model", "world")
KINDS = ("all_reduce", "all_gather", "broadcast", "broadcast_object")
# Collective calls and the elements they carried, in this process, by axis.
calls = {axis: dict.fromkeys(KINDS, 0) for axis in AXES}
elements = {axis: dict.fromkeys(KINDS, 0) for axis in AXES}


def reset_counts() -> None:
    for axis in AXES:
        for kind in KINDS:
            calls[axis][kind] = elements[axis][kind] = 0


def counts(axis: str | None = None) -> dict:
    """``{kind: calls}`` and ``{kind + '_elements': elements}`` over one
    axis, or summed over every axis."""
    axes = AXES if axis is None else (axis,)
    return {**{k: sum(calls[a][k] for a in axes) for k in KINDS},
            **{f"{k}_elements": sum(elements[a][k] for a in axes) for k in KINDS}}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the ``(data, model)`` mesh: the axis sizes,
    its rank on each, its device, and the process group of each axis
    (None: the default group, which is the data group when ``model`` is
    1; the model group is then never used)."""

    data: int
    model: int
    data_rank: int
    model_rank: int
    device: torch.device
    data_group: Any = None
    model_group: Any = None

    @property
    def world(self) -> int:
        return self.data * self.model

    @property
    def rank(self) -> int:
        return self.data_rank * self.model + self.model_rank

    def __deepcopy__(self, memo) -> "Mesh":
        # Modules holding a mesh are copied (the EMA shadow, folded
        # weights); process groups are shared, not copied.
        return self


def check_mesh_shape(data: int, model: int, world: int) -> int:
    """The data axis size for ``MESH_DATA=data``, ``MESH_MODEL=model`` on
    ``world`` ranks; raises ``ValueError`` for every shape the port cannot
    run."""
    if model <= 0:
        raise ValueError(f"model axis size must be >= 1, got {model}")
    if world % model:
        raise ValueError(f"{world} ranks not divisible by model={model}")
    if data == -1:
        return world // model
    if data <= 0:
        raise ValueError(f"data axis size must be >= 1 or -1, got {data}")
    if data * model > world:
        raise ValueError(f"mesh {data}x{model} needs {data * model} ranks, have {world}")
    if data * model < world:
        raise ValueError(
            f"mesh {data}x{model} would leave {world - data * model} of {world} launched "
            f"ranks idle; set MESH_DATA to -1 or {world // model}")
    return data


# Each mesh shape's groups, created once per process group (every rank
# must create every group, in the same order, or the launch hangs).
_GROUPS: dict = {}


def _axis_groups(data: int, model: int, rank: int) -> tuple[Any, Any]:
    key = (data, model, dist.group.WORLD)
    if key not in _GROUPS:
        data_groups = [dist.new_group([d * model + m for d in range(data)])
                       for m in range(model)]
        model_groups = [dist.new_group([d * model + m for m in range(model)])
                        for d in range(data)]
        _GROUPS[key] = (data_groups, model_groups)
    data_groups, model_groups = _GROUPS[key]
    return data_groups[rank % model], model_groups[rank // model]


def make_mesh(data: int = -1, model: int = 1) -> Mesh:
    """The mesh of the initialized process group
    (``distributed.maybe_initialize``), with the shape checks of
    :func:`check_mesh_shape`; without a group the world is 1 and, once
    the shape passes, this raises ``RuntimeError``."""
    rank, world = process_info()
    data = check_mesh_shape(data, model, world)
    device = initialized_device()
    if model == 1:
        return Mesh(data, 1, rank, 0, device)
    data_group, model_group = _axis_groups(data, model, rank)
    return Mesh(data, model, rank // model, rank % model, device, data_group, model_group)


def config_mesh(data: int, model: int) -> Mesh | None:
    """A config's mesh (``MESH_DATA``, ``MESH_MODEL``): :func:`make_mesh`
    under a process group; without one the shape is checked against a
    world of 1 and None (one process, no collectives) returned."""
    if dist.is_initialized():
        return make_mesh(data, model)
    check_mesh_shape(data, model, 1)
    return None


def split_model(mesh: Mesh | None) -> Mesh | None:
    """``mesh`` when it has a model axis (``model > 1``), else None."""
    return mesh if mesh is not None and mesh.model > 1 else None


# ---------------------------------------------------------------------------
# The Megatron layout of the NeRF MLPs (the JAX ``nerf_param_shardings``).

def mlp_layout(mlp: dict, model: int) -> dict:
    """One JAX-layout MLP tree's layout: each leaf ``'col'`` (split along
    its output features: ``w``'s dim 1, a vector's dim 0), ``'row'``
    (``w``'s dim 0, its input features) or None (replicated).  Leaves
    need only a ``shape``."""
    if "trunk" not in mlp:
        return _replicated(mlp)

    def col(w) -> str | None:
        return "col" if model > 1 and w.shape[1] % model == 0 else None

    def row(w) -> str | None:
        return "row" if model > 1 and w.shape[0] % model == 0 else None

    def layer(spec_w: str | None, src: dict, bias: str | None) -> dict:
        out = {"w": spec_w, "b": bias}
        for extra in ("gamma", "beta"):
            if extra in src:
                out[extra] = bias
        return out

    trunk = []
    for i, src in enumerate(mlp["trunk"]):
        w = col(src["w"]) if i % 2 == 0 else row(src["w"])
        trunk.append(layer(w, src, "col" if w == "col" else None))
    feature = col(mlp["feature"]["w"])
    return {"trunk": trunk,
            "sigma": {"w": row(mlp["sigma"]["w"]), "b": None},
            "feature": {"w": feature, "b": feature},
            "branch": layer(None, mlp["branch"], None),
            "rgb": {"w": None, "b": None}}


def _replicated(tree):
    if isinstance(tree, dict):
        return {k: _replicated(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_replicated(v) for v in tree]
    return None


def param_layout(models: dict, model: int) -> dict:
    """``{name: layout}`` of a ``{'coarse', 'fine'}`` or ``{'proposal',
    'fine'}`` JAX-layout params tree over a model axis of ``model``
    (:func:`mlp_layout`; the proposal nets replicated).  ``model == 1``
    replicates everything."""
    return {name: mlp_layout(tree, model) for name, tree in models.items()}


def is_main(mesh: Mesh | None) -> bool:
    """True on rank 0, and in one process without a mesh: the rank that
    prints reports and writes files."""
    return mesh is None or mesh.rank == 0


def local_rows(n: int, mesh: Mesh) -> slice:
    """This rank's contiguous rows of a global batch of ``n`` rows: its
    data rank's share (every model rank of a data group holds the same)."""
    if n % mesh.data:
        raise ValueError(f"global batch of {n} rows not divisible by the data axis "
                         f"({mesh.data} ranks)")
    k = n // mesh.data
    return slice(mesh.data_rank * k, (mesh.data_rank + 1) * k)


def _count(axis: str, kind: str, n: int) -> None:
    calls[axis][kind] += 1
    elements[axis][kind] += n


def _group(mesh: Mesh, axis: str):
    return {"data": mesh.data_group, "model": mesh.model_group, "world": None}[axis]


def _size(mesh: Mesh, axis: str) -> int:
    return {"data": mesh.data, "model": mesh.model, "world": mesh.world}[axis]


def all_reduce_flat(tensors: list[torch.Tensor], mesh: Mesh,
                    axis: str = "data") -> list[torch.Tensor]:
    """The sums over the ``axis`` group of ``tensors`` (one dtype), as new
    tensors of their shapes: one flattened buffer, one all-reduce."""
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    _count(axis, "all_reduce", flat.numel())
    dist.all_reduce(flat, group=_group(mesh, axis))
    out, start = [], 0
    for t in tensors:
        out.append(flat[start:start + t.numel()].view(t.shape))
        start += t.numel()
    return out


def all_gather_cat(x: torch.Tensor, mesh: Mesh, axis: str = "data",
                   dim: int = 0) -> torch.Tensor:
    """Every ``axis`` rank's ``x`` (equal shapes) concatenated along
    ``dim``, in rank order."""
    n = _size(mesh, axis)
    parts = [torch.empty_like(x) for _ in range(n)]
    _count(axis, "all_gather", x.numel() * n)
    dist.all_gather(parts, x.detach().contiguous(), group=_group(mesh, axis))
    return torch.cat(parts, dim=dim)


def all_gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every data rank's ``x`` (equal shapes) stacked along rows, in rank
    order."""
    return all_gather_cat(x, mesh, "data", 0)


@torch.no_grad()
def broadcast_(tensors: list[torch.Tensor], mesh: Mesh, src: int = 0,
               axis: str = "world") -> None:
    """Overwrite ``tensors`` (one dtype) with global rank ``src``'s values,
    in place: one flattened buffer, one broadcast over ``axis``."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    _count(axis, "broadcast", flat.numel())
    dist.broadcast(flat, src, group=_group(mesh, axis))
    start = 0
    for t in tensors:
        t.copy_(flat[start:start + t.numel()].view(t.shape))
        start += t.numel()


def broadcast_object(obj: Any, mesh: Mesh, src: int = 0) -> Any:
    """Rank ``src``'s picklable ``obj`` on every rank (the others pass
    anything, e.g. None).  NCCL moves it through the rank's own device."""
    box = [obj]
    device = mesh.device if dist.get_backend() == "nccl" else torch.device("cpu")
    dist.broadcast_object_list(box, src, device=device)
    _count("world", "broadcast_object", len(pickle.dumps(box[0])))
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


def broadcast_tree_(tree, mesh: Mesh, src: int = 0) -> None:
    """Overwrite every tensor of ``tree`` (nested dicts and lists, the same
    layout on every rank) with rank ``src``'s, in place: one
    :func:`broadcast_` per dtype, dtypes in name order."""
    by_dtype: dict[str, list[torch.Tensor]] = {}
    for t in _leaves(tree):
        by_dtype.setdefault(str(t.dtype), []).append(t)
    for name in sorted(by_dtype):
        broadcast_(by_dtype[name], mesh, src)


def share_from_main(build: Callable[[], tuple[Any, Any]], mesh: Mesh | None):
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
    """A differentiable sum over the data group: each rank's input gets the
    sum of every rank's output cotangent (the summed value feeds every
    rank's loss)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return all_reduce_flat([x], mesh)[0]

    @staticmethod
    def backward(ctx, g):
        return all_reduce_flat([g], ctx.mesh)[0], None


def all_reduce_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of ``x`` over the data group, differentiable (one all-reduce
    forward, one backward); BatchNorm's global batch moments use it."""
    return _AllReduceSum.apply(x, mesh)


# ---------------------------------------------------------------------------
# The model axis: Megatron's f, g and the feature gather, each one
# collective over the model group forward or backward.

class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_flat([g], ctx.mesh, "model")[0], None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce_flat([x], mesh, "model")[0]

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.width = mesh, x.shape[-1]
        return all_gather_cat(x, mesh, "model", dim=-1)

    @staticmethod
    def backward(ctx, g):
        start = ctx.mesh.model_rank * ctx.width
        return g[..., start:start + ctx.width].contiguous(), None


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Identity forward; backward, the sum of the model ranks' cotangents
    (one all-reduce).  It feeds a replicated activation to the layers that
    read it on this rank's features only (a column split, or a row split's
    own slice), whose cotangents are each rank's part."""
    return _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of the model ranks' ``x`` (a row split's float32 partial
    products; one all-reduce); identity backward."""
    return _ReduceFromModel.apply(x, mesh)


def gather_from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The model ranks' feature shards ``(..., k)`` concatenated into
    ``(..., model * k)`` (one all-gather); backward, this rank's slice."""
    return _GatherFromModel.apply(x, mesh)


def shard(x: torch.Tensor, dim: int | None, mesh: Mesh | None) -> torch.Tensor:
    """This model rank's block of ``x`` along ``dim`` (None, or no model
    axis: ``x`` itself)."""
    if dim is None or mesh is None:
        return x
    k = x.shape[dim] // mesh.model
    return x.narrow(dim, mesh.model_rank * k, k)


def unshard(x: torch.Tensor, dim: int | None, mesh: Mesh | None) -> torch.Tensor:
    """The full tensor of the model ranks' blocks along ``dim`` (one
    all-gather; every model rank must call it), or ``x`` itself."""
    if dim is None or mesh is None:
        return x
    return all_gather_cat(x, mesh, "model", dim=dim)
