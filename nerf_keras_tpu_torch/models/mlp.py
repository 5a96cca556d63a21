"""The NeRF MLP as an ``nn.Module``.

Counterpart of ``nerf_keras_tpu/models/mlp.py``: ``num_layers`` trunk
Dense+ReLU layers of width ``hidden_dim`` over the encoded position, with
the encoded position concatenated back in (order ``[h, x_enc]``) after
layer ``i`` whenever ``i % skip_layer == 0 and i > 0``; a 1-wide sigma
head and a ``hidden_dim`` feature layer off the trunk; the feature
concatenated with the encoded direction (order ``[feature, d_enc]``)
into a ``hidden_dim // 2`` ReLU branch and a 3-wide rgb head.  The output
is raw ``[rgb_logits, sigma]``; activations apply in ``volume_render``.

Mixed precision follows the JAX package: each product takes its operands
in ``compute_dtype`` and accumulates in float32, biases add in float32.
The plain path here emulates that by rounding the operands to
``compute_dtype`` and multiplying in float32 (TF32 is off, see
``runtime.py``), so the rounding sits exactly where the kernel's does:
the encodings, each post-ReLU hidden, and the feature before the concat.

The BatchNorm variant (``BATCH_NORM``; Dense -> BN -> ReLU in every
trunk layer and the branch) is Keras' BatchNormalization at its defaults,
as the JAX ``_batch_norm`` computes it: normalised over every axis but
the last (all rays x samples of a pass), eps 1e-3, and in training the
running statistics become ``0.99 old + 0.01 batch`` with the *biased*
batch variance (``nn.BatchNorm1d`` would store the unbiased one, under
the opposite momentum convention).  The running statistics are buffers
of the module; ``forward(..., bn_train=True)`` normalises with the batch
statistics and updates them, otherwise the running ones are used.  No
kernel has a BatchNorm variant: BN models run this plain path on every
device.

Parameters carry across from the JAX pytree exactly
(:meth:`NeRFMLP.from_jax_params`, :meth:`NeRFMLP.to_jax_params`, with
``gamma``/``beta`` in the BN layers; :meth:`NeRFMLP.bn_state` and
:meth:`NeRFMLP.load_bn_state` for the running statistics, the JAX
``bn_state`` layout).

Tensor parallelism (a mesh with ``model > 1``, ``MESH_MODEL``): the module
is initialised whole, as in one process, and then keeps this rank's
blocks of each leaf by ``parallel/mesh.mlp_layout`` (the JAX
``nerf_param_shardings``).  A column-split layer takes a replicated
input (through ``copy_to_model``) and gives its own output features; a
row-split layer takes its own input features (its slice of a replicated
input) and gives a float32 partial product that ``reduce_from_model``
sums before the bias is added, once; a replicated layer whose input is
split gathers it first (``gather_from_model``), as do the skip concat
and the ``feature || d_enc`` concat.  At 8x256, skip 4, one forward is 4
all-reduces (layers 1, 3, 7 and sigma) and 2 all-gathers (after layer 4
and the feature) over the model group.  The products keep ``_dense``'s
rounding.  The JAX-layout trees in and out stay whole: loading slices
them, reading them gathers them (a collective every model rank makes).
BatchNorm on a column split normalises its own features, its moments
summed over the data group.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from nerf_keras_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce_sum,
    copy_to_model,
    gather_from_model,
    mlp_layout,
    reduce_from_model,
    shard,
    split_model,
    unshard,
)


def trunk_input_dims(
    num_layers: int, hidden_dim: int, skip_layer: int, xyz_dim: int
) -> list[int]:
    """Input width of each trunk layer, accounting for skip concats."""
    dims = []
    for i in range(num_layers):
        if i == 0:
            dims.append(xyz_dim)
        elif (i - 1) % skip_layer == 0 and (i - 1) > 0:
            dims.append(hidden_dim + xyz_dim)
        else:
            dims.append(hidden_dim)
    return dims


def head_input_dim(
    num_layers: int, hidden_dim: int, skip_layer: int, xyz_dim: int
) -> int:
    """Input width of the sigma/feature heads: the concatenated width when
    the final trunk layer is itself a skip layer."""
    last = num_layers - 1
    if last % skip_layer == 0 and last > 0:
        return hidden_dim + xyz_dim
    return hidden_dim


def is_skip(i: int, skip_layer: int) -> bool:
    """Layer ``i``'s output gets the encoded position concatenated back."""
    return i % skip_layer == 0 and i > 0


def _glorot_linear(in_dim: int, out_dim: int, generator, device) -> nn.Linear:
    """Keras Dense defaults: glorot-uniform weights, zero biases."""
    layer = nn.Linear(in_dim, out_dim, device=device)
    limit = (6.0 / (in_dim + out_dim)) ** 0.5
    with torch.no_grad():
        w = torch.rand((out_dim, in_dim), generator=generator,
                       dtype=torch.float32)
        layer.weight.copy_((w * 2.0 - 1.0) * limit)
        layer.bias.zero_()
    return layer


BN_MOMENTUM = 0.99  # keras BatchNormalization default
BN_EPS = 1e-3  # keras BatchNormalization default


class KerasBatchNorm(nn.Module):
    """Keras-default BatchNormalization over every axis but the last:
    ``gamma``/``beta`` parameters, ``mean``/``var`` running buffers.

    Under a mesh the training moments are those of the global batch, as
    ``jnp.mean``/``jnp.var`` of a sharded array give them: the mean of
    the data ranks' sums, then the mean of the centred squares, each
    through a differentiable all-reduce over the data group (two forward,
    two backward per layer), so the running statistics stay identical on
    every rank of a model index.  On a column split the layer holds its
    own features' parameters and statistics."""

    def __init__(self, width: int, device=None):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(width, device=device))
        self.beta = nn.Parameter(torch.zeros(width, device=device))
        self.register_buffer("mean", torch.zeros(width, device=device))
        self.register_buffer("var", torch.ones(width, device=device))

    def forward(self, x: torch.Tensor, train: bool, mesh: Mesh | None = None) -> torch.Tensor:
        if train:
            flat = x.reshape(-1, x.shape[-1])
            if mesh is None:
                mean = flat.mean(dim=0)
                var = torch.square(flat - mean).mean(dim=0)  # biased, as jnp.var
            else:
                n = flat.shape[0] * mesh.data
                mean = all_reduce_sum(flat.sum(dim=0), mesh) / n
                var = all_reduce_sum(torch.square(flat - mean).sum(dim=0), mesh) / n
            with torch.no_grad():
                self.mean.copy_(BN_MOMENTUM * self.mean + (1 - BN_MOMENTUM) * mean)
                self.var.copy_(BN_MOMENTUM * self.var + (1 - BN_MOMENTUM) * var)
        else:
            mean, var = self.mean, self.var
        inv = torch.rsqrt(var + BN_EPS) * self.gamma
        return (x - mean) * inv + self.beta


def _product(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """``x @ w``: operands rounded to ``dtype``, float32 accumulation."""
    return x.to(dtype).to(torch.float32) @ layer.weight.to(dtype).to(torch.float32).T


def _dense(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """``x @ w + b``: operands rounded to ``dtype``, float32 accumulation,
    float32 bias."""
    return _product(x, layer, dtype) + layer.bias


def _wdim(kind: str | None) -> int | None:
    """The split dimension of an ``nn.Linear`` weight ``(out, in)``."""
    return {"col": 0, "row": 1}.get(kind)


def _bdim(kind: str | None) -> int | None:
    """The split dimension of a layer's bias and BatchNorm vectors."""
    return 0 if kind == "col" else None


class _Act:
    """An activation of the split forward: the value, whether it holds
    this rank's features only, and its :func:`copy_to_model` view, which
    every layer reading it on this rank's features shares (one all-reduce
    of their summed cotangents)."""

    def __init__(self, x: torch.Tensor, sharded: bool, mesh: Mesh):
        self.x, self.sharded, self.mesh, self._copied = x, sharded, mesh, None

    def full(self) -> torch.Tensor:
        if self.sharded:
            self.x, self.sharded = gather_from_model(self.x, self.mesh), False
        return self.x

    def copied(self) -> torch.Tensor:
        if self._copied is None:
            self._copied = copy_to_model(self.full(), self.mesh)
        return self._copied


class NeRFMLP(nn.Module):
    """One NeRF MLP (the coarse+fine model holds two)."""

    def __init__(
        self,
        num_layers: int = 8,
        hidden_dim: int = 256,
        skip_layer: int = 4,
        l_xyz: int = 10,
        l_dir: int = 4,
        batch_norm: bool = False,
        compute_dtype: torch.dtype = torch.bfloat16,
        generator: torch.Generator | None = None,
        device=None,
        mesh: Mesh | None = None,
    ):
        super().__init__()
        self.batch_norm = batch_norm
        self.num_layers = num_layers
        self.hidden_dim = hidden_dim
        self.skip_layer = skip_layer
        self.l_xyz = l_xyz
        self.l_dir = l_dir
        self.compute_dtype = compute_dtype
        self.xyz_dim = 3 + 2 * 3 * l_xyz
        self.dir_dim = 3 + 2 * 3 * l_dir
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        dims = trunk_input_dims(num_layers, hidden_dim, skip_layer, self.xyz_dim)
        head_in = head_input_dim(num_layers, hidden_dim, skip_layer, self.xyz_dim)
        lin = lambda i, o: _glorot_linear(i, o, generator, device)  # noqa: E731
        self.trunk = nn.ModuleList([lin(d, hidden_dim) for d in dims])
        self.sigma = lin(head_in, 1)
        self.feature = lin(head_in, hidden_dim)
        self.branch = lin(hidden_dim + self.dir_dim, hidden_dim // 2)
        self.rgb = lin(hidden_dim // 2, 3)
        if batch_norm:
            self.trunk_bn = nn.ModuleList(
                [KerasBatchNorm(hidden_dim, device) for _ in range(num_layers)])
            self.branch_bn = KerasBatchNorm(hidden_dim // 2, device)
        # The model axis this module is split over (None: whole), and each
        # dense layer's split (dense_layers() order).
        self.tp: Mesh | None = None
        self.kinds: list[str | None] = [None] * (num_layers + 4)
        if split_model(mesh) is not None:
            self._split(mesh)

    @torch.no_grad()
    def _split(self, mesh: Mesh) -> None:
        """Keep this model rank's blocks of every leaf (the whole module's
        :func:`mlp_layout` over ``mesh.model``)."""
        layout = mlp_layout(self.to_jax_params(), mesh.model)
        self.kinds = ([layer["w"] for layer in layout["trunk"]]
                      + [layout[k]["w"] for k in self.heads()])
        for layer, kind in zip(self.dense_layers(), self.kinds):
            layer.weight = nn.Parameter(shard(layer.weight, _wdim(kind), mesh).clone())
            layer.bias = nn.Parameter(shard(layer.bias, _bdim(kind), mesh).clone())
        for bn, kind in self._bn_kinds():
            for name in ("gamma", "beta"):
                setattr(bn, name, nn.Parameter(shard(getattr(bn, name), _bdim(kind),
                                                     mesh).clone()))
            for name in ("mean", "var"):
                setattr(bn, name, shard(getattr(bn, name), _bdim(kind), mesh).clone())
        self.tp = mesh

    def dense_layers(self) -> list[nn.Linear]:
        """The trunk, then sigma, feature, branch and rgb."""
        return [*self.trunk, *self.heads().values()]

    def _bn_kinds(self) -> list[tuple[KerasBatchNorm, str | None]]:
        """Each BN module with the split of the layer it follows."""
        return list(zip(self.bn_layers(), [*self.kinds[:self.num_layers], None]))

    def bn_layers(self) -> list[KerasBatchNorm]:
        """The BN modules by position: each trunk layer's, then the branch's."""
        return [*self.trunk_bn, self.branch_bn] if self.batch_norm else []

    def heads(self) -> dict[str, nn.Linear]:
        """The non-trunk layers by their JAX pytree names."""
        return {"sigma": self.sigma, "feature": self.feature,
                "branch": self.branch, "rgb": self.rgb}

    def forward(self, x_enc: torch.Tensor, d_enc: torch.Tensor,
                bn_train: bool = False, mesh: Mesh | None = None) -> torch.Tensor:
        """``(..., xyz_dim)`` and ``(..., dir_dim)`` encodings -> raw
        ``(..., 4)`` float32 ``[rgb_logits, sigma]``.  ``bn_train``: the BN
        layers normalise with this pass's statistics (the global batch's
        under ``mesh``) and update their running ones (ignored without
        BN)."""
        if self.tp is not None:
            return self._split_forward(x_enc, d_enc, bn_train, mesh)
        cd = self.compute_dtype
        x = x_enc
        for i, layer in enumerate(self.trunk):
            h = _dense(x, layer, cd)
            if self.batch_norm:
                h = self.trunk_bn[i](h, bn_train, mesh)
            h = torch.relu(h)
            if is_skip(i, self.skip_layer):
                x = torch.cat([h, x_enc.to(h.dtype)], dim=-1)
            else:
                x = h
        sigma = _dense(x, self.sigma, cd)
        feature = _dense(x, self.feature, cd)
        feature = torch.cat([feature, d_enc.to(feature.dtype)], dim=-1)
        h = _dense(feature, self.branch, cd)
        if self.batch_norm:
            h = self.branch_bn(h, bn_train, mesh)
        h = torch.relu(h)
        rgb = _dense(h, self.rgb, cd)
        return torch.cat([rgb, sigma], dim=-1).to(torch.float32)

    def sigma_logits(self, x_enc: torch.Tensor) -> torch.Tensor:
        """Density only: the trunk and the sigma head on ``(..., xyz_dim)``
        encodings, raw ``(...,)`` float32 logits before the ReLU (the
        JAX ``apply_nerf_sigma``).  Sigma reads the trunk before the
        direction concat, so the feature, branch and rgb products are
        skipped.  The proposal distillation is its one caller, and it has
        no BatchNorm variant."""
        if self.batch_norm:
            raise ValueError("the density-only pass has no BatchNorm variant (the "
                             "proposal sampler needs a model without BATCH_NORM)")
        if self.tp is not None:
            return self._split_forward(x_enc, None)[..., 0].to(torch.float32)
        cd = self.compute_dtype
        x = x_enc
        for i, layer in enumerate(self.trunk):
            h = torch.relu(_dense(x, layer, cd))
            x = torch.cat([h, x_enc.to(h.dtype)], dim=-1) if is_skip(i, self.skip_layer) else h
        return _dense(x, self.sigma, cd)[..., 0].to(torch.float32)

    def _split_dense(self, a: _Act, layer: nn.Linear, kind: str | None) -> tuple[
            torch.Tensor, bool]:
        """One layer of the split forward: its output and whether that is
        this rank's features only."""
        cd = self.compute_dtype
        if kind == "col":
            return _dense(a.copied(), layer, cd), True
        if kind == "row":
            if a.sharded:
                x = a.x
            else:
                k = layer.weight.shape[1]
                x = a.copied()[..., self.tp.model_rank * k:(self.tp.model_rank + 1) * k]
            return reduce_from_model(_product(x, layer, cd), self.tp) + layer.bias, False
        return _dense(a.full(), layer, cd), False

    def _split_forward(self, x_enc: torch.Tensor, d_enc: torch.Tensor | None,
                       bn_train: bool = False, mesh: Mesh | None = None) -> torch.Tensor:
        """:meth:`forward` over the model axis (module docstring); with
        ``d_enc`` None the raw sigma ``(..., 1)`` alone."""
        tp = self.tp
        a = _Act(x_enc, False, tp)
        for i, layer in enumerate(self.trunk):
            h, sharded = self._split_dense(a, layer, self.kinds[i])
            if self.batch_norm:
                h = self.trunk_bn[i](h, bn_train, mesh)
            h = torch.relu(h)
            if is_skip(i, self.skip_layer):
                h = gather_from_model(h, tp) if sharded else h
                a = _Act(torch.cat([h, x_enc.to(h.dtype)], dim=-1), False, tp)
            else:
                a = _Act(h, sharded, tp)
        n = self.num_layers
        sigma, _ = self._split_dense(a, self.sigma, self.kinds[n])
        if d_enc is None:
            return sigma
        feature, sharded = self._split_dense(a, self.feature, self.kinds[n + 1])
        feature = gather_from_model(feature, tp) if sharded else feature
        feature = torch.cat([feature, d_enc.to(feature.dtype)], dim=-1)
        h = _dense(feature, self.branch, self.compute_dtype)
        if self.batch_norm:
            h = self.branch_bn(h, bn_train, mesh)
        rgb = _dense(torch.relu(h), self.rgb, self.compute_dtype)
        return torch.cat([rgb, sigma], dim=-1).to(torch.float32)

    # ------------------------------------------------------------------
    # The JAX params pytree: {'trunk': [{'w','b'}...], 'sigma', 'feature',
    # 'branch', 'rgb'}, w laid out (in, out) — nn.Linear keeps (out, in).

    @torch.no_grad()
    def load_jax_params(self, params: dict) -> "NeRFMLP":
        """Copy a JAX-layout params tree (numpy or tensors, whole) into this
        module (this rank's blocks of it when split), exactly; shapes must
        match."""
        if len(params["trunk"]) != len(self.trunk):
            raise ValueError(
                f"params have {len(params['trunk'])} trunk layers, the "
                f"module {len(self.trunk)}"
            )
        if ("gamma" in params["trunk"][0]) != self.batch_norm:
            raise ValueError(
                f"params {'carry' if not self.batch_norm else 'lack'} BatchNorm "
                f"gamma/beta, the module has batch_norm={self.batch_norm}"
            )
        srcs = [*params["trunk"], *(params[k] for k in self.heads())]
        bn_srcs = [*params["trunk"], params["branch"]] if self.batch_norm else []
        for src, (bn, kind) in zip(bn_srcs, self._bn_kinds()):
            bn.gamma.copy_(self._local(src["gamma"], _bdim(kind)))
            bn.beta.copy_(self._local(src["beta"], _bdim(kind)))
        for src, layer, kind in zip(srcs, self.dense_layers(), self.kinds):
            w = torch.tensor(np.asarray(src["w"], np.float32)).T
            full = list(layer.weight.shape)
            if self.tp is not None and _wdim(kind) is not None:
                full[_wdim(kind)] *= self.tp.model
            if list(w.shape) != full:
                raise ValueError(
                    f"weight shape {tuple(w.shape[::-1])} does not match the "
                    f"module's (in, out) = {tuple(full[::-1])}"
                )
            layer.weight.copy_(shard(w, _wdim(kind), self.tp))
            layer.bias.copy_(self._local(src["b"], _bdim(kind)))
        return self

    def _local(self, x, dim: int | None) -> torch.Tensor:
        """This rank's block of a whole float32 array along ``dim``."""
        return shard(torch.tensor(np.asarray(x, np.float32)), dim, self.tp)

    def _whole(self, t: torch.Tensor, dim: int | None) -> np.ndarray:
        """The whole float32 array of this rank's block ``t`` (a gather
        over the model group when split along ``dim``)."""
        return unshard(t.detach(), dim, self.tp).float().cpu().numpy().copy()

    @torch.no_grad()
    def load_bn_state(self, bn_state: dict) -> "NeRFMLP":
        """Copy JAX-layout running statistics (``{'trunk': [{'mean',
        'var'}...], 'branch': {...}}``) into the BN buffers."""
        for src, (bn, kind) in zip([*bn_state["trunk"], bn_state["branch"]],
                                   self._bn_kinds()):
            bn.mean.copy_(self._local(src["mean"], _bdim(kind)))
            bn.var.copy_(self._local(src["var"], _bdim(kind)))
        return self

    @torch.no_grad()
    def bn_state(self) -> dict | None:
        """The running statistics in the JAX ``bn_state`` layout (float32
        numpy, whole), or None without BN."""
        if not self.batch_norm:
            return None
        stats = [{"mean": self._whole(bn.mean, _bdim(kind)),
                  "var": self._whole(bn.var, _bdim(kind))} for bn, kind in self._bn_kinds()]
        return {"trunk": stats[:-1], "branch": stats[-1]}

    @classmethod
    def from_jax_params(
        cls, params: dict, skip_layer: int = 4,
        compute_dtype: torch.dtype = torch.bfloat16, device=None,
        bn_state: dict | None = None, mesh: Mesh | None = None,
    ) -> "NeRFMLP":
        """Build a module whose shapes come from a JAX params tree:
        ``l_xyz`` from the first layer's input width, ``l_dir`` from the
        branch's, BatchNorm when the layers carry ``gamma`` (with
        ``bn_state``'s running statistics, else the init ones); split over
        ``mesh``'s model axis when it has one."""
        w0 = np.asarray(params["trunk"][0]["w"])
        hidden = w0.shape[1]
        l_xyz = (w0.shape[0] - 3) // 6
        l_dir = (np.asarray(params["branch"]["w"]).shape[0] - hidden - 3) // 6
        mlp = cls(
            num_layers=len(params["trunk"]), hidden_dim=hidden,
            skip_layer=skip_layer, l_xyz=l_xyz, l_dir=l_dir,
            batch_norm="gamma" in params["trunk"][0],
            compute_dtype=compute_dtype, device=device, mesh=mesh,
        )
        mlp.load_jax_params(params)
        return mlp if bn_state is None else mlp.load_bn_state(bn_state)

    @torch.no_grad()
    def to_jax_params(self, grad: bool = False) -> dict:
        """The JAX-layout params tree as whole float32 numpy arrays (split:
        gathered over the model group, on every model rank); with ``grad``
        the parameters' ``.grad`` in the same layout."""

        def val(p: torch.Tensor, dim: int | None) -> np.ndarray:
            return self._whole(p.grad if grad else p, dim)

        trees = [{"w": val(layer.weight, _wdim(kind)).T.copy(),
                  "b": val(layer.bias, _bdim(kind))}
                 for layer, kind in zip(self.dense_layers(), self.kinds)]
        out = {"trunk": trees[:self.num_layers]}
        out.update(zip(self.heads(), trees[self.num_layers:]))
        for dst, (bn, kind) in zip([*out["trunk"], out["branch"]], self._bn_kinds()):
            dst["gamma"] = val(bn.gamma, _bdim(kind))
            dst["beta"] = val(bn.beta, _bdim(kind))
        return out


@torch.no_grad()
def randomize_biases_(
    mlp: NeRFMLP, generator: torch.Generator,
    std: float = 0.1, sigma_shift: float = 1.0,
) -> NeRFMLP:
    """Fill every bias with ``N(0, std)`` noise and add ``sigma_shift`` to
    the sigma bias, in place.

    The glorot init leaves every bias at 0, which a trained checkpoint
    never does.  Random weights made for checks and timings pass through
    this so the bias path is exercised (a dropped or misplaced bias
    moves rgb by ~1e-2) and the field is dense enough for the coarse
    weights to steer the fine samples.
    """
    for layer in (*mlp.trunk, *mlp.heads().values()):
        noise = torch.randn(layer.bias.shape, generator=generator) * std
        layer.bias.copy_(noise)
    mlp.sigma.bias.add_(sigma_shift)
    return mlp


def random_params(cfg, seed: int = 0) -> dict:
    """``{'coarse', 'fine'}`` JAX-layout params at ``cfg``'s widths:
    glorot weights and :func:`randomize_biases_` biases from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    return {
        name: randomize_biases_(NeRFMLP(
            num_layers=cfg.num_layers, hidden_dim=cfg.hidden_dim,
            skip_layer=cfg.skip_layer, l_xyz=cfg.l_xyz, l_dir=cfg.l_dir,
            generator=gen,
        ), gen).to_jax_params()
        for name in ("coarse", "fine")
    }
