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
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from nerf_keras_tpu_torch.parallel.mesh import DataMesh, all_reduce_sum


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

    Under a data mesh the training moments are those of the global batch,
    as ``jnp.mean``/``jnp.var`` of a sharded array give them: the mean of
    the rank sums, then the mean of the centred squares, each through a
    differentiable all-reduce (two forward, two backward per layer), so
    the running statistics stay identical on every rank."""

    def __init__(self, width: int, device=None):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(width, device=device))
        self.beta = nn.Parameter(torch.zeros(width, device=device))
        self.register_buffer("mean", torch.zeros(width, device=device))
        self.register_buffer("var", torch.ones(width, device=device))

    def forward(self, x: torch.Tensor, train: bool, mesh: DataMesh | None = None) -> torch.Tensor:
        if train:
            flat = x.reshape(-1, x.shape[-1])
            if mesh is None:
                mean = flat.mean(dim=0)
                var = torch.square(flat - mean).mean(dim=0)  # biased, as jnp.var
            else:
                n = flat.shape[0] * mesh.world
                mean = all_reduce_sum(flat.sum(dim=0), mesh) / n
                var = all_reduce_sum(torch.square(flat - mean).sum(dim=0), mesh) / n
            with torch.no_grad():
                self.mean.copy_(BN_MOMENTUM * self.mean + (1 - BN_MOMENTUM) * mean)
                self.var.copy_(BN_MOMENTUM * self.var + (1 - BN_MOMENTUM) * var)
        else:
            mean, var = self.mean, self.var
        inv = torch.rsqrt(var + BN_EPS) * self.gamma
        return (x - mean) * inv + self.beta


def _dense(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """``x @ w + b``: operands rounded to ``dtype``, float32 accumulation,
    float32 bias."""
    xw = x.to(dtype).to(torch.float32) @ layer.weight.to(dtype).to(torch.float32).T
    return xw + layer.bias


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

    def bn_layers(self) -> list[KerasBatchNorm]:
        """The BN modules by position: each trunk layer's, then the branch's."""
        return [*self.trunk_bn, self.branch_bn] if self.batch_norm else []

    def heads(self) -> dict[str, nn.Linear]:
        """The non-trunk layers by their JAX pytree names."""
        return {"sigma": self.sigma, "feature": self.feature,
                "branch": self.branch, "rgb": self.rgb}

    def forward(self, x_enc: torch.Tensor, d_enc: torch.Tensor,
                bn_train: bool = False, mesh: DataMesh | None = None) -> torch.Tensor:
        """``(..., xyz_dim)`` and ``(..., dir_dim)`` encodings -> raw
        ``(..., 4)`` float32 ``[rgb_logits, sigma]``.  ``bn_train``: the BN
        layers normalise with this pass's statistics (the global batch's
        under ``mesh``) and update their running ones (ignored without
        BN)."""
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
        cd = self.compute_dtype
        x = x_enc
        for i, layer in enumerate(self.trunk):
            h = torch.relu(_dense(x, layer, cd))
            x = torch.cat([h, x_enc.to(h.dtype)], dim=-1) if is_skip(i, self.skip_layer) else h
        return _dense(x, self.sigma, cd)[..., 0].to(torch.float32)

    # ------------------------------------------------------------------
    # The JAX params pytree: {'trunk': [{'w','b'}...], 'sigma', 'feature',
    # 'branch', 'rgb'}, w laid out (in, out) — nn.Linear keeps (out, in).

    @torch.no_grad()
    def load_jax_params(self, params: dict) -> "NeRFMLP":
        """Copy a JAX-layout params tree (numpy or tensors) into this
        module, exactly; shapes must match."""
        pairs = list(zip(params["trunk"], self.trunk))
        pairs += [(params[k], layer) for k, layer in self.heads().items()]
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
        bn_srcs = [*params["trunk"], params["branch"]] if self.batch_norm else []
        for src, bn in zip(bn_srcs, self.bn_layers()):
            bn.gamma.copy_(torch.tensor(np.asarray(src["gamma"], np.float32)))
            bn.beta.copy_(torch.tensor(np.asarray(src["beta"], np.float32)))
        for src, layer in pairs:
            w = torch.tensor(np.asarray(src["w"], np.float32))
            b = torch.tensor(np.asarray(src["b"], np.float32))
            if tuple(w.shape) != tuple(layer.weight.shape[::-1]):
                raise ValueError(
                    f"weight shape {tuple(w.shape)} does not match the "
                    f"module's (in, out) = {tuple(layer.weight.shape[::-1])}"
                )
            layer.weight.copy_(w.T)
            layer.bias.copy_(b)
        return self

    @torch.no_grad()
    def load_bn_state(self, bn_state: dict) -> "NeRFMLP":
        """Copy JAX-layout running statistics (``{'trunk': [{'mean',
        'var'}...], 'branch': {...}}``) into the BN buffers."""
        for src, bn in zip([*bn_state["trunk"], bn_state["branch"]], self.bn_layers()):
            bn.mean.copy_(torch.tensor(np.asarray(src["mean"], np.float32)))
            bn.var.copy_(torch.tensor(np.asarray(src["var"], np.float32)))
        return self

    @torch.no_grad()
    def bn_state(self) -> dict | None:
        """The running statistics in the JAX ``bn_state`` layout (float32
        numpy), or None without BN."""
        if not self.batch_norm:
            return None
        stats = [{"mean": bn.mean.float().cpu().numpy().copy(),
                  "var": bn.var.float().cpu().numpy().copy()} for bn in self.bn_layers()]
        return {"trunk": stats[:-1], "branch": stats[-1]}

    @classmethod
    def from_jax_params(
        cls, params: dict, skip_layer: int = 4,
        compute_dtype: torch.dtype = torch.bfloat16, device=None,
        bn_state: dict | None = None,
    ) -> "NeRFMLP":
        """Build a module whose shapes come from a JAX params tree:
        ``l_xyz`` from the first layer's input width, ``l_dir`` from the
        branch's, BatchNorm when the layers carry ``gamma`` (with
        ``bn_state``'s running statistics, else the init ones)."""
        w0 = np.asarray(params["trunk"][0]["w"])
        hidden = w0.shape[1]
        l_xyz = (w0.shape[0] - 3) // 6
        l_dir = (np.asarray(params["branch"]["w"]).shape[0] - hidden - 3) // 6
        mlp = cls(
            num_layers=len(params["trunk"]), hidden_dim=hidden,
            skip_layer=skip_layer, l_xyz=l_xyz, l_dir=l_dir,
            batch_norm="gamma" in params["trunk"][0],
            compute_dtype=compute_dtype, device=device,
        )
        mlp.load_jax_params(params)
        return mlp if bn_state is None else mlp.load_bn_state(bn_state)

    @torch.no_grad()
    def to_jax_params(self, grad: bool = False) -> dict:
        """The JAX-layout params tree as float32 numpy arrays; with
        ``grad`` the parameters' ``.grad`` in the same layout."""

        def val(p: torch.Tensor) -> np.ndarray:
            return (p.grad if grad else p).detach().float().cpu().numpy()

        def dense(layer: nn.Linear) -> dict:
            return {"w": val(layer.weight).T.copy(), "b": val(layer.bias).copy()}

        out = {"trunk": [dense(layer) for layer in self.trunk]}
        out.update({k: dense(layer) for k, layer in self.heads().items()})
        for dst, bn in zip([*out["trunk"], out["branch"]], self.bn_layers()):
            dst["gamma"] = val(bn.gamma).copy()
            dst["beta"] = val(bn.beta).copy()
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
