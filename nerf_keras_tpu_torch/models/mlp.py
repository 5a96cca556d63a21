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

Parameters carry across from the JAX pytree exactly
(:meth:`NeRFMLP.from_jax_params`, :meth:`NeRFMLP.to_jax_params`).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


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
        if batch_norm:
            raise NotImplementedError(
                "BATCH_NORM=true is not ported yet: the BatchNorm MLP "
                "variant arrives with the training slice in a later PR"
            )
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

    def heads(self) -> dict[str, nn.Linear]:
        """The non-trunk layers by their JAX pytree names."""
        return {"sigma": self.sigma, "feature": self.feature,
                "branch": self.branch, "rgb": self.rgb}

    def forward(self, x_enc: torch.Tensor, d_enc: torch.Tensor) -> torch.Tensor:
        """``(..., xyz_dim)`` and ``(..., dir_dim)`` encodings -> raw
        ``(..., 4)`` float32 ``[rgb_logits, sigma]``."""
        cd = self.compute_dtype
        x = x_enc
        for i, layer in enumerate(self.trunk):
            h = torch.relu(_dense(x, layer, cd))
            if is_skip(i, self.skip_layer):
                x = torch.cat([h, x_enc.to(h.dtype)], dim=-1)
            else:
                x = h
        sigma = _dense(x, self.sigma, cd)
        feature = _dense(x, self.feature, cd)
        feature = torch.cat([feature, d_enc.to(feature.dtype)], dim=-1)
        h = torch.relu(_dense(feature, self.branch, cd))
        rgb = _dense(h, self.rgb, cd)
        return torch.cat([rgb, sigma], dim=-1).to(torch.float32)

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
        for src, layer in pairs:
            if "gamma" in src:
                raise NotImplementedError(
                    "BatchNorm params are not ported yet (later PR)"
                )
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

    @classmethod
    def from_jax_params(
        cls, params: dict, skip_layer: int = 4,
        compute_dtype: torch.dtype = torch.bfloat16, device=None,
    ) -> "NeRFMLP":
        """Build a module whose shapes come from a JAX params tree:
        ``l_xyz`` from the first layer's input width, ``l_dir`` from the
        branch's."""
        w0 = np.asarray(params["trunk"][0]["w"])
        hidden = w0.shape[1]
        l_xyz = (w0.shape[0] - 3) // 6
        l_dir = (np.asarray(params["branch"]["w"]).shape[0] - hidden - 3) // 6
        mlp = cls(
            num_layers=len(params["trunk"]), hidden_dim=hidden,
            skip_layer=skip_layer, l_xyz=l_xyz, l_dir=l_dir,
            compute_dtype=compute_dtype, device=device,
        )
        return mlp.load_jax_params(params)

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
