"""Import the reference's Keras ``.weights.h5`` checkpoints.

Counterpart of ``nerf_keras_tpu/utils/keras_import.py``, the same mapping
on the port's own HDF5 reader (:mod:`nerf_keras_tpu_torch.utils.h5`; the
card's machine has no h5py).  Keras 3 lays ``save_weights`` out as::

    /coarse_model/layers/dense/vars/{0: kernel, 1: bias}
    /coarse_model/layers/dense_1/vars/...
    /coarse_model/layers/batch_normalization/vars/{0: gamma, 1: beta,
                                                   2: moving_mean,
                                                   3: moving_var}
    /fine_model/layers/...

The top-level groups are the reference trainer's attributes; the layer
groups are numbered in the model's walk order (depth order, so the four
heads come as feature, branch, rgb, sigma).  The trunk's Dense layers
are taken in that order, the heads matched by their unique kernel shapes,
and the BatchNorm layers in order with their variables as gamma, beta,
moving mean, moving variance.  The result is the JAX params layout as
numpy, which ``Trainer.replace_params`` takes.
"""

from __future__ import annotations

import re

import numpy as np

from nerf_keras_tpu_torch.config import NeRFConfig
from nerf_keras_tpu_torch.models.mlp import head_input_dim, trunk_input_dims
from nerf_keras_tpu_torch.utils.h5 import read_tree


def _nat_index(name: str) -> int:
    """'dense' -> 0, 'dense_7' -> 7 (Keras' auto-naming order)."""
    m = re.search(r"_(\d+)$", name)
    return int(m.group(1)) if m else 0


def _collect(group: dict) -> tuple[list[list[np.ndarray]], list[list[np.ndarray]]]:
    """The (Dense, BatchNorm) layers' variable lists of one model group, in
    walk order."""
    layers = group["layers"] if "layers" in group else group
    dense, bn = [], []
    for name, sub in layers.items():
        if not isinstance(sub, dict) or "vars" not in sub:
            continue
        arrs = [sub["vars"][k] for k in sorted(sub["vars"], key=int)]
        if name.startswith("dense"):
            dense.append((_nat_index(name), arrs))
        elif name.startswith("batch_normalization"):
            bn.append((_nat_index(name), arrs))
    dense.sort(key=lambda t: t[0])
    bn.sort(key=lambda t: t[0])
    return [a for _, a in dense], [a for _, a in bn]


def _import_one_model(group: dict, cfg: NeRFConfig) -> tuple[dict, dict | None]:
    """One model group -> (JAX-layout params, BatchNorm running statistics)."""
    dense, bn = _collect(group)
    n = cfg.num_layers
    if len(dense) != n + 4:
        raise ValueError(f"expected {n} trunk + 4 head dense layers, found {len(dense)}")

    hidden, dir_dim = cfg.hidden_dim, cfg.dir_dim
    dims = trunk_input_dims(n, hidden, cfg.skip_layer, cfg.xyz_dim)
    head_in = head_input_dim(n, hidden, cfg.skip_layer, cfg.xyz_dim)

    def dense_params(arrs, want_shape, what):
        w, b = arrs
        if w.shape != want_shape:
            raise ValueError(f"{what}: kernel shape {w.shape} != expected {want_shape} "
                             "— wrong config for this checkpoint?")
        return {"w": w.astype(np.float32), "b": b.astype(np.float32)}

    trunk = [dense_params(arrs, (dims[i], hidden), f"trunk[{i}]")
             for i, arrs in enumerate(dense[:n])]
    want = {
        "sigma": (head_in, 1),
        "feature": (head_in, hidden),
        "branch": (hidden + dir_dim, hidden // 2),
        "rgb": (hidden // 2, 3),
    }
    if len(set(want.values())) != 4:
        raise ValueError(f"ambiguous head shapes for this config: {want}")
    by_shape = {v: k for k, v in want.items()}
    heads: dict[str, dict] = {}
    for arrs in dense[n:]:
        slot = by_shape.get(tuple(arrs[0].shape))
        if slot is None or slot in heads:
            raise ValueError(f"unmatched head kernel of shape {arrs[0].shape}; "
                             f"expected one of {want}")
        heads[slot] = dense_params(arrs, want[slot], slot)
    params = {"trunk": trunk, **heads}

    if not bn:
        return params, None
    if len(bn) != n + 1:
        raise ValueError(f"expected {n} trunk + 1 branch BatchNorm layers, found {len(bn)}")
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    for dst, arrs in zip([*params["trunk"], params["branch"]], bn):
        dst["gamma"], dst["beta"] = f32(arrs[0]), f32(arrs[1])
    stats = [{"mean": f32(arrs[2]), "var": f32(arrs[3])} for arrs in bn]
    return params, {"trunk": stats[:n], "branch": stats[n]}


def import_reference_weights(path: str, cfg: NeRFConfig) -> tuple[dict, dict | None]:
    """Load a reference ``.weights.h5`` into ``(params, bn_state)``:
    ``{'coarse': mlp, 'fine': mlp}`` JAX-layout trees of float32 numpy
    arrays, and the BatchNorm running statistics in the same two slots
    (None without BatchNorm).

    Raises:
        KeyError: the file has no ``coarse_model`` or ``fine_model`` group.
        ValueError: a layer count or kernel shape that does not fit ``cfg``,
            ambiguous heads, BatchNorm layers present where ``cfg`` has
            none or the other way round, or a file outside the HDF5 subset
            Keras writes.
    """
    tree = read_tree(path)
    out_p, out_bn = {}, {}
    for ours, theirs in (("coarse", "coarse_model"), ("fine", "fine_model")):
        if not isinstance(tree.get(theirs), dict):
            raise KeyError(f"{path} has no '{theirs}' group; found {list(tree)} — "
                           "not a reference NeRFTrainer weights file?")
        out_p[ours], out_bn[ours] = _import_one_model(tree[theirs], cfg)
        has_bn = out_bn[ours] is not None
        if has_bn != cfg.batch_norm:
            raise ValueError(
                f"{path}: checkpoint {'has' if has_bn else 'has no'} BatchNorm layers but "
                f"the config sets BATCH_NORM={'true' if cfg.batch_norm else 'false'}")
    if all(v is None for v in out_bn.values()):
        return out_p, None
    return out_p, out_bn
