"""Export to the reference's Keras ``.weights.h5`` checkpoint format.

Counterpart of ``nerf_keras_tpu/utils/keras_export.py``, the inverse of
:mod:`nerf_keras_tpu_torch.utils.keras_import`, written by the port's own
HDF5 writer (:mod:`nerf_keras_tpu_torch.utils.h5`): the reference loads
the file with ``NeRFTrainer.load_weights(path)``.

Keras 3 lays ``save_weights`` out as::

    /<attribute name>/layers/<class_slug[_i]>/vars/{0: kernel, 1: bias}

where ``<class_slug[_i]>`` is the snake-cased layer class with a counter
per file, assigned in the model's walk order (graph depth, not creation
order; each ``vars`` group records the creation-order layer ``name`` as an
attribute, which ``load_weights`` ignores).  The walk visits, per model:

- ``input_layer``, ``input_layer_1`` (no vars);
- the trunk's Dense layers from input to output (``dense`` ..
  ``dense_{n-1}``);
- the heads by depth: feature, branch, rgb, sigma (``dense_n`` ..
  ``dense_{n+3}``);
- the Concatenate layers (the skip concats, then the directions, then
  the rgb|sigma output; no vars);
- with ``BATCH_NORM``: BatchNormalization for the trunk then the branch
  (gamma, beta, moving_mean, moving_var) and the matching ReLU layers (no
  vars).

Keras walks its own model and looks each layer's group up by path, so the
groups without variables must exist too.
"""

from __future__ import annotations

import numpy as np

from nerf_keras_tpu_torch.config import NeRFConfig
from nerf_keras_tpu_torch.utils.h5 import write_tree


class _Walk:
    """Keras' per-class counter naming, in walk order, into one ``layers``
    group (a dict) and the ``name`` attributes (``{path: {'name': ...}}``)."""

    def __init__(self, layers: dict, path: str, attrs: dict):
        self.layers, self.path, self.attrs = layers, path, attrs
        self.counts: dict[str, int] = {}

    def add(self, slug: str, name: str, arrays: list) -> None:
        i = self.counts.get(slug, 0)
        self.counts[slug] = i + 1
        key = slug if i == 0 else f"{slug}_{i}"
        self.layers[key] = {"vars": {str(j): np.asarray(a, np.float32)
                                     for j, a in enumerate(arrays)}}
        self.attrs[f"{self.path}/{key}/vars"] = {"name": name}


class _Namer:
    """Creation-order layer names (the ``name`` attribute Keras records)."""

    def __init__(self):
        self.counts: dict[str, int] = {}

    def __call__(self, slug: str) -> str:
        i = self.counts.get(slug, 0)
        self.counts[slug] = i + 1
        return slug if i == 0 else f"{slug}_{i}"


def _export_one_model(tree: dict, attrs: dict, group_name: str, params: dict,
                      bn_state: dict | None, namer: _Namer, skip_layer: int) -> None:
    layers: dict = {}
    tree[group_name] = {"layers": layers, "vars": {}}
    attrs[f"/{group_name}/vars"] = {"name": namer("functional")}
    walk = _Walk(layers, f"/{group_name}/layers", attrs)

    trunk = params["trunk"]
    n = len(trunk)
    use_bn = "gamma" in trunk[0]
    if use_bn and bn_state is None:
        raise ValueError(f"{group_name}: params carry BatchNorm gamma/beta but no running "
                         "statistics were given — pass the trainer's bn state")

    # Creation-order names first (the reference's graph-build order):
    # inputs, trunk (+BN/ReLU), sigma, feature, dirs concat, branch
    # (+BN/ReLU), rgb, output concat.
    names = {"inputs": [namer("input_layer"), namer("input_layer")]}
    trunk_names = []
    for i in range(n):
        entry = {"dense": namer("dense")}
        if use_bn:
            entry["bn"] = namer("batch_normalization")
            entry["relu"] = namer("re_lu")
        if i % skip_layer == 0 and i > 0:
            entry["concat"] = namer("concatenate")
        trunk_names.append(entry)
    names["sigma"] = namer("dense")
    names["feature"] = namer("dense")
    names["dirs_concat"] = namer("concatenate")
    names["branch"] = namer("dense")
    if use_bn:
        names["branch_bn"] = namer("batch_normalization")
        names["branch_relu"] = namer("re_lu")
    names["rgb"] = namer("dense")
    names["out_concat"] = namer("concatenate")

    # Walk order (graph depth): what load_weights matches on.
    for nm in names["inputs"]:
        walk.add("input_layer", nm, [])
    for i in range(n):
        walk.add("dense", trunk_names[i]["dense"], [trunk[i]["w"], trunk[i]["b"]])
    for head in ("feature", "branch", "rgb", "sigma"):
        walk.add("dense", names[head], [params[head]["w"], params[head]["b"]])
    for entry in trunk_names:
        if "concat" in entry:
            walk.add("concatenate", entry["concat"], [])
    walk.add("concatenate", names["dirs_concat"], [])
    walk.add("concatenate", names["out_concat"], [])
    if use_bn:
        for i in range(n):
            walk.add("batch_normalization", trunk_names[i]["bn"],
                     [trunk[i]["gamma"], trunk[i]["beta"],
                      bn_state["trunk"][i]["mean"], bn_state["trunk"][i]["var"]])
        walk.add("batch_normalization", names["branch_bn"],
                 [params["branch"]["gamma"], params["branch"]["beta"],
                  bn_state["branch"]["mean"], bn_state["branch"]["var"]])
        for entry in trunk_names:
            walk.add("re_lu", entry["relu"], [])
        walk.add("re_lu", names["branch_relu"], [])


def export_reference_weights(path: str, params: dict, cfg: NeRFConfig,
                             bn_state: dict | None = None) -> None:
    """Write ``{'coarse','fine'}`` JAX-layout params as a reference
    ``.weights.h5``.

    Args:
        path: the output file (``.weights.h5`` by the reference's convention).
        params: ``{'coarse': mlp, 'fine': mlp}`` (EMA callers pass the shadow).
        cfg: the run config (``skip_layer`` shapes the graph walk).
        bn_state: the running statistics, ``{'coarse', 'fine'}``, for
            BatchNorm models.

    Raises:
        ValueError: for a proposal-trained state (``{'proposal','fine'}``):
            the reference format has coarse+fine slots only and its
            renderer needs the coarse model to place fine samples.
    """
    missing = {"coarse", "fine"} - set(params)
    if missing:
        raise ValueError(
            f"cannot export to the reference format: params have no {sorted(missing)} "
            f"model (found {sorted(params)}). TRAIN_SAMPLER='proposal' checkpoints carry "
            "a tiny proposal net instead of the coarse MLP the reference renderer "
            "requires — retrain with the parity coarse+fine step to export.")
    namer = _Namer()
    tree: dict = {"vars": {}}
    attrs: dict = {"/vars": {"name": "ne_rf_trainer"}}
    for ours, theirs in (("coarse", "coarse_model"), ("fine", "fine_model")):
        _export_one_model(tree, attrs, theirs, params[ours],
                          None if bn_state is None else bn_state.get(ours), namer,
                          cfg.skip_layer)
    write_tree(path, tree, attrs)
