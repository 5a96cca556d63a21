"""Read and write the JAX package's ``.ckpt.npz`` checkpoints with numpy.

Counterpart of ``nerf_keras_tpu/utils/checkpoint.py``.  A checkpoint is
one ``.npz`` whose keys are ``jax.tree_util.keystr`` paths of the
TrainState pytree — ``.params['fine']['trunk'][0]['w']``, ``.ema[...]``,
``.step``, ``.opt_state...`` — plus a ``.config.json`` sidecar in the
reference's UPPERCASE schema, optionally carrying a ``SCENE`` record
(near/far/focal).  The render path needs ``.params``, ``.ema`` and
``.step``; training resumes Adam from ``.opt_state[0]`` (count and
moments), which is optax's Adam state in the JAX package's checkpoints.
A ``TRAIN_SAMPLER=proposal`` state carries ``{'proposal', 'fine'}``, the
proposal tree as ``['proposal']['layers'][i]`` (one level) or
``['proposal']['l1']...`` (two).  A ``BATCH_NORM`` state adds ``gamma``/
``beta`` to the params' BN layers and the running statistics under
``.bn['coarse']['trunk'][i]['mean']`` (and ``'var'``, ``['branch']``).
:func:`save_checkpoint` writes a training state (the JAX
``save_checkpoint``'s counterpart), named by :func:`checkpoint_name`.
"""

from __future__ import annotations

import copy
import dataclasses
import io
import json
import os
import re

import numpy as np
import torch

from nerf_keras_tpu_torch.config import NeRFConfig, config_from_dict, to_reference_json
from nerf_keras_tpu_torch.ops.proposal import proposal_to_jax

_TOKEN = re.compile(r"\['([^']*)'\]|\[(\d+)\]|\.(\w+)")


def _parse_key(key: str) -> list:
    """``.params['fine']['trunk'][0]['w']`` -> ``['params', 'fine',
    'trunk', 0, 'w']``."""
    parts, pos = [], 0
    for m in _TOKEN.finditer(key):
        if m.start() != pos:
            raise ValueError(f"unparseable checkpoint key {key!r}")
        pos = m.end()
        name, index, attr = m.groups()
        parts.append(int(index) if index is not None else (name if name is not None else attr))
    if pos != len(key):
        raise ValueError(f"unparseable checkpoint key {key!r}")
    return parts


def _insert(tree: dict, path: list, value) -> None:
    node = tree
    for part, nxt in zip(path[:-1], path[1:]):
        default = [] if isinstance(nxt, int) else {}
        if isinstance(part, int):
            while len(node) <= part:
                node.append(None)
            if node[part] is None:
                node[part] = default
            node = node[part]
        else:
            node = node.setdefault(part, default)
    last = path[-1]
    if isinstance(last, int):
        while len(node) <= last:
            node.append(None)
        node[last] = value
    else:
        node[last] = value


def _flatten(tree, prefix: str) -> dict[str, np.ndarray]:
    """Inverse of the parse: keystr paths for a dict/list tree."""
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}['{k}']"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}[{i}]"))
    else:
        out[prefix] = np.asarray(tree)
    return out


def checkpoint_name(cfg: NeRFConfig) -> str:
    """The reference's file name, ``nerf_l{L}_d{D}_n{NS}_ep{E}.ckpt.npz``."""
    return (f"nerf_l{cfg.num_layers}_d{cfg.hidden_dim}"
            f"_n{cfg.ns_coarse + cfg.ns_fine}_ep{cfg.epochs}.ckpt.npz")


def load_checkpoint(path: str) -> dict:
    """``{'params': {...}, 'ema': {...} or None, 'bn': {...} or None,
    'step': int, 'opt_state': {'count': int, 'mu': {...}, 'nu': {...}} or
    None}`` from a ``.ckpt.npz``: the trees keep the JAX layout (numpy
    arrays).  The optimizer state is Adam's (``.opt_state[0]``); a
    checkpoint without it gives None."""
    with open(path, "rb") as f:
        data = np.load(io.BytesIO(f.read()))
    trees: dict = {}
    step = 0
    for key in data.files:
        path_parts = _parse_key(key)
        head = path_parts[0]
        if head == "step":
            step = int(data[key])
        elif head in ("params", "ema", "bn") or path_parts[:2] == ["opt_state", 0]:
            _insert(trees, path_parts, np.asarray(data[key]))
    if "params" not in trees:
        raise KeyError(f"checkpoint at {path} has no .params leaves")
    adam = trees.get("opt_state", [None])[0]
    opt_state = None
    if adam is not None and {"count", "mu", "nu"} <= set(adam):
        opt_state = {"count": int(adam["count"]), "mu": adam["mu"], "nu": adam["nu"]}
    return {"params": trees["params"], "ema": trees.get("ema"), "bn": trees.get("bn"),
            "step": step, "opt_state": opt_state}


def _write_atomic(path: str, data: bytes) -> None:
    """Temp file + ``os.replace``: a crash mid-write never destroys an
    existing file."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def save_params_npz(
    path: str,
    params: dict,
    cfg: NeRFConfig | None = None,
    scene: dict | None = None,
    step: int = 0,
    ema: dict | None = None,
    opt_state: dict | None = None,
    bn: dict | None = None,
) -> None:
    """Write a checkpoint in the JAX key format, numpy only.

    ``params`` (and ``ema``) are ``{'coarse': tree, 'fine': tree}`` or
    ``{'proposal': tree, 'fine': tree}`` in the JAX layout.  The sidecar
    is the reference JSON of ``cfg`` plus the ``SCENE`` record.
    ``opt_state`` ``{'count': int, 'mu': tree, 'nu': tree}`` is Adam's,
    written as optax's state (``.opt_state[0]``, and the schedule's count
    at ``.opt_state[1]`` when ``cfg.lr_final`` is set), which the JAX
    package's restore requires; without it no optimizer state is written.
    ``bn`` is ``{'coarse': bn_state, 'fine': bn_state}`` (BatchNorm).
    """
    arrays = _flatten(params, ".params")
    if ema is not None:
        arrays.update(_flatten(ema, ".ema"))
    if bn is not None:
        arrays.update(_flatten(bn, ".bn"))
    if opt_state is not None:
        count = np.asarray(opt_state["count"], dtype=np.int32)
        arrays[".opt_state[0].count"] = count
        arrays.update(_flatten(opt_state["mu"], ".opt_state[0].mu"))
        arrays.update(_flatten(opt_state["nu"], ".opt_state[0].nu"))
        if cfg is not None and cfg.lr_final is not None:
            arrays[".opt_state[1].count"] = count
    arrays[".step"] = np.asarray(step, dtype=np.int32)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    if cfg is not None:
        sidecar = to_reference_json(cfg)
        if scene is not None:
            sidecar["SCENE"] = {
                k.upper(): (bool(v) if isinstance(v, (bool, np.bool_)) else float(v))
                for k, v in scene.items()
            }
        _write_atomic(path + ".config.json", json.dumps(sidecar, indent=2).encode())
    _write_atomic(path, buf.getvalue())


def models_to_jax(models: dict, grad: bool = False) -> dict:
    """``{name: JAX-layout tree}`` of ``{name: module}`` (``NeRFMLP`` or the
    proposal chain): the parameters, or with ``grad`` their gradients."""
    return {name: (proposal_to_jax(m, grad) if name == "proposal" else m.to_jax_params(grad))
            for name, m in models.items()}


def models_bn(models: dict) -> dict | None:
    """``{name: bn_state}`` of the BatchNorm models, or None without BN."""
    bn = {name: m.bn_state() for name, m in models.items()
          if getattr(m, "batch_norm", False)}
    return bn or None


def save_checkpoint(path: str, state, cfg: NeRFConfig | None = None,
                    scene: dict | None = None, write: bool = True) -> None:
    """Write a training state (``engine.step.TrainState``: params, Adam's
    count and moments, EMA, BatchNorm statistics, step) with the config
    and ``scene`` sidecar, in the key format the JAX package's
    ``load_checkpoint`` restores.  Models split over a model axis gather
    their trees, a collective: every rank calls this, and only the rank
    given ``write`` writes."""
    from nerf_keras_tpu_torch.engine.step import params_of  # engine imports this module

    def moments(values: list) -> dict:
        # Adam's moments mirror the params: load them into a copy of the
        # models and read that copy's trees.
        shadow = {k: copy.deepcopy(m) for k, m in state.params.items()}
        with torch.no_grad():
            for p, v in zip(params_of(shadow), values):
                p.copy_(v)
        return models_to_jax(shadow)

    opt = state.opt
    opt_state = None if opt is None else {
        "count": opt.count, "mu": moments(opt.mu), "nu": moments(opt.nu)}
    params, bn = models_to_jax(state.params), models_bn(state.params)
    ema = None if state.ema is None else models_to_jax(state.ema)
    if write:
        save_params_npz(path, params, cfg, scene=scene, step=state.step, ema=ema,
                        opt_state=opt_state, bn=bn)


def load_checkpoint_config(path: str) -> NeRFConfig:
    with open(path + ".config.json") as f:
        raw = json.load(f)
    raw.pop("SCENE", None)
    return config_from_dict(raw)


def load_checkpoint_scene(path: str) -> dict | None:
    """``{"near", "far", "focal", ...}`` from the sidecar, or None."""
    sidecar = path + ".config.json"
    if not os.path.exists(sidecar):
        return None
    with open(sidecar) as f:
        scene = json.load(f).get("SCENE")
    if scene is None:
        return None
    return {
        k.lower(): (v if isinstance(v, bool) else float(v))
        for k, v in scene.items()
    }


def resolve_infer_config(
    cfg: NeRFConfig, path: str | None
) -> tuple[NeRFConfig, list[str]]:
    """Reconcile a user config with a checkpoint's sidecar for rendering.

    The render-relevant half of the JAX package's function: the sidecar
    wins for the state-tree architecture (``train_sampler`` and the
    proposal net), ``ema_decay`` (which weights serve), ``ndc``,
    ``white_bkgd`` and ``freq_anneal_steps``; the LR schedule and the
    sampling anneal are neutralized; an unresolved auto anneal horizon
    becomes the identity window.  Returns ``(cfg, notes)``.
    """
    notes: list[str] = []
    if cfg.prop_anneal_steps != 0:
        cfg = dataclasses.replace(cfg, prop_anneal_steps=0)
    if path is not None and os.path.exists(path + ".config.json"):
        side = load_checkpoint_config(path)
        arch = ("train_sampler", "prop_l_xyz", "prop_hidden", "prop_depth",
                "prop_union", "prop_levels", "prop_samples")
        if any(getattr(side, f) != getattr(cfg, f) for f in arch):
            cfg = dataclasses.replace(
                cfg, **{f: getattr(side, f) for f in arch}
            ).validate()
            notes.append(
                f"checkpoint sidecar sets train_sampler={cfg.train_sampler} "
                "(overrides the config)"
            )
        if side.ema_decay != cfg.ema_decay:
            cfg = dataclasses.replace(cfg, ema_decay=side.ema_decay)
            if cfg.ema_decay > 0:
                notes.append(
                    f"checkpoint sidecar sets ema_decay={cfg.ema_decay}: "
                    "rendering the EMA weights"
                )
        scene = load_checkpoint_scene(path) or {}
        trained = {
            "ndc": bool(scene["ndc"]) if "ndc" in scene else side.ndc,
            "white_bkgd": side.white_bkgd,
            "freq_anneal_steps": side.freq_anneal_steps,
        }
        for field, value in trained.items():
            if value != getattr(cfg, field):
                cfg = dataclasses.replace(cfg, **{field: value})
                notes.append(
                    f"checkpoint sidecar sets {field}={value} (overrides "
                    "the config — fixed at training time)"
                )
    if cfg.lr_final is not None:
        cfg = dataclasses.replace(cfg, lr_final=None, lr_decay_steps=0)
    if cfg.freq_anneal_steps == -1:
        cfg = dataclasses.replace(cfg, freq_anneal_steps=1)
    return cfg, notes


def _numeric_sort_key(name: str) -> tuple:
    """Natural sort: digit runs compare numerically (``ep10`` > ``ep2``)."""
    return tuple(
        int(part) if part.isdigit() else part
        for part in re.split(r"(\d+)", name)
    )


def latest_checkpoint(run_dir: str) -> str | None:
    """Newest ``*.ckpt.npz`` in a run directory (natural name order),
    excluding the ``best.*`` retention copies, or None."""
    if not os.path.isdir(run_dir):
        return None
    names = [
        n for n in os.listdir(run_dir)
        if n.endswith(".ckpt.npz") and not n.startswith("best.")
    ]
    if not names:
        return None
    return os.path.join(run_dir, sorted(names, key=_numeric_sort_key)[-1])


def best_checkpoint(run_dir: str) -> str | None:
    """The best-val retention checkpoint (``best.*.ckpt.npz``), or None."""
    if not os.path.isdir(run_dir):
        return None
    names = [
        n for n in os.listdir(run_dir)
        if n.startswith("best.") and n.endswith(".ckpt.npz")
    ]
    if not names:
        return None
    return os.path.join(run_dir, sorted(names, key=_numeric_sort_key)[-1])


def resolve_checkpoint(run_dir: str) -> str | None:
    """Checkpoint to serve from a run directory: the best-val copy when
    present, else the latest."""
    return best_checkpoint(run_dir) or latest_checkpoint(run_dir)
