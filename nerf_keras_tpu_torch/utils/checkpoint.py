"""Read and write the JAX package's ``.ckpt.npz`` checkpoints with numpy.

Counterpart of ``nerf_keras_tpu/utils/checkpoint.py``.  A checkpoint is
one ``.npz`` whose keys are ``jax.tree_util.keystr`` paths of the
TrainState pytree — ``.params['fine']['trunk'][0]['w']``, ``.ema[...]``,
``.step``, ``.opt_state...`` — plus a ``.config.json`` sidecar in the
reference's UPPERCASE schema, optionally carrying a ``SCENE`` record
(near/far/focal).  The render path needs ``.params``, ``.ema`` and
``.step``; the optimizer state is ignored.

What this slice does not render raises ``NotImplementedError``:
``TRAIN_SAMPLER=proposal``, ``NDC``, and a frequency-anneal window that is
not yet the identity.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import re

import numpy as np

from nerf_keras_tpu.config import NeRFConfig, config_from_dict, to_reference_json

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


def load_checkpoint(path: str) -> dict:
    """``{'params': {...}, 'ema': {...} or None, 'step': int}`` from a
    ``.ckpt.npz``: the params trees keep the JAX layout (numpy arrays)."""
    with open(path, "rb") as f:
        data = np.load(io.BytesIO(f.read()))
    trees: dict = {}
    step = 0
    for key in data.files:
        path_parts = _parse_key(key)
        head = path_parts[0]
        if head == "step":
            step = int(data[key])
        elif head in ("params", "ema"):
            _insert(trees, path_parts, np.asarray(data[key]))
        elif head == "bn" and data[key].size:
            raise NotImplementedError(
                "BatchNorm checkpoints are not ported yet (later PR)"
            )
    if "params" not in trees:
        raise KeyError(f"checkpoint at {path} has no .params leaves")
    return {"params": trees["params"], "ema": trees.get("ema"), "step": step}


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
) -> None:
    """Write a render checkpoint in the JAX key format, numpy only.

    ``params`` (and ``ema``) are ``{'coarse': tree, 'fine': tree}`` in
    the JAX layout.  The sidecar is the reference JSON of ``cfg`` plus
    the ``SCENE`` record.  No optimizer state is written: this is a
    checkpoint to render from, not to resume training from.
    """
    arrays = _flatten(params, ".params")
    if ema is not None:
        arrays.update(_flatten(ema, ".ema"))
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


def check_render_support(cfg: NeRFConfig, step: int | None = None) -> None:
    """Raise ``NotImplementedError`` for what this slice does not render.
    With ``step`` the frequency-anneal window is checked too: it is the
    identity when the knob is off or the run is past its horizon."""
    if cfg.train_sampler == "proposal":
        raise NotImplementedError(
            "TRAIN_SAMPLER=proposal checkpoints are not ported yet: the "
            "proposal render (ops/proposal.py) arrives in a later PR"
        )
    if cfg.ndc:
        raise NotImplementedError("NDC rendering is not ported yet (later PR)")
    if cfg.batch_norm:
        raise NotImplementedError("BATCH_NORM=true is not ported yet (later PR)")
    horizon = cfg.freq_anneal_steps
    if step is not None and horizon > 0 and step < horizon:
        raise NotImplementedError(
            f"checkpoint at step {step} is inside its {horizon}-step "
            "frequency-anneal window; the window fold is not ported yet "
            "(only completed runs, whose window is the identity, render)"
        )


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
    check_render_support(cfg)
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
