"""Weight-derived inference artifacts, kept in one file beside a checkpoint.

Counterpart of ``nerf_keras_tpu/utils/infer_cache.py``, in its file
format: the int8 tables (``ops/quant.py``) and the distilled proposal net
(``ops/proposal.distill_proposal``) are functions of the trained weights
and a few config fields, and rebuilding them costs a server start the
distillation and the calibration.  One ``.infer.npz`` holds both, keyed by
a sha256 digest of the exact weights, so a restart reuses them and
artifacts of other weights are refused (:class:`StaleArtifactsError`).

Keys are ``jax.tree_util.keystr`` paths (``['fine']['trunk'][0]['w']``)
behind a ``p:`` (proposal) or ``q:`` (int8) prefix, plus the scalars
``__digest__``, ``__prop_l_xyz__`` and ``__distill_loss__``.  The digest
hashes each leaf's path, dtype, shape and bytes in the JAX package's
flattening order (dict keys sorted, lists in order) and then the config
fields as sorted JSON, so one checkpoint gives the same digest in both
packages and a file written by either loads in the other.  Trees here are
nested dicts and lists of numpy arrays in the JAX layout.
"""

from __future__ import annotations

import hashlib
import io as _io
import json
import re

import numpy as np

from nerf_keras_tpu_torch.parallel.mesh import is_main
from nerf_keras_tpu_torch.utils import io
from nerf_keras_tpu_torch.utils.checkpoint import _flatten, _write_atomic

_KEY_TOKEN = re.compile(r"\['([^']+)'\]|\[(\d+)\]")


class StaleArtifactsError(RuntimeError):
    """The artifact file was derived from different weights/config."""


def params_digest(params, extra: dict | None = None) -> str:
    """sha256 over every leaf's path, dtype, shape and bytes (the JAX
    ``params_digest``); ``extra`` folds in the config fields the
    artifacts depend on."""
    h = hashlib.sha256()
    for path, arr in _flatten(params, "").items():
        h.update(path.encode())
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    if extra:
        h.update(json.dumps(extra, sort_keys=True).encode())
    return h.hexdigest()


def _unflatten(flat: dict[str, np.ndarray]):
    """Rebuild nested dicts and lists from keystr paths: integer tokens are
    list indices, string tokens dict keys.  A level mixing the two, or a
    list with a gap in its indices, is a corrupt file."""
    root: dict = {}
    for key, arr in flat.items():
        toks = [m.group(1) if m.group(1) is not None else int(m.group(2))
                for m in _KEY_TOKEN.finditer(key)]
        if not toks:
            raise ValueError(f"unparseable artifact key: {key!r}")
        node = root
        for t in toks[:-1]:
            node = node.setdefault(t, {})
        node[toks[-1]] = arr

    def finalize(node):
        if not isinstance(node, dict):
            return node
        out = {k: finalize(v) for k, v in node.items()}
        kinds = {isinstance(k, int) for k in out}
        if kinds == {True}:
            idx = sorted(out)
            if idx != list(range(len(idx))):
                raise ValueError(f"non-dense list indices: {idx}")
            return [out[i] for i in idx]
        if True in kinds:
            raise ValueError(f"mixed list/dict level: {sorted(map(str, out))}")
        return out

    return finalize(root)


def save_artifacts(path: str, digest: str, *, pparams=None, prop_l_xyz: int | None = None,
                   distill_loss: float | None = None, qparams=None) -> None:
    """Write proposal and/or int8 artifacts (at least one), atomically."""
    if pparams is None and qparams is None:
        raise ValueError("nothing to save: no proposal net, no int8 params")
    arrays: dict[str, np.ndarray] = {"__digest__": np.array(digest)}
    if pparams is not None:
        if prop_l_xyz is None:
            raise ValueError("prop_l_xyz is required with pparams")
        arrays.update(_flatten(pparams, "p:"))
        arrays["__prop_l_xyz__"] = np.array(prop_l_xyz, np.int32)
        if distill_loss is not None:
            arrays["__distill_loss__"] = np.array(distill_loss, np.float32)
    if qparams is not None:
        arrays.update(_flatten(qparams, "q:"))
    buf = _io.BytesIO()
    np.savez(buf, **arrays)
    _write_atomic(path, buf.getvalue())


def load_artifacts(path: str, expect_digest: str) -> dict:
    """Load and check the digest: ``{'pparams', 'prop_l_xyz',
    'distill_loss'?}`` and/or ``{'qparams'}``, as the file holds them.
    Raises :class:`StaleArtifactsError` for other weights or config."""
    with io.open_file(path, "rb") as f:
        data = np.load(_io.BytesIO(f.read()), allow_pickle=False)
    stored = data["__digest__"].item()
    if stored != expect_digest:
        raise StaleArtifactsError(
            f"{path} was derived from different weights/config "
            f"(stored {stored[:12]}…, current {expect_digest[:12]}…); "
            "re-run quantize_for_inference / build_proposal_sampler"
        )
    out: dict = {}
    p_flat = {k[2:]: data[k] for k in data.files if k.startswith("p:")}
    q_flat = {k[2:]: data[k] for k in data.files if k.startswith("q:")}
    if p_flat:
        out["pparams"] = _unflatten(p_flat)
        out["prop_l_xyz"] = int(data["__prop_l_xyz__"])
        if "__distill_loss__" in data.files:
            out["distill_loss"] = float(data["__distill_loss__"])
    if q_flat:
        out["qparams"] = _unflatten(q_flat)
    return out


def load_if_fresh(trainer, path: str | None) -> None:
    """Install the artifacts at ``path`` into ``trainer`` (an
    ``engine.trainer.Trainer``) when the file exists and matches its
    weights; a stale file is ignored with a notice, and the caller's build
    overwrites it.  Under a mesh the trainer takes rank 0's verdict
    on the file (``Trainer.load_inference_artifacts``), so every rank
    installs the same artifacts or none, and rank 0 prints the notice."""
    if not path:
        return
    main = is_main(trainer.mesh)
    try:
        trainer.load_inference_artifacts(path)
    except FileNotFoundError:
        return
    except StaleArtifactsError as e:
        if main:
            print(f"[nerf-torch] ignoring artifact cache: {e}")
        return
    if main:
        print(f"[nerf-torch] loaded inference artifacts from {path}")
