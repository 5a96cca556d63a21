"""Structural checks of the data-parallel step and render, and a real
multi-process run.

Counterpart of ``nerf_keras_tpu/parallel/audit.py``.  The JAX package
reads the collectives from the compiled HLO text; the port calls each
collective through a counted wrapper (``parallel/mesh.py``), so its two
checks read those counters instead:

* the train step makes exactly ONE all-reduce over the data group,
  carrying every local parameter's gradient and the
  :data:`~nerf_keras_tpu_torch.engine.step.N_METRICS` metric numerators,
  element for element; a ``BATCH_NORM`` config adds four per BatchNorm
  layer (its global mean and variance, forward and backward) and nothing
  else (:func:`audit_train_step`);
* a render makes ZERO all-reduces over the data group: its only
  collectives there are all-gathers of the output maps, exactly their
  elements (:func:`audit_render`);
* under a model axis each split MLP pass makes exactly the model-group
  all-reduces and all-gathers its layout implies (:func:`pass_collectives`:
  at 8x256, skip 4, 4 all-reduces and 2 all-gathers a forward, 4
  all-reduces a backward, 5 with input gradients), element for element,
  in the step and in the render, and nothing else crosses the model
  group.

:func:`run_ranks` launches a real job of N processes on one host (the
``NERF_*`` trio, a localhost rendezvous) that trains a few steps, audits
them and renders; or that builds, saves, reloads and renders through the
int8 tables and the distilled net (:func:`_infer_part`); or that runs the
entry points (:func:`_cli_part`: ``cli.evaluate``, ``cli.infer``, the
server).  :func:`run_two_process_smoke` runs two ranks and raises when
their metrics or parameters diverge (the counterpart of
``run_two_process_pallas_smoke``).  A rank runs as ``python -m
nerf_keras_tpu_torch.parallel.audit SPEC OUT`` (pickles this module
writes and reads).
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import os
import pickle
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch

from nerf_keras_tpu_torch.config import NeRFConfig
from nerf_keras_tpu_torch.engine import step as step_mod
from nerf_keras_tpu_torch.engine.step import (
    N_METRICS,
    aux_samples,
    make_train_step,
    params_of,
    union_step,
)
from nerf_keras_tpu_torch.engine.trainer import Trainer
from nerf_keras_tpu_torch.models.mlp import NeRFMLP, is_skip
from nerf_keras_tpu_torch.ops.kernels import launch_counts
from nerf_keras_tpu_torch.ops.proposal import proposal_to_jax
from nerf_keras_tpu_torch.ops.quant import qparams_to_jax
from nerf_keras_tpu_torch.parallel import mesh as mesh_mod
from nerf_keras_tpu_torch.parallel.distributed import barrier, maybe_initialize, shutdown
from nerf_keras_tpu_torch.profile_train import bench_batch
from nerf_keras_tpu_torch.runtime import cuda_ms
from nerf_keras_tpu_torch.utils.checkpoint import _flatten
from nerf_keras_tpu_torch.utils.infer_cache import load_if_fresh

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def expected_train_reduce(trainer: Trainer) -> tuple[int, int]:
    """``(all-reduce calls, elements)`` one train step must make: the one
    gradient reduce (parameters + metric numerators), plus four per
    BatchNorm layer of width w (w elements each) for ``BATCH_NORM``."""
    n_params = sum(p.numel() for p in params_of(trainer.params))
    bns = [bn for m in trainer.params.values() if isinstance(m, NeRFMLP)
           for bn in m.bn_layers()]
    return 1 + 4 * len(bns), n_params + N_METRICS + 4 * sum(bn.gamma.numel() for bn in bns)


_MODEL_KEYS = ("all_reduce", "all_reduce_elements", "all_gather", "all_gather_elements")


def pass_collectives(mlp: NeRFMLP, n: int, backward: bool = False,
                     input_grads: bool = False) -> dict:
    """The model-group collectives of one pass of a split ``mlp`` over
    ``n`` samples (forward, and with ``backward`` its backward; with
    ``input_grads`` the encodings carry a gradient), derived from its
    layout as ``NeRFMLP.forward`` runs it: a row split's partial
    all-reduce (its output width), a gather of a split activation before a
    layer or concat that reads it whole (the full width), and, backward,
    one all-reduce of the cotangent of each activation that split layers
    read (its width).  All zero for a whole module."""
    out = dict.fromkeys(_MODEL_KEYS, 0)
    if mlp.tp is None:
        return out

    def add(kind: str, width: int) -> None:
        out[kind] += 1
        out[kind + "_elements"] += n * width

    def act(width, sharded=False, grad=backward):
        return {"width": width, "sharded": sharded, "copied": False, "grad": grad}

    def full(a):
        if a["sharded"]:
            add("all_gather", a["width"])
            a["sharded"] = False

    def copy(a):
        full(a)
        if not a["copied"]:
            a["copied"] = True
            if backward and a["grad"]:
                add("all_reduce", a["width"])

    def dense(a, kind, width):
        if kind == "col":
            copy(a)
            return act(width, sharded=True)
        if kind == "row":
            if not a["sharded"]:
                copy(a)
            add("all_reduce", width)
        else:
            full(a)
        return act(width)

    a = act(mlp.xyz_dim, grad=backward and input_grads)
    for i in range(mlp.num_layers):
        h = dense(a, mlp.kinds[i], mlp.hidden_dim)
        if is_skip(i, mlp.skip_layer):
            full(h)
            h = act(mlp.hidden_dim + mlp.xyz_dim)
        a = h
    dense(a, mlp.kinds[mlp.num_layers], 1)
    full(dense(a, mlp.kinds[mlp.num_layers + 1], mlp.hidden_dim))
    return out


def _sum(parts: list[dict]) -> dict:
    return {k: sum(p[k] for p in parts) for k in _MODEL_KEYS}


def expected_step_model(trainer: Trainer, local_b: int, step: int) -> dict:
    """The model-group collectives of the train step at ``step`` over
    ``local_b`` rays a rank: the coarse and fine passes (the fine one with
    input gradients without ``STOP_PDF_GRADIENT``), or the proposal step's
    fine pass over its layout's samples and its aux pass."""
    cfg, models = trainer.cfg, trainer.params
    if cfg.train_sampler == "proposal":
        s = cfg.ns_fine + (cfg.ns_coarse if union_step(cfg, step) else 0)
        passes = [pass_collectives(models["fine"], local_b * s, True)]
        if aux_samples(cfg, step):
            passes.append(pass_collectives(models["fine"], local_b * aux_samples(cfg, step),
                                           True))
        return _sum(passes)
    return _sum([pass_collectives(models["coarse"], local_b * cfg.ns_coarse, True),
                 pass_collectives(models["fine"], local_b * (cfg.ns_coarse + cfg.ns_fine),
                                  True, not cfg.stop_pdf_gradient)])


def expected_render_model(trainer: Trainer, rows: int) -> dict:
    """The model-group collectives of rendering ``rows`` rays a rank (the
    float render, forward only)."""
    cfg, models = trainer.cfg, trainer.params
    if cfg.train_sampler == "proposal":
        s = cfg.ns_fine + (cfg.ns_coarse if cfg.prop_union else 0)
        return pass_collectives(models["fine"], rows * s)
    return _sum([pass_collectives(models["coarse"], rows * cfg.ns_coarse),
                 pass_collectives(models["fine"], rows * (cfg.ns_coarse + cfg.ns_fine))])


def _check_model(what: str, got: dict, want: dict) -> None:
    got = {k: got[k] for k in _MODEL_KEYS} | {"broadcast": got["broadcast"]}
    if got != dict(want, broadcast=0):
        raise AssertionError(f"{what} made {got} over the model group; expected {want}")


def audit_train_step(trainer: Trainer, batch, draws: dict | None = None) -> dict:
    """Run one train step of a trainer under a mesh and check its
    collectives (module docstring); returns the step's metrics and the
    counts (``collectives`` over every axis, ``model`` over the model
    group)."""
    if trainer.mesh is None:
        raise ValueError("audit_train_step needs a trainer under a mesh")
    mesh_mod.reset_counts()
    step = trainer.step
    metrics = trainer.train_step(batch, draws)
    got = mesh_mod.counts("data")
    model = mesh_mod.counts("model")
    _check_model("the train step", model, expected_step_model(trainer, len(batch[0]), step))
    if any(mesh_mod.counts("world").values()):
        raise AssertionError(f"the train step made world collectives: {mesh_mod.counts()}")
    calls, elements = expected_train_reduce(trainer)
    if (got["all_reduce"], got["all_reduce_elements"]) != (calls, elements):
        raise AssertionError(
            f"the train step made {got['all_reduce']} all-reduce(s) of "
            f"{got['all_reduce_elements']} elements; expected {calls} of {elements} "
            f"(one gradient reduce of the parameters + {N_METRICS} metrics"
            f"{', and BatchNorm moments' if calls > 1 else ''})")
    if got["all_gather"] or got["broadcast"]:
        raise AssertionError(f"the train step made other collectives: {got}")
    return {"metrics": metrics, "collectives": mesh_mod.counts(), "model": model,
            "by_axis": {axis: mesh_mod.counts(axis) for axis in mesh_mod.AXES},
            "all_reduce_count": calls, "all_reduce_elements": elements}


def audit_render(trainer: Trainer, origins, dirs, chunk: int = 16384) -> dict:
    """Render rays under a mesh (``Trainer.render_rays``) and check that
    no all-reduce ran over the data group, that the all-gathers there
    carried exactly the output maps of every (padded) chunk, and that each
    chunk's passes made exactly their model-group collectives; returns the
    outputs and the counts (``collectives`` of the data group, ``model``
    of the model group)."""
    if trainer.mesh is None:
        raise ValueError("audit_render needs a trainer under a mesh")
    mesh_mod.reset_counts()
    out = trainer.render_rays(origins, dirs, chunk=chunk)
    got = mesh_mod.counts("data")
    model = mesh_mod.counts("model")
    n, data = len(origins), trainer.mesh.data
    chunk = -(-min(chunk, max(n, 1)) // data) * data
    num_chunks = -(-n // chunk)
    per_chunk = expected_render_model(trainer, chunk // data)
    _check_model("the render", model, {k: v * num_chunks for k, v in per_chunk.items()})
    want = sum(v.size // n for v in out.values()) * num_chunks * chunk
    if got["all_reduce"] or got["broadcast"]:
        raise AssertionError(f"the render made a reduction or broadcast: {got}")
    if (got["all_gather"], got["all_gather_elements"]) != (num_chunks * len(out), want):
        raise AssertionError(
            f"the render gathered {got['all_gather']} maps of {got['all_gather_elements']} "
            f"elements; expected {num_chunks * len(out)} of {want} (the output maps)")
    return {"outputs": out, "collectives": got, "model": model}


def tree_rel_l2(got: dict, want: dict) -> float:
    """The largest per-leaf relative L2 error between two JAX-layout trees
    (``Trainer.params_tree``'s, e.g. gradients)."""
    got, want = _flatten(got, ""), _flatten(want, "")
    return max(float(np.linalg.norm(got[k] - w) / max(np.linalg.norm(w), 1e-30))
               for k, w in want.items())


def replicated_leaves(trainer: Trainer) -> dict[str, np.ndarray]:
    """The leaves this rank holds whole under a model axis (every leaf
    without one), by name: a split MLP's replicated weights, its row
    splits' biases and the BatchNorm vectors of layers not column-split,
    and the proposal nets."""
    out = {}
    for name, m in trainer.params.items():
        if not isinstance(m, NeRFMLP):
            out.update({f"{name}.{n}": p for n, p in m.named_parameters()})
            continue
        for i, (layer, kind) in enumerate(zip(m.dense_layers(), m.kinds)):
            if kind is None:
                out[f"{name}.{i}.w"] = layer.weight
            if kind != "col":
                out[f"{name}.{i}.b"] = layer.bias
        for i, (bn, kind) in enumerate(m._bn_kinds()):
            if kind != "col":
                out.update({f"{name}.bn{i}.{k}": getattr(bn, k)
                            for k in ("gamma", "beta", "mean", "var")})
    return {k: v.detach().cpu().numpy() for k, v in out.items()}


def state_digest(trainer: Trainer) -> str:
    """sha256 of the parameters, BatchNorm statistics and EMA shadow."""
    h = hashlib.sha256()
    for t in trainer.state_tensors():
        h.update(t.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def tree_digest(tree) -> str:
    """sha256 of a JAX-layout tree's paths and bytes."""
    h = hashlib.sha256()
    for path, arr in _flatten(tree, "").items():
        h.update(path.encode())
        h.update(arr.tobytes())
    return h.hexdigest()


def artifact_digests(trainer: Trainer) -> dict:
    """``{'qparams', 'pparams'}``: :func:`tree_digest` of the installed int8
    tables and distilled net, None where absent."""
    return {"qparams": None if trainer.qparams is None
            else tree_digest(qparams_to_jax(trainer.qparams)),
            "pparams": None if trainer.proposal_net is None
            else tree_digest(proposal_to_jax(trainer.proposal_net))}


def _drop_own_gradients() -> None:
    """The broken variant: this rank sends zeros into every reduce of the
    step (its gradients and metrics are left out of the sum), and takes
    the result as the others do."""
    real = step_mod.all_reduce_flat
    step_mod.all_reduce_flat = lambda tensors, mesh, axis="data": real(
        [torch.zeros_like(t) for t in tensors], mesh, axis)


def _count_profiled(prof) -> dict:
    """NCCL all-reduces in a profile: host calls (``nccl:all_reduce``) and
    device kernels (names with ``AllReduce``), beside the count of all
    device events (0 would mean the profiler saw no device work) and the
    names of the NCCL kernels seen."""
    from torch.autograd import DeviceType

    events = [(e.name, e.device_type) for e in prof.events()]
    device = [n for n, t in events if t == DeviceType.CUDA]
    return {"host_calls": sum(1 for n, t in events
                              if t == DeviceType.CPU and n == "nccl:all_reduce"),
            "device_kernels": sum(1 for n in device if "AllReduce" in n),
            "device_events": len(device),
            "nccl_kernel_names": sorted({n for n in device if "nccl" in n.lower()})}


def _run_rank(spec: dict) -> dict:
    """One rank's job (see :func:`run_ranks`)."""
    cfg = spec.get("cfg")
    mesh = (mesh_mod.make_mesh() if cfg is None
            else mesh_mod.make_mesh(cfg.mesh_data, cfg.mesh_model))
    record = {"rank": mesh.rank, "world": mesh.world, "device": str(mesh.device),
              "data_rank": mesh.data_rank, "model_rank": mesh.model_rank,
              "backend": torch.distributed.get_backend()}
    if spec.get("batch") is not None:
        record.update(_train_part(spec, mesh))
    if spec.get("infer") is not None:
        record["infer"] = _infer_part(spec, mesh)
    if spec.get("cli") is not None:
        record["cli"] = _cli_part(spec["cli"], mesh)
    return record


def _new_trainer(spec: dict, mesh) -> Trainer:
    trainer = Trainer(spec["cfg"], spec["near"], spec["far"], mesh=mesh)
    if spec.get("params") is not None:
        trainer.replace_params(spec["params"], spec.get("bn"))
    if spec.get("restore") is not None:
        trainer.restore(spec["restore"])
    return trainer


def _drop_model_reduce() -> None:
    """The broken variant of a split step: ``copy_to_model`` passes each
    rank's partial cotangent on unsummed."""
    mesh_mod._CopyToModel.backward = staticmethod(lambda ctx, g: (g, None))


def _train_part(spec: dict, mesh) -> dict:
    """Train, audit and render (:func:`run_ranks`)."""
    trainer = _new_trainer(spec, mesh)
    if spec.get("start_step") is not None:
        trainer.step = spec["start_step"]
    if spec.get("drop_rank") == mesh.rank:
        _drop_own_gradients()
    if spec.get("drop_model_reduce"):
        _drop_model_reduce()
    rows = mesh_mod.local_rows(len(spec["batch"][0]), mesh)
    batch = trainer.put_batch(tuple(x[rows] for x in spec["batch"]))
    record = {"device": str(trainer.device), "metrics": [], "launches": []}
    for i in range(spec.get("steps", 3)):
        before = launch_counts()
        if i == 0:
            if spec.get("drop_model_reduce"):  # its collectives are not the audit's
                metrics = trainer.train_step(batch, spec.get("draws"))
            else:
                audit = audit_train_step(trainer, batch, spec.get("draws"))
                metrics = audit.pop("metrics")
                record["audit"] = audit
            record["grads"] = trainer.params_tree(grad=True)
            record["bn_first"] = trainer.bn_tree()
        else:
            metrics = trainer.train_step(batch)
        record["metrics"].append({k: float(v) for k, v in metrics.items()})
        record["launches"].append({k: v - before[k] for k, v in launch_counts().items()
                                   if v != before[k]})
    record["params"] = trainer.params_tree()
    record["bn"] = trainer.bn_tree()
    record["digest"] = state_digest(trainer)
    record["replicated"] = replicated_leaves(trainer)
    if spec.get("evaluate"):
        record["eval"] = {k: float(v) for k, v in trainer.evaluate([spec["batch"]]).items()}
    if spec.get("save") is not None:
        trainer.save(spec["save"])
    if spec.get("render_rays"):
        n = spec["render_rays"]
        before = launch_counts()
        render = audit_render(trainer, spec["batch"][1][:n], spec["batch"][2][:n],
                              chunk=spec.get("render_chunk", 16384))
        record["render_launches"] = {k: v - before[k] for k, v in launch_counts().items()
                                     if v != before[k]}
        record["render_collectives"] = render["collectives"]
        record["render_model"] = render["model"]
        record["render"] = {k: v for k, v in render["outputs"].items()}
    if spec.get("time_steps"):
        n = spec["time_steps"]
        torch.cuda.reset_peak_memory_stats(trainer.device)
        record["step_ms"] = cuda_ms(lambda: trainer.train_step(batch), n)
        record["peak_mib"] = torch.cuda.max_memory_allocated(trainer.device) / 2**20
        if mesh.world == 1:
            # The same work without the mesh (no draws at the global shape,
            # no collective), on the same state, in the same process.
            plain = make_train_step(trainer.cfg, trainer.near, trainer.far)
            record["no_mesh_step_ms"] = cuda_ms(
                lambda: plain(trainer.state, batch, None, trainer.generator), n)
    if spec.get("profile"):
        # Last, so that no profiler state can touch the timed steps.
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(spec["profile"]):
                trainer.train_step(batch)
            torch.cuda.synchronize()
        record["nccl_all_reduce"] = _count_profiled(prof)
    return record


def _counted(steps: dict, name: str, fn):
    """``fn()`` with this rank's collectives and kernel launches in it
    recorded as ``steps[name]``."""
    mesh_mod.reset_counts()
    before = launch_counts()
    out = fn()
    steps[name] = {"collectives": mesh_mod.counts(), "model": mesh_mod.counts("model"),
                   "launches": {k: v - before[k] for k, v in launch_counts().items()
                                if v != before[k]}}
    return out


def _error(fn) -> str | None:
    """``'Type: message'`` of what ``fn()`` raised, or None."""
    try:
        fn()
    except (OSError, RuntimeError, ValueError) as e:
        return f"{type(e).__name__}: {e}"
    return None


def _infer_part(spec: dict, mesh) -> dict:
    """The int8 tables and the distilled net under the mesh
    (:func:`run_ranks`, ``infer``): build them, save and reload the cache,
    render frames through them."""
    job = spec["infer"]
    trainer = _new_trainer(spec, mesh)
    steps: dict = {}
    out: dict = {"steps": steps}
    calib = job["calib"]
    if job.get("broken"):
        # The broken variant: each rank installs the tables it calibrates
        # itself (nothing is shared), rank 1 on other rays.
        own = job["broken_calib"] if mesh.rank == 1 else calib
        _counted(steps, "calibrate", lambda: trainer.install_quant(
            trainer.calibrate_int8(*own)))
    else:
        _counted(steps, "calibrate", lambda: trainer.quantize_for_inference(*calib))
    if job.get("distill") is not None:
        _counted(steps, "distill", lambda: trainer.build_proposal_sampler(
            *calib, **job["distill"]))
        out["distill_losses"] = trainer.distill_losses
    out["digests"] = artifact_digests(trainer)
    out["infer_digest"] = trainer.infer_digest()
    if mesh.rank == 0:
        out["qparams"] = qparams_to_jax(trainer.qparams)
        if trainer.proposal_net is not None:
            out["pparams"] = proposal_to_jax(trainer.proposal_net)
    if job.get("cache") is not None:
        cache = job["cache"]
        if job.get("hidden_from") == mesh.rank:
            # A rank whose filesystem lacks the file: no file is at its path.
            cache += ".elsewhere"
        _counted(steps, "save", lambda: trainer.save_inference_artifacts(cache))
        trainer = _new_trainer(spec, mesh)
        _counted(steps, "load", lambda: trainer.load_inference_artifacts(cache))
        out["loaded_digests"] = artifact_digests(trainer)
    if job.get("stale") is not None:
        fresh = _new_trainer(spec, mesh)
        out["stale_error"] = _counted(steps, "stale", lambda: _error(
            lambda: fresh.load_inference_artifacts(job["stale"])))
        out["absent_error"] = _error(lambda: fresh.load_inference_artifacts(
            job["stale"] + ".absent"))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            load_if_fresh(fresh, job["stale"])
        out["stale_notice"] = buf.getvalue()
        out["stale_installed"] = fresh.quant_ready
    if job.get("corrupt") is not None:
        other = _new_trainer(spec, mesh)
        out["corrupt_error"] = _error(lambda: other.load_inference_artifacts(job["corrupt"]))
    origins, dirs = job["rays"]
    chunk = job.get("chunk", 16384)
    renders = {"float": {}, "int8": {"quant": True}}
    if trainer.proposal_net is not None:
        renders.update(proposal={"sampler": "proposal"},
                       proposal_int8={"sampler": "proposal", "quant": True})
    extra = job.get("render_kw", {})
    out["frames"] = {name: _counted(steps, name, lambda: trainer.render_rays(
        origins, dirs, chunk=chunk, **kw, **extra)) for name, kw in renders.items()}
    if job.get("time_frames"):
        # Each render ends in the copy of its maps to the host.
        out["frame_s"] = {}
        for name, kw in renders.items():
            times = []
            for _ in range(job["time_frames"]):
                t0 = time.perf_counter()
                trainer.render_rays(origins, dirs, chunk=chunk, **kw, **extra)
                times.append(time.perf_counter() - t0)
            out["frame_s"][name] = times
    return out


def _serve_client(port: int, requests: list, bodies: list) -> None:
    """Rank 0's client of its own server: wait for /healthz, send
    ``requests`` (``(method, path)``), keep each body (or ``'HTTP <code>'``),
    then stop the server as an operator does (SIGTERM)."""
    base = f"http://127.0.0.1:{port}"
    try:
        for _ in range(600):
            try:
                urllib.request.urlopen(f"{base}/healthz", timeout=5).read()
                break
            except OSError:
                time.sleep(0.1)
        for method, path in requests:
            req = urllib.request.Request(base + path, method=method,
                                         data=b"" if method == "POST" else None)
            try:
                with urllib.request.urlopen(req, timeout=600) as resp:
                    bodies.append(resp.read())
            except urllib.error.HTTPError as e:
                bodies.append(f"HTTP {e.code}: {e.read().decode()}")
    finally:
        os.kill(os.getpid(), signal.SIGTERM)


def _cli_part(runs: list, mesh) -> list[dict]:
    """The entry points as ranks of this job (:func:`run_ranks`, ``cli``):
    each ``(name, argv)``, ``'{rank}'`` in an argument replaced by the
    rank; stdout, the return value and the launches of each."""
    from nerf_keras_tpu_torch import serving
    from nerf_keras_tpu_torch.cli import evaluate, infer

    records = []
    for name, argv, *rest in runs:
        argv = [a.replace("{rank}", str(mesh.rank)) for a in argv]
        buf = io.StringIO()
        before = launch_counts()
        bodies: list = []
        with contextlib.redirect_stdout(buf):
            if name == "evaluate":
                result = evaluate.run_evaluation(argv)
            elif name == "infer":
                result = infer.run_inference(argv)
            else:
                client = None
                if mesh.rank == 0:
                    port = int(argv[argv.index("--port") + 1])
                    client = threading.Thread(target=_serve_client,
                                              args=(port, rest[0], bodies))
                    client.start()
                serving.main(argv)
                if client is not None:
                    client.join(timeout=600)
                result = bodies
        records.append({"name": name, "stdout": buf.getvalue(), "result": result,
                        "launches": {k: v - before[k] for k, v in launch_counts().items()
                                     if v != before[k]}})
    return records


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(world: int, spec: dict, timeout: float = 120.0) -> list[dict]:
    """Launch ``world`` processes of one job on this host and return each
    rank's record.

    ``spec``: ``device`` (``'cpu'``/``'cuda'``) and ``backend`` (None: the
    device's, see ``distributed.maybe_initialize``), ``cfg`` (a
    ``NeRFConfig``), ``near``/``far``, ``batch`` (the global ``(pixels,
    origins, dirs)`` numpy arrays; each rank trains on its rows), and
    optionally ``draws`` (the first step's, global-shaped), ``params``/
    ``bn`` (JAX-layout trees to start from), ``start_step``, ``restore`` (a
    checkpoint to resume from), ``steps``
    (default 3; the first is audited), ``render_rays`` (render and audit
    that many of the batch's rays), ``render_chunk``, and on the card
    ``time_steps`` (median ms of that many more steps, CUDA events; on
    one rank also of the same step built without the mesh),
    and each rank's peak memory over them (``peak_mib``),
    ``profile`` (count the NCCL all-reduces of that many more steps in a
    ``torch.profiler`` window), and ``drop_rank`` (that rank leaves its gradients
    out of the reduce: the broken variant), ``drop_model_reduce`` (the
    split MLP's backward leaves each rank's partial cotangent unsummed:
    the broken variant of a model axis), ``evaluate`` (the eval metrics of
    the global batch after the steps).  Without ``batch`` nothing is
    trained.

    ``save`` (a path: every rank saves, rank 0 writes).  ``restore`` (a
    checkpoint) is loaded into the trainer of a train or ``infer`` job.
    The mesh is the config's ``MESH_DATA`` x ``MESH_MODEL``.

    A record holds the rank's place in the mesh, ``metrics`` and kernel
    ``launches`` per step, the first step's reduced ``grads``, its
    ``audit`` and the BatchNorm statistics after it (``bn_first``), the
    final ``params``, ``bn``, ``digest`` and the leaves held whole
    (``replicated``), and what was asked for.

    ``infer`` (a dict) builds what is derived from the weights on a
    trainer of ``cfg``/``params`` under the mesh: ``calib`` (rays every
    rank passes) calibrates the int8 tables, ``distill`` (keyword
    arguments of ``build_proposal_sampler``, or None) distills the
    proposal net on them; ``cache`` (a path) saves them, then a new
    trainer loads them (``hidden_from``: that rank is given a path where
    no file is, as on a filesystem that lacks it); ``stale`` (a path of another weights' artifacts) is
    loaded by a new trainer, and so is ``corrupt`` (a file rank 0 cannot
    read); ``rays`` (``(origins, dirs)``, e.g. a frame's) and ``chunk``
    are rendered float, int8 and, with a net, distilled and distilled int8
    (``render_rays``, every map, or as ``render_kw`` asks), then rendered
    ``time_frames`` times more each on the host clock (``frame_s``); the
    record also holds ``infer_digest``.
    ``broken`` with ``broken_calib``: no rank shares the tables, and rank
    1 calibrates on ``broken_calib``.  Its record: ``steps``
    (collectives and launches of each), ``digests``, ``loaded_digests``,
    ``frames``, ``distill_losses``, the errors the stale, an absent and
    the corrupt file raised with the stale notice, and rank 0's
    ``qparams`` and ``pparams`` (JAX layout).

    ``cli`` (a list of ``(name, argv[, requests])``) runs ``evaluate``
    (``cli.evaluate``), ``infer`` (``cli.infer``) or ``serve``
    (``serving.main``; rank 0 sends ``requests``, ``(method, path)``, to
    its ``--port`` and then SIGTERMs itself) in turn, ``{rank}`` in an
    argument replaced by the rank: stdout, the returned value (the
    server's: the response bodies) and the launches of each.

    ``jobs`` (a list of specs over ``spec``, each with a config of the
    same mesh shape) runs each in turn in the one launch; a rank's record
    is then the list of theirs.

    Raises when a rank fails or outlives ``timeout`` seconds.
    """
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["NERF_COORDINATOR"] = f"localhost:{free_port()}"
    env["NERF_NUM_PROCESSES"] = str(world)
    with tempfile.TemporaryDirectory() as tmp:
        spec_path = os.path.join(tmp, "spec.pkl")
        with open(spec_path, "wb") as f:
            pickle.dump(spec, f)
        outs = [os.path.join(tmp, f"rank{r}.pkl") for r in range(world)]
        procs = [subprocess.Popen(
            [sys.executable, "-m", "nerf_keras_tpu_torch.parallel.audit", spec_path, outs[r]],
            env=dict(env, NERF_PROCESS_ID=str(r)), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE) for r in range(world)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=timeout))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        failed = [r for r, p in enumerate(procs) if p.returncode != 0]
        if failed:
            raise RuntimeError("rank(s) {} of {} failed:\n{}".format(failed, world, "\n".join(
                f"--- rank {r} rc={procs[r].returncode}\n{logs[r][1].decode()[-3000:]}"
                for r in failed)))
        records = []
        for path in outs:
            with open(path, "rb") as f:
                records.append(pickle.load(f))
    return records


def run_two_process_smoke(device: str, backend: str | None = None,
                          cfg_overrides: dict | None = None, timeout: float = 120.0,
                          **spec) -> list[dict]:
    """Two ranks of :func:`run_ranks` on ``device`` (``backend`` None: the
    device's; ``'gloo'`` puts two ranks on one card) with a config of
    ``cfg_overrides`` over the ``NeRFConfig`` defaults (``near``/``far``
    default 2/6, ``batch`` a ``profile_train.bench_batch`` of ``BATCH_SIZE``
    rays).
    Returns both records; raises when their metrics differ by more than
    1e-6 relative or their parameters, EMA or BatchNorm statistics differ
    in any bit."""
    cfg = NeRFConfig(**(cfg_overrides or {})).validate()
    spec = {"near": 2.0, "far": 6.0, "batch": bench_batch(cfg.batch_size), **spec,
            "device": device, "backend": backend, "cfg": cfg}
    a, b = run_ranks(2, spec, timeout)
    for i, (ma, mb) in enumerate(zip(a["metrics"], b["metrics"])):
        for k in ma:
            if abs(ma[k] - mb[k]) > 1e-6 * max(1.0, abs(ma[k])):
                raise AssertionError(f"cross-rank metric divergence at step {i}: {ma} vs {mb}")
    if a["digest"] != b["digest"]:
        raise AssertionError("cross-rank parameter divergence: the two ranks' parameters, "
                             "EMA or BatchNorm statistics differ")
    return [a, b]


def _main(spec_path: str, out_path: str) -> None:
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    if spec["device"] == "cpu":
        torch.set_num_threads(1)
    if not maybe_initialize(spec["device"], spec.get("backend")):
        raise RuntimeError("no launch environment (NERF_* trio) for this rank")
    try:
        record = ([_run_rank(dict(spec, jobs=None, **job)) for job in spec["jobs"]]
                  if spec.get("jobs") else _run_rank(spec))
        barrier()
    finally:
        shutdown()
    with open(out_path, "wb") as f:
        pickle.dump(record, f)


if __name__ == "__main__":
    _main(*sys.argv[1:3])
