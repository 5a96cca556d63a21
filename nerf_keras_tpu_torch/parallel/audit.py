"""Structural checks of the data-parallel step and render, and a real
multi-process run.

Counterpart of ``nerf_keras_tpu/parallel/audit.py``.  The JAX package
reads the collectives from the compiled HLO text; the port calls each
collective through a counted wrapper (``parallel/mesh.py``), so its two
checks read those counters instead:

* the train step makes exactly ONE all-reduce, carrying every parameter's
  gradient and the :data:`~nerf_keras_tpu_torch.engine.step.N_METRICS`
  metric numerators, element for element; a ``BATCH_NORM`` config adds
  four per BatchNorm layer (its global mean and variance, forward and
  backward) and nothing else (:func:`audit_train_step`);
* a render makes ZERO all-reduces: its only collectives are all-gathers
  of the output maps, exactly their elements (:func:`audit_render`).

:func:`run_ranks` launches a real job of N processes on one host (the
``NERF_*`` trio, a localhost rendezvous) that trains a few steps, audits
them and renders; :func:`run_two_process_smoke` runs two ranks and raises
when their metrics or parameters diverge (the counterpart of
``run_two_process_pallas_smoke``).  A rank runs as ``python -m
nerf_keras_tpu_torch.parallel.audit SPEC OUT`` (pickles this module
writes and reads).
"""

from __future__ import annotations

import hashlib
import os
import pickle
import socket
import subprocess
import sys
import tempfile

import numpy as np
import torch

from nerf_keras_tpu_torch.config import NeRFConfig
from nerf_keras_tpu_torch.engine import step as step_mod
from nerf_keras_tpu_torch.engine.step import N_METRICS, make_train_step, params_of
from nerf_keras_tpu_torch.engine.trainer import Trainer
from nerf_keras_tpu_torch.models.mlp import NeRFMLP
from nerf_keras_tpu_torch.ops.kernels import launch_counts
from nerf_keras_tpu_torch.parallel import mesh as mesh_mod
from nerf_keras_tpu_torch.parallel.distributed import maybe_initialize, shutdown
from nerf_keras_tpu_torch.profile_train import bench_batch
from nerf_keras_tpu_torch.runtime import cuda_ms
from nerf_keras_tpu_torch.utils.checkpoint import _flatten

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def expected_train_reduce(trainer: Trainer) -> tuple[int, int]:
    """``(all-reduce calls, elements)`` one train step must make: the one
    gradient reduce (parameters + metric numerators), plus four per
    BatchNorm layer of width w (w elements each) for ``BATCH_NORM``."""
    n_params = sum(p.numel() for p in params_of(trainer.params))
    bns = [bn for m in trainer.params.values() if isinstance(m, NeRFMLP)
           for bn in m.bn_layers()]
    return 1 + 4 * len(bns), n_params + N_METRICS + 4 * sum(bn.gamma.numel() for bn in bns)


def audit_train_step(trainer: Trainer, batch, draws: dict | None = None) -> dict:
    """Run one train step of a trainer under a mesh and check its
    collectives (module docstring); returns the step's metrics and the
    counts."""
    if trainer.mesh is None:
        raise ValueError("audit_train_step needs a trainer under a data mesh")
    mesh_mod.reset_counts()
    metrics = trainer.train_step(batch, draws)
    got = mesh_mod.counts()
    calls, elements = expected_train_reduce(trainer)
    if (got["all_reduce"], got["all_reduce_elements"]) != (calls, elements):
        raise AssertionError(
            f"the train step made {got['all_reduce']} all-reduce(s) of "
            f"{got['all_reduce_elements']} elements; expected {calls} of {elements} "
            f"(one gradient reduce of the parameters + {N_METRICS} metrics"
            f"{', and BatchNorm moments' if calls > 1 else ''})")
    if got["all_gather"] or got["broadcast"]:
        raise AssertionError(f"the train step made other collectives: {got}")
    return {"metrics": metrics, "collectives": got, "all_reduce_count": calls,
            "all_reduce_elements": elements}


def audit_render(trainer: Trainer, origins, dirs, chunk: int = 16384) -> dict:
    """Render rays under a mesh (``Trainer.render_rays``) and check that
    no all-reduce ran and that the all-gathers carried exactly the output
    maps of every (padded) chunk; returns the outputs and the counts."""
    if trainer.mesh is None:
        raise ValueError("audit_render needs a trainer under a data mesh")
    mesh_mod.reset_counts()
    out = trainer.render_rays(origins, dirs, chunk=chunk)
    got = mesh_mod.counts()
    n, world = len(origins), trainer.mesh.world
    chunk = -(-min(chunk, max(n, 1)) // world) * world
    num_chunks = -(-n // chunk)
    want = sum(v.size // n for v in out.values()) * num_chunks * chunk
    if got["all_reduce"] or got["broadcast"]:
        raise AssertionError(f"the render made a reduction or broadcast: {got}")
    if (got["all_gather"], got["all_gather_elements"]) != (num_chunks * len(out), want):
        raise AssertionError(
            f"the render gathered {got['all_gather']} maps of {got['all_gather_elements']} "
            f"elements; expected {num_chunks * len(out)} of {want} (the output maps)")
    return {"outputs": out, "collectives": got}


def tree_rel_l2(got: dict, want: dict) -> float:
    """The largest per-leaf relative L2 error between two JAX-layout trees
    (``Trainer.params_tree``'s, e.g. gradients)."""
    got, want = _flatten(got, ""), _flatten(want, "")
    return max(float(np.linalg.norm(got[k] - w) / max(np.linalg.norm(w), 1e-30))
               for k, w in want.items())


def state_digest(trainer: Trainer) -> str:
    """sha256 of the parameters, BatchNorm statistics and EMA shadow."""
    h = hashlib.sha256()
    for t in trainer.state_tensors():
        h.update(t.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def _drop_own_gradients() -> None:
    """The broken variant: this rank sends zeros into every reduce of the
    step (its gradients and metrics are left out of the sum), and takes
    the result as the others do."""
    real = step_mod.all_reduce_flat
    step_mod.all_reduce_flat = lambda tensors, mesh: real(
        [torch.zeros_like(t) for t in tensors], mesh)


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
    mesh = mesh_mod.make_mesh()
    trainer = Trainer(spec["cfg"], spec["near"], spec["far"], mesh=mesh)
    if spec.get("params") is not None:
        trainer.replace_params(spec["params"], spec.get("bn"))
    trainer.step = spec.get("start_step", 0)
    if spec.get("drop_rank") == mesh.rank:
        _drop_own_gradients()
    rows = mesh_mod.local_rows(len(spec["batch"][0]), mesh)
    batch = trainer.put_batch(tuple(x[rows] for x in spec["batch"]))
    record = {"rank": mesh.rank, "world": mesh.world, "device": str(trainer.device),
              "backend": torch.distributed.get_backend(), "metrics": [], "launches": []}
    for i in range(spec.get("steps", 3)):
        before = launch_counts()
        if i == 0:
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
    if spec.get("render_rays"):
        n = spec["render_rays"]
        before = launch_counts()
        render = audit_render(trainer, spec["batch"][1][:n], spec["batch"][2][:n],
                              chunk=spec.get("render_chunk", 16384))
        record["render_launches"] = {k: v - before[k] for k, v in launch_counts().items()
                                     if v != before[k]}
        record["render_collectives"] = render["collectives"]
        record["render"] = {k: v for k, v in render["outputs"].items()}
    if spec.get("time_steps"):
        n = spec["time_steps"]
        record["step_ms"] = cuda_ms(lambda: trainer.train_step(batch), n)
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
    ``bn`` (JAX-layout trees to start from), ``start_step``, ``steps``
    (default 3; the first is audited), ``render_rays`` (render and audit
    that many of the batch's rays), ``render_chunk``, and on the card
    ``time_steps`` (median ms of that many more steps, CUDA events; on
    one rank also of the same step built without the mesh),
    ``profile`` (count the NCCL all-reduces of that many more steps in a
    ``torch.profiler`` window), and ``drop_rank`` (that rank leaves its gradients
    out of the reduce: the broken variant).

    A record holds ``metrics`` and kernel ``launches`` per step, the
    first step's reduced ``grads``, its ``audit`` and the BatchNorm
    statistics after it (``bn_first``), the final
    ``params``, ``bn`` and ``digest``, and what was asked for.  Raises
    when a rank fails or outlives ``timeout`` seconds.
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
        record = _run_rank(spec)
    finally:
        shutdown()
    with open(out_path, "wb") as f:
        pickle.dump(record, f)


if __name__ == "__main__":
    _main(*sys.argv[1:3])
