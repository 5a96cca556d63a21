"""Step timing and profiler traces (counterpart of
``nerf_keras_tpu/utils/profiling.py``).

* :func:`trace`: a ``torch.profiler`` window written as a Chrome trace
  (``chrome://tracing`` or Perfetto loads it), the counterpart of the
  ``jax.profiler`` trace directory;
* :class:`StepTimer`: wall-clock time of a step function that launches
  work asynchronously.  It synchronizes with ``torch.cuda.synchronize``
  on the card; PyTorch on the CPU runs eagerly and needs no sync.  The
  JAX timer also subtracts a fetch round trip, which its remote backend
  needed and a local card does not.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass

import torch

TRACE_FILE = "trace.json"


def synchronize(device) -> None:
    """Wait for ``device``'s queued work (a no-op on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def trace(log_dir: str, device="cuda"):
    """Profile the enclosed work (host ops, and device kernels on the card)
    and write ``log_dir/trace.json`` when the window closes."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        synchronize(device)
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


@dataclass
class StepTimer:
    """Steady-state time of ``step_fn``: ``warmup`` calls, then ``steps``
    calls between two synchronizations of ``device``.

    Example::

        stats = StepTimer(warmup=5, steps=30).measure(lambda: trainer.train_step(batch))
        print(stats["step_ms"], stats["steps_per_sec"])
    """

    warmup: int = 5
    steps: int = 20
    device: str = "cuda"

    def measure(self, step_fn) -> dict:
        for _ in range(self.warmup):
            step_fn()
        synchronize(self.device)
        t0 = time.perf_counter()
        for _ in range(self.steps):
            step_fn()
        synchronize(self.device)
        step_s = max(time.perf_counter() - t0, 1e-9) / self.steps
        return {"step_ms": step_s * 1e3, "steps_per_sec": 1.0 / step_s}
