"""Device resolution, numeric settings and kernel timing for the port.

Every entry point resolves its device here, explicitly.  The plain
PyTorch path is what each kernel is compared with, so float32 products
must be true float32: TF32 (about three decimal digits) is switched off
for matmuls and for cuDNN.  TF32-class truncation of float32 operands is
the bug class that once cost the JAX package about 1.3 dB of PSNR
(docs/PERF.md).
"""

from __future__ import annotations

import statistics
import subprocess

import torch


def configure_numerics() -> None:
    """Pin float32 matmuls and convolutions to full float32 (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(name: str | None = None) -> torch.device:
    """``'cuda'``/``'cuda:N'``/``'cpu'`` -> ``torch.device``; ``None`` means
    ``'cuda'``.  A CUDA request without a card raises: the CPU runs only
    when the caller passes ``'cpu'``."""
    configure_numerics()
    device = torch.device("cuda" if name is None else name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} requested but CUDA is not available")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r} (cuda|cpu)")
    return device


def card_string() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them
    (``name, power.limit``), to stand beside every number measured on it.
    Raises when ``nvidia-smi`` is missing or fails."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0].strip()


def cuda_ms(fn, reps: int = 10) -> float:
    """Median milliseconds of ``fn()`` on the card over ``reps`` runs after
    one warm-up, each bracketed by CUDA events."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms_by_kernel(fn, families: dict, tries: int = 3) -> dict:
    """Device milliseconds of each kernel family in one call of ``fn``
    (``torch.profiler``; a family is a tuple of substrings of kernel
    names), and of all device work under ``"all"``.  The profiler now and
    then records no device event in a window: ``fn`` then runs again in a
    new one, and after ``tries`` empty windows this raises."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if events:
            break
    else:
        raise RuntimeError(f"torch.profiler recorded no device work in {tries} windows")
    span = lambda e: e.time_range.end - e.time_range.start  # noqa: E731
    out = {k: sum(span(e) for e in events if any(n in e.name for n in names)) / 1e3
           for k, names in families.items()}
    out["all"] = sum(span(e) for e in events) / 1e3
    return out
