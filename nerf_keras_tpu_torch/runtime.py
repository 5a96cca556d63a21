"""Device resolution and numeric settings for the port.

Every entry point resolves its device here, explicitly.  The plain
PyTorch path is what each kernel is compared with, so float32 products
must be true float32: TF32 (about three decimal digits) is switched off
for matmuls and for cuDNN.  TF32-class truncation of float32 operands is
the bug class that once cost the JAX package about 1.3 dB of PSNR
(docs/PERF.md).
"""

from __future__ import annotations

import subprocess

import torch


def configure_numerics() -> None:
    """Pin float32 matmuls and convolutions to full float32 (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(name: str | None = None) -> torch.device:
    """``'cuda'``/``'cuda:N'``/``'cpu'`` -> ``torch.device``; ``None`` means
    the card when one is present, else the CPU.  A CUDA request without a
    card raises instead of silently running on the CPU."""
    configure_numerics()
    if name is None:
        name = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(name)
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
