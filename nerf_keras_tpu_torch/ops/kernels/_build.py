"""Build and load the port's CUDA kernels.

``nvcc`` compiles ``csrc/*.cu`` for Hopper (``sm_90a``) into one shared
library with a plain C interface, at first use, and ``ctypes`` loads it.
No PyTorch headers are involved, so a build takes seconds.  The library
lands in ``nerf_keras_tpu_torch/_build/`` (ignored by git), named by a
hash of the sources and flags, so an edited source rebuilds and an
unchanged one is reused.

Never ``-use_fast_math``: the encoding's top octave takes ``sin`` of
thousands of radians, where the fast intrinsic is wrong.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_log = ""  # nvcc's output (ptxas register/spill report) of the last build


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels are "
        "built on the machine with the card"
    )


def library_path() -> Path:
    digest = hashlib.sha256()
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libnkt_kernels_{digest.hexdigest()[:16]}.so"


def build() -> float:
    """Compile the kernels unless the hashed library exists; returns the
    seconds spent in nvcc (0.0 when the library was already built)."""
    global build_log
    so = library_path()
    if so.exists():
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in _sources() if s.suffix == ".cu"]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, so)
    return seconds


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call), with every entry
    point's ``argtypes``/``restype`` declared: pointers and the stream as
    ``c_void_p``, so ctypes never truncates them to 32 bits."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(str(library_path()))
            vp, i32 = ctypes.c_void_p, ctypes.c_int
            fn = lib.nkt_fused_render_fwd
            fn.argtypes = [
                vp, vp, vp,          # origins, dirs, t_vals
                vp, vp, vp,          # w_pack, b_pack, dense_desc (host)
                i32, i32, i32, i32,  # n_dense, num_layers, skip, hidden
                i32, i32, i32, i32,  # l_xyz, l_dir, B, S
                vp, vp,              # rgb_out, w_out
                i32, vp,             # device, stream
            ]
            fn.restype = i32
            _lib = lib
        return _lib
