"""Build and load the port's CUDA kernels.

``nvcc`` compiles each ``csrc/*.cu`` for Hopper (``sm_90a``) into its own
shared library with a plain C interface, at first use, and ``ctypes``
loads them.  The compilers for all sources start together and run in
parallel.  No PyTorch headers are involved, so a build takes seconds.
The libraries land in ``nerf_keras_tpu_torch/_build/`` (ignored by git),
each named by a hash of its source, the shared headers and the flags, so
an edited source rebuilds and an unchanged one is reused.

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

_vp, _i32 = ctypes.c_void_p, ctypes.c_int
# nkt_fused_render_bwd and its 512 and 1024 libraries' entry points.
ROWS_ARGS = [
    _i32,                       # mode: 0 K2, 1 K3, 2 K6, 3 K5
    _vp, _vp, _vp, _vp,         # x_res, origins, dirs, d_enc
    _vp, _vp,                   # t_vals, preds
    _vp, _vp,                   # g_rgb, g_w
    _vp, _vp, _vp,              # w_pack, b_pack, desc_fwd (host)
    _vp, _vp, _vp,              # wb_pack, desc_bwd, desc_ws (host)
    _i32, _i32, _i32, _i32,     # n_dense, num_layers, skip, hidden
    _i32, _i32, _i32, _i32,     # l_xyz, l_dir, B, S
    _i32, _i32, _i32,           # chunk_rays, total_b, total_out
    _vp, _vp, _vp, _vp, _i32,   # dpreds, ws_a, ws_d, db_part, grid
    _vp, _i32,                  # dw_part, nsplit
    _vp, _i32,                  # dw_sched (device, above 256), dw_blocks
    _vp, _vp, _vp, _vp,         # dw_out, db_out, dx_out, dd_out (K5)
    _vp,                        # glob (hidden 1024)
    _i32, _vp,                  # device, stream
]
# Entry points by source, with their ctypes signatures: pointers and the
# stream as c_void_p, so ctypes never truncates them to 32 bits.
ENTRY_POINTS = {
    "fused_render_fwd": {
        "nkt_fused_render_fwd": [
            _vp, _vp, _vp,              # origins, dirs, t_vals
            _vp, _vp,                   # x_in, d_in (K6)
            _vp, _vp, _vp,              # w_pack, b_pack, dense_desc (host)
            _i32, _i32, _i32, _i32,     # n_dense, num_layers, skip, hidden
            _i32, _i32, _i32, _i32,     # l_xyz, l_dir, B, S
            _vp, _vp, _vp, _vp,         # rgb_out, w_out, xenc_out, preds_out
            _vp, _i32,                  # park, park_blocks (hidden 1024)
            _i32, _vp,                  # device, stream
        ],
    },
    # The rows kernels of K2, K3, K5 and K6 (csrc/nerf_rows.cuh), one library
    # for hidden 64-256 and one each for 512 and 1024, so that the three
    # compile in parallel.
    "fused_render_bwd": {
        "nkt_fused_render_bwd": ROWS_ARGS,
    },
    "fused_render_bwd_512": {
        "nkt_fused_render_bwd_512": ROWS_ARGS,
    },
    "fused_render_bwd_1024": {
        "nkt_fused_render_bwd_1024": ROWS_ARGS,
    },
    "fused_mlp_fwd": {
        "nkt_fused_mlp_fwd": [
            _vp, _vp,                   # x_enc, d_enc
            _vp, _vp, _vp,              # w_pack, b_pack, dense_desc (host)
            _i32, _i32, _i32, _i32,     # n_dense, num_layers, skip, hidden
            _i32, _i32, _i32, _i32,     # l_xyz, l_dir, N, grid
            _vp, _vp,                   # preds_out, park (hidden 1024)
            _i32, _vp,                  # device, stream
        ],
    },
    "quant_render_fwd": {
        "nkt_quant_render_fwd": [
            _vp, _vp, _vp,              # origins, dirs, t_vals
            _vp, _vp, _vp,              # w_pack (int8), f_pack, dense_desc (host)
            _i32, _i32, _i32, _i32,     # n_dense, num_layers, skip, hidden
            _i32, _i32, _i32, _i32,     # l_xyz, l_dir, x_off, d_off
            _i32, _i32,                 # B, S
            _vp, _vp,                   # rgb_out, w_out
            _i32, _vp,                  # device, stream
        ],
    },
    "fused_render_f32": {
        "nkt_f32_fwd": [
            _vp, _vp, _vp,              # origins, dirs, t_vals
            _vp, _vp,                   # x_in, d_in (K5, K6)
            _vp, _vp,                   # pack (f32), desc (host)
            _i32, _i32, _i32, _i32,     # n_dense, num_layers, skip, hidden
            _i32, _i32, _i32, _i32,     # l_xyz, l_dir, B, S
            _vp, _vp, _vp, _vp,         # rgb_out, w_out, xenc_out, preds_out
            _i32, _vp,                  # device, stream
        ],
        "nkt_f32_bwd": [
            _i32,                       # mode: 0 K2, 1 K3, 2 K6, 3 K5
            _vp, _vp, _vp, _vp,         # x_res, origins, dirs, d_enc
            _vp, _vp,                   # t_vals, preds
            _vp, _vp,                   # g_rgb, g_w
            _vp, _vp, _vp,              # pack, desc, desc_ws (host)
            _i32, _i32, _i32, _i32,     # n_dense, num_layers, skip, hidden
            _i32, _i32, _i32, _i32,     # l_xyz, l_dir, B, S
            _i32, _i32, _i32,           # chunk_rays, total_b, total_out
            _vp, _vp, _vp, _vp, _i32,   # dpreds, ws_a, ws_d, db_part, grid
            _vp, _i32,                  # dw_part, nsplit
            _vp, _vp, _vp, _vp,         # dw_out, db_out, dx_out, dd_out (K5)
            _i32, _vp,                  # device, stream
        ],
    },
    "pdf_union": {
        "nkt_pdf_union": [
            _vp, _vp, _vp, ctypes.c_longlong,  # t, w, u, u_stride
            _i32, _i32, _i32, ctypes.c_float,  # B, S, NF, w_floor
            _vp,                        # out
            _i32, _vp,                  # device, stream
        ],
    },
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_log = ""  # nvcc's output (ptxas register/spill report) of the last build


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _headers() -> list[Path]:
    return sorted(CSRC.glob("*.cuh"))


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


def library_path(source: Path) -> Path:
    digest = hashlib.sha256()
    for src in [source, *_headers()]:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{source.stem}_{digest.hexdigest()[:16]}.so"


def build() -> float:
    """Compile every source whose hashed library is missing, one nvcc per
    source, all started together; returns the wall seconds spent (0.0
    when every library was already built).  ``build_log`` heads each
    source's output with its seconds from the start."""
    global build_log
    todo = [s for s in _sources() if not library_path(s).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in todo:
        so = library_path(src)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((src, so, tmp, proc))
    done = {}  # source -> (output, seconds): each nvcc's pipe drained by a thread of its own

    def drain(src, proc):
        out, _ = proc.communicate()
        done[src] = (out, time.perf_counter() - t0)

    threads = [threading.Thread(target=drain, args=(src, proc)) for src, _, _, proc in jobs]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    logs, failed = [], []
    for src, so, tmp, proc in jobs:
        out, seconds = done[src]
        logs.append(f"== {src.name} ({seconds:.1f} s)\n{out}")
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode})")
        else:
            os.replace(tmp, so)
    build_log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed for {', '.join(failed)}:\n{build_log}")
    return time.perf_counter() - t0


def load(stem: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu`` (every source is built on
    the first call), with its entry points' ``argtypes``/``restype``
    declared."""
    with _lock:
        if stem not in _libs:
            build()
            lib = ctypes.CDLL(str(library_path(CSRC / f"{stem}.cu")))
            for name, argtypes in ENTRY_POINTS[stem].items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = _i32
            _libs[stem] = lib
        return _libs[stem]
