"""Host C++ of the port (not kernels), built with g++ at first use.

Each library goes into ``nerf_keras_tpu_torch/_build/``, never next to its
source, named after a hash of the source (``library_path``): the ray
batcher (``data/native.py``), the JPEG scan decoder (``utils/jpeg.py``),
the PNG unfilter (``utils/png.py``) and the GIF palettes and LZW
(``utils/gif.py``).  The three codecs load theirs through
``load_library``, which raises ``RuntimeError`` naming g++ where it is
missing or fails.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"


def library_path(src: Path, stem: str) -> Path:
    """``_build/<stem>-<hash of src>.so``."""
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"{stem}-{digest}.so"


def compile_library(src: Path, lib: Path) -> None:
    """g++ one C++ source into the shared library ``lib``.  A per-process
    temp name and ``os.replace``: a sibling process never loads a
    half-written library."""
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", str(tmp), str(src)],
            check=True, capture_output=True,
        )
        os.replace(tmp, lib)
    finally:
        tmp.unlink(missing_ok=True)


def load_library(src: Path, lib: Path, what: str) -> ctypes.CDLL:
    """Build ``src`` into ``lib`` unless it is there, and load it; ``what``
    (e.g. "the PNG decoder") names the caller in the error without g++."""
    if not lib.exists():
        if shutil.which("g++") is None:
            raise RuntimeError(f"{what} needs g++ to build native/{src.name}, and no g++ "
                               "is on PATH")
        try:
            compile_library(src, lib)
        except subprocess.CalledProcessError as e:
            raise RuntimeError(f"g++ failed to build {src}: "
                               f"{e.stderr.decode(errors='replace')[:400]}") from e
    return ctypes.CDLL(str(lib))
