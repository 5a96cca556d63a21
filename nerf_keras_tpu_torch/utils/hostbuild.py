"""Host C++ of the port (not kernels), built with g++ at first use.

Each library goes into ``nerf_keras_tpu_torch/_build/``, never next to its
source, named by its caller after a hash of the source: the ray batcher
(``data/native.py``), the JPEG scan decoder (``utils/jpeg.py``) and the
PNG unfilter (``utils/png.py``).
"""

from __future__ import annotations

import os
import subprocess
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"


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
