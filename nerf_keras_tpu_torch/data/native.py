"""ctypes bindings for the native C++ ray batcher (host code, not a kernel).

Counterpart of ``nerf_keras_tpu/data/native.py`` over the port's own copy
of its source (``data/native/batcher.cc``): a background thread draws each
epoch's permutation and gathers the rows of every batch into a 4-deep
ring, so host batch assembly overlaps the device's step.  The permutation
comes from a Python callback, ``np.random.default_rng((seed, epoch))``,
so the native batches are :func:`~nerf_keras_tpu_torch.data.pipeline.iterate_batches`'
bit for bit.

g++ compiles the library at first use (about a second) into
``nerf_keras_tpu_torch/_build/``, named by a hash of the source, never
next to the source.  Without a toolchain :class:`NativeRayBatcher`
raises and the training CLI falls back to the numpy iterator.
"""

from __future__ import annotations

import ctypes
import hashlib
import subprocess
import threading
from pathlib import Path
from typing import Iterator

import numpy as np

from nerf_keras_tpu_torch.utils.hostbuild import BUILD_DIR, compile_library

_SRC = Path(__file__).resolve().parent / "native" / "batcher.cc"
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
batches = 0  # batches served in this process (every NativeRayBatcher)

# void (*)(uint64_t epoch, int64_t* order, int64_t n): the worker thread
# asks Python for each epoch's permutation (ctypes takes the GIL).
RESHUFFLE_FN = ctypes.CFUNCTYPE(
    None, ctypes.c_uint64, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64
)


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libray_batcher-{digest}.so"


def load_library() -> ctypes.CDLL:
    """Compile (once) and load the batcher.  Raises ``RuntimeError`` when
    it cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        try:
            if not path.exists():
                compile_library(_SRC, path)
            lib = ctypes.CDLL(str(path))
        except (OSError, subprocess.CalledProcessError) as e:
            detail = getattr(e, "stderr", b"") or b""
            raise RuntimeError(
                f"native batcher unavailable: {e} {detail.decode(errors='replace')[:400]}"
            ) from e
        lib.batcher_create.restype = ctypes.c_void_p
        lib.batcher_create.argtypes = [ctypes.POINTER(ctypes.c_float)] * 3 + [
            ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64, ctypes.c_uint64,
            RESHUFFLE_FN,
        ]
        lib.batcher_next.restype = None
        lib.batcher_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
        lib.batcher_steps_per_epoch.restype = ctypes.c_int64
        lib.batcher_steps_per_epoch.argtypes = [ctypes.c_void_p]
        lib.batcher_destroy.restype = None
        lib.batcher_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


class NativeRayBatcher:
    """Prefetching batch iterator over a RayDataset (an endless stream).

    Yields ``(pixels, origins, directions)`` float32 arrays of shape
    ``(batch_size, 3)``; reshuffles at each epoch boundary.  Close it (or
    drop it) to stop the worker thread.
    """

    def __init__(self, dataset, batch_size: int, seed: int = 0, start_epoch: int = 0):
        if int(batch_size) <= 0 or int(batch_size) > len(dataset):
            # The worker would read the permutation out of bounds: a
            # SIGSEGV in a thread no try/except can catch.
            raise ValueError(
                f"batch_size={batch_size} must be in [1, len(dataset)={len(dataset)}]"
            )
        self._handle = None
        self._lib = load_library()
        self.batch_size = int(batch_size)
        # Own contiguous copies: the C++ side borrows these pointers.
        self._px = np.ascontiguousarray(dataset.pixels, dtype=np.float32)
        self._og = np.ascontiguousarray(dataset.origins, dtype=np.float32)
        self._dr = np.ascontiguousarray(dataset.directions, dtype=np.float32)

        def _reshuffle(epoch: int, order_ptr, n: int) -> None:
            # iterate_batches' keying: the same order on both paths, and a
            # resumed run (start_epoch > 0) continues the original order.
            perm = np.ascontiguousarray(
                np.random.default_rng((seed, int(epoch))).permutation(n), dtype=np.int64)
            ctypes.memmove(order_ptr, perm.ctypes.data, n * 8)

        self._reshuffle_cb = RESHUFFLE_FN(_reshuffle)  # kept alive with self
        fp = ctypes.POINTER(ctypes.c_float)
        self._handle = self._lib.batcher_create(
            self._px.ctypes.data_as(fp), self._og.ctypes.data_as(fp),
            self._dr.ctypes.data_as(fp), self._px.shape[0], self.batch_size, seed,
            start_epoch, self._reshuffle_cb,
        )
        if not self._handle:
            raise RuntimeError("batcher_create rejected the arguments")
        self._out = np.empty((3, self.batch_size, 3), dtype=np.float32)

    def _live(self):
        if self._handle is None:
            # ctypes would pass NULL into C++: a segfault, not an exception.
            raise RuntimeError("NativeRayBatcher is closed")
        return self._handle

    @property
    def steps_per_epoch(self) -> int:
        return int(self._lib.batcher_steps_per_epoch(self._live()))

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]]:
        return self

    def __next__(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        global batches
        self._lib.batcher_next(self._live(),
                               self._out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        batches += 1
        return self._out[0].copy(), self._out[1].copy(), self._out[2].copy()

    def close(self) -> None:
        if self._handle is not None:
            self._lib.batcher_destroy(self._handle)
            self._handle = None

    def __enter__(self) -> "NativeRayBatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        if getattr(self, "_handle", None) is not None:
            self.close()
