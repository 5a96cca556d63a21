"""Storage helpers: local paths only.

Counterpart of ``nerf_keras_tpu/utils/io.py``, which also reaches remote
object stores (``gs://``) through fsspec.  The port's machines have no
fsspec, so a remote path raises ``NotImplementedError`` here instead of
failing later inside a write.
"""

from __future__ import annotations

import os
from contextlib import contextmanager
from typing import IO, Iterator


def _local(path: str) -> str:
    if "://" in path:
        raise NotImplementedError(
            f"{path!r}: remote storage is not ported (the port writes local "
            "paths only; pass a local directory, e.g. --run-dir)"
        )
    return path


def exists(path: str) -> bool:
    return os.path.exists(_local(path))


def makedirs(path: str) -> None:
    os.makedirs(_local(path), exist_ok=True)


def listdir(path: str) -> list[str]:
    return sorted(os.listdir(_local(path)))


def join(*parts: str) -> str:
    return os.path.join(_local(parts[0]), *parts[1:])


@contextmanager
def open_file(path: str, mode: str = "rb") -> Iterator[IO]:
    """``open`` that creates the parent directory for a write."""
    _local(path)
    if "w" in mode or "a" in mode:
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
    with open(path, mode) as f:
        yield f
