"""The port's native ray batcher (``nerf_keras_tpu_torch/data/native.py``,
its own copy of the C++ source) against the JAX package's numpy
pipeline: the same batches, bit for bit, in the same order."""

import numpy as np
import pytest

from nerf_keras_tpu.data import pipeline as jpipe
from nerf_keras_tpu_torch.data import native
from nerf_keras_tpu_torch.data.pipeline import RayDataset


def _dataset(n=203, seed=0):
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=(n, 3)).astype(np.float32) for _ in range(3)]
    return arrays, RayDataset(*arrays, near=2.0, far=6.0, focal=3.0, height=7, width=29)


@pytest.mark.parametrize("seed,start_epoch", [(0, 0), (42, 0), (42, 1), (7, 5)])
def test_batches_equal_jax_iterate_batches(seed, start_epoch):
    arrays, ds = _dataset()
    jds = jpipe.RayDataset(*arrays, near=2.0, far=6.0, focal=3.0, height=7, width=29)
    bs = 32
    with native.NativeRayBatcher(ds, bs, seed=seed, start_epoch=start_epoch) as nb:
        assert nb.steps_per_epoch == len(ds) // bs == 6
        for epoch in range(start_epoch, start_epoch + 3):
            for want in jpipe.iterate_batches(jds, bs, shuffle=True, seed=seed, epoch=epoch):
                got = next(nb)
                for a, b in zip(got, want):
                    assert a.shape == (bs, 3) and a.dtype == np.float32
                    np.testing.assert_array_equal(a, b)


def test_guards_raise():
    _, ds = _dataset(n=10)
    for bad in (0, -1, 11):
        with pytest.raises(ValueError, match="batch_size"):
            native.NativeRayBatcher(ds, bad)
    nb = native.NativeRayBatcher(ds, len(ds))  # the whole set in one batch is fine
    next(nb)
    nb.close()
    nb.close()  # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        next(nb)
    with pytest.raises(RuntimeError, match="closed"):
        nb.steps_per_epoch


def test_library_builds_under_the_port_build_dir():
    native.load_library()
    path = native.library_path()
    assert path.exists()
    assert path.parent == native.BUILD_DIR
    assert path.parent.name == "_build" and path.parent.parent.name == "nerf_keras_tpu_torch"
    # Nothing is built beside the source.
    src_dir = native._SRC.parent
    assert sorted(p.name for p in src_dir.iterdir()) == ["batcher.cc"]
