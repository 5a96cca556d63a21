"""The port's LLFF loader (``data/llff.py``) against the JAX package's.

Both sides are numpy on the same files, so poses, bounds, render paths,
images and rays agree to 1e-6 (they come out bit-equal; the resized
frames go through ``resize_bilinear``, held to ``jax.image.resize`` at
6e-7 by ``tests/test_torch_image.py``).  The capture is the port's
``write_forward_facing_capture``: 5 PNG views in ``images_8/`` at 12x16
(the JAX loader reads them with PIL).  What the port does not load (a
broken JPEG or PNG, a ``gs://`` root) raises naming the file or
directory; JPEG captures and ``minify`` are ``tests/test_torch_jpeg.py``'s.
"""

import os

import numpy as np
import pytest

from nerf_keras_tpu.data import llff as jllff
from nerf_keras_tpu_torch.data import llff as pllff
from nerf_keras_tpu_torch.data.synthetic import write_forward_facing_capture
from nerf_keras_tpu_torch.utils.png import encode_png

ATOL = 1e-6


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    return write_forward_facing_capture(str(tmp_path_factory.mktemp("llff")), 5, 12, 16,
                                        15.0)


def _random_poses(seed, n=6):
    """``(N, 3, 5)`` poses of cameras around a common focus, with hwf."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        pos = rng.normal(size=3) * 0.4 + np.array([0.0, 0.0, 3.0])
        z = pos / np.linalg.norm(pos)
        out.append(np.concatenate([jllff.view_matrix(z, np.array([0.1, 1.0, 0.0]), pos),
                                   [[12.0], [16.0], [15.0]]], axis=1))
    return np.stack(out).astype(np.float32)


def _close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_pose_math_matches_jax(seed):
    poses = _random_poses(seed)
    bds = np.random.default_rng(seed).uniform(1.0, 5.0, (6, 2)).astype(np.float32)
    _close(pllff.average_pose(poses), jllff.average_pose(poses))
    _close(pllff.recenter_poses(poses), jllff.recenter_poses(poses))
    np.testing.assert_allclose(pllff.average_pose(pllff.recenter_poses(poses))[:, :4],
                               np.eye(4)[:3], atol=1e-5)
    avg = jllff.average_pose(poses)
    args = (avg, np.array([0.0, 1.0, 0.0]), np.array([0.3, 0.2, 0.1]), 2.5, 0.5, 2, 17)
    _close(pllff.spiral_render_path(*args), jllff.spiral_render_path(*args))
    for a, b in zip(pllff.spherify_poses(poses, bds), jllff.spherify_poses(poses, bds)):
        _close(a, b)


@pytest.mark.parametrize("n_frames", [17, 30])
@pytest.mark.parametrize("spherify", [False, True])
def test_render_path_matches_jax(capture, spherify, n_frames):
    ours = pllff.load_llff_render_path(capture, spherify=spherify, n_frames=n_frames)
    theirs = jllff.load_llff_render_path(capture, spherify=spherify, n_frames=n_frames)
    assert ours.shape == (n_frames, 3, 5)
    _close(ours, theirs)


def test_load_llff_data_matches_jax(capture):
    ours = pllff.load_llff_data(capture)
    theirs = jllff.load_llff_data(capture)
    for a, b in zip(ours[:4], theirs[:4]):
        _close(a, b)
    assert ours[0].shape == (5, 12, 16, 3) and ours[0].std() > 0.05
    assert ours[4] == theirs[4]
    np.testing.assert_allclose(ours[1][:, :, 4], [[12.0, 16.0, 15.0]] * 5)


@pytest.mark.parametrize("size", [(12, 16), (24, 32)])
def test_prepare_fern_data_matches_jax(capture, size):
    ours = pllff.prepare_fern_data(*size, basedir=capture)
    theirs = jllff.prepare_fern_data(*size, basedir=capture)
    assert ours[2] == theirs[2] and ours[3] == theirs[3]
    for a, b in zip(ours[:2], theirs[:2]):
        assert (a.height, a.width, a.near, a.far, a.focal) == (
            b.height, b.width, b.near, b.far, b.focal)
        assert len(a) == len(b)
        for x, y in ((a.pixels, b.pixels), (a.origins, b.origins),
                     (a.directions, b.directions)):
            _close(x, y)
    assert ours[1].num_images == 1 and ours[0].num_images == 4
    assert (ours[0].directions[:, 2] < 0).all()  # forward-facing


def test_unported_captures_raise_naming_what(capture, tmp_path):
    """What the loader cannot read raises naming the file or directory: a
    capture with an empty ``images/`` gets the JAX package's count error
    (both create ``images_8/`` first), a JPEG too short to be one a
    ``ValueError`` naming it (the JAX loader fails there too, with PIL's
    ``OSError``), a PNG with a broken header likewise, a ``gs://`` root
    the remote-storage error."""
    msgs = []
    for pkg, name in ((pllff, "port"), (jllff, "jax")):
        root = tmp_path / name
        (root / "images").mkdir(parents=True)
        with open(os.path.join(capture, "poses_bounds.npy"), "rb") as f:
            (root / "poses_bounds.npy").write_bytes(f.read())
        with pytest.raises(ValueError, match="0 images in .*images_8 but 5 poses") as e:
            pkg.load_llff_data(str(root))
        assert (root / "images_8").is_dir()
        msgs.append(str(e.value).replace(str(root), ""))
    assert msgs[0] == msgs[1]
    root = tmp_path / "port"
    for i in range(5):
        (root / "images_8" / f"img_{i:02d}.jpg").write_bytes(b"\xff\xd8\xff")
    with pytest.raises(ValueError, match="img_00.jpg: truncated data"):
        pllff.load_llff_data(str(root))
    with pytest.raises(OSError):
        jllff.load_llff_data(str(root))
    # A PNG whose header says 16 bits over 8-bit data (and no longer
    # matches its CRC): both loaders refuse it, the port's naming the file.
    png = bytearray(encode_png(np.zeros((2, 2, 3), np.uint8)))
    png[24] = 16  # IHDR bit depth
    deep = tmp_path / "deep.png"
    deep.write_bytes(bytes(png))
    with pytest.raises(ValueError, match="deep.png: broken PNG: bad CRC in the IHDR"):
        pllff._read_image(str(deep))
    with pytest.raises(OSError):
        jllff._read_image(str(deep))
    with pytest.raises(NotImplementedError, match="remote storage"):
        pllff.prepare_fern_data(12, 16, basedir="gs://dataset-nerf/nerf_llff_data/fern")


def test_default_fern_dir(monkeypatch):
    monkeypatch.delenv("NERF_LLFF_DIR", raising=False)
    assert pllff.default_fern_dir() == jllff.default_fern_dir()
    monkeypatch.setenv("NERF_LLFF_DIR", "/data/fern")
    assert pllff.default_fern_dir() == jllff.default_fern_dir() == "/data/fern"
