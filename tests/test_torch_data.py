"""The port's data layer (``nerf_keras_tpu_torch/data``) against the JAX
package's on the same inputs.

Batches and shards are bit-equal (the same ``default_rng((seed, epoch))``
permutation and numpy gathers).  Rays: atol 1e-6 (both compute the
pinhole directions in float32, the port with torch, the JAX package with
jnp).  Pixels: atol 1e-5 (the analytic scenes are numpy on those rays;
the resized frames go through ``F.interpolate`` against
``jax.image.resize``).  The Blender loader decodes with the port's PNG
decoder against the JAX loader's PIL: atol 1e-6.
"""

import json
import os
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from nerf_keras_tpu.data import blender as jblender
from nerf_keras_tpu.data import lego as jlego
from nerf_keras_tpu.data import pipeline as jpipe
from nerf_keras_tpu.data import synthetic as jsynth
from nerf_keras_tpu.ops.rays import pose_spherical
from nerf_keras_tpu_torch.data import blender as pblender
from nerf_keras_tpu_torch.data import lego as plego
from nerf_keras_tpu_torch.data import pipeline as ppipe
from nerf_keras_tpu_torch.data import synthetic as psynth

torch.set_num_threads(1)

RAY_TOL = 1e-6
PIXEL_TOL = 1e-5


def _datasets(n=103, h=3, w=5, seed=0):
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=(n, 3)).astype(np.float32) for _ in range(3)]
    kw = dict(near=2.0, far=6.0, focal=3.0, height=h, width=w)
    return jpipe.RayDataset(*arrays, **kw), ppipe.RayDataset(*arrays, **kw)


def _same_ds(port, jax_ds, pixel_tol=PIXEL_TOL):
    assert len(port) == len(jax_ds)
    assert (port.height, port.width, port.num_images) == (jax_ds.height, jax_ds.width,
                                                           jax_ds.num_images)
    assert (port.near, port.far) == (jax_ds.near, jax_ds.far)
    np.testing.assert_allclose(port.focal, jax_ds.focal, rtol=1e-12)
    for name in ("pixels", "origins", "directions"):
        got, want = getattr(port, name), np.asarray(getattr(jax_ds, name))
        assert got.dtype == np.float32 and got.shape == want.shape, name
        tol = pixel_tol if name == "pixels" else RAY_TOL
        np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=name)


@pytest.mark.parametrize("seed,epoch", [(0, 0), (0, 1), (42, 0), (42, 7), (5, 3)])
@pytest.mark.parametrize("shuffle,drop", [(True, True), (False, True), (True, False)])
def test_iterate_batches_bit_equal(seed, epoch, shuffle, drop):
    jds, pds = _datasets()
    kw = dict(shuffle=shuffle, seed=seed, epoch=epoch, drop_remainder=drop)
    got = list(ppipe.iterate_batches(pds, 16, **kw))
    want = list(jpipe.iterate_batches(jds, 16, **kw))
    assert len(got) == len(want) == (6 if drop else 7)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    assert ppipe.steps_per_epoch(pds, 16) == jpipe.steps_per_epoch(jds, 16)


@pytest.mark.parametrize("index,count", [(0, 1), (0, 2), (1, 2), (2, 3)])
def test_process_slice_and_views_bit_equal(index, count):
    jds, pds = _datasets(n=90, h=3, w=5)
    got, want = pds.process_slice(index, count), jds.process_slice(index, count)
    for name in ("pixels", "origins", "directions"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    for i in range(pds.num_images):
        np.testing.assert_array_equal(pds.image(i), jds.image(i))
        for a, b in zip(pds.image_rays(i), jds.image_rays(i)):
            np.testing.assert_array_equal(a, b)


def test_build_ray_dataset_and_focal():
    rng = np.random.default_rng(1)
    images = rng.uniform(size=(3, 6, 9, 3)).astype(np.float32)
    poses = np.stack([pose_spherical(t, -30.0, 4.0) for t in (0.0, 100.0, 250.0)])
    poses[:, :3, 3] += rng.normal(size=(3, 3)).astype(np.float32)
    want = jpipe.build_ray_dataset(images, poses, 6, 9, 7.5, 2.0, 6.0)
    got = ppipe.build_ray_dataset(images, poses, 6, 9, 7.5, 2.0, 6.0)
    _same_ds(got, want, pixel_tol=0.0)
    assert ppipe.rescale_focal(50.0, 100, 100, 25, 40) == jpipe.rescale_focal(
        50.0, 100, 100, 25, 40)
    # These cameras look down at 30 degrees, so every ray is forward-facing
    # and NDC applies: bounds [0, 1], the JAX rays.
    ndc = ppipe.dataset_to_ndc(got)
    _same_ds(ndc, jpipe.dataset_to_ndc(want), pixel_tol=0.0)
    assert (ndc.near, ndc.far) == (0.0, 1.0)


@pytest.mark.parametrize("scene,holdout,size", [
    ("sphere", None, (10, 10)),
    ("sphere", "interleave", (8, 12)),
    ("spheres", None, (9, 7)),
    ("spheres", "tail", (10, 10)),
])
def test_prepare_synthetic_data_matches_jax(scene, holdout, size):
    h, w = size
    kw = dict(num_views=7, seed=3, scene=scene, holdout=holdout)
    jt, jv, jb, jf = jsynth.prepare_synthetic_data(h, w, **kw)
    pt, pv, pb, pf = psynth.prepare_synthetic_data(h, w, **kw)
    assert pb == jb and pf == jf
    _same_ds(pt, jt)
    _same_ds(pv, jv)
    with pytest.raises(ValueError, match="unknown synthetic scene"):
        psynth.prepare_synthetic_data(h, w, scene="cube")


def _write_npz(path, views=5, size=100, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.uniform(size=(views, size, size, 3)).astype(np.float32)
    poses = np.stack([pose_spherical(36.0 * i, -30.0, 4.0) for i in range(views)])
    np.savez(path, images=images, poses=poses, focal=np.float64(138.9))


@pytest.mark.parametrize("size", [(25, 25), (40, 60)])
def test_prepare_lego_data_matches_jax(tmp_path, size):
    path = str(tmp_path / "tiny_nerf_data.npz")
    _write_npz(path)
    want = jlego.prepare_lego_data(*size, path=path)
    got = plego.prepare_lego_data(*size, path=path)
    assert got[2] == want[2]
    np.testing.assert_allclose(got[3], want[3], rtol=1e-12)
    _same_ds(got[0], want[0])
    _same_ds(got[1], want[1])
    assert got[0].num_images == 4 and got[1].num_images == 1


def test_find_lego_npz_never_downloads(tmp_path, monkeypatch):
    def no_network(*args, **kwargs):
        raise AssertionError("the port's Lego loader opened a URL")

    monkeypatch.setattr(urllib.request, "urlretrieve", no_network)
    monkeypatch.setattr(urllib.request, "urlopen", no_network)
    monkeypatch.delenv("NERF_DATA_DIR", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError) as err:
        plego.find_lego_npz(str(tmp_path / "missing.npz"))
    for cand in plego.lego_candidates(str(tmp_path / "missing.npz")):
        assert cand in str(err.value)
    # The same candidates in the same order as the JAX loader's search.
    data_dir = tmp_path / "env"
    data_dir.mkdir()
    monkeypatch.setenv("NERF_DATA_DIR", str(data_dir))
    (tmp_path / "data").mkdir()
    _write_npz(tmp_path / "data" / "tiny_nerf_data.npz", views=2, size=4)
    assert plego.find_lego_npz() == jlego.find_lego_npz() == os.path.join(
        "data", "tiny_nerf_data.npz")
    _write_npz(data_dir / "tiny_nerf_data.npz", views=2, size=4)
    assert plego.find_lego_npz() == jlego.find_lego_npz() == str(
        data_dir / "tiny_nerf_data.npz")


MODES = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}


def _write_scene(root, mode, train=5, val=3, size=(12, 16), with_val=True, seed=0):
    """A nerf_synthetic-layout scene with PIL-written PNGs in ``mode``."""
    rng = np.random.default_rng(seed)
    h, w = size
    splits = {"train": train, **({"val": val} if with_val else {})}
    for split, n in splits.items():
        (root / split).mkdir(parents=True)
        frames = []
        for i in range(n):
            arr = rng.integers(0, 256, (h, w, MODES[mode]), dtype=np.uint8)
            if mode in ("LA", "RGBA"):
                arr[..., -1] = np.where(rng.uniform(size=(h, w)) < 0.3, 0,
                                        arr[..., -1])  # some fully clear pixels
            Image.fromarray(arr[..., 0] if mode == "L" else arr, mode=mode).save(
                root / split / f"r_{i}.png")
            pose = pose_spherical(360.0 * i / n, -30.0, 4.0)
            # Leave the extension off half the frames (the loader adds .png).
            rel = f"./{split}/r_{i}" + (".png" if i % 2 else "")
            frames.append({"file_path": rel, "transform_matrix": pose.tolist()})
        (root / f"transforms_{split}.json").write_text(
            json.dumps({"camera_angle_x": 0.69, "frames": frames}))


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("white", [True, False])
def test_load_blender_split_matches_jax(tmp_path, mode, white):
    _write_scene(tmp_path, mode)
    for split, every in (("train", 1), ("val", 2)):
        got = pblender.load_blender_split(str(tmp_path), split, white_bkgd=white, every=every)
        want = jblender.load_blender_split(str(tmp_path), split, white_bkgd=white,
                                           every=every)
        assert got[0].shape == want[0].shape and got[0].dtype == np.float32
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]


@pytest.mark.parametrize("with_val", [True, False])
def test_prepare_blender_data_matches_jax(tmp_path, with_val):
    """Val from transforms_val.json every 2nd frame, or (no val split) the
    last 20% of the train frames; resized 12x16 -> 9x10."""
    _write_scene(tmp_path / "lego", "RGBA", train=5, val=4, with_val=with_val)
    kw = dict(scene="lego", white_bkgd=False, val_every=2)
    want = jblender.prepare_blender_data(9, 10, str(tmp_path), **kw)
    got = pblender.prepare_blender_data(9, 10, str(tmp_path), **kw)
    assert got[2] == want[2]
    np.testing.assert_allclose(got[3], want[3], rtol=1e-12)
    _same_ds(got[0], want[0])
    _same_ds(got[1], want[1])
    assert got[1].num_images == (2 if with_val else 1)


def test_blender_refuses_unsupported_pngs_by_name(tmp_path):
    """A palette frame loads as the JAX loader loads it; a PNG whose image
    data ends early (PIL refuses it too) raises naming the file."""
    _write_scene(tmp_path, "RGB", train=2, with_val=False)
    bad = tmp_path / "train" / "r_1.png"
    Image.fromarray(np.arange(192, dtype=np.uint8).reshape(12, 16), mode="L").convert(
        "P").save(bad)
    got = pblender.load_blender_split(str(tmp_path), "train")
    want = jblender.load_blender_split(str(tmp_path), "train")
    np.testing.assert_array_equal(got[0], want[0])
    data = bad.read_bytes()
    bad.write_bytes(data[:data.index(b"IEND") - 12] + data[data.index(b"IEND") - 4:])
    with pytest.raises(OSError):
        jblender.load_blender_split(str(tmp_path), "train")
    with pytest.raises(ValueError, match="r_1.png"):
        pblender.load_blender_split(str(tmp_path), "train")
    with pytest.raises(FileNotFoundError, match="transforms_train.json"):
        pblender.find_blender_scene(str(tmp_path / "nowhere"), "lego")
