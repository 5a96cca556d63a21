"""The port's image helpers against the JAX package's: ``resize_bilinear``
(against ``jax.image.resize``, atol 1e-5), ``ssim`` (against the genuine
``tf.image.ssim`` golden file at ``tests/test_image_metrics.py``'s
tolerance, and against the JAX ``ssim``), the PNG RGBA widening (against
PIL's ``convert("RGBA")``, exact), the history JSON (each package reads
the other's), and the panel, local storage and step timer the CLI uses."""

import io as _io
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from nerf_keras_tpu.utils import image_metrics as jmetrics
from nerf_keras_tpu.utils.image import resize_bilinear as jax_resize
from nerf_keras_tpu.utils.metrics import History as JaxHistory
from nerf_keras_tpu_torch.utils import io as pio
from nerf_keras_tpu_torch.utils.image import resize_bilinear
from nerf_keras_tpu_torch.utils.image_metrics import ssim
from nerf_keras_tpu_torch.utils.metrics import History
from nerf_keras_tpu_torch.utils.png import decode_png, to_rgba
from nerf_keras_tpu_torch.utils.profiling import StepTimer
from nerf_keras_tpu_torch.utils.viz import loss_strip, save_panel

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "ssim_golden.npz")


@pytest.mark.parametrize("src,dst", [
    ((100, 100), (25, 25)),   # down 4x
    ((100, 100), (37, 37)),   # down, non-integer ratio
    ((25, 25), (40, 40)),     # up
    ((100, 100), (40, 60)),   # non-square target
    ((30, 50), (45, 20)),     # up one axis, down the other
])
def test_resize_bilinear_matches_jax(src, dst):
    x = np.random.default_rng(0).uniform(size=(2, *src, 3)).astype(np.float32)
    got = resize_bilinear(x, *dst)
    want = jax_resize(x, *dst)
    assert got.shape == want.shape == (2, *dst, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(resize_bilinear(x[0], *dst), want[0], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(resize_bilinear(x, *src), x)


def _golden():
    raw = np.load(FIXTURE)
    names = sorted({k.split("__")[0] for k in raw.files})
    return [(n, raw[f"{n}__a"], raw[f"{n}__b"], float(raw[f"{n}__maxval"]),
             raw[f"{n}__ssim"]) for n in names]


@pytest.mark.parametrize("name,a,b,max_val,want", _golden(), ids=[c[0] for c in _golden()])
def test_ssim_matches_tf_golden_and_jax(name, a, b, max_val, want):
    got = ssim(a, b, max_val).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)
    jax_val = np.asarray(jmetrics.ssim(jnp.asarray(a), jnp.asarray(b), max_val))
    np.testing.assert_allclose(got, jax_val, atol=2e-5, rtol=1e-5)


def test_ssim_validates_shapes():
    a = np.zeros((8, 8, 3), np.float32)
    with pytest.raises(ValueError, match="smaller than"):
        ssim(a, a)
    with pytest.raises(ValueError, match="mismatch"):
        ssim(np.zeros((16, 16, 3)), np.zeros((16, 16, 1)))


@pytest.mark.parametrize("mode,channels", [("L", 1), ("LA", 2), ("RGB", 3), ("RGBA", 4)])
def test_to_rgba_equals_pil_convert(mode, channels):
    arr = np.random.default_rng(channels).integers(0, 256, (9, 13, channels), dtype=np.uint8)
    img = Image.fromarray(arr[..., 0] if channels == 1 else arr, mode=mode)
    buf = _io.BytesIO()
    img.save(buf, format="PNG")
    got = to_rgba(decode_png(buf.getvalue()))
    want = np.asarray(img.convert("RGBA"))
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def _fill(history, n_eval):
    for i in range(4):
        metrics = {"loss": 0.1 / (i + 1), "loss_coarse": 0.2 / (i + 1), "psnr": 10.0 + i}
        val = ({"loss": 0.3 / (i + 1), "psnr": 9.0 + i, "ssim": 0.5 + 0.1 * i}
               if i < n_eval else None)
        history.append(metrics, val)


@pytest.mark.parametrize("n_eval", [0, 4])
def test_history_files_load_in_either_package(tmp_path, n_eval):
    port, jax_h = History(), JaxHistory()
    _fill(port, n_eval)
    _fill(jax_h, n_eval)
    assert port.to_dict() == jax_h.to_dict()
    port.save(str(tmp_path / "p.json"))
    jax_h.save(str(tmp_path / "j.json"))
    assert JaxHistory.load(str(tmp_path / "p.json")).to_dict() == port.to_dict()
    assert History.load(str(tmp_path / "j.json")).to_dict() == jax_h.to_dict()
    assert port.few_view_collapse() == jax_h.few_view_collapse()


def test_few_view_collapse_matches_jax():
    for val_psnrs, train_psnrs in (([11.0, 11.2, 11.1], [10, 12, 14, 16, 18, 20]),
                                   ([11.0, 14.0, 17.0], [10, 12, 14, 16, 18, 20]),
                                   ([20.0, 20.1, 20.2], [10, 12, 14, 16, 18, 20])):
        port, jax_h = History(), JaxHistory()
        for h in (port, jax_h):
            h.psnrs = list(map(float, train_psnrs))
            h.val["psnrs"] = list(val_psnrs)
        assert port.few_view_collapse() == jax_h.few_view_collapse()


def test_panel_is_a_png_with_both_tiles_and_a_loss_curve(tmp_path):
    rng = np.random.default_rng(0)
    rgbs = [rng.uniform(size=(20, 30, 3)).astype(np.float32) for _ in range(2)]
    depths = [rng.uniform(2, 6, size=(20, 30)).astype(np.float32) for _ in range(2)]
    path = str(tmp_path / "images" / "003.png")
    save_panel(path, rgbs, depths, [0.3, 0.2, float("nan"), 0.1], 3, 10)
    img = decode_png(open(path, "rb").read())
    # Two rows of (rgb | gap | depth), then the loss strip, gaps between.
    assert img.shape == (20 + 2 + 20 + 2 + 16, 30 + 2 + 30, 3)
    np.testing.assert_array_equal(img[:20, :30], (255 * rgbs[0]).astype(np.uint8))
    strip = loss_strip([0.3, 0.2, 0.1], 16, 62)
    np.testing.assert_array_equal(img[-16:], strip)
    inked = np.all(strip == [31, 119, 180], axis=-1)
    assert inked[1, 1] and inked[-2, -2]  # first (largest) top left, last bottom right


def test_io_is_local_only(tmp_path):
    d = str(tmp_path / "a" / "b")
    pio.makedirs(d)
    with pio.open_file(pio.join(d, "c", "x.txt"), "w") as f:
        f.write("x")
    assert pio.exists(pio.join(d, "c", "x.txt")) and pio.listdir(d) == ["c"]
    for call in (lambda: pio.exists("gs://bucket/x"), lambda: pio.join("gs://b", "x"),
                 lambda: pio.makedirs("gs://b/x")):
        with pytest.raises(NotImplementedError, match="remote storage is not ported"):
            call()


def test_step_timer_counts_steps_on_the_cpu():
    calls = []
    stats = StepTimer(warmup=2, steps=5, device="cpu").measure(lambda: calls.append(1))
    assert len(calls) == 7
    assert stats["step_ms"] > 0 and stats["steps_per_sec"] > 0
