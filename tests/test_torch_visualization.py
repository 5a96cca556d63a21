"""``python -m nerf_keras_tpu_torch.visualization`` against the root
``visualization.py`` (the JAX package's ``frames_to_video``) on the panels
that the port's train CLI writes: both write a GIF where imageio has no
mp4 encoder, and the port's meets the GIF contract of
``tests/test_torch_gif.py`` against the JAX package's (PIL's frame count,
durations, loop and size; each frame exact where it has at most 256
colours, else within 0.3 dB of PIL's own PSNR).  The defaults follow the
config's name."""

import json
import os
import shutil

import imageio.v2 as imageio
import numpy as np
import pytest
import torch
from PIL import Image

from nerf_keras_tpu.utils.viz import frames_to_video as jax_frames_to_video
from nerf_keras_tpu_torch import visualization
from nerf_keras_tpu_torch.cli import train_synthetic
from nerf_keras_tpu_torch.utils.gif import read_gif, shown_frames
from nerf_keras_tpu_torch.utils.png import decode_png

torch.set_num_threads(1)

TINY = {"BATCH_SIZE": 128, "NS_COARSE": 8, "NS_FINE": 8, "HEIGHT": 16, "WIDTH": 16,
        "L_XYZ": 4, "L_DIR": 2, "NUM_LAYERS": 4, "HIDDEN_DIM": 32, "SKIP_LAYER": 2,
        "EPOCHS": 3, "LEARNING_RATE": 0.005, "BATCH_NORM": False, "WITH_GCS": False,
        "COMPUTE_DTYPE": "float32", "EVAL_EVERY": 1}
SLACK_DB = 0.3


@pytest.fixture(scope="module")
def panels(tmp_path_factory):
    """(config path, panel directory) of a 3-epoch run: one panel an epoch."""
    tmp = tmp_path_factory.mktemp("vis")
    cfg = tmp / "tiny.json"
    cfg.write_text(json.dumps(TINY))
    train_synthetic.main(["--config", str(cfg), "--run-dir", str(tmp / "run"),
                          "--device", "cpu"])
    image_dir = tmp / "run" / "images"
    assert sorted(os.listdir(image_dir)) == ["000.png", "001.png", "002.png"]
    return str(cfg), str(image_dir)


@pytest.fixture
def no_mp4(monkeypatch):
    """Both packages' ``write_video`` without an mp4 encoder."""
    def refuse(*args, **kwargs):
        raise ValueError("no ffmpeg backend")

    monkeypatch.setattr(imageio, "mimwrite", refuse)


def _pil_read(path):
    im = Image.open(path)
    frames, durations = [], []
    for i in range(im.n_frames):
        im.seek(i)
        frames.append(np.asarray(im.convert("RGB")))
        durations.append(im.info.get("duration", 0))
    return frames, durations, im.info.get("loop"), im.size


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return np.inf if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def test_panels_to_a_gif_as_the_jax_visualization(panels, tmp_path, no_mp4, capsys):
    cfg, image_dir = panels
    ours = visualization.main(["--config", cfg, "--image-dir", image_dir,
                               "--out", str(tmp_path / "port.mp4")])
    assert ours == str(tmp_path / "port.gif")
    assert f"video saved to {ours}" in capsys.readouterr().out
    theirs = jax_frames_to_video(image_dir, str(tmp_path / "jax.mp4"), fps=30)
    assert theirs == str(tmp_path / "jax.gif")
    inputs = [decode_png(open(os.path.join(image_dir, n), "rb").read())
              for n in sorted(os.listdir(image_dir))]
    got, d_ours, loop_ours, size_ours = _pil_read(ours)
    want, d_theirs, loop_theirs, size_theirs = _pil_read(theirs)
    assert d_ours == d_theirs and loop_ours == loop_theirs == 0
    assert size_ours == size_theirs == inputs[0].shape[1::-1]
    assert len(got) == len(want) == len(inputs)
    for g, w, f in zip(got, want, inputs):
        if len(np.unique(f.reshape(-1, 3), axis=0)) <= 256:
            np.testing.assert_array_equal(g, f)
        assert _psnr(g, f) >= _psnr(w, f) - SLACK_DB
    decoded, durations, loop = read_gif(ours)
    assert durations == d_ours and loop == 0
    for d, s in zip(decoded, shown_frames(inputs)):
        np.testing.assert_array_equal(d, s)


def test_defaults_follow_the_config_name(panels, tmp_path, monkeypatch, no_mp4, capsys):
    """No ``--image-dir`` or ``--out``: ``images/models/<name>-best`` to
    ``<name>_training.mp4``, so the GIF ``<name>_training.gif``."""
    cfg, image_dir = panels
    monkeypatch.chdir(tmp_path)
    shutil.copytree(image_dir, tmp_path / "images" / "models" / "tiny-best")
    written = visualization.main(["--config", cfg])
    assert written == "tiny_training.gif"
    assert "video saved to tiny_training.gif" in capsys.readouterr().out
    assert len(read_gif(str(tmp_path / written))[0]) == 3


def test_no_panels_raises(tmp_path):
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="no PNG frames"):
        visualization.main(["--config", "config/lego_batch_h256.json", "--image-dir",
                            str(tmp_path / "empty"), "--out", str(tmp_path / "x.mp4")])
