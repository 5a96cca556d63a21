"""The port's inference CLI (``cli/infer.py``): the JAX package's orbit,
both accelerations' gates (pass and fail, with the frames of the path
that was decided), the artifact cache, the profiler trace, and what
raises or exits.  Where imageio has no ffmpeg backend (or is missing) the
frames land in the PNG directory that ``write_video`` falls back to; the
tests read either."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from nerf_keras_tpu.cli.infer import spherical_poses as jax_spherical_poses
from nerf_keras_tpu.config import load_config as jax_load_config
from nerf_keras_tpu.engine.step import init_train_state
from nerf_keras_tpu.utils.checkpoint import save_checkpoint
from nerf_keras_tpu_torch.cli.infer import run_inference, spherical_poses
from nerf_keras_tpu_torch.config import load_config
from nerf_keras_tpu_torch.engine.trainer import Trainer
from nerf_keras_tpu_torch.utils.png import decode_png

from fern_run import fern_run

torch.set_num_threads(1)

FOCAL = 24.0


def _has_ffmpeg() -> bool:
    try:
        import imageio_ffmpeg  # noqa: F401
    except ImportError:
        return False
    return True


@pytest.fixture
def ckpt(tmp_path):
    cfg = {"BATCH_SIZE": 64, "NS_COARSE": 8, "NS_FINE": 16, "HEIGHT": 20, "WIDTH": 20,
           "L_XYZ": 6, "L_DIR": 3, "NUM_LAYERS": 4, "HIDDEN_DIM": 64, "SKIP_LAYER": 2,
           "EPOCHS": 1, "LEARNING_RATE": 5e-4, "BATCH_NORM": False, "WITH_GCS": False,
           "COMPUTE_DTYPE": "float32"}
    cfg_path = tmp_path / "tiny.json"
    cfg_path.write_text(json.dumps(cfg))
    jcfg = jax_load_config(str(cfg_path))
    state = jax.device_get(init_train_state(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(0)

    def bump(path, x):
        x = np.asarray(x) + rng.normal(size=x.shape).astype(np.float32) * 0.05
        return x + 1.0 if jax.tree_util.keystr(path).endswith("['sigma']['b']") else x

    state = state._replace(params=jax.tree_util.tree_map_with_path(bump, state.params))
    path = str(tmp_path / "tiny.ckpt.npz")
    save_checkpoint(path, state, jcfg, scene={"near": 2.0, "far": 6.0, "focal": FOCAL})
    return str(cfg_path), path


def _frames(written: str, n: int) -> list[np.ndarray]:
    """The frames a run wrote: the mp4, or the PNG directory."""
    if written.endswith(".mp4"):
        import imageio.v2 as imageio

        return [np.asarray(f) for f in imageio.mimread(written)]
    names = sorted(os.listdir(written))
    assert names == [f"{i:03d}.png" for i in range(n)]
    return [decode_png(open(os.path.join(written, f), "rb").read()) for f in names]


def _render(cfg_path, ckpt, cache, pose, **kw):
    """A frame from a fresh port Trainer on the checkpoint (and cache), as
    the CLI renders it."""
    cfg = load_config(cfg_path)
    tr = Trainer(cfg, 2.0, 6.0, device="cpu").restore(ckpt)
    if cache:
        tr.load_inference_artifacts(cache)
    return tr.render_image(pose, 20, 20, FOCAL, uint8_rgb=True, **kw)["rgb"]


@pytest.mark.parametrize("full_orbit", [False, True])
def test_spherical_poses_match_jax(full_orbit):
    ours = spherical_poses(7, full_orbit=full_orbit, phi=-20.0, radius=3.5)
    theirs = jax_spherical_poses(7, full_orbit=full_orbit, phi=-20.0, radius=3.5)
    assert len(ours) == len(theirs) == 7
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-6, rtol=0)


def test_three_frames_and_depth(ckpt, tmp_path, capsys):
    cfg_path, path = ckpt
    out = str(tmp_path / "vid.mp4")
    written = run_inference(["--config", cfg_path, "--checkpoint", path, "--frames", "3",
                             "--chunk", "128", "--out", out, "--depth-video",
                             "--device", "cpu"])
    assert written == (out if _has_ffmpeg() else str(tmp_path / "vid_frames"))
    frames = _frames(written, 3)
    depth = _frames(str(tmp_path / ("vid_depth.mp4" if _has_ffmpeg() else
                                    "vid_depth_frames")), 3)
    assert all(f.shape == (20, 20, 3) for f in frames) and len(depth) == 3
    poses = spherical_poses(3)
    np.testing.assert_array_equal(frames[1], _render(cfg_path, path, None, poses[1]))
    assert not np.array_equal(frames[0], frames[1])
    text = capsys.readouterr().out
    assert "frame 3/3 (" in text and "video saved to" in text


def test_default_name_and_sample_overrides(ckpt, tmp_path, monkeypatch):
    """``<config>_rgb_video_gpu.mp4`` in the working directory; ``--ns-fine
    0`` (coarse only) is a valid override."""
    cfg_path, path = ckpt
    monkeypatch.chdir(tmp_path)
    written = run_inference(["--config", cfg_path, "--checkpoint", path, "--frames", "1",
                             "--ns-coarse", "6", "--ns-fine", "0", "--device", "cpu"])
    stem = "tiny_rgb_video_gpu"
    assert os.path.abspath(written) == str(tmp_path / (stem + ".mp4" if _has_ffmpeg()
                                                       else stem + "_frames"))
    assert _frames(written, 1)[0].shape == (20, 20, 3)


@pytest.mark.parametrize("gate_db", [0.0, 1000.0])
def test_gates_decide_the_frames(ckpt, tmp_path, capsys, gate_db):
    """Both gates at 0 dB pass (int8 + proposal frames), at 1000 dB both
    fail (float, coarse-sampled frames), with the JAX package's lines."""
    cfg_path, path = ckpt
    cache = str(tmp_path / "m.infer.npz")
    written = run_inference([
        "--config", cfg_path, "--checkpoint", path, "--frames", "2", "--chunk", "128",
        "--out", str(tmp_path / "g.mp4"), "--device", "cpu", "--quant", "int8",
        "--quant-gate-db", str(gate_db), "--sampler", "proposal", "--sampler-gate-db",
        str(gate_db), "--proposal-steps", "10", "--infer-cache", cache])
    text = capsys.readouterr().out
    passed = gate_db == 0.0
    if passed:
        assert "int8 gate PASS" in text and "proposal gate PASS" in text
        kw = dict(quant=True, sampler="proposal")
    else:
        assert "int8 gate FAIL" in text and "falling back to the float path" in text
        assert "proposal gate FAIL" in text and "falling back to the coarse sampler" in text
        kw = {}
    assert f"saved inference artifacts to {cache}" in text
    frames = _frames(written, 2)
    pose = spherical_poses(2)[1]
    np.testing.assert_array_equal(frames[1], _render(cfg_path, path, cache, pose, **kw))
    other = _render(cfg_path, path, cache, pose,
                    **({} if passed else dict(quant=True, sampler="proposal")))
    assert not np.array_equal(frames[1], other)


def test_infer_cache_second_run_loads(ckpt, tmp_path, capsys, monkeypatch):
    import nerf_keras_tpu_torch.engine.trainer as ptrainer

    cfg_path, path = ckpt
    cache = str(tmp_path / "m.infer.npz")
    argv = ["--config", cfg_path, "--checkpoint", path, "--frames", "1", "--chunk", "128",
            "--device", "cpu", "--sampler", "proposal", "--sampler-gate-db", "0",
            "--proposal-steps", "10", "--infer-cache", cache]
    first = run_inference(argv + ["--out", str(tmp_path / "a.mp4")])
    assert f"saved inference artifacts to {cache}" in capsys.readouterr().out

    def refuse(*args, **kwargs):
        raise AssertionError("distilled again")

    monkeypatch.setattr(ptrainer, "distill_proposal", refuse)
    second = run_inference(argv + ["--out", str(tmp_path / "b.mp4")])
    text = capsys.readouterr().out
    assert f"loaded inference artifacts from {cache}" in text
    assert "saved inference artifacts" not in text
    np.testing.assert_array_equal(_frames(second, 1)[0], _frames(first, 1)[0])


def test_profile_writes_a_trace(ckpt, tmp_path):
    cfg_path, path = ckpt
    trace_dir = tmp_path / "trace"
    written = run_inference(["--config", cfg_path, "--checkpoint", path, "--frames", "2",
                             "--chunk", "128", "--out", str(tmp_path / "p.mp4"),
                             "--profile", str(trace_dir), "--device", "cpu"])
    assert len(_frames(written, 2)) == 2
    with open(trace_dir / "trace.json") as f:
        assert json.load(f)["traceEvents"]


def test_unported_paths_raise(ckpt, tmp_path, monkeypatch):
    cfg_path, path = ckpt
    # The spiral is the capture's own path: without a capture, the JAX
    # CLI's exit.
    with pytest.raises(SystemExit, match="--path spiral requires --data-dir"):
        run_inference(["--config", cfg_path, "--checkpoint", path, "--path", "spiral",
                       "--device", "cpu"])
    # Beside a checkpoint, --reference-weights is the JAX CLI's exit
    # (its renders: tests/test_torch_keras.py).
    with pytest.raises(SystemExit, match="exactly one of"):
        run_inference(["--config", cfg_path, "--checkpoint", path, "--reference-weights",
                       "ref.weights.h5", "--device", "cpu"])
    with pytest.raises(ValueError, match="ns_fine"):
        run_inference(["--config", cfg_path, "--checkpoint", path, "--frames", "1",
                       "--ns-fine", "0", "--sampler", "proposal", "--device", "cpu",
                       "--out", str(tmp_path / "x.mp4")])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_inference(["--config", cfg_path, "--checkpoint", path])


@pytest.mark.parametrize("spherify", [False, True])
def test_spiral_poses_from_capture_match_jax(tmp_path, spherify):
    from nerf_keras_tpu.cli.infer import spiral_poses_from_capture as jax_spiral
    from nerf_keras_tpu_torch.cli.infer import spiral_poses_from_capture
    from nerf_keras_tpu_torch.data.synthetic import write_forward_facing_capture

    capture = write_forward_facing_capture(str(tmp_path / "cap"), 5, 12, 16, 15.0)
    ours = spiral_poses_from_capture(capture, 7, spherify=spherify)
    theirs = jax_spiral(capture, 7, spherify=spherify)
    assert len(ours) == len(theirs) == 7
    for a, b in zip(ours, theirs):
        assert a.shape == (3, 4)
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)


def test_spiral_frames_match_the_jax_cli(tmp_path, monkeypatch):
    """``--path spiral`` on an NDC checkpoint that ``cli.train_fern`` wrote
    with its frequency-anneal window open, float and ``--quant int8``:
    every frame within rgb 5e-3 (one uint8 level) of the JAX CLI's; the
    orbit raises the forward-facing ``ValueError`` on the same
    checkpoint."""
    import nerf_keras_tpu.cli.infer as jinfer

    capture, cfg_path, run = fern_run(ndc=True)
    captured = {}
    monkeypatch.setattr(jinfer, "write_video",
                        lambda path, frames, fps: captured.setdefault(path, frames) and path)
    base = ["--config", cfg_path, "--checkpoint", run, "--path", "spiral",
            "--data-dir", capture, "--frames", "3", "--chunk", "64"]
    for extra in ([], ["--quant", "int8", "--quant-gate-db", "0"]):
        out = str(tmp_path / f"{len(extra)}.mp4")
        jinfer.run_inference(base + extra + ["--out", out, "--platform", "cpu"])
        written = run_inference(base + extra + ["--out", out, "--device", "cpu"])
        ours, theirs = _frames(written, 3), captured[out]
        assert len(theirs) == 3
        for a, b in zip(ours, theirs):
            assert a.shape == (12, 16, 3)
            assert np.abs(a.astype(np.int16) - np.asarray(b, np.int16)).max() <= 1
        assert ours[0].std() > 1.0
    with pytest.raises(ValueError, match="forward-facing camera"):
        run_inference(["--config", cfg_path, "--checkpoint", run, "--frames", "1",
                       "--phi", "0", "--out", str(tmp_path / "o.mp4"), "--device", "cpu"])
