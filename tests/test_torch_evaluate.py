"""The port's evaluation CLI (``cli/evaluate.py``) against the JAX package's.

Both score the same checkpoint on the procedural synthetic scene at 20x20
(3 val views), and a checkpoint ``cli.train_fern`` wrote on an LLFF
capture (``--data llff``: its holdout view, world space and NDC;
``fern_run.py``).  Per-view PSNR within 0.05 dB and SSIM within 1e-3: the
float renders agree to ~1e-6 rgb (``tests/test_torch_render.py``), far
inside both.  With ``--quant int8 --sampler proposal`` the port loads the
``--infer-cache`` the JAX run wrote, so both render with the same int8
tables and the same distilled net (frames 6e-4 apart at most,
``tests/test_torch_infer_cache.py``), and the PSNRs agree to 0.05 dB.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from nerf_keras_tpu.cli.evaluate import run_evaluation as jax_run_evaluation
from nerf_keras_tpu.config import load_config as jax_load_config
from nerf_keras_tpu.engine.step import init_train_state
from nerf_keras_tpu.utils.checkpoint import save_checkpoint
from nerf_keras_tpu_torch.cli.evaluate import run_evaluation

from fern_run import fern_run

torch.set_num_threads(1)


def _write_config(tmp_path, name="tiny", **extra):
    cfg = {"BATCH_SIZE": 64, "NS_COARSE": 8, "NS_FINE": 16, "HEIGHT": 20, "WIDTH": 20,
           "L_XYZ": 6, "L_DIR": 3, "NUM_LAYERS": 4, "HIDDEN_DIM": 64, "SKIP_LAYER": 2,
           "EPOCHS": 1, "LEARNING_RATE": 5e-4, "BATCH_NORM": False, "WITH_GCS": False,
           "COMPUTE_DTYPE": "float32", "USE_PALLAS": False}
    cfg.update(extra)
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def _make_ckpt(tmp_path, cfg_path, run="run"):
    """A JAX checkpoint of a denser field than the init: noise on every
    leaf, the sigma biases at +1."""
    cfg = jax_load_config(cfg_path)
    state = jax.device_get(init_train_state(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(0)

    def bump(path, x):
        x = np.asarray(x) + rng.normal(size=x.shape).astype(np.float32) * 0.05
        return x + 1.0 if jax.tree_util.keystr(path).endswith("['sigma']['b']") else x

    state = state._replace(params=jax.tree_util.tree_map_with_path(bump, state.params))
    run = tmp_path / run
    run.mkdir()
    ckpt = str(run / "tiny.ckpt.npz")
    save_checkpoint(ckpt, state, cfg, scene={"near": 2.0, "far": 6.0, "focal": 24.0})
    return ckpt


def _close(ours, theirs):
    assert set(ours) == set(theirs)
    assert [set(v) for v in ours["views"]] == [set(v) for v in theirs["views"]]
    assert set(ours["mean"]) == set(theirs["mean"]) == {"mse", "psnr", "ssim"}
    assert len(ours["views"]) == len(theirs["views"]) == 3
    for a, b in zip(ours["views"], theirs["views"]):
        assert abs(a["psnr"] - b["psnr"]) <= 0.05
        assert abs(a["ssim"] - b["ssim"]) <= 1e-3
        assert np.isfinite(a["psnr"])


def test_report_matches_jax(tmp_path, capsys):
    cfg_path = _write_config(tmp_path)
    ckpt = _make_ckpt(tmp_path, cfg_path)
    argv = ["--config", cfg_path, "--checkpoint", str(tmp_path / "run"), "--data",
            "synthetic", "--split", "val", "--chunk", "128"]
    default_out = str(tmp_path / "run" / "eval_val.json")
    theirs = jax_run_evaluation(argv + ["--platform", "cpu"])
    assert json.load(open(default_out))["mean"] == theirs["mean"]
    ours = run_evaluation(argv + ["--device", "cpu", "--save-images", str(tmp_path / "img")])
    _close(ours, theirs)
    assert ours["checkpoint"] == theirs["checkpoint"] == ckpt
    assert (ours["split"], ours["quant"], ours["sampler"]) == ("val", "none", "coarse")
    on_disk = json.load(open(default_out))  # the same default path, now the port's
    assert on_disk["mean"] == ours["mean"] and on_disk["views"] == ours["views"]
    assert sorted(os.listdir(tmp_path / "img")) == [
        f"val_{i:03d}_{k}.png" for i in range(3) for k in ("gt", "pred")]
    assert "[nerf-torch] val: psnr=" in capsys.readouterr().out


def test_int8_proposal_on_the_jax_cache(tmp_path, capsys, monkeypatch):
    """The JAX run builds and saves the cache; the port loads it and scores
    the same int8 + proposal renders, without distilling or calibrating."""
    import nerf_keras_tpu_torch.engine.trainer as ptrainer

    cfg_path = _write_config(tmp_path)
    _make_ckpt(tmp_path, cfg_path)
    cache = str(tmp_path / "m.infer.npz")
    argv = ["--config", cfg_path, "--checkpoint", str(tmp_path / "run"), "--chunk", "128",
            "--quant", "int8", "--sampler", "proposal", "--proposal-steps", "20",
            "--infer-cache", cache]
    theirs = jax_run_evaluation(argv + ["--platform", "cpu", "--out", str(tmp_path / "j.json")])
    assert os.path.exists(cache)
    capsys.readouterr()

    def refuse(*args, **kwargs):
        raise AssertionError("the port rebuilt an artifact the cache holds")

    monkeypatch.setattr(ptrainer, "distill_proposal", refuse)
    monkeypatch.setattr(ptrainer, "calibrate_render", refuse)
    ours = run_evaluation(argv + ["--device", "cpu", "--out", str(tmp_path / "p.json")])
    out = capsys.readouterr().out
    assert f"loaded inference artifacts from {cache}" in out
    assert "saved inference artifacts" not in out
    _close(ours, theirs)
    assert (ours["quant"], ours["sampler"]) == ("int8", "proposal")
    # The int8 + proposal scores are their own, not the float ones.
    flt = run_evaluation(argv[:6] + ["--device", "cpu", "--out", str(tmp_path / "f.json")])
    assert flt["views"][0]["psnr"] != ours["views"][0]["psnr"]


def test_unported_inputs_raise_before_any_work(tmp_path, monkeypatch):
    import nerf_keras_tpu_torch.cli.evaluate as pev

    cfg_path = _write_config(tmp_path)
    ckpt = _make_ckpt(tmp_path, cfg_path)

    def no_trainer(*args, **kwargs):
        raise AssertionError("work started")

    monkeypatch.setattr(pev, "Trainer", no_trainer)
    # An LLFF capture without frames: minify makes an empty images_8/ and the
    # loader raises the JAX package's count error; and a remote root.
    from nerf_keras_tpu.data.llff import load_llff_data as jax_load_llff

    capture = tmp_path / "capture"
    (capture / "images").mkdir(parents=True)
    np.save(capture / "poses_bounds.npy", np.zeros((3, 17)))
    with pytest.raises(ValueError, match="0 images in .*images_8 but 3 poses") as e:
        run_evaluation(["--config", cfg_path, "--checkpoint", ckpt, "--data", "llff",
                        "--data-dir", str(capture), "--device", "cpu"])
    with pytest.raises(ValueError) as want:
        jax_load_llff(str(capture))
    assert str(e.value) == str(want.value)
    with pytest.raises(NotImplementedError, match="remote storage"):
        run_evaluation(["--config", cfg_path, "--checkpoint", ckpt, "--data", "llff",
                        "--data-dir", "gs://dataset-nerf/nerf_llff_data/fern",
                        "--device", "cpu"])
    with pytest.raises(SystemExit):
        run_evaluation(["--config", cfg_path, "--checkpoint", ckpt, "--split", "test",
                        "--device", "cpu"])


@pytest.mark.parametrize("ndc", [False, True])
def test_llff_report_matches_jax(tmp_path, monkeypatch, ndc):
    """``--data llff`` on a checkpoint ``cli.train_fern`` wrote (world space,
    and NDC with the anneal window still open): the holdout view's report
    within 0.05 dB of the JAX CLI's.  With ``--quant int8`` the tables are
    calibrated on train views in the checkpoint's ray space (NDC there),
    never on the scored view."""
    from nerf_keras_tpu.data import pipeline as jpipe
    from nerf_keras_tpu.data.llff import prepare_fern_data as jax_prepare_fern
    from nerf_keras_tpu_torch.engine.trainer import Trainer

    capture, cfg_path, run = fern_run(ndc)
    argv = ["--config", cfg_path, "--checkpoint", run, "--data", "llff", "--data-dir",
            capture]
    theirs = jax_run_evaluation(argv + ["--platform", "cpu", "--out", str(tmp_path / "j.json")])
    ours = run_evaluation(argv + ["--device", "cpu", "--out", str(tmp_path / "p.json")])
    assert len(ours["views"]) == len(theirs["views"]) == 1
    for k in ("psnr", "ssim"):
        assert abs(ours["mean"][k] - theirs["mean"][k]) <= (0.05 if k == "psnr" else 1e-3)
    assert ours["mean"]["psnr"] > 10.0

    seen = {}
    real = Trainer.quantize_for_inference

    def record(self, origins, directions, **kw):
        seen["rays"] = (np.asarray(origins), np.asarray(directions))
        return real(self, origins, directions, **kw)

    monkeypatch.setattr(Trainer, "quantize_for_inference", record)
    q = run_evaluation(argv + ["--device", "cpu", "--quant", "int8", "--out",
                               str(tmp_path / "q.json")])
    train, _, _, _ = jax_prepare_fern(12, 16, basedir=capture)
    if ndc:
        train = jpipe.dataset_to_ndc(train)
    np.testing.assert_allclose(seen["rays"][0], train.origins, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(seen["rays"][1], train.directions, rtol=1e-6, atol=1e-6)
    assert abs(q["mean"]["psnr"] - ours["mean"]["psnr"]) < 1.0


def test_no_silent_cpu(tmp_path, monkeypatch):
    """Without ``--device`` the CLI asks for the card; with none it raises
    instead of running on the CPU."""
    cfg_path = _write_config(tmp_path)
    ckpt = _make_ckpt(tmp_path, cfg_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_evaluation(["--config", cfg_path, "--checkpoint", ckpt])
