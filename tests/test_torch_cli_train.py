"""The port's training CLI (``nerf_keras_tpu_torch/cli/train.py``) against
the JAX CLI.

* The resolved config: the JAX ``run_training`` is run with a stub
  ``Trainer`` that records the config it is given and stops the program
  there (no step runs), and held to the port's for the auto LR decay,
  ``PROP_ANNEAL_STEPS=-1``, epoch-unit horizons and the 80-epoch pin with
  and without ``--no-pin-schedules``; the helper functions directly.
* Tiny runs of the port's ``run_training`` on ``--device cpu`` (16x16
  frames, 4x32 MLPs, float32): files, the history schema (JAX's keys),
  resume (step, history, batch order), ``best.*`` only on improvement,
  the emergency checkpoint, the SIGTERM flag, the batches reaching
  ``train_step`` (the JAX pipeline's, numpy and native batcher), and no
  silent CPU without ``--device cpu``.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from nerf_keras_tpu.cli import train as jcli
from nerf_keras_tpu.config import load_config as jax_load_config
from nerf_keras_tpu.data import pipeline as jpipe
from nerf_keras_tpu.utils.metrics import History as JaxHistory
from nerf_keras_tpu_torch.cli import train as pcli
from nerf_keras_tpu_torch.cli import train_synthetic
from nerf_keras_tpu_torch.config import load_config
from nerf_keras_tpu_torch.data import native
from nerf_keras_tpu_torch.data import pipeline as ppipe
from nerf_keras_tpu_torch.engine.trainer import Trainer
from nerf_keras_tpu_torch.utils.checkpoint import load_checkpoint
from nerf_keras_tpu_torch.utils.metrics import History

torch.set_num_threads(1)

TINY = {"BATCH_SIZE": 128, "NS_COARSE": 8, "NS_FINE": 8, "HEIGHT": 16, "WIDTH": 16,
        "L_XYZ": 4, "L_DIR": 2, "NUM_LAYERS": 4, "HIDDEN_DIM": 32, "SKIP_LAYER": 2,
        "EPOCHS": 2, "LEARNING_RATE": 0.005, "BATCH_NORM": False, "WITH_GCS": False,
        "COMPUTE_DTYPE": "float32", "EVAL_EVERY": 1}
# 12 views of 16x16, 9 for training: 2,304 rays, 18 steps of 128.
STEPS = 18


def _config(tmp_path, name="tiny", **kw):
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps({**TINY, **kw}))
    return str(path)


def _run(tmp_path, *extra, config=None):
    argv = ["--config", config or _config(tmp_path), "--run-dir", str(tmp_path / "run"),
            "--device", "cpu", *extra]
    return train_synthetic.main(argv)


class _Stop(Exception):
    pass


def _resolved(module, monkeypatch, config, argv, rays=1000):
    """The config ``module.run_training`` hands its Trainer, for a stub
    dataset of ``rays`` rays."""
    seen = {}

    def stub_trainer(cfg, near, far, *args, **kwargs):
        seen["cfg"] = cfg
        raise _Stop

    pipe = jpipe if module is jcli else ppipe

    def prepare(h, w, data_dir=None):
        arrays = [np.zeros((rays, 3), np.float32)] * 3
        ds = pipe.RayDataset(*arrays, near=2.0, far=6.0, focal=10.0, height=10, width=10)
        return ds, ds, (2.0, 6.0), 10.0

    monkeypatch.setattr(module, "Trainer", stub_trainer)
    extra = ["--device", "cpu"] if module is pcli else []
    with pytest.raises(_Stop):
        module.run_training(prepare, config, 5, argv=["--config", config, "--run-dir", "x",
                                                      *extra, *argv])
    return dataclasses.asdict(seen["cfg"])


HORIZONS = {
    "lr_decay_auto": (dict(LR_FINAL=5e-5, EPOCHS=10), []),
    "prop_anneal_auto": (dict(TRAIN_SAMPLER="proposal", PROP_ANNEAL_STEPS=-1, EPOCHS=10), []),
    "epoch_units": (dict(TRAIN_SAMPLER="proposal", PROP_LEVELS=2, LR_FINAL=5e-5,
                         LR_DECAY_EPOCHS=7, PROP_ANNEAL_EPOCHS=3, EPOCHS=200), []),
    "freq_anneal_auto": (dict(FREQ_ANNEAL_STEPS=-1, EPOCHS=4), []),
    "pinned_at_80": (dict(TRAIN_SAMPLER="proposal", PROP_ANNEAL_STEPS=-1, LR_FINAL=5e-5,
                          EPOCHS=200), []),
    "not_pinned": (dict(TRAIN_SAMPLER="proposal", PROP_ANNEAL_STEPS=-1, LR_FINAL=5e-5,
                        EPOCHS=200), ["--no-pin-schedules"]),
}


@pytest.mark.parametrize("case", sorted(HORIZONS))
def test_resolved_horizons_match_the_jax_cli(case, tmp_path, monkeypatch):
    keys, argv = HORIZONS[case]
    config = _config(tmp_path, **keys)
    want = _resolved(jcli, monkeypatch, config, argv)
    got = _resolved(pcli, monkeypatch, config, argv)
    assert got == want
    steps = 1000 // 128
    horizon = 200 if case == "not_pinned" else min(want["epochs"], 80)
    if case in ("pinned_at_80", "not_pinned", "lr_decay_auto"):
        assert got["lr_decay_steps"] == horizon * steps
    if case == "epoch_units":
        assert (got["lr_decay_steps"], got["prop_anneal_steps"]) == (7 * steps, 3 * steps)
    assert got["prop_anneal_steps"] >= 0 and got["freq_anneal_steps"] >= 0


def test_helpers_match_the_jax_cli(tmp_path):
    cfg_path = _config(tmp_path, EVAL_EVERY=3)
    cfg, jcfg = load_config(cfg_path), jax_load_config(cfg_path)
    for cli_value, default in ((None, 5), (2, 5), (None, 1)):
        assert pcli.resolve_eval_every(cli_value, cfg, default) == jcli.resolve_eval_every(
            cli_value, jcfg, default)
    for test_bs, n_val in ((4096, 30000), (4096, 625), (128, 1200), (7, 3)):
        assert pcli.resolve_eval_batch(test_bs, n_val) == jcli.resolve_eval_batch(
            test_bs, n_val, 1, 1)
    chain = dataclasses.replace(cfg, train_sampler="proposal", prop_levels=2, epochs=80)
    jchain = dataclasses.replace(jcfg, train_sampler="proposal", prop_levels=2, epochs=80)
    assert pcli.warn_chain_horizon(chain) is jcli.warn_chain_horizon(jchain) is True
    assert pcli.warn_chain_horizon(cfg) is jcli.warn_chain_horizon(jcfg) is False
    assert pcli.resolve_run_dirs(cfg, "n", "r") == jcli.resolve_run_dirs(jcfg, "n", "r")
    local, jlocal = pcli.resolve_run_dirs(cfg, "n", None), jcli.resolve_run_dirs(jcfg, "n", None)
    assert [p.rsplit("-", 2)[0] for p in local] == [p.rsplit("-", 2)[0] for p in jlocal]


def test_with_gcs_needs_run_dir_before_any_work(tmp_path):
    def prepare(*args, **kwargs):
        raise AssertionError("data prepared before the run dir was resolved")

    config = _config(tmp_path, WITH_GCS=True)
    with pytest.raises(NotImplementedError, match="--run-dir"):
        pcli.run_training(prepare, config, 5, argv=["--config", config, "--device", "cpu"])


def test_no_silent_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--config", _config(tmp_path), "--run-dir", str(tmp_path / "run")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_synthetic.main(argv)
    assert not (tmp_path / "run").exists()


@pytest.mark.parametrize("batcher", ["native", "numpy"])
def test_tiny_run_resume_and_files(tmp_path, monkeypatch, capsys, batcher):
    if batcher == "numpy":
        def no_toolchain(*args, **kwargs):
            raise RuntimeError("no g++")

        monkeypatch.setattr(native, "NativeRayBatcher", no_toolchain)
    tr = _run(tmp_path)
    out = capsys.readouterr().out
    assert ("using numpy" in out) == (batcher == "numpy")
    assert tr.step == 2 * STEPS
    run = tmp_path / "run"
    ckpt = run / "nerf_l4_d32_n16_ep2.ckpt.npz"
    names = sorted(os.listdir(run))
    assert names == sorted([ckpt.name, ckpt.name + ".config.json", "best." + ckpt.name,
                            "best." + ckpt.name + ".config.json", "images",
                            "history_l4_d32_n16_ep2.json"])
    assert sorted(os.listdir(run / "images")) == ["000.png", "001.png"]
    raw = json.loads((run / "history_l4_d32_n16_ep2.json").read_text())
    reference = JaxHistory()
    reference.append({"loss": 1, "loss_coarse": 1, "psnr": 1},
                     {"loss": 1, "psnr": 1, "ssim": 1})
    assert sorted(raw) == sorted(reference.to_dict())
    assert len(raw["losses"]) == 2 and len(raw["val_ssims"]) == 2
    assert JaxHistory.load(str(run / "history_l4_d32_n16_ep2.json")).to_dict() == raw
    assert raw["val_psnrs"][1] > raw["val_psnrs"][0]  # it learns
    assert load_checkpoint(str(ckpt))["step"] == 2 * STEPS

    tr = _run(tmp_path, "--resume", str(ckpt), "--epochs", "3")
    out = capsys.readouterr().out
    assert f"resumed from {ckpt} at step {2 * STEPS}" in out
    assert "continuing history from history_l4_d32_n16_ep2.json (2 epochs recorded)" in out
    assert tr.step == 3 * STEPS and tr.state.opt.count == 3 * STEPS
    resumed = History.load(str(run / "history_l4_d32_n16_ep3.json"))
    assert len(resumed.losses) == 3 and resumed.losses[:2] == raw["losses"]


def test_best_is_written_only_on_improvement(tmp_path, monkeypatch):
    psnrs = iter([12.0, 11.0, 13.0])
    monkeypatch.setattr(Trainer, "evaluate", lambda self, batches: {
        "loss": 0.1, "loss_coarse": 0.1, "psnr": next(psnrs)})
    saved = []
    real_save = pcli.save_checkpoint
    monkeypatch.setattr(pcli, "save_checkpoint", lambda path, state, *a, **k: (
        saved.append((os.path.basename(path), state.step)), real_save(path, state, *a, **k)))
    _run(tmp_path, "--epochs", "3")
    latest, best = "nerf_l4_d32_n16_ep3.ckpt.npz", "best.nerf_l4_d32_n16_ep3.ckpt.npz"
    assert saved == [(latest, STEPS), (best, STEPS), (latest, 2 * STEPS),
                     (latest, 3 * STEPS), (best, 3 * STEPS)]
    assert load_checkpoint(str(tmp_path / "run" / best))["step"] == 3 * STEPS


def test_non_finite_loss_saves_an_emergency_checkpoint(tmp_path, monkeypatch):
    real = Trainer.train_epoch

    def poisoned(self, batches, log_every=0):
        metrics = real(self, batches, log_every)
        return {**metrics, "loss": float("nan")}

    monkeypatch.setattr(Trainer, "train_epoch", poisoned)
    with pytest.raises(FloatingPointError, match="non-finite train loss"):
        _run(tmp_path)
    path = tmp_path / "run" / "emergency.nerf_l4_d32_n16_ep2.ckpt.npz"
    assert load_checkpoint(str(path))["step"] == STEPS


def test_sigterm_flag_checkpoints_and_exits_cleanly(tmp_path, monkeypatch):
    """The CLI's SIGTERM handler (recorded through a stand-in for
    ``signal.signal``) is called during epoch 1 of 3: the run checkpoints
    at that epoch boundary, returns, and puts the old handler back."""
    installed = []

    class FakeSignal:
        SIGTERM = 15

        @staticmethod
        def signal(signum, handler):
            installed.append(handler)
            return "previous"

    monkeypatch.setattr(pcli, "signal", FakeSignal)
    real = Trainer.train_epoch

    def interrupted(self, batches, log_every=0):
        metrics = real(self, batches, log_every)
        installed[0](15, None)
        return metrics

    monkeypatch.setattr(Trainer, "train_epoch", interrupted)
    tr = _run(tmp_path, "--epochs", "3", "--eval-every", "2")
    assert tr.step == STEPS
    assert installed[-1] == "previous" and len(installed) == 2
    ckpt = tmp_path / "run" / "nerf_l4_d32_n16_ep3.ckpt.npz"
    assert load_checkpoint(str(ckpt))["step"] == STEPS


@pytest.mark.parametrize("batcher", ["native", "numpy"])
def test_batches_reaching_train_step_are_the_jax_pipeline(tmp_path, monkeypatch, batcher):
    if batcher == "numpy":
        monkeypatch.setattr(native, "NativeRayBatcher", lambda *a, **k: (_ for _ in ()).throw(
            RuntimeError("no g++")))
    seen = []

    def record(self, batch, draws=None):
        seen.append(tuple(np.array(x) for x in batch))
        self.step += 1
        z = torch.zeros(())
        return {"loss_coarse": z, "loss": z + 0.1, "psnr": z + 10.0}

    monkeypatch.setattr(Trainer, "train_step", record)
    _run(tmp_path, "--eval-every", "5")
    train, _, _, _ = train_synthetic.prepare(16, 16)
    jds = jpipe.RayDataset(train.pixels, train.origins, train.directions, near=2.0, far=6.0,
                           focal=train.focal, height=16, width=16)
    want = [b for epoch in range(2)
            for b in jpipe.iterate_batches(jds, 128, shuffle=True, seed=42, epoch=epoch)]
    assert len(seen) == len(want) == 2 * STEPS
    for got, ref in zip(seen, want):
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)


# An LLFF capture at 12x16 (5 views: 4 train, the holdout val), a 4x16 MLP.
FERN = {**TINY, "HEIGHT": 12, "WIDTH": 16, "BATCH_SIZE": 64, "HIDDEN_DIM": 16,
        "NS_FINE": 16}


@pytest.mark.parametrize("ndc", [False, True])
def test_train_fern_end_to_end(tmp_path, capsys, monkeypatch, ndc):
    """``cli.train_fern`` on a capture it has not seen before, world space
    and NDC (with the frequency anneal open through the run): the rays the
    steps train on are the JAX loader's (through the JAX ``dataset_to_ndc``
    for NDC), the printed bounds, the sidecar's ``SCENE``, a falling loss."""
    from nerf_keras_tpu.data.llff import prepare_fern_data as jax_prepare_fern
    from nerf_keras_tpu_torch.cli import train_fern
    from nerf_keras_tpu_torch.data.synthetic import write_forward_facing_capture
    from nerf_keras_tpu_torch.utils.checkpoint import load_checkpoint_scene

    capture = write_forward_facing_capture(str(tmp_path / "cap"), 5, 12, 16, 15.0)
    config = _config(tmp_path, **FERN, **({"NDC": True, "FREQ_ANNEAL_STEPS": 40} if ndc
                                         else {}))
    seen = []
    real_step = Trainer.train_step

    def record(self, batch, draws=None):
        seen.append(tuple(np.array(x) for x in batch))
        return real_step(self, batch, draws)

    monkeypatch.setattr(Trainer, "train_step", record)
    tr = train_fern.main(["--config", config, "--data-dir", capture, "--run-dir",
                          str(tmp_path / "run"), "--device", "cpu"])
    out = capsys.readouterr().out
    bounds = "near=0.000 far=1.000" if ndc else "near=1.200 far=3.111"
    assert f"rays: train=768 val=192 {bounds} focal=15.00" in out
    train, _, bounds, _ = jax_prepare_fern(12, 16, basedir=capture)
    bounds = (0.0, 1.0) if ndc else bounds
    assert tr.step == 2 * 12 and (tr.near, tr.far) == bounds
    if ndc:
        train = jpipe.dataset_to_ndc(train)
    want = [b for epoch in range(2)
            for b in jpipe.iterate_batches(train, 64, shuffle=True, seed=42, epoch=epoch)]
    assert len(seen) == len(want)
    for got, ref in zip(seen, want):
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-6)

    ckpt = str(tmp_path / "run" / "nerf_l4_d16_n24_ep2.ckpt.npz")
    scene = load_checkpoint_scene(ckpt)
    assert scene["ndc"] is ndc and scene["focal"] == 15.0
    assert (scene["near"], scene["far"]) == bounds
    history = History.load(str(tmp_path / "run" / "history_l4_d16_n24_ep2.json"))
    assert np.isfinite(history.losses).all() and history.losses[1] < history.losses[0]
