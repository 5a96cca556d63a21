"""The union-free proposal layout (``PROP_UNION=false``, with
``PROP_AUX_SAMPLES`` and ``PROP_UNION_EVERY``) in the port against the JAX
package, beyond the train-step replays of ``tests/test_torch_train.py``.

The JAX side runs its XLA path (``USE_PALLAS=false``), float32, at tiny
widths (4x32 MLPs, 8 + 12 samples, a few dozen rays), from the same
JAX-initialized weights with random biases; its draws are replayed into
the port by copying its key schedule (``tests/test_torch_train.py``).

Tolerances, the files' own: eval metrics and train-step metrics rtol 5e-4,
gradients per leaf rtol 5e-4 and atol 5e-4 x the leaf's largest entry
(``tests/test_torch_train.py``); the float render rgb 1e-4, depth 1e-3,
the placed t and the weights 1e-4 (``test_proposal_render_matches_jax``);
int8 calibration stats rtol 1e-3 and frames ``ATOL_SAME_Q``/``ATOL_OWN_Q``
(``tests/test_torch_quant.py``); CLI reports 0.05 dB PSNR
(``tests/test_torch_evaluate.py``); served PNGs +-2 levels
(``tests/test_torch_serving.py``); two gloo ranks against one process 1e-5
(``tests/test_torch_parallel.py``).
"""

import dataclasses
import json
import os
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerf_keras_tpu.cli.evaluate import run_evaluation as jax_run_evaluation
from nerf_keras_tpu.config import NeRFConfig
from nerf_keras_tpu.config import load_config as jax_load_config
from nerf_keras_tpu.engine import step as jstep
from nerf_keras_tpu.engine.trainer import Trainer as JaxTrainer
from nerf_keras_tpu.ops import quant as jq
from nerf_keras_tpu.ops.rays import pose_spherical
from nerf_keras_tpu.serving import RenderService as JaxRenderService
from nerf_keras_tpu.utils.checkpoint import save_checkpoint
from nerf_keras_tpu_torch.cli import train_synthetic
from nerf_keras_tpu_torch.cli.evaluate import run_evaluation
from nerf_keras_tpu_torch.cli.infer import run_inference
from nerf_keras_tpu_torch.engine import step as pstep
from nerf_keras_tpu_torch.engine.trainer import Trainer
from nerf_keras_tpu_torch.ops import quant as pq
from nerf_keras_tpu_torch.parallel.audit import run_two_process_smoke
from nerf_keras_tpu_torch.profile_train import bench_batch
from nerf_keras_tpu_torch.serving import RenderService, serve
from nerf_keras_tpu_torch.utils.png import decode_png

from torch_videos import capture_videos, video_frames

torch.set_num_threads(1)

NEAR, FAR = 2.0, 6.0
TOL = 5e-4
ATOL_SAME_Q = {"rgb_fine": 1e-3, "depth_fine": 5e-3}
ATOL_OWN_Q = {"rgb_fine": 5e-3, "depth_fine": 1e-2}
POSE = pose_spherical(30.0, -30.0, 4.0)
FOCAL = 9.6


def _cfg(levels=1, **kw):
    base = dict(
        batch_size=24, ns_coarse=8, ns_fine=12, num_layers=4, hidden_dim=32,
        skip_layer=2, l_xyz=4, l_dir=2, compute_dtype="float32", use_pallas=False,
        train_sampler="proposal", prop_union=False, prop_explore=0.1,
        distortion_loss_mult=1e-4, prop_anneal_steps=10, ema_decay=0.9,
        learning_rate=5e-3, height=8, width=8,
    )
    if levels == 2:
        base.update(prop_levels=2, prop_samples=6)
    base.update(kw)
    return NeRFConfig(**base).validate()


def _batch(seed, b):
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 1, (b, 3)).astype(np.float32)
    dirs = rng.normal(size=(b, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    origins = (np.tile([0, 0, 4.0], (b, 1)) + rng.normal(size=(b, 3)) * 0.1).astype(np.float32)
    return images, origins, dirs


def _jax_state(cfg, step, sigma_bias=0.0):
    """JAX-initialized params with random biases at ``step`` (the fine
    sigma bias raised by ``sigma_bias``: a denser field)."""
    st = jstep.init_train_state(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(3)

    def bias(path, x):
        x = np.asarray(x, np.float32)
        if x.ndim == 1:
            x = x + (rng.normal(size=x.shape) * 0.1).astype(np.float32)
            if jax.tree_util.keystr(path).endswith("['sigma']['b']"):
                x = x + np.float32(sigma_bias)
        return jnp.asarray(x)

    params = jax.tree_util.tree_map_with_path(bias, st.params)
    ema = None if st.ema is None else jax.tree_util.tree_map(jnp.array, params)
    return st._replace(params=params, ema=ema, step=jnp.asarray(step, jnp.int32))


def _port(cfg, st):
    tr = Trainer(cfg, NEAR, FAR, device="cpu")
    tr.replace_params(jax.tree_util.tree_map(np.asarray, st.params))
    tr.step = int(st.step)
    return tr


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _grab_grads():
    """An optax transform whose state after ``update`` is the gradients."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g),
    )


def _draws(cfg, key, step, b):
    """The JAX step's uniforms at ``step``: t, then (on a union-free step
    with the aux pass) the chain key split into (chain, aux), one split per
    chain level."""
    key_t, key_pdf = jax.random.split(jax.random.fold_in(key, step))
    out = {"t": torch.as_tensor(np.array(jax.random.uniform(key_t, (b, cfg.ns_coarse))))}
    if pstep.aux_samples(cfg, step):
        key_pdf, key_aux = jax.random.split(key_pdf)
        out["aux"] = torch.as_tensor(np.array(
            jax.random.uniform(key_aux, (b, cfg.prop_aux_samples))))
    chain, k = [], key_pdf
    for i in range(cfg.prop_levels):
        k, sub = jax.random.split(k)
        n = cfg.ns_fine if i == cfg.prop_levels - 1 else (cfg.prop_samples or cfg.ns_coarse)
        chain.append(torch.as_tensor(np.array(jax.random.uniform(sub, (b, n)))))
    out["chain"] = chain
    return out


# ---------------------------------------------------------------- eval, render

@pytest.mark.parametrize("levels", [1, 2])
def test_eval_step_matches_jax(levels):
    """The union-free eval step (the distillation metric unblurred, as in
    the JAX eval) and ``Trainer.evaluate`` of the EMA shadow."""
    cfg = _cfg(levels)
    st = _jax_state(cfg, 0)
    batch = _batch(2, cfg.batch_size)
    jm = jstep.make_eval_step(cfg, NEAR, FAR)(st, tuple(jnp.asarray(x) for x in batch))
    tr = _port(cfg, st)
    pm = pstep.make_eval_step(cfg, NEAR, FAR)(tr.params, tr.put_batch(batch))
    for k in ("loss_coarse", "loss", "psnr"):
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=TOL, err_msg=k)
    assert float(pm["loss_coarse"]) > 0
    got = tr.evaluate([batch])
    np.testing.assert_allclose(got["loss"], float(jm["loss"]), rtol=TOL)


@pytest.mark.parametrize("levels", [1, 2])
def test_float_render_and_weight_maps_match_jax(levels):
    """The ``Trainer``'s float render and its ``weights_fine``/``t_fine``
    maps: ``NS_FINE`` placed samples a ray, ascending, as the JAX
    ``Trainer`` gives them."""
    cfg = _cfg(levels)
    st = _jax_state(cfg, 0, sigma_bias=1.0)
    jt = JaxTrainer(cfg, NEAR, FAR)
    jt.replace_params(st.params)
    tr = _port(cfg, st)
    _, o, d = _batch(3, 16)
    keys = ("rgb_fine", "depth_fine", "weights_fine", "t_fine")
    want = jt.render_rays(o, d, chunk=16, keys=keys)
    got = tr.render_rays(o, d, chunk=16, keys=keys)
    assert got["t_fine"].shape == got["weights_fine"].shape == (16, cfg.ns_fine)
    assert (np.diff(got["t_fine"], axis=-1) >= 0).all()
    for k, tol in (("rgb_fine", 1e-4), ("depth_fine", 1e-3), ("weights_fine", 1e-4),
                   ("t_fine", 1e-4)):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=tol, rtol=0, err_msg=k)
    assert got["weights_fine"].sum(-1).max() > 0.1


def test_int8_calibration_and_frame_match_jax(tmp_path):
    """int8 on a union-free checkpoint: the calibration stats at the placed
    samples the float chain gives, and the int8 frame, on the JAX qparams
    and on the port's own."""
    cfg = _cfg(l_xyz=6, l_dir=3)
    st = _jax_state(cfg, 0, sigma_bias=1.0)
    st = st._replace(ema=st.params)
    jt = JaxTrainer(cfg, NEAR, FAR)
    jt.state = st
    path = str(tmp_path / "q.ckpt.npz")
    save_checkpoint(path, jax.device_get(st), cfg, scene={"near": NEAR, "far": FAR})
    o, d = (np.asarray(x) for x in jt.pose_rays(POSE, 8, 8, FOCAL))
    jt.quantize_for_inference(o, d)
    pt = Trainer(cfg, NEAR, FAR, device="cpu").restore(path)
    pt.quantize_for_inference(o, d)

    params = jax.device_get(jt.eval_params)
    want = jq.calibrate_render_proposal(params, cfg, NEAR, FAR, o, d)
    fine = jax.tree_util.tree_map(lambda x: torch.tensor(np.asarray(x)), params["fine"])
    got = pq.calibrate_render_proposal({"proposal": pt.eval_params["proposal"],
                                        "fine": fine}, cfg, NEAR, FAR,
                                       torch.tensor(o), torch.tensor(d))
    assert set(got) == set(want) == {"fine"}
    for a, b in zip(_leaves(jax.tree_util.tree_map(lambda x: x.numpy(), got["fine"])),
                    _leaves(want["fine"])):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=0)

    ref = jt.render_rays(o, d, chunk=64, quant=True)
    same = Trainer(cfg, NEAR, FAR, device="cpu").restore(path).install_quant(
        pq.qparams_from_jax(jax.tree_util.tree_map(np.asarray, jt._qparams)))
    same_q = same.render_rays(o, d, chunk=64, quant=True)
    own = pt.render_rays(o, d, chunk=64, quant=True)
    assert sorted(own) == sorted(ref) == ["depth_fine", "rgb_fine"]
    for k in ref:
        np.testing.assert_allclose(same_q[k], ref[k], atol=ATOL_SAME_Q[k], rtol=0, err_msg=k)
        np.testing.assert_allclose(own[k], ref[k], atol=ATOL_OWN_Q[k], rtol=0, err_msg=k)
    flt = pt.render_rays(o, d, chunk=64)
    assert not np.array_equal(own["rgb_fine"], flt["rgb_fine"])


# ---------------------------------------------------------------- train steps

STEP_CASES = {
    "aux": (dict(prop_aux_samples=6), 5),
    "il2_union_step": (dict(prop_union_every=2), 4),
    "il2_free_step": (dict(prop_union_every=2), 5),
    "aux_il2_union_step": (dict(prop_aux_samples=6, prop_union_every=2), 4),
    "aux_il2_free_step": (dict(prop_aux_samples=6, prop_union_every=2), 5),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_steps_with_white_background_and_freq_anneal_match_jax(case, monkeypatch):
    """The aux and interleaved steps with ``WHITE_BKGD`` (the aux pass
    composites onto white too) and ``FREQ_ANNEAL_STEPS`` inside its window
    (step 4-5 of 10): metrics, gradients, params and EMA after Adam."""
    knobs, step = STEP_CASES[case]
    cfg = _cfg(white_bkgd=True, freq_anneal_steps=10, **knobs)
    st = _jax_state(cfg, step)
    key = jax.random.PRNGKey(7)
    batch = _batch(1, cfg.batch_size)
    jbatch = tuple(jnp.asarray(x) for x in batch)
    new_st, jm = jstep.make_train_step(cfg, NEAR, FAR)(st, jbatch, key)
    with monkeypatch.context() as m:
        m.setattr(jstep, "make_optimizer", lambda c: _grab_grads())
        grads = jstep.make_train_step(cfg, NEAR, FAR)(
            st._replace(opt_state=_grab_grads().init(st.params)), jbatch, key)[0].opt_state

    tr = _port(cfg, st)
    draws = _draws(cfg, key, step, cfg.batch_size)
    assert ("aux" in draws) == (case.startswith("aux") and not case.endswith("union_step"))
    pm = tr.train_step(batch, draws=draws)
    for k in ("loss_coarse", "loss", "psnr"):
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=TOL, err_msg=k)
    jg = _leaves(grads)
    pg = _leaves(tr.params_tree(grad=True))
    for a, c in zip(jg, pg):
        np.testing.assert_allclose(c, a, rtol=TOL, atol=TOL * np.abs(a).max())
    lr = cfg.learning_rate
    for after_j, after_p, scale in ((new_st.params, tr.params_tree(), 1.0),
                                    (new_st.ema, tr.ema_tree(), 1.0 - cfg.ema_decay)):
        for a, c, g in zip(_leaves(after_j), _leaves(after_p), jg):
            resolved = np.abs(g) > 1e-3 * np.abs(g).max()
            np.testing.assert_allclose(c[resolved], a[resolved], atol=5e-4 * scale, rtol=0)
            assert np.all(np.abs(c - a) <= 2 * lr * scale * 1.001 + 1e-6)


def test_resume_continues_the_interleave(tmp_path, monkeypatch):
    """A checkpoint written at step 3 of ``PROP_UNION_EVERY=2`` resumes with
    the layout of its restored step (3 union-free, 4 union) and the
    restored Adam state: steps 3 and 4 after ``restore`` equal, bit for bit,
    those of the run that never stopped."""
    cfg = _cfg(prop_union_every=2, prop_aux_samples=4)
    batch = _batch(5, cfg.batch_size)
    gen = torch.Generator().manual_seed(0)
    draws = [{"t": torch.rand((cfg.batch_size, cfg.ns_coarse), generator=gen),
              "chain": [torch.rand((cfg.batch_size, cfg.ns_fine), generator=gen)],
              "aux": torch.rand((cfg.batch_size, 4), generator=gen)} for _ in range(5)]
    seen = []
    real = pstep.render_rays_fused

    def spy(mlp, o, d, t, **kw):
        seen.append(t.shape[-1])
        return real(mlp, o, d, t, **kw)

    monkeypatch.setattr(pstep, "render_rays_fused", spy)
    whole = Trainer(cfg, NEAR, FAR, device="cpu")
    for i in range(3):
        whole.train_step(batch, draws=draws[i])
    path = str(tmp_path / "il.ckpt.npz")
    whole.save(path)
    for i in (3, 4):
        whole.train_step(batch, draws=draws[i])
    # Fine samples a ray by step: union 8 + 12; union-free 12 and the aux 4.
    assert seen == [20, 12, 4, 20, 12, 4, 20]
    seen.clear()
    resumed = Trainer(cfg, NEAR, FAR, device="cpu").restore(path)
    assert resumed.step == 3 and resumed.state.opt.count == 3
    for i in (3, 4):
        resumed.train_step(batch, draws=draws[i])
    assert seen == [12, 4, 20]
    for a, b in zip(_leaves(whole.params_tree()) + _leaves(whole.ema_tree()),
                    _leaves(resumed.params_tree()) + _leaves(resumed.ema_tree())):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- CLIs, server

CLI_CFG = {"BATCH_SIZE": 128, "NS_COARSE": 8, "NS_FINE": 12, "HEIGHT": 16, "WIDTH": 16,
           "L_XYZ": 4, "L_DIR": 2, "NUM_LAYERS": 4, "HIDDEN_DIM": 32, "SKIP_LAYER": 2,
           "EPOCHS": 1, "LEARNING_RATE": 0.005, "BATCH_NORM": False, "WITH_GCS": False,
           "COMPUTE_DTYPE": "float32", "USE_PALLAS": False, "EVAL_EVERY": 1,
           "TRAIN_SAMPLER": "proposal", "PROP_UNION": False, "PROP_EXPLORE": 0.1,
           "PROP_AUX_SAMPLES": 4, "PROP_UNION_EVERY": 3, "PROP_ANNEAL_STEPS": -1,
           "DISTORTION_LOSS_MULT": 1e-4}


def test_cli_trains_scores_and_renders(tmp_path, capsys, monkeypatch):
    """``cli.train_synthetic`` with the three knobs and an auto anneal
    horizon, then ``cli.evaluate`` (float and ``--quant int8``) and
    ``cli.infer`` (3 frames; ``--infer-cache`` saved, then loaded) on its
    checkpoint."""
    cfg_path = tmp_path / "uf.json"
    cfg_path.write_text(json.dumps(CLI_CFG))
    run = tmp_path / "run"
    tr = train_synthetic.main(["--config", str(cfg_path), "--run-dir", str(run),
                               "--device", "cpu"])
    assert tr.step == 18 and tr.cfg.prop_anneal_steps == 18  # 1 epoch of 18 steps
    assert not tr.cfg.prop_union and tr.cfg.prop_union_every == 3
    out = capsys.readouterr().out
    assert "epoch 1/1" in out
    reports = {}
    for quant in ("none", "int8"):
        reports[quant] = run_evaluation(["--config", str(cfg_path), "--checkpoint", str(run),
                                         "--data", "synthetic", "--split", "val",
                                         "--chunk", "128", "--device", "cpu",
                                         "--quant", quant,
                                         "--out", str(tmp_path / f"eval_{quant}.json")])
        assert len(reports[quant]["views"]) == 3
        assert np.isfinite(reports[quant]["mean"]["psnr"])
    assert reports["none"]["mean"]["psnr"] != reports["int8"]["mean"]["psnr"]
    cache = str(tmp_path / "uf.infer.npz")
    videos = capture_videos(monkeypatch)
    argv = ["--config", str(cfg_path), "--checkpoint", str(run), "--frames", "3",
            "--chunk", "128", "--quant", "int8", "--quant-gate-db", "0",
            "--infer-cache", cache, "--device", "cpu"]
    capsys.readouterr()
    first = run_inference(argv + ["--out", str(tmp_path / "a.mp4")])
    assert "saved inference artifacts" in capsys.readouterr().out
    second = run_inference(argv + ["--out", str(tmp_path / "b.mp4")])
    text = capsys.readouterr().out
    assert "loaded inference artifacts" in text and "saved inference" not in text
    a, b = video_frames(videos, first, 3), video_frames(videos, second, 3)
    assert all(f.shape == (16, 16, 3) for f in a)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def _jax_checkpoint(tmp_path):
    """A union-free checkpoint the JAX package wrote (a denser field than
    the init, so the frames carry structure) and its config file."""
    cfg_path = tmp_path / "uf.json"
    cfg_path.write_text(json.dumps(dict(CLI_CFG, HEIGHT=20, WIDTH=20, PROP_ANNEAL_STEPS=0)))
    cfg = jax_load_config(str(cfg_path))
    state = jax.device_get(_jax_state(cfg, 0, sigma_bias=1.0))
    run = tmp_path / "jrun"
    run.mkdir()
    path = str(run / "uf.ckpt.npz")
    save_checkpoint(path, state, cfg, scene={"near": NEAR, "far": FAR, "focal": 24.0})
    return str(cfg_path), path


def test_jax_checkpoint_scores_as_in_jax(tmp_path):
    """``cli.evaluate`` on a union-free checkpoint the JAX package wrote
    reports the JAX CLI's per-view PSNR and SSIM."""
    cfg_path, path = _jax_checkpoint(tmp_path)
    argv = ["--config", cfg_path, "--checkpoint", path, "--data", "synthetic", "--split",
            "val", "--chunk", "128"]
    theirs = jax_run_evaluation(argv + ["--platform", "cpu", "--out",
                                        str(tmp_path / "j.json")])
    ours = run_evaluation(argv + ["--device", "cpu", "--out", str(tmp_path / "p.json")])
    assert len(ours["views"]) == len(theirs["views"]) == 3
    for a, b in zip(ours["views"], theirs["views"]):
        assert abs(a["psnr"] - b["psnr"]) <= 0.05
        assert abs(a["ssim"] - b["ssim"]) <= 1e-3


def test_server_renders_a_jax_union_free_checkpoint(tmp_path):
    """The server on a union-free checkpoint the JAX package wrote, given
    a coarse config (the sidecar decides the layout): the PNG within +-2
    levels of the JAX server's, and one /render over HTTP."""
    _, path = _jax_checkpoint(tmp_path)
    user = NeRFConfig(batch_size=64, ns_coarse=8, ns_fine=12, num_layers=4, hidden_dim=32,
                      skip_layer=2, l_xyz=4, l_dir=2, compute_dtype="float32",
                      height=8, width=8).validate()
    svc = RenderService(user, path, device="cpu")
    assert not svc.trainer.cfg.prop_union and svc.trainer.online_proposal
    kw = dict(theta=30.0, phi=-30.0, radius=4.0, height=8, width=8, chunk=64)
    ours = decode_png(svc.render_png(**kw))
    theirs = decode_png(JaxRenderService(user, path, NEAR, FAR).render_png(**kw))
    assert ours.shape == theirs.shape == (8, 8, 3)
    assert np.abs(ours.astype(int) - theirs.astype(int)).max() <= 2
    assert ours.std() > 0
    server = serve(svc, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        png = urllib.request.urlopen(f"{base}/render?theta=10&height=6&width=7").read()
        assert decode_png(png).shape == (6, 7, 3)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)


# ---------------------------------------------------------------- two ranks

RANK_CASES = {
    # (knobs, start step): the first, audited step is union-free; the
    # interleave's second step (4) is a union step on both ranks.
    "auxfree": (dict(prop_aux_samples=4), 0),
    "il4": (dict(prop_union_every=4), 3),
}


@pytest.mark.parametrize("case", sorted(RANK_CASES))
def test_two_gloo_ranks_equal_one_process(case):
    """Two gloo ranks, 16 rays each, 2 steps drawing from the shared seeded
    generator (the aux t after the chain's, at the global shape): the
    ranks bit-identical (``run_two_process_smoke`` checks the digests),
    and the first step's metrics and reduced gradients those of one
    process on the 32 rays within 1e-5."""
    knobs, start = RANK_CASES[case]
    kw = dict(batch_size=32, ns_coarse=4, ns_fine=8, num_layers=2, hidden_dim=16,
              skip_layer=4, l_xyz=4, l_dir=2, compute_dtype="float32", use_pallas=False,
              learning_rate=5e-3, height=8, width=8, train_sampler="proposal",
              prop_union=False, prop_explore=0.1, prop_anneal_steps=10,
              distortion_loss_mult=1e-4, **knobs)
    cfg = _cfg(**kw)
    batch = bench_batch(cfg.batch_size, seed=2)
    a, b = run_two_process_smoke("cpu", cfg_overrides=dataclasses.asdict(cfg), timeout=120,
                                 near=NEAR, far=FAR, batch=batch, steps=2, start_step=start)
    assert a["digest"] == b["digest"] and (a["world"], a["backend"]) == (2, "gloo")
    one = Trainer(cfg, NEAR, FAR, device="cpu")
    one.step = start
    om = one.train_step(batch)
    for k in om:
        assert abs(a["metrics"][0][k] - float(om[k])) <= 1e-5 * max(1.0, abs(float(om[k]))), k
    for x, y in zip(_leaves(one.params_tree(grad=True)), _leaves(a["grads"])):
        assert np.abs(x - y).max() <= 1e-5 * max(np.abs(x).max(), 1e-30)


def _script_arms(path: str, batch: int) -> dict:
    """The ``NeRFConfig`` keywords of every arm of
    ``scripts/exp_coverage_step_ab.py``, read from its source: its
    ``common`` dict (``batch_size`` its ``--batch`` default) and the
    literal keywords of each ``(name, NeRFConfig(...))`` entry."""
    import ast

    tree = ast.parse(open(path).read())
    common, arms = None, {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign) or not isinstance(node.targets[0], ast.Name):
            continue
        if node.targets[0].id == "common":
            common = {k.arg: (batch if isinstance(k.value, ast.Name)
                              else ast.literal_eval(k.value)) for k in node.value.keywords}
        elif node.targets[0].id == "variants_cfg":
            for entry in node.value.elts:
                name, call = entry.elts
                call = call.func.value  # NeRFConfig(...).validate()
                arms[ast.literal_eval(name).strip()] = {
                    k.arg: ast.literal_eval(k.value) for k in call.keywords if k.arg}
    return {name: dict(common, **kw) for name, kw in arms.items()}


def test_profile_arms_are_the_jax_scripts():
    """``profile_train``'s arms: the union recipe, ``auxfree-128+32`` and
    ``il4-128`` are the configs of the JAX package's
    ``scripts/exp_coverage_step_ab.py``, read from that script's source;
    ``nounion-128`` is ``docs/TRAINING.md``'s throughput recipe
    (``PROP_UNION`` false, ``PROP_EXPLORE`` 0.1) at the script's common
    widths with 64 + 128 samples.  Every field is compared but
    ``USE_PALLAS``, which the port does not read."""
    from nerf_keras_tpu_torch.profile_train import ARMS, UNION_ARM, arm_config

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = _script_arms(os.path.join(root, "scripts", "exp_coverage_step_ab.py"), 4096)
    recipe = open(os.path.join(root, "docs", "TRAINING.md")).read()
    assert '"PROP_UNION": false, "PROP_EXPLORE": 0.1' in recipe
    common = {k: v for k, v in script[UNION_ARM].items() if k not in ("ns_coarse", "ns_fine")}
    want = {UNION_ARM: script[UNION_ARM],
            "nounion-128": dict(common, ns_coarse=64, ns_fine=128, prop_union=False,
                                prop_explore=0.1),
            "auxfree-128+32": script["auxfree-128+32"],
            "il4-128": script["il4-128"]}
    assert sorted(want) == sorted([UNION_ARM, *ARMS])
    for arm, kw in want.items():
        got = dataclasses.asdict(arm_config(arm))
        ref = dataclasses.asdict(NeRFConfig(**kw).validate())
        got.pop("use_pallas"), ref.pop("use_pallas")
        assert got == ref, arm
