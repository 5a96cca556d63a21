"""The port's int8 path (``ops/quant.py``, K4's plain version, the int8
renders, the ``Trainer``'s int8 half and ``--quant int8`` serving) against
the JAX package's.

Tolerances.  The integer pipeline is the same on both sides, so on the
same qparams and the same encodings the MLP agrees bit for bit; K4's
plain version against the JAX kernel (interpret mode, whose in-kernel
encode takes ``cos`` as ``sin(z + pi/2)``) within 1e-5, the JAX test's own
tolerance.  Through the ``Trainer`` the two frameworks place their
t-values with ``linspace`` implementations that differ by float32 ulps
(and the fine samples follow ``sample_pdf``, ulps apart, ROADMAP.md
section 3).  At the top octave (2^(L-1) |p|) that moves an encoding,
which can carry it across an int8 rounding boundary, so frames on the
same qparams agree to ``ATOL_SAME_Q`` (measured: coarse 1.2e-7 rgb,
4.8e-7 depth; fine 1.1e-4 rgb, 4.0e-4 depth), and each framework's own
calibration, whose stats move with the encodings, to ``ATOL_OWN_Q``
(measured 6.2e-4 rgb, 1.1e-3 depth), the served frame's tolerance.
"""

import dataclasses
import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_keras_tpu.config import NeRFConfig
from nerf_keras_tpu.engine.trainer import Trainer as JaxTrainer
from nerf_keras_tpu.models.mlp import init_nerf_params
from nerf_keras_tpu.ops import encode_position, sample_rays
from nerf_keras_tpu.ops import quant as jq
from nerf_keras_tpu.ops.pallas.quant_render import render_rays_fused_quant as jax_k4
from nerf_keras_tpu.ops.rays import pose_spherical
from nerf_keras_tpu.utils.checkpoint import save_checkpoint
from nerf_keras_tpu_torch.engine.trainer import Trainer
from nerf_keras_tpu_torch.ops import quant as pq
from nerf_keras_tpu_torch.ops.kernels import quant_render as k4
from nerf_keras_tpu_torch.serving import RenderService, serve
from nerf_keras_tpu_torch.utils.image_metrics import accuracy_gate, frame_psnr
from nerf_keras_tpu_torch.utils.png import decode_png

# See tests/test_torch_serving.py: one torch thread beside JAX workers.
torch.set_num_threads(1)

L_XYZ, L_DIR = 6, 3
POSE = pose_spherical(30.0, -30.0, 4.0)
FOCAL = 9.6
ATOL_SAME_Q = {"rgb_coarse": 1e-5, "depth_coarse": 1e-4, "rgb_fine": 1e-3, "depth_fine": 5e-3}
ATOL_OWN_Q = {"rgb_coarse": 5e-3, "depth_coarse": 1e-2, "rgb_fine": 5e-3, "depth_fine": 1e-2}


def _t(x):
    return torch.tensor(np.asarray(x))


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _tree_t(tree):
    if isinstance(tree, dict):
        return {k: _tree_t(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_t(v) for v in tree]
    return _t(tree)


def _assert_tree_close(got, want, rtol, what=""):
    got_leaves = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda x: x.numpy(), got, is_leaf=torch.is_tensor))
    want_leaves = jax.tree_util.tree_leaves(_tree_np(want))
    assert len(got_leaves) == len(want_leaves)
    for i, (g, w) in enumerate(zip(got_leaves, want_leaves)):
        assert g.shape == w.shape, (what, i)
        if w.dtype == np.int8:
            assert g.dtype == np.int8
            np.testing.assert_array_equal(g, w, err_msg=f"{what} leaf {i}")
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=0, err_msg=f"{what} leaf {i}")


def _mlp_case(num_layers, hidden, skip, bound, seed, n=1024):
    params = init_nerf_params(jax.random.PRNGKey(seed), num_layers=num_layers,
                              hidden_dim=hidden, skip_layer=skip, l_xyz=L_XYZ, l_dir=L_DIR)
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + rng.normal(size=x.shape).astype(np.float32) * 0.05, params)
    pts = jnp.asarray(rng.uniform(-bound, bound, (n, 3)), jnp.float32)
    dirs = jnp.asarray(rng.normal(size=(n, 3)), jnp.float32)
    dirs = dirs / jnp.linalg.norm(dirs, axis=-1, keepdims=True)
    return params, encode_position(pts, L_XYZ), encode_position(dirs, L_DIR)


def test_quantize_activation_matches_jax():
    """Half-to-even ties, values past +-127 (clamped, never -128), and a
    random spread: bit-equal int8."""
    ties = np.array([-300.0, -128.5, -127.5, -126.5, -2.5, -1.5, -0.5, 0.0, 0.5, 1.5,
                     2.5, 3.5, 126.5, 127.5, 128.0, 1e6], np.float32)
    rng = np.random.default_rng(0)
    x = np.concatenate([ties, (rng.normal(size=240) * 60).astype(np.float32)]).reshape(16, 16)
    inv = np.ones((1, 16), np.float32)
    inv[0, 8:] = rng.uniform(0.5, 3.0, 8).astype(np.float32)
    want = np.asarray(jq.quantize_activation(jnp.asarray(x), jnp.asarray(inv)))
    got = pq.quantize_activation(_t(x), _t(inv))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.min() >= -127 and got.max() <= 127


@pytest.mark.parametrize("arch,bound", [
    ((8, 64, 4), 4.0),
    ((6, 32, 2), 40.0),   # skip concats whose x_enc columns are 40x the sin features
])
def test_calibration_and_quantize_mlp_match_jax(arch, bound):
    """Calibration stats (the float32 forward, summed in another order:
    a few ulps, 1.1e-6 measured deep in the skip case) to rtol 1e-5;
    ``quantize_mlp`` on the same stats: ``wq`` bit-equal, the float rows
    to rtol 1e-6; ``merge_absmax`` of two halves equals the whole."""
    params, x_enc, d_enc = _mlp_case(*arch, bound, seed=arch[0])
    skip = arch[2]
    tree = _tree_t(_tree_np(params))
    stats_j = jq.mlp_calibration_absmax(params, x_enc, d_enc, skip)
    stats_p = pq.mlp_calibration_absmax(tree, _t(x_enc), _t(d_enc), skip)
    _assert_tree_close(stats_p, stats_j, 1e-5, "stats")
    halves = pq.merge_absmax(pq.mlp_calibration_absmax(tree, _t(x_enc[:300]), _t(d_enc[:300]), skip),
                             pq.mlp_calibration_absmax(tree, _t(x_enc[300:]), _t(d_enc[300:]), skip))
    for a, b in zip(jax.tree_util.tree_leaves(halves), jax.tree_util.tree_leaves(stats_p)):
        assert torch.equal(a, b)
    qp_j = jq.quantize_mlp(params, stats_j, skip)
    qp_p = pq.quantize_mlp(tree, _tree_t(_tree_np(stats_j)), skip)
    _assert_tree_close(qp_p, qp_j, 1e-6, "qparams")
    assert len(pq.flatten_qparams(qp_p)) == pq.n_flat_qparams(arch[0])


@pytest.mark.parametrize("arch,bound", [((8, 64, 4), 4.0), ((6, 32, 2), 40.0)])
def test_apply_nerf_mlp_quant_matches_jax(arch, bound):
    params, x_enc, d_enc = _mlp_case(*arch, bound, seed=10 + arch[0])
    qp = jq.quantize_mlp(params, jq.mlp_calibration_absmax(params, x_enc, d_enc, arch[2]),
                         arch[2])
    want = np.asarray(jq.apply_nerf_mlp_quant(qp, x_enc, d_enc, arch[2]))
    got = pq.apply_nerf_mlp_quant(pq.qparams_from_jax(_tree_np(qp)), _t(x_enc), _t(d_enc),
                                  arch[2])
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def _ray_batch(b, s, seed):
    rng = np.random.default_rng(seed)
    origins = jnp.asarray(rng.uniform(-0.1, 0.1, (b, 3)) + [0, 0, 4], jnp.float32)
    dirs = jnp.asarray(rng.normal(size=(b, 3)) * 0.2 + [0, 0, -1], jnp.float32)
    t = np.sort(rng.uniform(2.0, 6.0, (b, s)), axis=-1).astype(np.float32)
    return origins, dirs, jnp.asarray(t)


@pytest.mark.parametrize("b,s", [(64, 16), (37, 16), (20, 40)])
def test_k4_plain_matches_jax_kernel(b, s):
    """K4's plain version (the CPU route of ``render_rays_fused_quant``)
    against the JAX kernel in interpret mode, on the JAX qparams and the
    same rays; a ragged B and an S that is no multiple of 8."""
    params, _, _ = _mlp_case(8, 64, 4, 4.0, seed=3)
    origins, dirs, t_vals = _ray_batch(b, s, seed=b)
    pts, ds = sample_rays(origins, dirs, t_vals)
    x_enc, d_enc = encode_position(pts, L_XYZ), encode_position(ds, L_DIR)
    qp = jq.quantize_mlp(params, jq.mlp_calibration_absmax(params, x_enc, d_enc))
    rgb_j, w_j = jax_k4(qp, origins, dirs, t_vals, l_xyz=L_XYZ, l_dir=L_DIR)
    before = k4.launches
    rgb_p, w_p = k4.render_rays_fused_quant(pq.qparams_from_jax(_tree_np(qp)), _t(origins),
                                            _t(dirs), _t(t_vals), l_xyz=L_XYZ, l_dir=L_DIR)
    assert k4.launches == before  # the CPU takes the plain version
    np.testing.assert_allclose(rgb_p.numpy(), np.asarray(rgb_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(w_p.numpy(), np.asarray(w_j), atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="l_xyz"):
        k4.render_rays_fused_quant(pq.qparams_from_jax(_tree_np(qp)), _t(origins), _t(dirs),
                                   _t(t_vals), l_xyz=L_XYZ + 1, l_dir=L_DIR)


# ---------------------------------------------------------------------------
# The Trainer's int8 half.

ARCH = dict(batch_size=64, ns_coarse=8, ns_fine=8, num_layers=6, hidden_dim=32,
            skip_layer=4, l_xyz=L_XYZ, l_dir=L_DIR, height=8, width=8,
            compute_dtype="float32", use_pallas=False)
PROPOSAL = dict(ARCH, ns_fine=12, skip_layer=2, train_sampler="proposal",
                prop_anneal_steps=10, ema_decay=0.9)


def _dense_field(state, seed):
    """A denser, less uniform field than the init (sigma bias +1, noise on
    every leaf): the init's sigma sits at 0, where the 1e10 terminal delta
    makes the last weight a step function of any perturbation."""
    rng = np.random.default_rng(seed)

    def bump(path, x):
        x = np.asarray(x)
        if jax.tree_util.keystr(path).endswith("['sigma']['b']"):
            return x + 1.0
        return x + rng.normal(size=x.shape).astype(np.float32) * 0.05

    params = jax.tree_util.tree_map_with_path(bump, state.params)
    return state._replace(params=params, ema=params if state.ema is not None else None)


@pytest.fixture(scope="module", params=["coarse", "proposal"])
def pair(request, tmp_path_factory):
    """A JAX Trainer and the port's, on the same checkpoint, both
    calibrated on the same pose's rays."""
    cfg = NeRFConfig(**(ARCH if request.param == "coarse" else PROPOSAL)).validate()
    jt = JaxTrainer(cfg, 2.0, 6.0)
    jt.state = _dense_field(jt.state, 0)
    path = str(tmp_path_factory.mktemp("q") / "m.ckpt.npz")
    save_checkpoint(path, jax.device_get(jt.state), cfg, scene={"near": 2.0, "far": 6.0})
    o, d = jt.pose_rays(POSE, 8, 8, FOCAL)
    jt.quantize_for_inference(o, d)
    pt = Trainer(cfg, 2.0, 6.0, device="cpu").restore(path)
    pt.quantize_for_inference(o, d)
    return request.param, cfg, jt, pt, path, (np.asarray(o), np.asarray(d))


def _maps(trainer, o, d):
    return trainer.render_rays(o, d, chunk=64, quant=True)


def test_trainer_calibration_matches_jax(pair):
    """The calibration stats of each MLP, from the Trainer's own rays, to
    rtol 1e-3: the abs-maxes move with the encodings, whose t-values
    (``linspace``, then ``sample_pdf`` or the proposal chain for the fine
    pass) are ulps apart; measured 1.3e-4 coarse, 4.3e-5 fine."""
    kind, cfg, jt, pt, _, (o, d) = pair
    params = jax.device_get(jt.eval_params)
    trees = {k: _tree_t(_tree_np(v)) for k, v in params.items() if k != "proposal"}
    if kind == "coarse":
        want = jq.calibrate_render(params, cfg, 2.0, 6.0, o, d)
        got = pq.calibrate_render(trees, cfg, 2.0, 6.0, _t(o), _t(d))
        _assert_tree_close(got["coarse"], want["coarse"], 1e-3, "coarse stats")
    else:
        want = jq.calibrate_render_proposal(params, cfg, 2.0, 6.0, o, d)
        got = pq.calibrate_render_proposal({"proposal": pt.eval_params["proposal"], **trees},
                                           cfg, 2.0, 6.0, _t(o), _t(d))
    assert set(got) == set(want)
    _assert_tree_close(got["fine"], want["fine"], 1e-3, "fine stats")


def test_trainer_int8_frame_matches_jax(pair):
    """Every map of the int8 render: on the JAX qparams (installed with
    ``qparams_from_jax``) within ``ATOL_SAME_Q``; each framework on its
    own calibration within ``ATOL_OWN_Q``."""
    kind, cfg, jt, pt, path, (o, d) = pair
    want = jt.render_rays(o, d, chunk=64, quant=True)
    keys = sorted(want)
    assert keys == (["depth_fine", "rgb_fine"] if kind == "proposal" else
                    ["depth_coarse", "depth_fine", "rgb_coarse", "rgb_fine"])
    own = _maps(pt, o, d)
    same = Trainer(cfg, 2.0, 6.0, device="cpu").restore(path).install_quant(
        pq.qparams_from_jax(_tree_np(jt._qparams)))
    same_q = _maps(same, o, d)
    for k in keys:
        assert own[k].shape == want[k].shape and np.isfinite(own[k]).all()
        np.testing.assert_allclose(same_q[k], want[k], atol=ATOL_SAME_Q[k], rtol=0, err_msg=k)
        np.testing.assert_allclose(own[k], want[k], atol=ATOL_OWN_Q[k], rtol=0, err_msg=k)
    # int8, not the float render
    flt = pt.render_rays(o, d, chunk=64, keys=tuple(keys))
    assert not np.array_equal(own["rgb_fine"], flt["rgb_fine"])
    assert frame_psnr(flt["rgb_fine"], own["rgb_fine"]) > 20.0


def test_trainer_int8_errors_and_invalidation(pair, tmp_path):
    kind, cfg, jt, pt, path, (o, d) = pair
    fresh = Trainer(cfg, 2.0, 6.0, device="cpu").restore(path)
    assert not fresh.quant_ready
    with pytest.raises(RuntimeError, match="quantize_for_inference"):
        fresh.render_rays(o, d, chunk=64, quant=True)
    fresh.quantize_for_inference(o, d)
    assert fresh.quant_ready
    if kind == "coarse":
        with pytest.raises(ValueError, match="rgb/depth"):
            fresh.render_rays(o, d, chunk=64, quant=True, full=True)
    with pytest.raises(ValueError, match="rgb/depth"):
        fresh.render_rays(o, d, chunk=64, quant=True, keys=("rgb_fine", "weights_fine"))
    # New weights drop the int8 tables: restore, replace_params, train_step.
    fresh.restore(path)
    assert not fresh.quant_ready
    fresh.quantize_for_inference(o, d)
    fresh.replace_params(fresh.params_tree())
    assert not fresh.quant_ready
    fresh.quantize_for_inference(o, d)
    rng = np.random.default_rng(0)
    batch = (rng.uniform(0, 1, (cfg.batch_size, 3)).astype(np.float32),
             np.tile(np.float32([0, 0, 4]), (cfg.batch_size, 1)),
             rng.normal(size=(cfg.batch_size, 3)).astype(np.float32))
    fresh.train_step(batch)
    assert not fresh.quant_ready
    with pytest.raises(RuntimeError, match="quantize_for_inference"):
        fresh.render_image(POSE, 8, 8, FOCAL, chunk=64, quant=True)
    fresh.cfg = dataclasses.replace(cfg, batch_norm=True)
    with pytest.raises(ValueError, match="BatchNorm"):
        fresh.quantize_for_inference(o, d)


def test_calibration_subsamples_as_jax(pair):
    """More rays than ``calib_rays``: the same ``default_rng(seed)``
    subset as the JAX Trainer, so a subsample of 20 rays calibrates the
    same tables as calibrating on those 20 rays directly."""
    kind, cfg, jt, pt, path, (o, d) = pair
    idx = np.random.default_rng(7).choice(o.shape[0], 20, replace=False)
    a = Trainer(cfg, 2.0, 6.0, device="cpu").restore(path).quantize_for_inference(
        o, d, calib_rays=20, seed=7)
    b = Trainer(cfg, 2.0, 6.0, device="cpu").restore(path).quantize_for_inference(
        o[idx], d[idx])
    for x, y in zip(jax.tree_util.tree_leaves(a.qparams), jax.tree_util.tree_leaves(b.qparams)):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# --quant int8 serving.

@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    cfg = NeRFConfig(**ARCH).validate()
    jt = JaxTrainer(cfg, 2.0, 6.0)
    jt.state = _dense_field(jt.state, 1)
    path = str(tmp_path_factory.mktemp("srvq") / "m.ckpt.npz")
    save_checkpoint(path, jax.device_get(jt.state), cfg, scene={"near": 2.0, "far": 6.0})
    return cfg, path


def test_int8_server_gates_and_serves_int8(ckpt):
    cfg, path = ckpt
    svc = RenderService(cfg, path, device="cpu", quant=True)
    assert svc.use_quant and svc.trainer.quant_ready
    assert svc.quant_gate_psnr >= 30.0
    server = serve(svc, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        png = urllib.request.urlopen(f"{base}/render?theta=10&height=6&width=7").read()
        assert decode_png(png).shape == (6, 7, 3)
        stats = json.loads(urllib.request.urlopen(f"{base}/stats").read())
        assert stats["quant"] == "int8" and stats["requests"] == 1
        req = urllib.request.Request(f"{base}/reload", method="POST")
        result = json.loads(urllib.request.urlopen(req).read())
        assert result["quant"] == "int8" and svc.trainer.quant_ready
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    # The served frame is the int8 render, not the float one.
    kw = dict(theta=20.0, phi=-30.0, radius=4.0, height=8, width=8)
    q = decode_png(svc.render_png(**kw))
    flt = decode_png(RenderService(cfg, path, device="cpu").render_png(**kw))
    want = svc.trainer.render_image(pose_spherical(20.0, -30.0, 4.0), 8, 8, 9.6,
                                    quant=True, uint8_rgb=True, need_depth=False)["rgb"]
    np.testing.assert_array_equal(q, want)
    assert not np.array_equal(q, flt)


def test_int8_server_falls_back_when_the_gate_fails(ckpt, capsys):
    """A gate no render can pass: the server says so and serves the float
    path, as the JAX server does."""
    cfg, path = ckpt
    svc = RenderService(cfg, path, device="cpu", quant=True, quant_gate_db=1000.0)
    assert "gate FAIL" in capsys.readouterr().out
    assert not svc.use_quant and svc.stats()["quant"] == "none"
    assert svc.reload()["quant"] == "none"
    kw = dict(theta=20.0, phi=-30.0, radius=4.0, height=8, width=8)
    flt = RenderService(cfg, path, device="cpu").render_png(**kw)
    np.testing.assert_array_equal(decode_png(svc.render_png(**kw)), decode_png(flt))


def test_accuracy_gate():
    ref = np.zeros((4, 4, 3), np.float32)
    assert frame_psnr(ref, ref) == float("inf")
    assert accuracy_gate(ref, ref + 0.01, 30.0, "t", "f") == (True, pytest.approx(40.0))
    assert not accuracy_gate(ref, ref + 0.1, 30.0, "t", "f")[0]
    assert not accuracy_gate(ref, ref * np.nan, 30.0, "t", "f")[0]
