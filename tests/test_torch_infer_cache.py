"""The port's inference-artifact cache against the JAX package's.

``utils/infer_cache.py`` keeps the int8 tables and the distilled proposal
net in the JAX package's ``.infer.npz`` format, keyed by the same sha256
digest of the weights: one checkpoint gives the same hex string in both
packages, a file written by either loads in the other, and a file of other
weights is refused.  Frames on the same carried-across artifacts:
float32 config, the distilled float render to 1e-4 rgb and its int8 render
to 1e-3 (the two packages' t-values are ulps apart, which can carry an
encoding across an int8 rounding boundary: ``tests/test_torch_quant.py``'s
``ATOL_SAME_Q``); bfloat16 config 5e-3 both.
"""

import jax
import numpy as np
import pytest
import torch

from nerf_keras_tpu.config import NeRFConfig
from nerf_keras_tpu.engine.trainer import Trainer as JaxTrainer
from nerf_keras_tpu.ops.rays import pose_spherical
from nerf_keras_tpu.utils import infer_cache as jcache
from nerf_keras_tpu.utils.checkpoint import save_checkpoint
from nerf_keras_tpu_torch.engine.trainer import Trainer
from nerf_keras_tpu_torch.ops.quant import qparams_to_jax
from nerf_keras_tpu_torch.utils.infer_cache import (
    StaleArtifactsError,
    _unflatten,
    load_artifacts,
    params_digest,
    save_artifacts,
)

torch.set_num_threads(1)

NEAR, FAR, FOCAL = 2.0, 6.0, 24.0
POSE = pose_spherical(30.0, -30.0, 4.0)
ARCH = dict(batch_size=64, ns_coarse=8, ns_fine=16, num_layers=4, hidden_dim=64,
            skip_layer=2, l_xyz=6, l_dir=3, height=20, width=20, use_pallas=False)
FRAME_TOL = {"float32": (1e-4, 1e-3), "bfloat16": (5e-3, 5e-3)}


def test_unflatten_rebuilds_nested_dicts_and_lists():
    flat = {
        "['layers'][1]['w']": np.ones((2, 2)),
        "['layers'][0]['w']": np.zeros((2, 2)),
        "['layers'][0]['b']": np.zeros((2,)),
        "['layers'][1]['b']": np.ones((2,)),
        "['inv_x']": np.full((1, 3), 2.0),
    }
    tree = _unflatten(flat)
    assert isinstance(tree["layers"], list) and len(tree["layers"]) == 2
    assert tree["layers"][1]["w"][0, 0] == 1.0
    assert tree["inv_x"].shape == (1, 3)
    with pytest.raises(ValueError, match="non-dense"):
        _unflatten({"['a'][0]['w']": np.zeros(1), "['a'][2]['w']": np.zeros(1)})
    with pytest.raises(ValueError, match="mixed"):
        _unflatten({"['a'][0]": np.zeros(1), "['a']['b']": np.zeros(1)})
    with pytest.raises(ValueError, match="unparseable"):
        _unflatten({"a.b": np.zeros(1)})


def test_digest_and_file_format_match_jax(tmp_path):
    """The same tree and extra give JAX's hex string; a file written by
    either module loads through the other's."""
    rng = np.random.default_rng(0)
    tree = {"fine": {"trunk": [{"w": rng.normal(size=(3, 4)).astype(np.float32),
                                "b": np.zeros(4, np.float32)}] * 2},
            "coarse": {"sigma": {"w": np.ones((4, 1), np.float32)}}}
    extra = {"skip_layer": 4, "l_xyz": 6, "l_dir": 3, "compute_dtype": "float32"}
    assert params_digest(tree, extra) == jcache.params_digest(tree, extra)
    assert params_digest(tree) == jcache.params_digest(tree)
    assert params_digest(tree) != params_digest(tree, extra)
    pparams = {"layers": [{"w": np.arange(6, dtype=np.float32).reshape(2, 3),
                           "b": np.zeros(3, np.float32)}]}
    qparams = {"trunk": [{"wq": np.ones((2, 2), np.int8),
                          "scale": np.ones((1, 2), np.float32)}],
               "inv_x": np.full((1, 2), 3.0, np.float32)}
    ours, theirs = str(tmp_path / "ours.infer.npz"), str(tmp_path / "theirs.infer.npz")
    save_artifacts(ours, "d1", pparams=pparams, prop_l_xyz=4, distill_loss=0.25,
                   qparams=qparams)
    jcache.save_artifacts(theirs, "d1", pparams=pparams, prop_l_xyz=4, distill_loss=0.25,
                          qparams=qparams)
    a, b = np.load(ours), np.load(theirs)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])
    art = load_artifacts(theirs, "d1")
    assert art["prop_l_xyz"] == 4 and art["distill_loss"] == 0.25
    assert art["qparams"]["trunk"][0]["wq"].dtype == np.int8
    assert jcache.load_artifacts(ours, "d1")["prop_l_xyz"] == 4
    with pytest.raises(StaleArtifactsError, match="different weights"):
        load_artifacts(theirs, "d2")
    with pytest.raises(ValueError, match="nothing to save"):
        save_artifacts(str(tmp_path / "e.npz"), "d1")


def _dense(tree, rng, scale=0.05):
    def bump(path, x):
        x = np.asarray(x) + rng.normal(size=x.shape).astype(np.float32) * scale
        return x + 1.0 if jax.tree_util.keystr(path).endswith("['sigma']['b']") else x

    return jax.tree_util.tree_map_with_path(bump, tree)


def _checkpoint(tmp_path, cfg, seed=0):
    """A JAX checkpoint of a denser field than the init; with EMA on, a
    shadow that differs from the params."""
    jt = JaxTrainer(cfg, NEAR, FAR)
    rng = np.random.default_rng(seed)
    state = jax.device_get(jt.state)
    params = _dense(state.params, rng)
    ema = None if state.ema is None else _dense(params, rng, 0.01)
    path = str(tmp_path / f"m{seed}.ckpt.npz")
    save_checkpoint(path, state._replace(params=params, ema=ema), cfg,
                    scene={"near": NEAR, "far": FAR, "focal": FOCAL})
    return path


CASES = {
    "coarse_ema": dict(ema_decay=0.9),
    "coarse": dict(),
    "proposal_ema": dict(train_sampler="proposal", prop_anneal_steps=10, ema_decay=0.9),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_infer_digest_matches_jax(case, tmp_path):
    cfg = NeRFConfig(**ARCH, compute_dtype="float32", **CASES[case]).validate()
    path = _checkpoint(tmp_path, cfg)
    jt = JaxTrainer(cfg, NEAR, FAR).restore(path)
    pt = Trainer(cfg, NEAR, FAR, device="cpu").restore(path)
    assert pt.infer_digest() == jt.infer_digest()
    if cfg.ema_decay > 0:  # the digest is of the EMA shadow, which serves
        plain = Trainer(cfg, NEAR, FAR, device="cpu").restore(path)
        plain.ema = None
        assert plain.infer_digest() != pt.infer_digest()
    other = Trainer(cfg, NEAR, FAR, device="cpu").restore(_checkpoint(tmp_path, cfg, seed=1))
    assert other.infer_digest() != pt.infer_digest()


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def caches(request, tmp_path_factory):
    """One checkpoint; an ``.infer.npz`` written by the JAX Trainer (its own
    distilled net, the port's int8 tables: one calibration, JAX's costs ~9
    s of CPU) and one written by the port's (its own net and tables)."""
    tmp = tmp_path_factory.mktemp("cache")
    cfg = NeRFConfig(**ARCH, compute_dtype=request.param).validate()
    path = _checkpoint(tmp, cfg)
    jt = JaxTrainer(cfg, NEAR, FAR).restore(path)
    o, d = (np.asarray(x) for x in jt.pose_rays(POSE, 20, 20, FOCAL))
    pt = Trainer(cfg, NEAR, FAR, device="cpu").restore(path)
    pt.build_proposal_sampler(o, d, steps=20, batch=128)
    pt.quantize_for_inference(o, d)
    jt.build_proposal_sampler(o, d, steps=20, batch=128)
    jt._install_quant(qparams_to_jax(pt.qparams))
    jax_file = str(tmp / "jax.infer.npz")
    jt.save_inference_artifacts(jax_file)
    port_file = str(tmp / "port.infer.npz")
    pt.save_inference_artifacts(port_file)
    return request.param, cfg, path, jax_file, port_file, jt, pt


def _frames(trainer):
    return [trainer.render_image(POSE, 20, 20, FOCAL, chunk=128, sampler="proposal",
                                 quant=quant)["rgb"] for quant in (False, True)]


def test_jax_written_cache_renders_in_the_port(caches):
    dtype, cfg, path, jax_file, _, jt, _ = caches
    pt = Trainer(cfg, NEAR, FAR, device="cpu").restore(path)
    assert not pt.quant_ready and not pt.proposal_ready
    pt.load_inference_artifacts(jax_file)
    assert pt.quant_ready and pt.proposal_ready
    # The tables and the net as the JAX Trainer holds them.
    for got, want in ((qparams_to_jax(pt.qparams), jt._qparams),
                      (pt._pparams.to_jax_params(), jt._pparams)):
        got_l = jax.tree_util.tree_leaves(got)
        want_l = jax.tree_util.tree_leaves(jax.device_get(want))
        assert len(got_l) == len(want_l)
        for g, w in zip(got_l, want_l):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    for tol, got, want in zip(FRAME_TOL[dtype], _frames(pt), _frames(jt)):
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def test_port_written_cache_renders_in_jax(caches):
    dtype, cfg, path, _, port_file, _, pt = caches
    jt = JaxTrainer(cfg, NEAR, FAR).restore(path)
    jt.load_inference_artifacts(port_file)
    assert jt.quant_ready and jt.proposal_ready
    for tol, got, want in zip(FRAME_TOL[dtype], _frames(pt), _frames(jt)):
        np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    # The port round trip renders exactly what the writing trainer rendered.
    again = Trainer(cfg, NEAR, FAR, device="cpu").restore(path).load_inference_artifacts(
        port_file)
    for got, want in zip(_frames(again), _frames(pt)):
        np.testing.assert_array_equal(got, want)


def test_stale_cache_raises(caches, tmp_path):
    dtype, cfg, _, jax_file, port_file, _, _ = caches
    other = Trainer(cfg, NEAR, FAR, device="cpu").restore(_checkpoint(tmp_path, cfg, seed=2))
    for f in (jax_file, port_file):
        with pytest.raises(StaleArtifactsError, match="different weights"):
            other.load_inference_artifacts(f)
    assert not other.quant_ready and not other.proposal_ready
    fresh = Trainer(cfg, NEAR, FAR, device="cpu")
    with pytest.raises(RuntimeError, match="nothing to save"):
        fresh.save_inference_artifacts(str(tmp_path / "none.infer.npz"))
