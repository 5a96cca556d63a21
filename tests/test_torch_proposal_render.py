"""Renders of proposal-trained models (``TRAIN_SAMPLER=proposal``).

* ``render_rays(keys=("weights_fine", "t_fine"))`` returns the fine pass's
  compositing weights and the sorted t-values they weight, as the JAX
  ``Trainer.render_rays`` does (``make_proposal_render_fn(want_weights=
  True)``); the JAX test is ``tests/test_proposal_training.py``'s union
  render.  Tolerances: float32 on both sides; weights atol 1e-4 (the
  compositing over t-values that agree to ~1e-5, ``test_torch_train.py``),
  t_fine atol 1e-4 (``sample_pdf`` in another summation order).
* ``RenderService(sampler="proposal")`` serves a proposal-trained
  checkpoint unchanged, as the JAX server does; on a coarse-trained one it
  still raises (the offline-distilled sampler is not ported).
"""

import jax
import numpy as np
import pytest
import torch

from nerf_keras_tpu.config import NeRFConfig
from nerf_keras_tpu.engine.trainer import Trainer as JaxTrainer
from nerf_keras_tpu_torch.engine.trainer import Trainer
from nerf_keras_tpu_torch.ops.rays import pose_spherical
from nerf_keras_tpu_torch.serving import RenderService
from nerf_keras_tpu_torch.utils.png import decode_png

torch.set_num_threads(1)

NEAR, FAR = 2.0, 6.0
KEYS = ("rgb_fine", "depth_fine", "weights_fine", "t_fine")


def _cfg(train_sampler="proposal", **kw):
    base = dict(
        batch_size=16, ns_coarse=8, ns_fine=12, num_layers=4, hidden_dim=32,
        skip_layer=2, l_xyz=4, l_dir=2, compute_dtype="float32", use_pallas=False,
        train_sampler=train_sampler, ema_decay=0.0, learning_rate=5e-3,
        height=8, width=8,
    )
    if train_sampler == "proposal":
        base.update(prop_anneal_steps=10, prop_explore=0.03)
    base.update(kw)
    return NeRFConfig(**base).validate()


def _rays(n, seed=0):
    """Rays from near (0, 0, 4) towards the origin, jittered."""
    rng = np.random.default_rng(seed)
    o = (np.tile([0, 0, 4.0], (n, 1)) + rng.normal(size=(n, 3)) * 0.1).astype(np.float32)
    d = -o / np.linalg.norm(o, axis=-1, keepdims=True) + rng.normal(size=(n, 3)) * 0.2
    return o, (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("levels", [1, 2])
def test_weights_fine_and_t_fine_match_jax(levels):
    extra = dict(prop_levels=2, prop_samples=6) if levels == 2 else {}
    cfg = _cfg(**extra)
    jt = JaxTrainer(cfg, NEAR, FAR)
    o, d = _rays(37)
    want = jt.render_rays(o, d, chunk=16, keys=KEYS)
    tr = Trainer(cfg, NEAR, FAR, device="cpu").replace_params(
        jax.tree_util.tree_map(np.asarray, jt.state.params))
    got = tr.render_rays(o, d, chunk=16, keys=KEYS)
    assert sorted(got) == sorted(KEYS)
    s = cfg.ns_coarse + cfg.ns_fine
    assert got["weights_fine"].shape == (37, s) and got["t_fine"].shape == (37, s)
    assert np.all(np.diff(got["t_fine"], axis=-1) >= 0)
    for k in KEYS:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=1e-4, rtol=0, err_msg=k)
    # The same weights give the served depth.
    np.testing.assert_allclose((got["weights_fine"] * got["t_fine"]).sum(-1),
                               got["depth_fine"], atol=1e-5, rtol=0)
    rgb_only = tr.render_rays(o, d, chunk=16, keys=("rgb_fine",))
    np.testing.assert_array_equal(rgb_only["rgb_fine"], got["rgb_fine"])
    with pytest.raises(ValueError, match="no coarse pass"):
        tr.render_rays(o, d, keys=("weights_coarse",))


def _checkpoint(tmp_path, cfg):
    tr = Trainer(cfg, NEAR, FAR, device="cpu")
    rng = np.random.default_rng(1)
    batch = (rng.uniform(0, 1, (16, 3)).astype(np.float32), *_rays(16, seed=2))
    tr.train_step(batch)
    path = str(tmp_path / f"{cfg.train_sampler}.ckpt.npz")
    tr.save(path, scene={"near": NEAR, "far": FAR, "focal": 9.0})
    return path


def test_sampler_proposal_serves_a_proposal_checkpoint_unchanged(tmp_path):
    cfg = _cfg()
    path = _checkpoint(tmp_path, cfg)
    kw = dict(theta=30.0, phi=-30.0, radius=4.0, height=6, width=7, chunk=16)
    plain = RenderService(cfg, path, device="cpu")
    prop = RenderService(cfg, path, device="cpu", sampler="proposal")
    for map_name in ("rgb", "depth"):
        a = decode_png(plain.render_png(map_name=map_name, **kw))
        b = decode_png(prop.render_png(map_name=map_name, **kw))
        np.testing.assert_array_equal(b, a)
    frame = prop.trainer.render_image(pose_spherical(30.0, -30.0, 4.0), 6, 7, 9.0, chunk=16)
    assert np.isfinite(frame["rgb"]).all()


def test_sampler_proposal_on_a_coarse_checkpoint_still_raises(tmp_path):
    cfg = _cfg("coarse")
    path = _checkpoint(tmp_path, cfg)
    RenderService(cfg, path, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item 4"):
        RenderService(cfg, path, device="cpu", sampler="proposal")
    with pytest.raises(ValueError, match="sampler"):
        RenderService(cfg, path, device="cpu", sampler="distilled")
