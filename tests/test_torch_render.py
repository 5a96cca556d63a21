"""The whole serving slice against the JAX package on one checkpoint.

A JAX ``Trainer`` with ``use_pallas=True`` writes a checkpoint and renders
8x8 frames through its K1 Pallas kernel (interpret mode on the CPU); the
port restores the same file and renders the same frames through its K1
wrapper (the plain version on the CPU).  Both run coarse K1 ->
deterministic ``sample_pdf`` -> ``sorted_union`` -> fine K1.

Tolerances (float32).  Coarse pass: rgb atol 1e-4, K1's own bound (the
JAX kernel's ``sin(z + pi/2)`` cos at the top octave); depth atol 1e-3,
that bound on the weights times t <= 6.  Fine pass: its samples come from
inverse-CDF draws that divide by the coarse pdf, so summation-order ulps
move them by up to ~1e-5 (tests/test_torch_ops.py); at the top octave
(2^9 * |d|, |d| <= 1.3 here) that is ~7e-3 rad of phase, hence rgb atol
5e-3 and depth atol 1e-2.  A wrong sample, order or formula errs by 0.1+.
"""

import jax
import numpy as np
import pytest
import torch

from nerf_keras_tpu.config import NeRFConfig
from nerf_keras_tpu.engine.trainer import Trainer as JaxTrainer
from nerf_keras_tpu.ops.rays import pose_spherical
from nerf_keras_tpu.utils.checkpoint import save_checkpoint
from nerf_keras_tpu_torch.engine.trainer import Trainer
from nerf_keras_tpu_torch.utils.checkpoint import resolve_infer_config

# Tier-1 runs several pytest workers on a few cores.  With torch's
# default pool (one OpenMP thread per core) a JAX training test in a
# sibling worker aborted; one thread is plenty at these sizes.
torch.set_num_threads(1)

ATOL = {"rgb_coarse": 1e-4, "depth_coarse": 1e-3, "rgb": 5e-3, "depth": 1e-2}
ARCH = dict(
    batch_size=64, ns_coarse=8, ns_fine=8, num_layers=6, hidden_dim=32,
    skip_layer=4, height=8, width=8, compute_dtype="float32", use_pallas=True,
)
POSE = pose_spherical(30.0, -30.0, 4.0)
FOCAL = 9.6


def _scale_density(state, seed):
    """A denser, less uniform random field than the init (sigma bias +1,
    noise on every leaf) so the coarse weights steer the fine samples."""
    rng = np.random.default_rng(seed)

    def bump(path, x):
        x = np.asarray(x)
        name = jax.tree_util.keystr(path)
        if name.endswith("['sigma']['b']"):
            return x + 1.0
        return x + rng.normal(size=x.shape).astype(np.float32) * 0.05

    params = jax.tree_util.tree_map_with_path(bump, state.params)
    return state._replace(params=params)


@pytest.fixture(scope="module")
def jax_pair(tmp_path_factory):
    cfg = NeRFConfig(**ARCH).validate()
    jt = JaxTrainer(cfg, 2.0, 6.0)
    jt.state = _scale_density(jt.state, 0)
    path = str(tmp_path_factory.mktemp("render") / "m.ckpt.npz")
    save_checkpoint(path, jax.device_get(jt.state), cfg,
                    scene={"near": 2.0, "far": 6.0, "focal": FOCAL})
    return cfg, jt, path


def test_render_image_matches_jax(jax_pair):
    cfg, jt, path = jax_pair
    ref = jt.render_image(POSE, 8, 8, FOCAL, chunk=64, include_coarse=True)
    rcfg, _ = resolve_infer_config(cfg, path)
    pt = Trainer(rcfg, 2.0, 6.0, device="cpu").restore(path)
    out = pt.render_image(POSE, 8, 8, FOCAL, chunk=64, include_coarse=True)
    for k, atol in ATOL.items():
        assert out[k].shape == ((8, 8, 3) if k.startswith("rgb") else (8, 8))
        np.testing.assert_allclose(out[k], ref[k], atol=atol, rtol=0)
    # the frame is not trivially uniform
    assert float(np.std(out["rgb"])) > 1e-3
    assert float(np.std(out["depth"])) > 1e-3


def test_render_image_matches_jax_bf16(tmp_path):
    """bf16 compute, the serving dtype.  Coarse maps and fine rgb at 3e-2
    (bf16 rounding flips, as the K1 bf16 bound).  Fine depth: a flip in
    the coarse weights can move one fine sample across a density edge and
    shift that pixel's depth by ~0.2, so the bound is on the mean (2e-2)
    and on how many pixels exceed 5e-2 (at most 1 in 32)."""
    cfg = NeRFConfig(**{**ARCH, "compute_dtype": "bfloat16"}).validate()
    jt = JaxTrainer(cfg, 2.0, 6.0)
    jt.state = _scale_density(jt.state, 0)
    path = str(tmp_path / "bf16.ckpt.npz")
    save_checkpoint(path, jax.device_get(jt.state), cfg)
    ref = jt.render_image(POSE, 8, 8, FOCAL, chunk=64, include_coarse=True)
    out = Trainer(cfg, 2.0, 6.0, device="cpu").restore(path).render_image(
        POSE, 8, 8, FOCAL, chunk=64, include_coarse=True)
    for k in ("rgb_coarse", "depth_coarse", "rgb"):
        np.testing.assert_allclose(out[k], ref[k], atol=3e-2, rtol=0)
    dd = np.abs(out["depth"] - ref["depth"])
    assert dd.mean() <= 2e-2
    assert np.mean(dd > 5e-2) <= 1 / 32


def test_chunking_and_uint8_do_not_change_the_frame(jax_pair):
    """Padding the last chunk (64 rays in chunks of 24) changes nothing,
    and the device-side uint8 conversion equals the host one."""
    cfg, jt, path = jax_pair
    pt = Trainer(cfg, 2.0, 6.0, device="cpu").restore(path)
    whole = pt.render_image(POSE, 8, 8, FOCAL, chunk=64)
    parts = pt.render_image(POSE, 8, 8, FOCAL, chunk=24)
    np.testing.assert_array_equal(parts["rgb"], whole["rgb"])
    np.testing.assert_array_equal(parts["depth"], whole["depth"])
    u8 = pt.render_image(POSE, 8, 8, FOCAL, chunk=24, uint8_rgb=True,
                         need_depth=False)
    assert set(u8) == {"rgb"} and u8["rgb"].dtype == np.uint8
    np.testing.assert_array_equal(
        u8["rgb"], np.clip(255.0 * whole["rgb"], 0.0, 255.0).astype(np.uint8)
    )
    ref_u8 = jt.render_image(POSE, 8, 8, FOCAL, chunk=64, uint8_rgb=True)
    # 5e-3 (fine rgb bound above) is at most 2 levels of 255
    assert np.abs(u8["rgb"].astype(int) - ref_u8["rgb"].astype(int)).max() <= 2


def test_ema_checkpoint_renders_the_shadow(tmp_path):
    """EMA_DECAY > 0 in the sidecar routes rendering to the ``.ema``
    weights, as the JAX Trainer does; the raw params render differently."""
    cfg = NeRFConfig(**{**ARCH, "ema_decay": 0.9}).validate()
    jt = JaxTrainer(cfg, 2.0, 6.0)
    state = _scale_density(jt.state, 1)
    shadow = _scale_density(state, 2).params
    jt.state = state._replace(ema=shadow)
    path = str(tmp_path / "ema.ckpt.npz")
    save_checkpoint(path, jax.device_get(jt.state), cfg)

    user_cfg = NeRFConfig(**ARCH).validate()  # says nothing about EMA
    rcfg, notes = resolve_infer_config(user_cfg, path)
    assert rcfg.ema_decay == 0.9 and any("EMA" in n for n in notes)
    pt = Trainer(rcfg, 2.0, 6.0, device="cpu").restore(path)
    assert pt.eval_params is pt.ema

    ref = jt.render_image(POSE, 8, 8, FOCAL, chunk=64)
    out = pt.render_image(POSE, 8, 8, FOCAL, chunk=64)
    for k in ("rgb", "depth"):
        np.testing.assert_allclose(out[k], ref[k], atol=ATOL[k], rtol=0)

    raw = Trainer(user_cfg, 2.0, 6.0, device="cpu").restore(path)
    assert raw.ema is None
    assert np.abs(raw.render_image(POSE, 8, 8, FOCAL)["rgb"] - out["rgb"]).max() > 1e-3

    # replace_params resets the shadow to the new params
    pt.replace_params({k: raw.params[k].to_jax_params() for k in ("coarse", "fine")})
    np.testing.assert_array_equal(
        pt.render_image(POSE, 8, 8, FOCAL)["rgb"],
        raw.render_image(POSE, 8, 8, FOCAL)["rgb"],
    )
