"""The port's NDC rays (``ops/rays.ndc_rays``, ``data/pipeline.dataset_to_ndc``,
``Trainer.pose_rays`` with ``NDC``) against the JAX package.

``ndc_rays`` keeps the JAX order of float32 operations (shift onto the near
plane, then divide by ``o_z`` and ``d_z``), so the rays agree to 1e-6
(they come out bit-equal here).  An NDC checkpoint renders a forward-facing
frame as the JAX Trainer renders it (rgb 5e-3, the fine samples following
the coarse weights as in ``tests/test_torch_render.py``) and refuses any
pose whose rays are not all ``d_z < 0``, in the Trainer and behind the
server.
"""

import jax
import numpy as np
import pytest
import torch

from nerf_keras_tpu.config import NeRFConfig
from nerf_keras_tpu.data import pipeline as jpipe
from nerf_keras_tpu.engine.trainer import Trainer as JaxTrainer
from nerf_keras_tpu.ops.rays import NDC_NEAR_PLANE as JAX_NEAR_PLANE
from nerf_keras_tpu.ops.rays import ndc_rays as jax_ndc_rays
from nerf_keras_tpu.utils.checkpoint import save_checkpoint
from nerf_keras_tpu_torch.data import pipeline as ppipe
from nerf_keras_tpu_torch.engine.trainer import Trainer
from nerf_keras_tpu_torch.ops.rays import NDC_NEAR_PLANE, ndc_rays, pose_spherical
from nerf_keras_tpu_torch.serving import RenderService

torch.set_num_threads(1)

CFG = NeRFConfig(batch_size=64, ns_coarse=8, ns_fine=8, num_layers=4, hidden_dim=32,
                 skip_layer=2, l_xyz=4, l_dir=2, height=12, width=16,
                 compute_dtype="float32", ndc=True).validate()
# A camera at z=1.5 looking down -z (tilted a little): every ray d_z < 0.
FORWARD = np.array([[0.995, 0.0, 0.0998, 0.1], [0.0, 1.0, 0.0, -0.05],
                    [-0.0998, 0.0, 0.995, 1.5]], np.float32)


def _forward_rays(seed, n):
    rng = np.random.default_rng(seed)
    o = (rng.normal(size=(n, 3)) * 0.3).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 0.3
    return o, d


@pytest.mark.parametrize("shape", [(7,), (5, 9)])
@pytest.mark.parametrize("near", [1.0, 0.5])
def test_ndc_rays_match_jax(shape, near):
    o, d = _forward_rays(0, int(np.prod(shape)))
    o, d = o.reshape(*shape, 3), d.reshape(*shape, 3)
    ours = ndc_rays(12, 16, 13.7, near, o, d)
    theirs = jax_ndc_rays(12, 16, 13.7, near, o, d)
    assert NDC_NEAR_PLANE == JAX_NEAR_PLANE
    for a, b in zip(ours, theirs):
        assert a.dtype == torch.float32 and tuple(a.shape) == (*shape, 3)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    # t'=0 is the near plane: the shifted origins' NDC z is -1.
    np.testing.assert_allclose(ours[0][..., 2].numpy(), -1.0, atol=1e-6)


def test_dataset_to_ndc_matches_jax():
    rng = np.random.default_rng(1)
    images = rng.uniform(size=(2, 12, 16, 3)).astype(np.float32)
    poses = np.stack([FORWARD, FORWARD + np.float32(0.05)])
    ours = ppipe.dataset_to_ndc(ppipe.build_ray_dataset(images, poses, 12, 16, 14.0,
                                                        1.2, 3.1))
    theirs = jpipe.dataset_to_ndc(jpipe.build_ray_dataset(images, poses, 12, 16, 14.0,
                                                          1.2, 3.1))
    assert (ours.near, ours.far) == (theirs.near, theirs.far) == (0.0, 1.0)
    assert (ours.focal, ours.height, ours.width) == (theirs.focal, 12, 16)
    np.testing.assert_array_equal(ours.pixels, theirs.pixels)
    for a, b in ((ours.origins, theirs.origins), (ours.directions, theirs.directions)):
        assert a.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def ndc_ckpt(tmp_path_factory):
    """A JAX NDC checkpoint of a denser field than the init (bounds [0, 1])."""
    jt = JaxTrainer(CFG, 0.0, 1.0)
    rng = np.random.default_rng(0)

    def bump(path, x):
        x = np.asarray(x) + rng.normal(size=x.shape).astype(np.float32) * 0.05
        return x + 1.0 if jax.tree_util.keystr(path).endswith("['sigma']['b']") else x

    state = jax.device_get(jt.state)
    state = state._replace(params=jax.tree_util.tree_map_with_path(bump, state.params))
    path = str(tmp_path_factory.mktemp("ndc") / "ndc.ckpt.npz")
    save_checkpoint(path, state, CFG, scene={"near": 0.0, "far": 1.0, "focal": 14.0,
                                             "ndc": True})
    return path


def test_pose_rays_and_frame_match_jax(ndc_ckpt):
    jt = JaxTrainer(CFG, 0.0, 1.0).restore(ndc_ckpt)
    pt = Trainer(CFG, 0.0, 1.0, device="cpu").restore(ndc_ckpt)
    for a, b in zip(pt.pose_rays(FORWARD, 12, 16, 14.0), jt.pose_rays(FORWARD, 12, 16, 14.0)):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-6)
    ours = pt.render_image(FORWARD, 12, 16, 14.0)
    theirs = jt.render_image(FORWARD, 12, 16, 14.0)
    np.testing.assert_allclose(ours["rgb"], np.asarray(theirs["rgb"]), atol=5e-3, rtol=0)
    assert ours["rgb"].std() > 1e-3 and np.isfinite(ours["depth"]).all()


def test_sideways_pose_raises_like_jax(ndc_ckpt):
    orbit = pose_spherical(30.0, 0.0, 4.0)  # level: half the rays point up
    pt = Trainer(CFG, 0.0, 1.0, device="cpu").restore(ndc_ckpt)
    jt = JaxTrainer(CFG, 0.0, 1.0).restore(ndc_ckpt)
    for tr in (pt, jt):
        with pytest.raises(ValueError, match="forward-facing camera") as err:
            tr.pose_rays(orbit, 12, 16, 14.0)
        assert "--path spiral" in str(err.value)
    with pytest.raises(ValueError, match="forward-facing camera"):
        pt.render_image(orbit, 12, 16, 14.0)


def test_server_refuses_the_orbit_on_an_ndc_checkpoint(ndc_ckpt):
    """The server's requests are orbit poses: an NDC checkpoint fails
    loudly on one whose rays are not all forward-facing (not with NaN
    frames), as behind the JAX server."""
    service = RenderService(CFG, ndc_ckpt, device="cpu")
    assert service.cfg.ndc and (service.near, service.far) == (0.0, 1.0)
    with pytest.raises(ValueError, match="forward-facing camera"):
        service.render_png(30.0, 0.0, 4.0, 12, 16)
    assert service.requests == 0
