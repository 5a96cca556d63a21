"""Device resolution, numeric settings and the render engine's refusals."""

import dataclasses

import jax
import pytest
import torch

from nerf_keras_tpu.config import NeRFConfig
from nerf_keras_tpu_torch import runtime
from nerf_keras_tpu_torch.engine.step import make_render_fn
from nerf_keras_tpu_torch.engine.trainer import Trainer, rgb_to_u8
from nerf_keras_tpu_torch.profile_render import union_us

# Tier-1 runs several pytest workers on a few cores.  With torch's
# default pool (one OpenMP thread per core) a JAX training test in a
# sibling worker aborted; one thread is plenty at these sizes.
torch.set_num_threads(1)

CFG = NeRFConfig(batch_size=64, ns_coarse=4, ns_fine=4, num_layers=2,
                 hidden_dim=16, height=4, width=4).validate()


def test_resolve_device_is_explicit_and_pins_fp32(monkeypatch):
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    assert runtime.resolve_device("cpu") == torch.device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    # No silent CPU: the default is the card, and without one it raises.
    for name in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            runtime.resolve_device(name)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(CFG, 2.0, 6.0)
    with pytest.raises(ValueError, match="unsupported device"):
        runtime.resolve_device("meta")


@pytest.mark.parametrize("field,value", [
    ("train_sampler", "proposal"), ("ndc", True), ("batch_norm", True),
])
def test_render_refuses_unported_configs(field, value):
    """Configs this test once held as refused render now: the union-free
    proposal layout (the ``proposal`` case: the render function and the
    Trainer build, and the frame of JAX-initialized weights matches the JAX
    Trainer's), BatchNorm and NDC."""
    import numpy as np
    from nerf_keras_tpu.engine.trainer import Trainer as JaxTrainer

    if field == "batch_norm":
        # BatchNorm renders (the plain MLP on every device); what both
        # configs refuse with it is an explicit USE_PALLAS.
        from nerf_keras_tpu_torch.config import NeRFConfig as PortConfig

        for config in (NeRFConfig, PortConfig):
            with pytest.raises(ValueError, match="incompatible with batch_norm"):
                config(batch_norm=True, use_pallas=True).validate()
        cfg = dataclasses.replace(CFG, batch_norm=True)
        make_render_fn(cfg, 2.0, 6.0)
        Trainer(cfg, 2.0, 6.0, device="cpu")
        return
    if field == "ndc":
        # NDC renders: the render function and the Trainer build, and an
        # NDC frame of a forward-facing camera matches the JAX Trainer's.
        cfg = dataclasses.replace(CFG, ndc=True)
        make_render_fn(cfg, 0.0, 1.0)
        jt = JaxTrainer(cfg, 0.0, 1.0)
        pt = Trainer(cfg, 0.0, 1.0, device="cpu")
        pt.replace_params(jax.device_get(jt.state.params))
        pose = np.array([[1, 0, 0, 0.1], [0, 1, 0, 0], [0, 0, 1, 1.5]], np.float32)
        np.testing.assert_allclose(pt.render_image(pose, 4, 4, 5.0)["rgb"],
                                   np.asarray(jt.render_image(pose, 4, 4, 5.0)["rgb"]),
                                   atol=5e-3, rtol=0)
        return
    # The union-free layout: the fine pass sees the 8 placed samples alone.
    cfg = dataclasses.replace(CFG, train_sampler="proposal", prop_union=False,
                              prop_explore=0.1, ns_fine=8).validate()
    make_render_fn(cfg, 2.0, 6.0)
    jt = JaxTrainer(cfg, 2.0, 6.0)
    pt = Trainer(cfg, 2.0, 6.0, device="cpu")
    pt.replace_params(jax.device_get(jt.state.params))
    pose = np.array([[1, 0, 0, 0.1], [0, 1, 0, 0], [0, 0, 1, 4.0]], np.float32)
    got = pt.render_image(pose, 4, 4, 5.0)
    np.testing.assert_allclose(got["rgb"], np.asarray(jt.render_image(pose, 4, 4, 5.0)["rgb"]),
                               atol=5e-3, rtol=0)
    assert np.isfinite(got["depth"]).all()


def test_rgb_to_u8_truncates_like_the_host():
    x = torch.tensor([-0.5, 0.0, 0.5, 0.999, 1.0, 1.7, 0.1234])
    ref = torch.clamp(255.0 * x, 0.0, 255.0).numpy().astype("uint8")
    assert rgb_to_u8(x).numpy().tolist() == ref.tolist()
    assert rgb_to_u8(x).dtype == torch.uint8


@pytest.mark.parametrize("intervals,busy", [
    ([], 0.0),
    ([(0.0, 2.0), (5.0, 6.0)], 3.0),            # disjoint
    ([(4.0, 6.0), (0.0, 3.0), (2.0, 5.0)], 6.0),  # overlapping, unsorted
    ([(0.0, 10.0), (2.0, 3.0)], 10.0),          # nested
])
def test_profile_busy_time_is_the_interval_union(intervals, busy):
    """The device idle share counts overlapping kernels once."""
    assert union_us(intervals) == busy
