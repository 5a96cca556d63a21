"""Device resolution, numeric settings and the render engine's refusals."""

import dataclasses

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
    # The proposal case is its union-free layout: the union layout renders.
    extra = {"prop_union": False} if value == "proposal" else {}
    cfg = dataclasses.replace(CFG, **{field: value}, **extra)
    with pytest.raises(NotImplementedError, match="not ported"):
        make_render_fn(cfg, 2.0, 6.0)
    with pytest.raises(NotImplementedError, match="not ported"):
        Trainer(cfg, 2.0, 6.0, device="cpu")


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
