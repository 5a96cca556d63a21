"""K1 on the card against its plain version, and the slice on the card.

Marked ``cuda``: without a card every test here skips (decided inside the
fixture, never at import).  This file imports no JAX, so it also runs on
a machine that has only PyTorch:

    python -m pytest -o addopts="" -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Weights are glorot with nonzero random biases (``randomize_biases_``), so
the kernel's bias epilogue and the pack's bias offsets are under test.
Tolerance (as chip_smoke.py): both sides round operands to bf16 and
accumulate in f32; summation order can flip a hidden activation's bf16
rounding, so rgb/weights max |diff| <= TOL_MAX and mean |diff| <= TOL_MEAN.
"""

import numpy as np
import pytest
import torch

from nerf_keras_tpu.config import NeRFConfig
from nerf_keras_tpu_torch.engine.trainer import Trainer
from nerf_keras_tpu_torch.models.mlp import (
    NeRFMLP,
    random_params,
    randomize_biases_,
)
from nerf_keras_tpu_torch.ops.kernels import fused_render as k1
from nerf_keras_tpu_torch.ops.rays import pose_spherical
from nerf_keras_tpu_torch.utils.checkpoint import save_params_npz

pytestmark = pytest.mark.cuda

TOL_MAX = 5e-3
TOL_MEAN = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _rays(dev, b, s, seed=0):
    gen = torch.Generator().manual_seed(seed)
    o = (torch.randn((b, 3), generator=gen) * 0.3 + torch.tensor([0.0, 0.0, 4.0]))
    d = torch.randn((b, 3), generator=gen)
    t = torch.sort(torch.rand((b, s), generator=gen) * 4.0 + 2.0, dim=-1).values
    return o.to(dev), d.to(dev), t.to(dev).contiguous()


@pytest.mark.parametrize("arch,b,s", [
    ((8, 256, 4), 4096, 64),
    ((8, 256, 4), 1024, 192),
    ((8, 256, 4), 1000, 24),   # several rays per block, ragged last block
    ((8, 256, 4), 333, 100),   # a ragged last tile inside each ray
    ((5, 64, 4), 257, 40),     # skip on the last layer widens the heads
])
def test_k1_matches_plain(dev, arch, b, s):
    num_layers, hidden, skip = arch
    gen = torch.Generator().manual_seed(1)
    mlp = randomize_biases_(
        NeRFMLP(num_layers=num_layers, hidden_dim=hidden, skip_layer=skip,
                generator=gen, device=dev),
        gen,
    )
    o, d, t = _rays(dev, b, s)
    before = k1.launches
    with torch.inference_mode():
        rgb, w = k1.render_rays_fused(mlp, o, d, t, skip_layer=skip)
        torch.cuda.synchronize()
        rgb_p, w_p = k1.render_rays_reference(mlp, o, d, t, skip_layer=skip)
    assert k1.launches == before + 1
    assert rgb.shape == (b, 3) and w.shape == (b, s)
    assert bool(torch.isfinite(rgb).all() and torch.isfinite(w).all())
    assert float((rgb - rgb_p).abs().max()) <= TOL_MAX
    assert float((rgb - rgb_p).abs().mean()) <= TOL_MEAN
    assert float((w - w_p).abs().max()) <= TOL_MAX
    assert float((w - w_p).abs().mean()) <= TOL_MEAN


def test_k1_checks_its_inputs(dev):
    mlp = NeRFMLP(num_layers=2, hidden_dim=32, device=dev)
    o, d, t = _rays(dev, 16, 8)
    with pytest.raises(ValueError, match="contiguous"):
        k1.render_rays_fused(mlp, o, d, t.t().contiguous().t())
    with pytest.raises(TypeError, match="float32"):
        k1.render_rays_fused(mlp, o.double(), d, t)
    with pytest.raises(ValueError, match="shape"):
        k1.render_rays_fused(mlp, o[:8], d, t)
    mlp32 = NeRFMLP(num_layers=2, hidden_dim=32, compute_dtype=torch.float32,
                    device=dev)
    with pytest.raises(NotImplementedError, match="bf16"):
        k1.render_rays_fused(mlp32, o, d, t)
    cpu_mlp = NeRFMLP(num_layers=2, hidden_dim=32)
    with pytest.raises(ValueError, match="parameters"):
        k1.render_rays_fused(cpu_mlp, o, d, t)


def test_trainer_frame_on_card_matches_cpu(dev, tmp_path):
    """The served path (two K1 launches per chunk) against the plain path
    on the CPU, same checkpoint; rgb TOL_MAX and depth 2e-2, as
    chip_smoke.py's frame check (the fine samples follow the coarse
    weights)."""
    cfg = NeRFConfig(num_layers=8, hidden_dim=256, ns_coarse=64, ns_fine=128,
                     height=16, width=16).validate()
    path = str(tmp_path / "r.ckpt.npz")
    save_params_npz(path, random_params(cfg, seed=0), cfg)
    pose = pose_spherical(45.0, -30.0, 4.0)
    gpu = Trainer(cfg, 2.0, 6.0, device="cuda").restore(path)
    before = k1.launches
    out = gpu.render_image(pose, 16, 16, 19.2, chunk=100)
    assert k1.launches == before + 2 * 3  # 256 rays in chunks of 100
    ref = Trainer(cfg, 2.0, 6.0, device="cpu").restore(path).render_image(
        pose, 16, 16, 19.2, chunk=100)
    assert np.abs(out["rgb"] - ref["rgb"]).max() <= TOL_MAX
    assert np.abs(out["depth"] - ref["depth"]).max() <= 2e-2
