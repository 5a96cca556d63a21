"""K1-K7 on the card against their plain versions, and the slices on the card.

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

import hashlib

import k4_adversarial
import numpy as np
import pytest
import torch

from nerf_keras_tpu_torch.config import NeRFConfig
from nerf_keras_tpu_torch.engine import step as pstep
from nerf_keras_tpu_torch.engine.trainer import Trainer
from nerf_keras_tpu_torch.models.mlp import (
    NeRFMLP,
    random_params,
    randomize_biases_,
)
from nerf_keras_tpu_torch.ops.encoding import encode_position
from nerf_keras_tpu_torch.ops.kernels import fused_f32
from nerf_keras_tpu_torch.ops.kernels import fused_mlp as k5
from nerf_keras_tpu_torch.ops.kernels import launch_counts
from nerf_keras_tpu_torch.ops.kernels import fused_render as k1
from nerf_keras_tpu_torch.ops.kernels import pdf_union as k7
from nerf_keras_tpu_torch.ops.kernels import quant_render as k4
from nerf_keras_tpu_torch.ops import quant
from nerf_keras_tpu_torch.ops.rays import pose_spherical
from nerf_keras_tpu_torch.runtime import device_ms_by_kernel
from nerf_keras_tpu_torch.utils.checkpoint import save_params_npz

pytestmark = pytest.mark.cuda

TOL_MAX = 5e-3
TOL_MEAN = 1e-4
K2_TOL_REL = 2e-2
# K5's raw predictions (rgb logits, sigma: unbounded) against the plain MLP,
# and its gradients (per leaf, dx_enc, dd_enc) as relative L2 errors; the
# reasons are chip_smoke.py's.
K5_PREDS_MAX = 5e-2
K5_PREDS_MEAN = 1e-3
K5_TOL_REL = 2e-2
# STOP_PDF_GRADIENT=false: the coarse leaves' gradient runs through
# sample_pdf's 1/denominator, which amplifies the bf16 differences of the
# fine pass's dx_enc (chip_smoke.py: PDF_COARSE_TOL_REL).
PDF_COARSE_TOL_REL = 0.5
# The f32 kernels against their plain f32 versions (TF32 off): relative L2
# on every output and gradient (chip_smoke.py: F32_TOL_REL).
F32_TOL_REL = 1e-5


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
    ((8, 256, 4), 4096, 128),  # the union-free fine pass: one ray a block
    ((8, 256, 4), 4096, 32),   # the union-free aux pass
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
    # A float32 MLP runs the f32 K1, held to its plain f32 version.
    mlp32 = NeRFMLP(num_layers=2, hidden_dim=32, compute_dtype=torch.float32,
                    device=dev)
    with torch.no_grad():
        got = k1.render_rays_fused(mlp32, o, d, t)
        want = k1.render_rays_reference(mlp32, o, d, t)
    for a, b in zip(got, want):
        assert _rel_l2(a, b) <= F32_TOL_REL
    cpu_mlp = NeRFMLP(num_layers=2, hidden_dim=32)
    with pytest.raises(ValueError, match="parameters"):
        k1.render_rays_fused(cpu_mlp, o, d, t)


@pytest.mark.parametrize("b,s", [(333, 100), (1000, 24), (257, 160), (4096, 128),
                                 (4096, 32)])
def test_k1_training_residuals_match_plain(dev, b, s):
    """K1 in training mode writes the bf16 position encodings (exactly the
    plain encode, rounded) and the raw predictions (the plain MLP on them,
    TOL_MAX), and its rgb/weights equal the forward-only launch's."""
    gen = torch.Generator().manual_seed(3)
    mlp = randomize_biases_(NeRFMLP(generator=gen, device=dev), gen)
    o, d, t = _rays(dev, b, s, seed=1)
    with torch.no_grad():
        rgb, w, x_enc, preds = k1.launch_k1(mlp, o, d, t, 10, 4, train=True)
        rgb0, w0, _, _ = k1.launch_k1(mlp, o, d, t, 10, 4, train=False)
        torch.cuda.synchronize()
        pts = o[:, None, :] + d[:, None, :] * t[..., None]
        x_plain = encode_position(pts, 10).reshape(b * s, -1)
        d_plain = encode_position(d, 4)[:, None, :].expand(b, s, -1).reshape(b * s, -1)
        preds_plain = mlp(x_enc.float(), d_plain)
    assert torch.equal(rgb, rgb0) and torch.equal(w, w0)
    assert x_enc.dtype == torch.bfloat16 and x_enc.shape == (b * s, 63)
    assert float((x_enc.float() - x_plain.to(torch.bfloat16).float()).abs().max()) <= 1e-2
    assert float((preds - preds_plain).abs().max()) <= TOL_MAX * 4
    assert float((preds - preds_plain).abs().mean()) <= TOL_MEAN


def _rel_l2(a, b):
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp_min(1e-30))


def _kernel_grads(mlp, o, d, t, g_rgb, g_w):
    """Gradients of <rgb, g_rgb> + <weights, g_w> through render_rays_fused
    (K1 in training mode, K2); ``g_w=None`` leaves the weights cotangent
    unread."""
    rgb, w = k1.render_rays_fused(mlp, o, d, t, weights_grad=g_w is not None)
    outs, cots = ([rgb, w], [g_rgb, g_w]) if g_w is not None else ([rgb], [g_rgb])
    return list(torch.autograd.grad(outs, list(mlp.parameters()), cots))


@pytest.mark.parametrize("with_gw", [True, False])
@pytest.mark.parametrize("b,s", [(333, 100), (1000, 24), (257, 160), (4096, 128),
                                 (4096, 32)])
def test_k2_matches_plain_vjp(dev, b, s, with_gw):
    """K2's gradients against autograd of the plain K1, per leaf: relative
    L2 error <= K2_TOL_REL (see chip_smoke.py for the measured errors);
    one K1 and one K2 launch."""
    gen = torch.Generator().manual_seed(4)
    mlp = randomize_biases_(NeRFMLP(generator=gen, device=dev), gen)
    o, d, t = _rays(dev, b, s, seed=2)
    g_rgb = torch.randn((b, 3), generator=gen).to(dev)
    g_w = torch.randn((b, s), generator=gen).to(dev) if with_gw else None
    before = (k1.launches, k1.bwd_launches)
    got = _kernel_grads(mlp, o, d, t, g_rgb, g_w)
    torch.cuda.synchronize()
    assert (k1.launches, k1.bwd_launches) == (before[0] + 1, before[1] + 1)
    want = k1.render_rays_reference_vjp(mlp, o, d, t, g_rgb, g_w)
    for (name, _), g, r in zip(mlp.named_parameters(), got, want):
        assert g.shape == r.shape, name
        assert bool(torch.isfinite(g).all()), name
        assert _rel_l2(g, r) <= K2_TOL_REL, (name, _rel_l2(g, r))


def test_k2_is_deterministic(dev):
    """No atomics: the same inputs give bit-identical gradients."""
    gen = torch.Generator().manual_seed(5)
    mlp = randomize_biases_(NeRFMLP(generator=gen, device=dev), gen)
    o, d, t = _rays(dev, 300, 64, seed=3)
    g_rgb = torch.randn((300, 3), generator=gen).to(dev)
    g_w = torch.randn((300, 64), generator=gen).to(dev)
    a = _kernel_grads(mlp, o, d, t, g_rgb, g_w)
    b = _kernel_grads(mlp, o, d, t, g_rgb, g_w)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_k2_chunks_of_rays(dev, monkeypatch):
    """A workspace budget that forces several chunks of whole rays (a
    ragged last one) gives K2's one-chunk gradients within K2's gate, and
    K3 equals K2 bit for bit at that budget."""
    gen = torch.Generator().manual_seed(14)
    mlp = randomize_biases_(NeRFMLP(generator=gen, device=dev), gen)
    b, s = 333, 100
    o, d, t = _rays(dev, b, s, seed=8)
    g_rgb = torch.randn((b, 3), generator=gen).to(dev)
    g_w = torch.randn((b, s), generator=gen).to(dev)
    with torch.no_grad():
        _, _, x_enc, preds = k1.launch_k1(mlp, o, d, t, 10, 4, train=True)
        one = k1.launch_k2(mlp, x_enc, d, t, preds, g_rgb, g_w, 10, 4)
        monkeypatch.setattr(k1, "DW_CHUNK_BYTES", 64 * 128 * 10_112)
        plan = k1.chunk_plan(b, s, 10_112)
        assert len(plan) >= 3 and plan[-1][1] < plan[0][1]
        got = k1.launch_k2(mlp, x_enc, d, t, preds, g_rgb, g_w, 10, 4)
        k3 = k1.launch_k3(mlp, o, d, t, preds, g_rgb, g_w, 10, 4)
    for x, y, z in zip(got, one, k3):
        assert _rel_l2(x, y) <= K2_TOL_REL
        assert torch.equal(x, z)


def test_autograd_seam_on_card(dev):
    """render_rays_fused under autograd: the weights detached unless
    weights_grad; .backward() fills each parameter's grad with K2's
    gradients; without grad it launches K1 alone."""
    gen = torch.Generator().manual_seed(6)
    mlp = randomize_biases_(NeRFMLP(num_layers=4, hidden_dim=64, generator=gen,
                                    device=dev), gen)
    o, d, t = _rays(dev, 200, 40, seed=4)
    g_w = torch.randn((200, 40), generator=gen).to(dev)
    for weights_grad in (False, True):
        mlp.zero_grad(set_to_none=True)
        rgb, w = k1.render_rays_fused(mlp, o, d, t, weights_grad=weights_grad)
        assert w.requires_grad == weights_grad
        loss = rgb.square().sum() + ((w * g_w).sum() if weights_grad else 0.0)
        loss.backward()
        want = _kernel_grads(mlp, o, d, t, 2.0 * rgb.detach(),
                             g_w if weights_grad else None)
        for p, g in zip(mlp.parameters(), want):
            assert torch.equal(p.grad, g)
    before = (k1.launches, k1.bwd_launches)
    with torch.no_grad():
        k1.render_rays_fused(mlp, o, d, t)
    assert (k1.launches, k1.bwd_launches) == (before[0] + 1, before[1])


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


def _k5_setup(dev, arch, n, seed):
    """An MLP with random biases and N samples' bf16 encodings (points
    along random rays from near the camera ring, unit directions) and a
    cotangent for the raw predictions."""
    num_layers, hidden, skip = arch
    gen = torch.Generator().manual_seed(seed)
    mlp = randomize_biases_(NeRFMLP(num_layers=num_layers, hidden_dim=hidden,
                                    skip_layer=skip, generator=gen, device=dev), gen)
    o, d, t = _rays(dev, n, 1, seed)
    x_enc = encode_position(o + d * t, 10).to(torch.bfloat16)
    d_enc = encode_position(d / d.norm(dim=-1, keepdim=True), 4).to(torch.bfloat16)
    g = (torch.randn((n, 4), generator=gen) * 1e-2).to(dev)
    return mlp, x_enc.contiguous(), d_enc.contiguous(), g


@pytest.mark.parametrize("arch,n", [
    ((8, 256, 4), 4096),
    ((8, 256, 4), 1000),   # a ragged last tile
    ((5, 64, 4), 257),     # skip on the last layer widens the heads
])
def test_k5_forward_matches_plain(dev, arch, n):
    mlp, x_enc, d_enc, _ = _k5_setup(dev, arch, n, seed=7)
    before = k5.launches
    with torch.no_grad():
        out = k5.apply_nerf_mlp_fused(mlp, x_enc, d_enc, need_input_grads=False)
        torch.cuda.synchronize()
        want = mlp(x_enc, d_enc)
    assert k5.launches == before + 1
    assert out.shape == (n, 4) and out.dtype == torch.float32
    assert bool(torch.isfinite(out).all())
    assert float((out - want).abs().max()) <= K5_PREDS_MAX
    assert float((out - want).abs().mean()) <= K5_PREDS_MEAN


@pytest.mark.parametrize("need", [True, False])
@pytest.mark.parametrize("arch,n", [
    ((8, 256, 4), 3000),   # ragged
    ((5, 64, 4), 257),
    ((4, 64, 1), 130),     # a skip after every layer but the first
])
def test_k5_backward_matches_plain(dev, arch, n, need):
    """Per-leaf gradients, and with need_input_grads dx_enc/dd_enc (bf16),
    against autograd of the plain MLP; one K5 forward and one backward."""
    mlp, x_enc, d_enc, g = _k5_setup(dev, arch, n, seed=8)
    x = x_enc.clone().requires_grad_(True)
    d = d_enc.clone().requires_grad_(True)
    params = list(mlp.parameters())
    before = (k5.launches, k5.bwd_launches)
    out = k5.apply_nerf_mlp_fused(mlp, x, d, need_input_grads=need)
    got = torch.autograd.grad([out], params + [x, d], [g], allow_unused=True)
    torch.cuda.synchronize()
    assert (k5.launches, k5.bwd_launches) == (before[0] + 1, before[1] + 1)
    want, dx, dd = k5.apply_nerf_mlp_reference_vjp(mlp, x_enc, d_enc, g, need)
    for (name, _), a, b in zip(mlp.named_parameters(), got, want):
        assert a.shape == b.shape and bool(torch.isfinite(a).all()), name
        assert _rel_l2(a, b) <= K5_TOL_REL, (name, _rel_l2(a, b))
    if not need:
        assert got[-2] is None and got[-1] is None
        return
    assert got[-2].dtype == torch.bfloat16 and got[-1].dtype == torch.bfloat16
    assert _rel_l2(got[-2].float(), dx.float()) <= K5_TOL_REL
    assert _rel_l2(got[-1].float(), dd.float()) <= K5_TOL_REL


def test_k5_backward_is_deterministic(dev):
    """No atomics: the same inputs give bit-identical gradients."""
    mlp, x_enc, d_enc, g = _k5_setup(dev, (8, 256, 4), 2000, seed=9)
    runs = [k5.launch_k5_bwd(mlp, x_enc, d_enc, g, True, True) for _ in range(2)]
    (ga, dxa, dda), (gb, dxb, ddb) = runs
    assert all(torch.equal(a, b) for a, b in zip(ga, gb))
    assert torch.equal(dxa, dxb) and torch.equal(dda, ddb)


def test_k5_chunks_of_samples(dev, monkeypatch):
    """A workspace budget that forces several chunks of samples (a ragged
    last one) gives the one-chunk gradients, dx_enc and dd_enc within K5's
    gate."""
    mlp, x_enc, d_enc, g = _k5_setup(dev, (8, 256, 4), 3000, seed=10)
    one = k5.launch_k5_bwd(mlp, x_enc, d_enc, g, True, True)
    monkeypatch.setattr(k1, "DW_CHUNK_BYTES", 8 * 128 * 10_112)
    plan = k1.chunk_plan(3000, 1, 10_112)
    assert len(plan) >= 3 and plan[-1][1] < plan[0][1]
    got = k5.launch_k5_bwd(mlp, x_enc, d_enc, g, True, True)
    for a, b in zip(got[0], one[0]):
        assert _rel_l2(a, b) <= K5_TOL_REL
    for a, b in zip(got[1:], one[1:]):
        assert _rel_l2(a.float(), b.float()) <= K5_TOL_REL


def test_k5_takes_only_instantiated_widths(dev):
    """Its name is historical: hidden 96 runs on the pack zero-padded to the
    128 instantiation, held to the plain version at K5's gates (forward,
    every leaf, dx_enc and dd_enc)."""
    mlp, x_enc, d_enc, g = _k5_setup(dev, (4, 96, 2), 256, seed=11)
    with torch.no_grad():
        out = k5.launch_k5_fwd(mlp, x_enc, d_enc)
        got, dx, dd = k5.launch_k5_bwd(mlp, x_enc, d_enc, g, True, True)
        torch.cuda.synchronize()
        want_out = mlp(x_enc, d_enc)
    assert float((out - want_out).abs().max()) <= K5_PREDS_MAX
    assert float((out - want_out).abs().mean()) <= K5_PREDS_MEAN
    want, want_dx, want_dd = k5.apply_nerf_mlp_reference_vjp(mlp, x_enc, d_enc, g, True)
    for (name, p), a, b in zip(mlp.named_parameters(), got, want):
        assert a.shape == p.shape and _rel_l2(a, b) <= K5_TOL_REL, name
    assert _rel_l2(dx.float(), want_dx.float()) <= K5_TOL_REL
    assert _rel_l2(dd.float(), want_dd.float()) <= K5_TOL_REL


def _parity_cfg(stop: bool) -> NeRFConfig:
    return NeRFConfig(batch_size=256, ns_coarse=64, ns_fine=128, num_layers=8,
                      hidden_dim=256, skip_layer=4, stop_pdf_gradient=stop,
                      distortion_loss_mult=1e-4).validate()


def _plain_render_pass(mlp, o, d, t, weights_grad):
    rgb, w = k1.render_rays_reference(mlp, o, d, t)
    return rgb, w if weights_grad else w.detach()


@pytest.mark.parametrize("stop", [True, False])
def test_parity_step_kernel_path_matches_plain(dev, stop):
    """One parity step's gradients, kernel path (K1/K2, or K5) against the
    plain path on the card with the same draws: per leaf relative L2 <=
    K2_TOL_REL, the coarse leaves without STOP_PDF_GRADIENT <=
    PDF_COARSE_TOL_REL (chip_smoke.py reports the measured errors)."""
    cfg = _parity_cfg(stop)
    tr = Trainer(cfg, 2.0, 6.0, device="cuda")
    for m in tr.params.values():
        randomize_biases_(m, torch.Generator().manual_seed(10))
    o, d, _ = _rays(dev, cfg.batch_size, 2, seed=10)
    images = torch.rand((cfg.batch_size, 3), generator=torch.Generator().manual_seed(11)).to(dev)
    gen = torch.Generator(device="cuda").manual_seed(12)
    t_vals = pstep.draw_t_vals(cfg, 2.0, 6.0, (cfg.batch_size,), dev,
                               noise=torch.rand((cfg.batch_size, cfg.ns_coarse),
                                                generator=gen, device="cuda"))
    noise = torch.rand((cfg.batch_size, cfg.ns_fine), generator=gen, device="cuda")
    params = pstep.params_of(tr.params)
    grads = []
    for plain in (False, True):
        loss_fn = pstep.make_loss_fn(
            cfg, 2.0, 6.0, render_pass=_plain_render_pass if plain else None,
            mlp_fn=(lambda mlp, x, dd: mlp(x, dd)) if plain else None)
        for p in params:
            p.grad = None
        loss, _ = loss_fn(tr.params, images, o, d, t_vals, 0, noise=noise)
        loss.backward()
        grads.append([p.grad.clone() for p in params])
    n_coarse = len(list(tr.params["coarse"].parameters()))  # params_of: sorted names
    for i, (a, b) in enumerate(zip(*grads)):
        tol = PDF_COARSE_TOL_REL if (not stop and i < n_coarse) else K2_TOL_REL
        assert _rel_l2(a, b) <= tol, (i, _rel_l2(a, b))


@pytest.mark.parametrize("stop", [True, False])
def test_parity_step_launch_counts(dev, stop):
    """STOP_PDF_GRADIENT: two K1 and two K2 launches per step, no K5;
    without it two K5 forward and two K5 backward launches, no K1/K2."""
    cfg = _parity_cfg(stop)
    tr = Trainer(cfg, 2.0, 6.0, device="cuda")
    o, d, _ = _rays(dev, cfg.batch_size, 2, seed=13)
    batch = (torch.rand((cfg.batch_size, 3), device=dev), o, d / d.norm(dim=-1, keepdim=True))
    for _ in range(2):
        before = (k1.launches, k1.bwd_launches, k5.launches, k5.bwd_launches)
        loss = float(tr.train_step(batch)["loss"])
        grew = tuple(a - b for a, b in zip(
            (k1.launches, k1.bwd_launches, k5.launches, k5.bwd_launches), before))
        assert grew == ((2, 2, 0, 0) if stop else (0, 0, 2, 2))
        assert np.isfinite(loss)


def _k4_setup(dev, arch, b, s, seed):
    """A random-bias MLP, rays, and its qparams calibrated on the rays'
    own samples (``quant.mlp_calibration_absmax`` -> ``quantize_mlp``)."""
    num_layers, hidden, skip = arch
    gen = torch.Generator().manual_seed(seed)
    mlp = randomize_biases_(NeRFMLP(num_layers=num_layers, hidden_dim=hidden,
                                    skip_layer=skip, generator=gen, device=dev), gen)
    o, d, t = _rays(dev, b, s, seed)
    tree = quant.mlp_tree(mlp)
    pts = o[:, None, :] + d[:, None, :] * t[..., None]
    d_enc = encode_position(d, 4)[:, None, :].expand(b, s, -1)
    stats = quant.mlp_calibration_absmax(tree, encode_position(pts, 10), d_enc, skip)
    return quant.quantize_mlp(tree, stats, skip), o, d, t


@pytest.mark.parametrize("arch,b,s", [
    ((8, 256, 4), 4096, 64),
    ((8, 256, 4), 1024, 192),
    ((8, 256, 4), 333, 160),   # a ragged last tile inside each ray
    ((8, 256, 4), 1001, 24),   # several rays per block, ragged last block
    ((5, 64, 4), 257, 40),     # skip on the last layer widens the heads
    ((8, 256, 4), 16384, 128),  # the server's chunk, union-free
])
def test_k4_matches_plain(dev, arch, b, s):
    """K4 against its plain version on the same qparams: the same integer
    pipeline, so only a sin/cos ulp that moves an encoding across an int8
    boundary, and the compositing's order, separate them (K1's gates)."""
    qp, o, d, t = _k4_setup(dev, arch, b, s, seed=20)
    before = k4.launches
    rgb, w = k4.render_rays_fused_quant(qp, o, d, t, skip_layer=arch[2])
    torch.cuda.synchronize()
    rgb_p, w_p = k4.render_rays_reference_quant(qp, o, d, t, skip_layer=arch[2])
    assert k4.launches == before + 1
    assert rgb.shape == (b, 3) and w.shape == (b, s)
    assert bool(torch.isfinite(rgb).all() and torch.isfinite(w).all())
    for got, want in ((rgb, rgb_p), (w, w_p)):
        assert float((got - want).abs().max()) <= TOL_MAX
        assert float((got - want).abs().mean()) <= TOL_MEAN


def test_k4_is_deterministic(dev):
    qp, o, d, t = _k4_setup(dev, (8, 256, 4), 500, 96, seed=21)
    a = k4.render_rays_fused_quant(qp, o, d, t)
    b = k4.render_rays_fused_quant(qp, o, d, t)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_k4_checks_its_inputs(dev):
    qp, o, d, t = _k4_setup(dev, (2, 32, 4), 16, 8, seed=22)
    with pytest.raises(ValueError, match="contiguous"):
        k4.render_rays_fused_quant(qp, o, d, t.t().contiguous().t())
    with pytest.raises(TypeError, match="float32"):
        k4.render_rays_fused_quant(qp, o.double(), d, t)
    with pytest.raises(ValueError, match="l_xyz"):
        k4.render_rays_fused_quant(qp, o, d, t, l_xyz=8)
    cpu_qp = dict(qp, inv_x=qp["inv_x"].cpu())
    with pytest.raises(ValueError, match="qparams"):
        k4.render_rays_fused_quant(cpu_qp, o, d, t)


def test_k4_exact_where_accumulators_reach_the_bound(dev):
    """The adversarial int8 MLP of ``k4_adversarial.py``: the layer after
    the skip and the branch accumulate exactly k * 127^2 (> 2^22, where K4
    converts instead of taking the magic number), the other layers up to
    256 * 127^2.  K4 against its plain version within K4's gates
    (chip_smoke.py: max 1e-3, mean 1e-5), which a K4 with the magic number
    everywhere misses by 10x (``test_torch_wg_pack.py`` checks that on the
    CPU)."""
    qp, o, d, t = k4_adversarial.adversarial_case(dev)
    rgb, w = k4.render_rays_fused_quant(qp, o, d, t)
    torch.cuda.synchronize()
    rgb_p, w_p = k4.render_rays_reference_quant(qp, o, d, t)
    for got, want in ((rgb, rgb_p), (w, w_p)):
        assert bool(torch.isfinite(got).all())
        assert float((got - want).abs().max()) <= 1e-3
        assert float((got - want).abs().mean()) <= 1e-5


def test_k4_rejects_an_unsupported_width(dev):
    """Its name is historical: hidden 96 runs on the int8 tables zero-padded
    to the 128 instantiation (quant_render.pad_qparams), held to the plain
    version at K4's gates; hidden 1025 still raises, naming 1024."""
    qp, o, d, t = _k4_setup(dev, (2, 96, 4), 16, 8, seed=23)
    rgb, w = k4.render_rays_fused_quant(qp, o, d, t)
    torch.cuda.synchronize()
    rgb_p, w_p = k4.render_rays_reference_quant(qp, o, d, t)
    for got, want in ((rgb, rgb_p), (w, w_p)):
        assert float((got - want).abs().max()) <= TOL_MAX
        assert float((got - want).abs().mean()) <= TOL_MEAN
    qp, o, d, t = _k4_setup(dev, (2, 1025, 4), 16, 8, seed=23)
    with pytest.raises(NotImplementedError, match="up to 1024"):
        k4.render_rays_fused_quant(qp, o, d, t)


def test_trainer_int8_frame_on_card_matches_cpu(dev, tmp_path):
    """The int8 served path (two K4 launches per chunk, no K1) against the
    plain int8 path on the CPU with the same qparams: rgb TOL_MAX, depth
    2e-2, as the float frame check (the fine samples follow the coarse
    weights)."""
    cfg = NeRFConfig(num_layers=8, hidden_dim=256, ns_coarse=64, ns_fine=128,
                     height=16, width=16).validate()
    path = str(tmp_path / "q.ckpt.npz")
    save_params_npz(path, random_params(cfg, seed=0), cfg)
    pose = pose_spherical(45.0, -30.0, 4.0)
    gpu = Trainer(cfg, 2.0, 6.0, device="cuda").restore(path)
    o, d = gpu.pose_rays(pose, 16, 16, 19.2)
    gpu.quantize_for_inference(o, d)
    before = (k1.launches, k4.launches)
    out = gpu.render_image(pose, 16, 16, 19.2, chunk=100, quant=True)
    assert (k1.launches, k4.launches) == (before[0], before[1] + 2 * 3)
    cpu = Trainer(cfg, 2.0, 6.0, device="cpu").restore(path).install_quant(gpu.qparams)
    ref = cpu.render_image(pose, 16, 16, 19.2, chunk=100, quant=True)
    assert np.abs(out["rgb"] - ref["rgb"]).max() <= TOL_MAX
    assert np.abs(out["depth"] - ref["depth"]).max() <= 2e-2


# ---------------------------------------------------------------------------
# K3 (the recompute backward), K6 (over encodings), K7 (pdf + union).

@pytest.mark.parametrize("with_gw", [True, False])
@pytest.mark.parametrize("b,s", [(333, 100), (1000, 24), (257, 160)])
def test_k3_equals_k2_bit_for_bit(dev, b, s, with_gw):
    """bwd_mode="recompute" (K1 with predictions only, then K3) gives K2's
    gradients to the bit, launching K3 and no K2."""
    gen = torch.Generator().manual_seed(11)
    mlp = randomize_biases_(NeRFMLP(generator=gen, device=dev), gen)
    o, d, t = _rays(dev, b, s, seed=5)
    g_rgb = torch.randn((b, 3), generator=gen).to(dev)
    g_w = torch.randn((b, s), generator=gen).to(dev) if with_gw else None
    want = _kernel_grads(mlp, o, d, t, g_rgb, g_w)
    before = (k1.train_launches, k1.bwd_launches, k1.recompute_launches)
    rgb, w = k1.render_rays_fused(mlp, o, d, t, weights_grad=with_gw, bwd_mode="recompute")
    outs, cots = ([rgb, w], [g_rgb, g_w]) if with_gw else ([rgb], [g_rgb])
    got = torch.autograd.grad(outs, list(mlp.parameters()), cots)
    assert (k1.train_launches, k1.bwd_launches, k1.recompute_launches) == (
        before[0] + 1, before[1], before[2] + 1)
    for g, r in zip(got, want):
        assert torch.equal(g, r)


def test_k3_checks_its_inputs(dev):
    mlp = NeRFMLP(num_layers=4, hidden_dim=64, device=dev)
    o, d, t = _rays(dev, 16, 24)
    preds = torch.zeros((16 * 24, 4), device=dev)
    g_rgb = torch.zeros((16, 3), device=dev)
    with pytest.raises(ValueError, match="preds"):
        k1.launch_k3(mlp, o, d, t, preds[:-1], g_rgb, None, 10, 4)
    with pytest.raises(ValueError, match="bwd_mode"):
        k1.render_rays_fused(mlp, o, d, t, bwd_mode="cached")


def _k6_inputs(dev, b, s, seed):
    """bf16 encodings of the rays' points and of a unit direction per sample."""
    o, d, t = _rays(dev, b, s, seed=seed)
    gen = torch.Generator().manual_seed(seed)
    ds = torch.randn((b, s, 3), generator=gen).to(dev)
    pts = o[:, None, :] + d[:, None, :] * t[..., None]
    x_enc = encode_position(pts, 10).to(torch.bfloat16).contiguous()
    d_enc = encode_position(ds / ds.norm(dim=-1, keepdim=True), 4).to(torch.bfloat16)
    return x_enc, d_enc.contiguous(), t


@pytest.mark.parametrize("b,s", [(1024, 64), (333, 100), (1000, 24), (257, 192)])
def test_k6_matches_plain(dev, b, s):
    """K6's forward within K1's gates and its backward within K2's, against
    the plain MLP + compositing on the same bf16 encodings."""
    gen = torch.Generator().manual_seed(12)
    mlp = randomize_biases_(NeRFMLP(generator=gen, device=dev), gen)
    x_enc, d_enc, t = _k6_inputs(dev, b, s, seed=6)
    with torch.no_grad():
        rgb, w = k1.apply_nerf_render_fused(mlp, x_enc, d_enc, t)
        torch.cuda.synchronize()
        rgb_p, w_p = k1.apply_nerf_render_reference(mlp, x_enc, d_enc, t)
    for a, r in ((rgb, rgb_p), (w, w_p)):
        assert float((a - r).abs().max()) <= TOL_MAX
        assert float((a - r).abs().mean()) <= TOL_MEAN
    g_rgb = torch.randn((b, 3), generator=gen).to(dev)
    before = (k1.enc_launches, k1.enc_bwd_launches, k1.launches)
    rgb, w = k1.apply_nerf_render_fused(mlp, x_enc, d_enc, t)
    got = torch.autograd.grad([rgb], list(mlp.parameters()), [g_rgb])
    assert (k1.enc_launches, k1.enc_bwd_launches, k1.launches) == (
        before[0] + 1, before[1] + 1, before[2])
    assert not w.requires_grad
    want = k1.apply_nerf_render_reference_vjp(mlp, x_enc, d_enc, t, g_rgb)
    for (name, _), g, r in zip(mlp.named_parameters(), got, want):
        assert _rel_l2(g, r) <= K2_TOL_REL, (name, _rel_l2(g, r))


def test_k6_is_deterministic_and_checks_its_inputs(dev):
    gen = torch.Generator().manual_seed(13)
    mlp = randomize_biases_(NeRFMLP(generator=gen, device=dev), gen)
    x_enc, d_enc, t = _k6_inputs(dev, 300, 64, seed=7)
    g_rgb = torch.randn((300, 3), generator=gen).to(dev)
    runs = []
    for _ in range(2):
        rgb, _ = k1.apply_nerf_render_fused(mlp, x_enc, d_enc, t)
        runs.append(torch.autograd.grad([rgb], list(mlp.parameters()), [g_rgb]))
    assert all(torch.equal(x, y) for x, y in zip(*runs))
    with pytest.raises(TypeError, match="bfloat16"):
        k1.apply_nerf_render_fused(mlp, x_enc.float(), d_enc, t)
    with pytest.raises(ValueError, match="d_enc"):
        k1.apply_nerf_render_fused(mlp, x_enc, d_enc[:, :1], t)


# K7's main shapes (B, S, NF, sorted uniforms): the render chunk, the parity
# step and the bench recipe's 64 + 96 samples.
K7_MAIN_SHAPES = [(16384, 64, 128, False), (4096, 64, 128, True), (4096, 64, 96, True)]


@pytest.mark.parametrize("b,s,nf,sorted_u", [(4096, 64, 128, False), (1000, 64, 128, True),
                                             (77, 16, 8, False), (300, 40, 50, True),
                                             (129, 13, 7, False), (200, 100, 30, True),
                                             *K7_MAIN_SHAPES])
def test_k7_matches_plain(dev, b, s, nf, sorted_u):
    """K7 against the sample_pdf + sorted_union chain: the coarse values
    bit-exact in every row, rows ascending, fine values within 1e-3 (the
    1/denominator amplifies cdf rounding; chip_smoke.py reports the spread),
    and the same bits on a second run.  Row 3 repeats a coarse value four
    times and puts the mass between the equal midpoints, so draws tie with
    coarse values.  At the main shapes, against the chain in float64, K7's
    max error and its count above 1e-5 are no larger than the float32
    chain's own (K7's cdf is accumulated in double)."""
    gen = torch.Generator().manual_seed(14)
    t = torch.sort(torch.rand((b, s), generator=gen) * 4.0 + 2.0, dim=-1).values
    t[3, s // 2:s // 2 + 4] = t[3, s // 2]
    t = t.to(dev)
    w = (torch.rand((b, s), generator=gen) ** 3).to(dev)
    w[0] = 0.0
    w[1] = 0.0
    w[1, s // 2] = 5.0
    w[3] = 0.0
    w[3, s // 2 + 1:s // 2 + 3] = 1.0
    u = torch.sort(torch.rand((b, nf), generator=gen), dim=-1).values.to(dev) if sorted_u else None
    before = k7.launches
    got = k7.sample_pdf_union(t, w, nf, u)
    assert k7.launches == before + 1
    want = k7.sample_pdf_union_reference(t, w, nf, u)
    idx = torch.searchsorted(got, t).clamp(max=s + nf - 1)
    assert torch.equal(got.gather(1, idx), t)
    assert bool((got.diff(dim=-1) >= 0).all())
    assert int((got[3] == t[3, s // 2]).sum()) > 4  # draws landed on the repeated value
    assert torch.equal(k7.sample_pdf_union(t, w, nf, u), got)
    off = (got - want).abs() > 1e-3
    if (b, s, nf, sorted_u) not in K7_MAIN_SHAPES:
        assert not bool(off.any())
        return
    exact = k7.sample_pdf_union_float64(t, w, nf, u)
    mine, chain = (got.double() - exact).abs(), (want.double() - exact).abs()
    assert float(mine.max()) <= float(chain.max())
    assert int((mine > 1e-5).sum()) <= int((chain > 1e-5).sum())
    # A u within an ulp of a cdf entry that ends a floored bin (mass < 1e-5,
    # denominator 1) takes the neighbouring bin when the float32 chain's cdf
    # rounds across it, and its draw jumps by a bin width.  Where K7 is
    # further than 1e-3 from the chain, the float64 chain decides: the chain
    # must be the one that is off, K7 within 1e-5 of float64.
    assert bool((chain[off] > 1e-3).all()) and bool((mine[off] <= 1e-5).all())


def test_k7_checks_its_inputs(dev):
    t = torch.sort(torch.rand((8, 16), device=dev), dim=-1).values
    wide = torch.sort(torch.rand((8, k7.MAX_S + 1), device=dev), dim=-1).values
    with pytest.raises(NotImplementedError, match="S <="):
        k7.sample_pdf_union(wide, wide, 4)
    with pytest.raises(TypeError, match="float32"):
        k7.sample_pdf_union(t, t.double(), 4)
    with pytest.raises(ValueError, match="u_sorted"):
        k7.sample_pdf_union(t, t, 4, u_sorted=torch.rand((8, 5), device=dev))


# ---------------------------------------------------------------------------
# The distilled proposal sampler and the evaluation CLI on the card.

@pytest.mark.parametrize("quant", [False, True])
def test_proposal_render_on_card_matches_cpu(dev, tmp_path, quant):
    """``sampler='proposal'`` at full width: one K1 launch per chunk (one
    K4 with ``quant``) and nothing else, against the plain path on the CPU
    with the same net and tables: rgb TOL_MAX, depth 2e-2."""
    cfg = NeRFConfig(num_layers=8, hidden_dim=256, ns_coarse=64, ns_fine=128,
                     height=16, width=16).validate()
    path = str(tmp_path / "p.ckpt.npz")
    save_params_npz(path, random_params(cfg, seed=0), cfg)
    pose = pose_spherical(45.0, -30.0, 4.0)
    gpu = Trainer(cfg, 2.0, 6.0, device="cuda").restore(path)
    o, d = gpu.pose_rays(pose, 16, 16, 19.2)
    gpu.build_proposal_sampler(o, d, steps=50, batch=4096)
    if quant:
        gpu.quantize_for_inference(o, d)
    before = (k1.launches, k4.launches, k5.launches, k7.launches)
    out = gpu.render_image(pose, 16, 16, 19.2, chunk=100, quant=quant, sampler="proposal")
    grew = (k1.launches, k4.launches, k5.launches, k7.launches)
    assert tuple(a - b for a, b in zip(grew, before)) == ((0, 3) if quant else (3, 0)) + (0, 0)
    cpu = Trainer(cfg, 2.0, 6.0, device="cpu").restore(path)
    cpu._install_proposal(gpu._pparams.to_jax_params(), 4)
    if quant:
        cpu.install_quant(gpu.qparams)
    ref = cpu.render_image(pose, 16, 16, 19.2, chunk=100, quant=quant, sampler="proposal")
    assert np.isfinite(out["rgb"]).all() and np.isfinite(out["depth"]).all()
    assert np.abs(out["rgb"] - ref["rgb"]).max() <= TOL_MAX
    assert np.abs(out["depth"] - ref["depth"]).max() <= 2e-2


def test_distill_on_card_learns(dev, tmp_path):
    """The default distillation (1,500 steps of 16,384 points) at full
    width: finite losses, the last below the first."""
    cfg = NeRFConfig(num_layers=8, hidden_dim=256, ns_coarse=64, ns_fine=128,
                     height=32, width=32).validate()
    path = str(tmp_path / "d.ckpt.npz")
    save_params_npz(path, random_params(cfg, seed=1), cfg)
    gpu = Trainer(cfg, 2.0, 6.0, device="cuda").restore(path)
    o, d = gpu.pose_rays(pose_spherical(0.0, -30.0, 4.0), 32, 32, 38.4)
    gpu.build_proposal_sampler(o, d)
    losses = gpu.distill_losses
    assert len(losses) == 1500 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_run_evaluation_on_card(dev, tmp_path):
    """``cli.evaluate`` without ``--device`` on the card: the synthetic val
    split at 100x100 (3 views, one chunk each), two K1 launches a view."""
    import json

    from nerf_keras_tpu_torch.cli.evaluate import run_evaluation

    cfg = NeRFConfig(num_layers=8, hidden_dim=256, ns_coarse=64, ns_fine=128,
                     height=100, width=100).validate()
    cfg_path = tmp_path / "c.json"
    cfg_path.write_text(json.dumps({"NUM_LAYERS": 8, "HIDDEN_DIM": 256, "NS_COARSE": 64,
                                    "NS_FINE": 128, "HEIGHT": 100, "WIDTH": 100}))
    path = str(tmp_path / "e.ckpt.npz")
    save_params_npz(path, random_params(cfg, seed=2), cfg, scene={"near": 2.0, "far": 6.0})
    before = (k1.launches, k4.launches, k5.launches)
    report = run_evaluation(["--config", str(cfg_path), "--checkpoint", path])
    assert (k1.launches - before[0], k4.launches - before[1], k5.launches - before[2]) == (
        2 * 3, 0, 0)
    assert len(report["views"]) == 3 and np.isfinite(report["mean"]["psnr"])


def test_world_one_nccl_mesh_equals_no_mesh(dev):
    """A world of 1 on NCCL (a child process: ``parallel/audit.run_ranks``)
    at 8x256 and 64 + 128: the first step's gradients through the mesh
    equal the no-mesh step's on the same batch and draws bit for bit, every
    step makes exactly one all-reduce (the counter, and one
    ``nccl:all_reduce`` host call in the profile) and two K1 training-mode
    and two K2 launches."""
    from nerf_keras_tpu_torch.parallel.audit import run_ranks
    from nerf_keras_tpu_torch.profile_train import bench_batch
    from nerf_keras_tpu_torch.utils.checkpoint import _flatten

    cfg = _parity_cfg(True)
    params = random_params(cfg, seed=4)
    batch = bench_batch(cfg.batch_size, seed=5)
    (rec,) = run_ranks(1, {"device": "cuda", "backend": None, "cfg": cfg, "near": 2.0,
                           "far": 6.0, "batch": batch, "params": params, "steps": 2,
                           "profile": 2}, timeout=300)
    assert rec["backend"] == "nccl"
    assert rec["audit"]["all_reduce_count"] == 1
    assert rec["launches"] == [{"k1_train": 2, "k2": 2}] * 2
    assert rec["nccl_all_reduce"]["host_calls"] == 2
    one = Trainer(cfg, 2.0, 6.0, device="cuda").replace_params(params)
    one.train_step(batch)
    got = _flatten(rec["grads"], "")
    for k, want in _flatten(one.params_tree(grad=True), "").items():
        np.testing.assert_array_equal(got[k], want, err_msg=k)


@pytest.mark.parametrize("knobs,per_step", [
    (dict(), [(1, 1)] * 4),
    (dict(prop_aux_samples=32), [(2, 2)] * 4),
    (dict(prop_union_every=2), [(1, 1)] * 4),
])
def test_union_free_steps_launch_k1_k2_at_the_layouts_sample_counts(dev, knobs, per_step):
    """The union-free proposal steps on the card at full width (batch 1024,
    64 + 128): K1 training-mode and K2 launches a step (the aux pass adds
    one of each), at S=128 (union steps of the interleave: 192; the aux
    pass: 32), and a finite loss."""
    cfg = NeRFConfig(batch_size=1024, ns_coarse=64, ns_fine=128, train_sampler="proposal",
                     prop_union=False, prop_explore=0.1, distortion_loss_mult=1e-4,
                     prop_anneal_steps=1000, **knobs).validate()
    tr = Trainer(cfg, 2.0, 6.0, device="cuda")
    o, d, _ = _rays(dev, cfg.batch_size, 2, seed=30)
    batch = (torch.rand((cfg.batch_size, 3), generator=torch.Generator().manual_seed(31)).to(dev),
             o, d / d.norm(dim=-1, keepdim=True))
    seen = []
    real = k1.launch_k1

    def spy(mlp, origins, dirs, t_vals, *args, **kw):
        seen.append(t_vals.shape[-1])
        return real(mlp, origins, dirs, t_vals, *args, **kw)

    k1.launch_k1 = spy
    try:
        for i, (n_fwd, n_bwd) in enumerate(per_step):
            before = (k1.train_launches, k1.bwd_launches)
            seen.clear()
            loss = float(tr.train_step(batch)["loss"])
            assert (k1.train_launches - before[0], k1.bwd_launches - before[1]) == (n_fwd, n_bwd)
            union = cfg.prop_union_every and i % cfg.prop_union_every == 0
            want = [192] if union else [128] + ([32] if cfg.prop_aux_samples else [])
            assert seen == want, (i, seen)
            assert np.isfinite(loss)
    finally:
        k1.launch_k1 = real


def _f32_setup(dev, hidden, b, s, seed, l_xyz=10, l_dir=4):
    """A float32 MLP (8 layers, skip 4) with random biases, rays, t, the
    per-sample f32 encodings and cotangents."""
    gen = torch.Generator().manual_seed(seed)
    mlp = randomize_biases_(NeRFMLP(num_layers=8, hidden_dim=hidden, skip_layer=4, l_xyz=l_xyz,
                                    l_dir=l_dir, compute_dtype=torch.float32, generator=gen,
                                    device=dev), gen)
    o, d, t = _rays(dev, b, s, seed)
    pts = o[:, None, :] + d[:, None, :] * t[..., None]
    x_enc = encode_position(pts, l_xyz).contiguous()
    d_enc = encode_position(d, l_dir)[:, None, :].expand(b, s, -1).contiguous()
    g = [(torch.randn(shape, generator=gen) * 1e-3).to(dev) for shape in ((b, 3), (b, s))]
    return mlp, o, d, t, x_enc, d_enc, g[0], g[1]


@pytest.mark.parametrize("hidden,l_xyz,l_dir", [(256, 10, 4), (96, 16, 6), (17, 4, 2)])
@pytest.mark.parametrize("kernel", ["k1", "k2", "k3", "k6", "k5"])
def test_f32_kernels_match_plain(dev, kernel, hidden, l_xyz, l_dir):
    """Each f32 kernel against its plain f32 version at relative L2 <=
    F32_TOL_REL on every output and gradient, and one launch of it by the
    f32 counters (the bf16 ones untouched)."""
    mlp, o, d, t, x_enc, d_enc, g_rgb, g_w = _f32_setup(dev, hidden, 300, 48, seed=31,
                                                        l_xyz=l_xyz, l_dir=l_dir)
    b, s = t.shape
    before = launch_counts()
    with torch.no_grad():
        if kernel == "k1":
            got = list(k1.render_rays_fused(mlp, o, d, t, l_xyz=l_xyz, l_dir=l_dir))
            want = list(k1.render_rays_reference(mlp, o, d, t, l_xyz=l_xyz, l_dir=l_dir))
        elif kernel in ("k2", "k3"):
            _, _, x_res, preds = k1.launch_k1(mlp, o, d, t, l_xyz, l_dir, train=True,
                                              emit_xenc=kernel == "k2")
            assert (x_res is None) == (kernel == "k3")
            got = (k1.launch_k2(mlp, x_res, d, t, preds, g_rgb, g_w, l_xyz, l_dir)
                   if kernel == "k2" else
                   k1.launch_k3(mlp, o, d, t, preds, g_rgb, g_w, l_xyz, l_dir))
        elif kernel == "k6":
            got = list(k1.apply_nerf_render_fused(mlp, x_enc, d_enc, t))
            want = list(k1.apply_nerf_render_reference(mlp, x_enc, d_enc, t))
            _, _, preds = k1.launch_k6_fwd(mlp, x_enc, d_enc, t, train=True)
            got += k1.launch_k6_bwd(mlp, x_enc, d_enc, t, preds, g_rgb)
        else:
            x2, d2 = x_enc.reshape(b * s, -1), d_enc.reshape(b * s, -1)
            g5 = torch.randn((b * s, 4), generator=torch.Generator().manual_seed(3)).to(dev)
            got = [k5.launch_k5_fwd(mlp, x2, d2)]
            grads, dx, dd = k5.launch_k5_bwd(mlp, x2, d2, g5, True, True)
            got += grads + [dx, dd]
        torch.cuda.synchronize()
    if kernel in ("k2", "k3"):
        want = k1.render_rays_reference_vjp(mlp, o, d, t, g_rgb, g_w, l_xyz=l_xyz, l_dir=l_dir)
    elif kernel == "k6":
        want += k1.apply_nerf_render_reference_vjp(mlp, x_enc, d_enc, t, g_rgb)
    elif kernel == "k5":
        with torch.no_grad():
            want = [mlp(x2, d2)]
        grads, dx, dd = k5.apply_nerf_mlp_reference_vjp(mlp, x2, d2, g5, True)
        want += grads + [dx, dd]
    assert len(got) == len(want)
    for i, (a, w) in enumerate(zip(got, want)):
        assert a.dtype == torch.float32 and a.shape == w.shape, i
        assert _rel_l2(a, w) <= F32_TOL_REL, (i, _rel_l2(a, w))
    grew = {k: v - before[k] for k, v in launch_counts().items() if v != before[k]}
    assert grew and all(k.endswith("_f32") for k in grew), grew


@pytest.mark.parametrize("hidden", [16, 96, 192, 256])
@pytest.mark.parametrize("l_xyz,l_dir", [(4, 2), (16, 6)])
@pytest.mark.parametrize("kernel", ["k1", "k1_train", "k5", "k6"])
def test_f32_forward_matches_the_f64_yardstick(dev, kernel, hidden, l_xyz, l_dir):
    """The f32 forward (f32_fwd_kernel: K1 in both modes, K5 at S = 1, K6)
    on 300 rays of 49 samples (14,700: no multiple of the 64-sample tile)
    within F32_TOL_REL of its plain version with the compositing in
    float64 (chip_smoke.py's yardstick), K1's f32 x_enc residual equal
    to the plain encode of o + d * t bit for bit, and two launches giving
    the same bits."""
    from chip_smoke import _f64_yardstick

    mlp, o, d, t, x_enc, d_enc, _, _ = _f32_setup(dev, hidden, 300, 49, seed=hidden + l_xyz,
                                                  l_xyz=l_xyz, l_dir=l_dir)
    b, s = t.shape
    x2, d2 = x_enc.reshape(b * s, -1), d_enc.reshape(b * s, -1)
    kw = dict(l_xyz=l_xyz, l_dir=l_dir)
    calls = {
        "k1": lambda: list(k1.render_rays_fused(mlp, o, d, t, **kw)),
        "k1_train": lambda: list(k1.launch_k1(mlp, o, d, t, l_xyz, l_dir, train=True)),
        "k5": lambda: [k5.launch_k5_fwd(mlp, x2, d2)],
        "k6": lambda: list(k1.apply_nerf_render_fused(mlp, x_enc, d_enc, t)),
    }
    with torch.no_grad():
        got, again = calls[kernel](), calls[kernel]()
        torch.cuda.synchronize()
        with _f64_yardstick():
            if kernel in ("k1", "k1_train"):
                want = list(k1.render_rays_reference(mlp, o, d, t, **kw))
            elif kernel == "k6":
                want = list(k1.apply_nerf_render_reference(mlp, x_enc, d_enc, t))
            else:
                want = []
            if kernel in ("k1_train", "k5"):
                want.append(mlp(x2, d2))
    if kernel == "k1_train":
        assert torch.equal(got.pop(2), x2)  # the residual: the plain encode, bit for bit
        again.pop(2)
    assert len(got) == len(want)
    for i, (a, a2, w) in enumerate(zip(got, again, want)):
        assert a.dtype == torch.float32 and a.shape == w.shape, i
        assert torch.equal(a, a2), i
        assert _rel_l2(a, w) <= F32_TOL_REL, (i, _rel_l2(a, w))


@pytest.mark.parametrize("kernel", ["k2", "k5"])
def test_f32_backward_over_chunks_repeats_its_bits(dev, monkeypatch, kernel):
    """The f32 backward (K2, and K5 with input gradients) over a workspace
    budget that forces several chunks, the last one short, within
    F32_TOL_REL on every gradient of its plain version with the parameter
    gradients' sums and the compositing in float64 (chip_smoke.py's
    yardstick for this gate: the plain f32 version's own sums over 33,300
    samples err by ~1e-5 on the sigma head's bias); two launches give
    identical bits (no atomics, a fixed order of sums)."""
    from chip_smoke import _f64_yardstick

    mlp, o, d, t, x_enc, d_enc, g_rgb, g_w = _f32_setup(dev, 256, 333, 100, seed=37)
    b, s = t.shape
    per = fused_f32.bytes_per_sample(fused_f32.kernel_pack_f32(mlp, dev))
    monkeypatch.setattr(k1, "DW_CHUNK_BYTES", 64 * 128 * per)
    n = b if kernel == "k2" else b * s
    plan = k1.chunk_plan(n, s if kernel == "k2" else 1, per)
    assert len(plan) >= 3 and plan[-1][1] < plan[0][1]
    x2, d2 = x_enc.reshape(b * s, -1), d_enc.reshape(b * s, -1)
    g5 = (torch.randn((b * s, 4), generator=torch.Generator().manual_seed(5)) * 1e-2).to(dev)
    runs = []
    with torch.no_grad():
        if kernel == "k2":
            _, _, x_res, preds = k1.launch_k1(mlp, o, d, t, 10, 4, train=True)
        for _ in range(2):
            if kernel == "k2":
                runs.append(k1.launch_k2(mlp, x_res, d, t, preds, g_rgb, g_w, 10, 4))
            else:
                grads, dx, dd = k5.launch_k5_bwd(mlp, x2, d2, g5, True, True)
                runs.append(grads + [dx, dd])
        torch.cuda.synchronize()
    with _f64_yardstick():
        if kernel == "k2":
            want = k1.render_rays_reference_vjp(mlp, o, d, t, g_rgb, g_w)
        else:
            grads, dx, dd = k5.apply_nerf_mlp_reference_vjp(mlp, x2, d2, g5, True)
            want = grads + [dx, dd]
    assert len(runs[0]) == len(want)
    for i, (a, a2, w) in enumerate(zip(runs[0], runs[1], want)):
        assert torch.equal(a, a2), i
        assert _rel_l2(a, w) <= F32_TOL_REL, (i, _rel_l2(a, w))


@pytest.mark.parametrize("what", ["hidden 1025 bf16", "hidden 320 f32",
                                  "hidden 320 bf16 K5 input gradients", "L_XYZ 21",
                                  "L_DIR 11"])
def test_beyond_the_kernels_raises_naming_the_limit(dev, what):
    """A bf16 MLP wider than 1024, a float32 one wider than 256, K5's input
    gradients wider than 256, L_XYZ > 20 and L_DIR > 10 raise
    NotImplementedError naming the limit and the ROADMAP.md item, before
    any launch; nothing falls back."""
    hidden = 1025 if "1025" in what else 320 if "320" in what else 64
    l_xyz, l_dir = (21 if what == "L_XYZ 21" else 10), (11 if what == "L_DIR 11" else 4)
    dtype = torch.float32 if "f32" in what else torch.bfloat16
    mlp = NeRFMLP(num_layers=2, hidden_dim=hidden, l_xyz=l_xyz, l_dir=l_dir,
                  compute_dtype=dtype, device=dev)
    o, d, t = _rays(dev, 8, 8)
    x = torch.zeros((8, mlp.xyz_dim), dtype=dtype, device=dev)
    dd = torch.zeros((8, mlp.dir_dim), dtype=dtype, device=dev)
    limit = {"hidden 1025 bf16": "up to 1024", "hidden 320 f32": "up to 256",
             "hidden 320 bf16 K5 input gradients": "input gradients.*up to 256"}.get(
        what, "L_XYZ <= 20, L_DIR <= 10")
    before = launch_counts()
    if "input gradients" not in what:
        with pytest.raises(NotImplementedError, match=limit) as err:
            k1.render_rays_fused(mlp, o, d, t, l_xyz=l_xyz, l_dir=l_dir)
        assert "ROADMAP.md queue 2 A3" in str(err.value)
    with pytest.raises(NotImplementedError, match=limit) as err:
        k5.apply_nerf_mlp_fused(mlp, x, dd, need_input_grads=True)
    assert "ROADMAP.md queue 2 A3" in str(err.value)
    assert launch_counts() == before


# ---------------------------------------------------------------------------
# Hidden widths above 256: the 64-row split tile of hidden 512 and 1024 (in
# column passes of 512 there), and widths between zero-padded to them, each
# kernel against its plain version.

WIDE = (320, 512, 640, 1024)
# The dW workspace bytes of a sample at 8 x 512 and 8 x 1024.
WS_BYTES = {512: 19_840, 1024: 39_296}


def _wide_mlp(dev, hidden, seed, num_layers=8, skip=4):
    gen = torch.Generator().manual_seed(seed)
    return randomize_biases_(NeRFMLP(num_layers=num_layers, hidden_dim=hidden,
                                     skip_layer=skip, generator=gen, device=dev), gen)


@pytest.mark.parametrize("hidden", WIDE)
@pytest.mark.parametrize("b,s", [(1024, 64), (333, 100), (1000, 24), (257, 192)])
def test_wide_k1_matches_plain(dev, hidden, b, s):
    """K1 (and its training mode, as ``test_k1_training_residuals_match_plain``
    holds it: the bf16 x_enc residual, the predictions of the plain MLP on
    it, the same rgb and weights) at 8 x 320, 512, 640 and 1024 against the
    plain version: one ray a block, several, and a ragged last tile."""
    mlp = _wide_mlp(dev, hidden, seed=31)
    o, d, t = _rays(dev, b, s, seed=4)
    before = (k1.launches, k1.train_launches)
    with torch.no_grad():
        rgb, w = k1.render_rays_fused(mlp, o, d, t)
        rgb1, w1, x_enc, preds = k1.launch_k1(mlp, o, d, t, 10, 4, train=True)
        torch.cuda.synchronize()
        rgb_p, w_p = k1.render_rays_reference(mlp, o, d, t)
        pts = o[:, None, :] + d[:, None, :] * t[..., None]
        x_plain = encode_position(pts, 10).reshape(b * s, -1)
        d_plain = encode_position(d, 4)[:, None, :].expand(b, s, -1).reshape(b * s, -1)
        preds_p = mlp(x_enc.float(), d_plain)
    assert (k1.launches, k1.train_launches) == (before[0] + 2, before[1] + 1)
    assert torch.equal(rgb, rgb1) and torch.equal(w, w1)
    for got, want in ((rgb, rgb_p), (w, w_p)):
        assert bool(torch.isfinite(got).all())
        assert float((got - want).abs().max()) <= TOL_MAX
        assert float((got - want).abs().mean()) <= TOL_MEAN
    assert float((x_enc.float() - x_plain.to(torch.bfloat16).float()).abs().max()) <= 1e-2
    assert float((preds - preds_p).abs().max()) <= TOL_MAX * 4
    assert float((preds - preds_p).abs().mean()) <= TOL_MEAN


@pytest.mark.parametrize("hidden", WIDE)
@pytest.mark.parametrize("with_gw", [True, False])
def test_wide_k2_matches_plain_vjp(dev, hidden, with_gw):
    """K2 at 320, 512, 640 and 1024 (its rows kernel on the split tile, dW
    in 264-column windows, csrc/nerf_dw.cuh: mlp_dw_window_kernel) against
    autograd of the plain K1, per leaf within K2_TOL_REL; K3 gives K2's
    bits.  At 320 (zero-padded to the 512 kernels) the reference is the
    float64 yardstick (``exp_wide_numerics.yardstick_grads``) within the
    same K2_TOL_REL, the plain path's distance printed: on these 33,300
    samples the plain bf16 path is itself up to 0.0195 from the yardstick
    over seeded draws, and the gate against it turns on single ReLU signs
    (K2 0.0379 from the plain path, 0.0177 from the yardstick, without
    the weights cotangent)."""
    mlp = _wide_mlp(dev, hidden, seed=32)
    b, s = 333, 100
    o, d, t = _rays(dev, b, s, seed=5)
    gen = torch.Generator().manual_seed(6)
    g_rgb = torch.randn((b, 3), generator=gen).to(dev)
    g_w = torch.randn((b, s), generator=gen).to(dev) if with_gw else None
    got = _kernel_grads(mlp, o, d, t, g_rgb, g_w)
    torch.cuda.synchronize()
    want = k1.render_rays_reference_vjp(mlp, o, d, t, g_rgb, g_w)
    if hidden == 320:
        from nerf_keras_tpu_torch import exp_wide_numerics as nx
        plain = max(_rel_l2(g, r) for g, r in zip(got, want))
        want = nx.yardstick_grads(mlp, o, d, t, g_rgb, g_w)
        print(f"8x320: K2 {max(_rel_l2(g, r) for g, r in zip(got, want)):.4f} from the "
              f"yardstick, {plain:.4f} from the plain path")
    for (name, p), g, r in zip(mlp.named_parameters(), got, want):
        assert g.shape == p.shape and bool(torch.isfinite(g).all()), name
        assert _rel_l2(g, r) <= K2_TOL_REL, (name, _rel_l2(g, r))
    with torch.no_grad():
        _, _, x_res, preds = k1.launch_k1(mlp, o, d, t, 10, 4, train=True)
        k2 = k1.launch_k2(mlp, x_res, d, t, preds, g_rgb, g_w, 10, 4)
        k3 = k1.launch_k3(mlp, o, d, t, preds, g_rgb, g_w, 10, 4)
    assert all(torch.equal(a, c) for a, c in zip(k2, k3))


@pytest.mark.parametrize("hidden", [512, 1024])
def test_wide_k2_chunks_and_determinism(dev, monkeypatch, hidden):
    """At 8 x 512 and 8 x 1024: two runs give the same bits (no atomics;
    the bias sums over the split tile's four row groups in a fixed order),
    and a budget that forces several chunks of rays (a ragged last one: the
    dW slabs accumulate over chunks, column tile by column tile) stays
    within K2's gate of one chunk."""
    mlp = _wide_mlp(dev, hidden, seed=33)
    b, s = 300, 64
    o, d, t = _rays(dev, b, s, seed=7)
    gen = torch.Generator().manual_seed(8)
    g_rgb = torch.randn((b, 3), generator=gen).to(dev)
    g_w = torch.randn((b, s), generator=gen).to(dev)
    one = _kernel_grads(mlp, o, d, t, g_rgb, g_w)
    again = _kernel_grads(mlp, o, d, t, g_rgb, g_w)
    assert all(torch.equal(x, y) for x, y in zip(one, again))
    per_sample = WS_BYTES[hidden]
    monkeypatch.setattr(k1, "DW_CHUNK_BYTES", 64 * 128 * per_sample)
    plan = k1.chunk_plan(b, s, per_sample)
    assert len(plan) >= 3 and plan[-1][1] < plan[0][1]
    got = _kernel_grads(mlp, o, d, t, g_rgb, g_w)
    for x, y in zip(got, one):
        assert _rel_l2(x, y) <= K2_TOL_REL


@pytest.mark.parametrize("hidden", [512, 1024])
@pytest.mark.parametrize("chunk_rays", [None, 81, 40])
def test_wide_dw_windows_match_plain_over_chunks(dev, monkeypatch, chunk_rays, hidden):
    """The split tile's dW product (csrc/nerf_dw.cuh: mlp_dw_window_kernel,
    a persistent walk over units of 128 or 64 rows by up to 256 columns and
    a range of samples) at 8 x 512 and 8 x 1024 (four units a trunk
    layer's row tile), 257 rays of 100 samples: in the default budget's
    chunks (one at 512, two at 1024), and in chunks of 81 and of 40 rays (4
    and 7 chunks, the last ragged: each unit's sample ranges shift with the
    chunk's stages), K2 against the plain VJP per leaf within K2_TOL_REL,
    run twice the same bits, one mlp_dw_window_kernel launch a chunk and no
    mlp_dw_kernel (torch.profiler)."""
    mlp = _wide_mlp(dev, hidden, seed=36)
    b, s = 257, 100
    o, d, t = _rays(dev, b, s, seed=13)
    gen = torch.Generator().manual_seed(14)
    g_rgb = torch.randn((b, 3), generator=gen).to(dev)
    g_w = torch.randn((b, s), generator=gen).to(dev)
    per_sample = WS_BYTES[hidden]
    if chunk_rays is not None:
        rows = -(-chunk_rays * s // 128) * 128
        monkeypatch.setattr(k1, "DW_CHUNK_BYTES", rows * per_sample)
    plan = k1.chunk_plan(b, s, per_sample)
    # The default budget holds the 25,700 samples in one chunk at 8x512
    # (19,840 B each), in two at 8x1024 (39,296 B each).
    assert len(plan) == {None: 1 if hidden == 512 else 2, 81: 4, 40: 7}[chunk_rays]
    with torch.no_grad():
        _, _, x_res, preds = k1.launch_k1(mlp, o, d, t, 10, 4, train=True)
        run = lambda: k1.launch_k2(mlp, x_res, d, t, preds, g_rgb, g_w, 10, 4)  # noqa: E731
        got, again = run(), run()
        torch.cuda.synchronize()
        seen = device_ms_by_kernel(run, {"windows": ("mlp_dw_window_kernel",),
                                         "tiles": ("mlp_dw_kernel",)}, tries=8,
                                   launches={"windows": len(plan), "tiles": 0})["launches"]
    assert seen == {"windows": len(plan), "tiles": 0}
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    want = k1.render_rays_reference_vjp(mlp, o, d, t, g_rgb, g_w)
    for (name, _), a, c in zip(mlp.named_parameters(), got, want):
        assert bool(torch.isfinite(a).all()), name
        assert _rel_l2(a, c) <= K2_TOL_REL, (name, _rel_l2(a, c))


def k2_wide_bits(dev, b, s, seed=35, hidden=512):
    """sha256 (16 hex digits) of K2's gradients at 8 x ``hidden`` (the
    seeded model of test_wide_clusters_at_odd_and_ragged_tile_counts, rays
    of ``_rays``) from K1's residuals, with the weights cotangent."""
    mlp = _wide_mlp(dev, hidden, seed=seed)
    o, d, t = _rays(dev, b, s, seed=11)
    gen = torch.Generator().manual_seed(12)
    g_rgb = torch.randn((b, 3), generator=gen).to(dev)
    g_w = torch.randn((b, s), generator=gen).to(dev)
    with torch.no_grad():
        _, _, x_res, preds = k1.launch_k1(mlp, o, d, t, 10, 4, train=True)
        got = k1.launch_k2(mlp, x_res, d, t, preds, g_rgb, g_w, 10, 4)
    torch.cuda.synchronize()
    h = hashlib.sha256()
    for x in got:
        h.update(x.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


# K2 at 8 x 512 with each 32-deep stage's products a fresh wgmma sum added
# into the layer's f32 sums (csrc/nerf_wgmlp.cuh: wg_product_staged):
# k2_wide_bits on "NVIDIA H100 80GB HBM3", torch 2.11.0+cu128.  The dW
# product's window tiles keep each element's sums and their order of the
# design before them (csrc/nerf_dw.cuh's mlp_dw_kernel on column tiles of
# d_width / 2).
K2_WIDE_BITS = {(1, 64): "efbd80b36fd095bd", (41, 100): "fece6bd34bc1dad6",
                (257, 100): "a3bb08bdd977cf54"}


@pytest.mark.parametrize("b,s", [(1, 64), (41, 100), (257, 100)])
def test_wide_k2_bits_equal_the_first_designs(dev, b, s):
    """K2 at 8 x 512 gives the bits recorded in K2_WIDE_BITS (its sums of
    32-deep stages; the dW product's window tiles keep the sums of the
    design before them): one tile of samples, one sample range of the dW
    product (41 x 100) and several (257 x 100: 4 ranges)."""
    assert k2_wide_bits(dev, b, s) == K2_WIDE_BITS[(b, s)]


# K2 at 8 x 1024 (sums of 64 k, csrc/nerf_wgmlp.cuh: kSumDepth) with the dW
# product on a block a window tile and the whole chunk's samples, before the
# persistent dW walk: k2_wide_bits(hidden=1024) on "NVIDIA H100 80GB HBM3",
# torch 2.11.0+cu128.  The walk keeps each dW element's sums and their
# order.
K2_WIDE1024_BITS = {(1, 64): "327764e8413eeb09", (41, 100): "49d1f352644d6d10",
                    (257, 100): "1e46b047228a3dd8"}


@pytest.mark.parametrize("b,s", [(1, 64), (41, 100), (257, 100)])
def test_wide1024_k2_bits_equal_the_window_tiles(dev, b, s):
    """K2 at 8 x 1024 gives the bits of the dW product's window tiles before
    the persistent walk (K2_WIDE1024_BITS): one tile of samples, one chunk
    of 41 x 100 and two chunks of 257 x 100 (the second accumulating into
    the slabs)."""
    assert k2_wide_bits(dev, b, s, hidden=1024) == K2_WIDE1024_BITS[(b, s)]


# The seeded few-sample cases of nerf_keras_tpu_torch.exp_wide_numerics
# (SEEDED) that K2 is held to the float64 yardstick on, and the draws of
# each: draw m adds m to the model seed and 2m to the ray and cotangent
# seeds.
FEW_SAMPLE_CASES = ("h512_3x100", "h512_41x100", "h1024_3x100")
FEW_SAMPLE_DRAWS = 8


@pytest.mark.parametrize("draw", range(FEW_SAMPLE_DRAWS))
@pytest.mark.parametrize("case", FEW_SAMPLE_CASES)
def test_wide_k2_few_samples_near_the_yardstick(dev, case, draw):
    """K2 at 8 x 512 and 8 x 1024 on a few hundred samples (3 and 41 rays
    of 100), on each seeded draw, within K2_TOL_REL per leaf of the float64
    yardstick (``exp_wide_numerics.yardstick_grads``: the kernels' bf16
    roundings, every sum in float64), which neither bf16 path computes; K3
    gives K2's bits.  The plain path's own distance from the yardstick is
    printed beside it, not gated: on so few samples a single ReLU sign
    that either path rounds the other way moves a leaf by percents.  With
    a layer's whole depth in one wgmma sum (which rounds toward zero at
    every k16 step) K2 misses on 3 x 100 at 8 x 512 (0.0329 on draw 0)."""
    from nerf_keras_tpu_torch import exp_wide_numerics as nx
    _, hidden, b, seed, ray_seed, cot_seed, with_gw = next(c for c in nx.SEEDED if c[0] == case)
    mlp, o, d, t, g_rgb, g_w = nx.seeded(hidden, seed + draw, b, ray_seed + 2 * draw,
                                         cot_seed + 2 * draw, with_gw)
    got = _kernel_grads(mlp, o, d, t, g_rgb, g_w)
    with torch.no_grad():
        _, _, x_res, preds = k1.launch_k1(mlp, o, d, t, 10, 4, train=True)
        k2 = k1.launch_k2(mlp, x_res, d, t, preds, g_rgb, g_w, 10, 4)
        k3 = k1.launch_k3(mlp, o, d, t, preds, g_rgb, g_w, 10, 4)
    yard = nx.yardstick_grads(mlp, o, d, t, g_rgb, g_w)
    plain = k1.render_rays_reference_vjp(mlp, o, d, t, g_rgb, g_w)
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(k2, k3))
    names = [n for n, _ in mlp.named_parameters()]
    k2_rel = [_rel_l2(g, y) for g, y in zip(got, yard)]
    plain_rel = [_rel_l2(g, y) for g, y in zip(plain, yard)]
    print(f"{case} draw {draw}: K2 {max(k2_rel):.4f} ({names[k2_rel.index(max(k2_rel))]}), "
          f"plain {max(plain_rel):.4f} from the yardstick")
    assert all(bool(torch.isfinite(g).all()) for g in got)
    assert max(k2_rel) <= K2_TOL_REL, (names[k2_rel.index(max(k2_rel))], max(k2_rel))


def _ws_tile(ws_flat, n, col, width):
    """A layer's (n, width) tile out of the dW workspace layout (64-row
    stages of 8-column strips: nerf_wgmlp.cuh, store_ws)."""
    blk = ws_flat[n * col:n * col + n * width].view(n // 64, width // 8, 64, 8)
    return blk.permute(0, 2, 1, 3).reshape(n, width)


def _rounded_once(got, exact, absum, k):
    """Where bf16 ``got`` differs from ``exact`` (float64) rounded once to
    bf16, and whether every such element is one a float32 sum could round
    the other way: ``exact`` within 2 k 2^-24 sum|terms| (twice the bound
    of a k-term float32 sum) of the midpoint of the two roundings."""
    want = exact.to(torch.bfloat16).double()
    off = got != want
    ok = ~off | ((exact - (got + want) / 2).abs() <= 2 * k * 2.0 ** -24 * absum)
    return off, ok


@pytest.mark.parametrize("b,s,seed", [(3, 100, 35), (1, 64, 13)])
def test_wide_rows_kernel_is_locally_exact(dev, b, s, seed):
    """The split tile's rows kernel at 8 x 512 (K5's mode: the cotangent
    given, no compositing), layer by layer from its own workspace: each
    recomputed activation is bf16(relu(A W^T + b)) of the layer's stored
    input, and each dPre is bf16(mask * (D' W')) of the next layer's stored
    dPre and the ReLU signs of the stored activations, both with sums in
    float64 and one rounding, but at float32 ties; the head's dPre is
    [bf16(D_branch W_branch), bf16(d sigma)].  An extra bf16 rounding in
    the walk, a wrong mask or a stale operand fails it."""
    mlp = _wide_mlp(dev, 512, seed=seed)
    o, d, t = _rays(dev, b, s, seed=11)
    n, hid = b * s, 512
    x = encode_position(o[:, None, :] + d[:, None, :] * t[..., None], 10)
    x = x.reshape(n, -1).to(torch.bfloat16).contiguous()
    de = encode_position(d, 4)[:, None, :].expand(b, s, -1).reshape(n, -1)
    de = de.to(torch.bfloat16).contiguous()
    g = (torch.randn((n, 4), generator=torch.Generator().manual_seed(12)) * 1e-2).to(dev)
    with torch.no_grad():
        _, ws = k1.launch_rows(k1._ROWS_K5, mlp, None, None, None, None, 10, 4,
                               x_res=x, d_enc=de, g=g)
    torch.cuda.synchronize()
    rows = -(-n // 64) * 64
    lay = ws.layout.tolist()
    A = [_ws_tile(ws.ws_a, rows, r[0], r[1])[:n].double() for r in lay]
    D = [_ws_tile(ws.ws_d, rows, r[2], r[3])[:n].double() for r in lay]
    W = lambda layer: layer.weight.detach().to(torch.bfloat16).double()  # noqa: E731
    L = mlp.num_layers
    checks = []  # (name, the kernel's bf16, float64 value, sum of |terms|, terms)
    for i, layer in enumerate(mlp.trunk):
        k = layer.weight.shape[1]
        b_ = layer.bias.detach().double()
        pre = A[i][:, :k] @ W(layer).T + b_
        absum = A[i][:, :k].abs() @ W(layer).abs().T + b_.abs()
        checks.append((f"h{i}", A[i + 1][:, :hid], torch.relu(pre), absum, k + 1))
    dbr, wbr = D[L + 1][:, :hid // 2], W(mlp.branch)[:, :hid]
    checks.append(("dfeature", D[L][:, :hid], dbr @ wbr, dbr.abs() @ wbr.abs(), hid // 2))
    checks.append(("dsigma", D[L][:, hid:hid + 1], g[:, 3:].double(), 0.0, 1))
    whead = torch.cat([W(mlp.feature), W(mlp.sigma)], 0)
    for i in range(L - 1, -1, -1):
        dn, wn = ((D[L][:, :hid + 1], whead) if i == L - 1
                  else (D[i + 1][:, :hid], W(mlp.trunk[i + 1])[:, :hid]))
        mask = A[i + 1][:, :hid] > 0
        checks.append((f"dpre{i}", D[i][:, :hid], (dn @ wn) * mask,
                       (dn.abs() @ wn.abs()) * mask, dn.shape[1]))
    for name, got, exact, absum, k in checks:
        off, ok = _rounded_once(got, exact, absum, k)
        assert bool(ok.all()), (name, int((~ok).sum()))
        assert int(off.sum()) <= max(4, got.numel() // 2000), (name, int(off.sum()))


def _to(tree, dev):
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, dev) for v in tree)
    return tree


def k4_wide_bits(dev, b, s, hidden=512):
    """sha256 (16 hex digits) of K4's rgb and weights bytes at 8 x
    ``hidden`` on tables calibrated on the CPU (the same on every machine)
    and (b, s) rays."""
    qp, o, d, t = _k4_setup(torch.device("cpu"), (8, hidden, 4), b, s, seed=27)
    rgb, w = k4.render_rays_fused_quant(_to(qp, dev), o.to(dev), d.to(dev),
                                        t.to(dev).contiguous())
    torch.cuda.synchronize()
    h = hashlib.sha256()
    for x in (rgb, w):
        h.update(x.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


# K4 at 8 x 512 before its persistent grid (a block per group of rays, each
# stage's products waited on, the encode by warpgroup 0; the commit before
# csrc/quant_render_fwd.cu's quant_render_wide_kernel): k4_wide_bits on
# "NVIDIA H100 80GB HBM3", torch 2.11.0+cu128.  Integer sums: any order
# gives these bits.
K4_WIDE_BITS = {(1, 192): "42478615073b81e5", (100, 192): "5277a7a36cdd9656",
                (257, 100): "1b149b59cb38fb4c", (1000, 24): "72b553f19fd92dbf"}


@pytest.mark.parametrize("b,s", [(1, 192), (100, 192), (257, 100), (1000, 24)])
def test_wide_k4_bits_equal_the_first_designs(dev, b, s):
    """K4 at 8 x 512 on its persistent grid gives the bits of the design
    before it (K4_WIDE_BITS): one ray, fewer rays than SMs, a ragged last
    tile inside each ray (S = 100), several rays a group (S = 24)."""
    assert k4_wide_bits(dev, b, s) == K4_WIDE_BITS[(b, s)]


# K4 at 8 x 1024 before its clusters (a block per SM at most, each striding
# over the groups of rays and streaming every weight stage itself):
# k4_wide_bits(hidden=1024) on "NVIDIA H100 80GB HBM3", torch 2.11.0+cu128.
K4_WIDE1024_BITS = {(1, 192): "b1abc4aec8da3a6c", (100, 192): "f320d924ff8db961",
                    (257, 100): "511ee1585a8d2857", (1000, 24): "3c958085ad621564"}


@pytest.mark.parametrize("b,s", [(1, 192), (100, 192), (257, 100), (1000, 24)])
def test_wide1024_k4_bits_equal_the_unclustered_kernels(dev, b, s):
    """K4 at 8 x 1024 in clusters gives the bits of the kernel before them
    (K4_WIDE1024_BITS): one ray (one group: the cluster's second block only
    drains), 100 groups of one ray, 43 groups of six rays (odd, a ragged
    last tile inside each ray), 125 groups of eight rays (odd)."""
    assert k4_wide_bits(dev, b, s, hidden=1024) == K4_WIDE1024_BITS[(b, s)]


@pytest.mark.parametrize("kernel", ["k1", "k2", "k3", "k5", "k6", "k4", "k4_1024"])
@pytest.mark.parametrize("b,s", [(1, 64), (41, 100)])
def test_wide_clusters_at_odd_and_ragged_tile_counts(dev, kernel, b, s):
    """At 8 x 512 the kernels run as clusters of two blocks that share each
    weight stage, and both blocks of a cluster walk the same tiles' worth
    of stages.  One ray of 64 samples is one tile (fewer than a cluster's
    blocks: the second block only drains).  41 x 100 samples are 65 tiles
    (odd, the last ragged: the rows kernel's and K5's last cluster has a
    phantom step) and seven K1 blocks of six rays (the grid rounds up to
    eight, the last block past B; the seventh holds five rays).  K4 at 8 x
    512 and 8 x 1024 (``k4_1024``) walks groups of rays in clusters: one
    group of one ray (the second block drains a phantom group), and seven
    groups of six rays (odd: the last cluster's second block drains a
    phantom group; the seventh group holds five rays).  Each kernel against
    its plain version, and run twice, the same bits."""
    mlp = _wide_mlp(dev, 512, seed=35)
    o, d, t = _rays(dev, b, s, seed=11)
    gen = torch.Generator().manual_seed(12)
    g_rgb = torch.randn((b, 3), generator=gen).to(dev)
    g_w = torch.randn((b, s), generator=gen).to(dev)
    pts = o[:, None, :] + d[:, None, :] * t[..., None]
    x2 = encode_position(pts, 10).to(torch.bfloat16).reshape(b * s, -1).contiguous()
    d_enc = encode_position(d / d.norm(dim=-1, keepdim=True), 4)[:, None, :].expand(
        b, s, -1).to(torch.bfloat16).contiguous()
    d2 = d_enc.reshape(b * s, -1)
    g5 = (torch.randn((b * s, 4), generator=gen) * 1e-2).to(dev)
    x3 = x2.reshape(b, s, -1)

    if kernel.startswith("k4"):
        hidden = 1024 if kernel == "k4_1024" else 512
        qp = _to(_k4_setup(torch.device("cpu"), (8, hidden, 4), b, s, seed=35)[0], dev)

    def run():
        with torch.no_grad():
            if kernel.startswith("k4"):
                return list(k4.render_rays_fused_quant(qp, o, d, t.contiguous()))
            if kernel == "k1":
                return list(k1.render_rays_fused(mlp, o, d, t))
            if kernel == "k5":
                return [k5.launch_k5_fwd(mlp, x2, d2),
                        *k5.launch_k5_bwd(mlp, x2, d2, g5, False, False)[0]]
            if kernel == "k6":
                rgb, w, preds = k1.launch_k6_fwd(mlp, x3, d_enc, t, train=True)
                return [rgb, w, *k1.launch_k6_bwd(mlp, x3, d_enc, t, preds, g_rgb)]
            _, _, x_res, preds = k1.launch_k1(mlp, o, d, t, 10, 4, train=True)
            if kernel == "k2":
                return k1.launch_k2(mlp, x_res, d, t, preds, g_rgb, g_w, 10, 4)
            return k1.launch_k3(mlp, o, d, t, preds, g_rgb, g_w, 10, 4)

    got, again = run(), run()
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    assert all(bool(torch.isfinite(x).all()) for x in got)
    with torch.no_grad():
        if kernel.startswith("k4"):
            for a, c in zip(got, k4.render_rays_reference_quant(qp, o, d, t.contiguous())):
                assert float((a - c).abs().max()) <= TOL_MAX
                assert float((a - c).abs().mean()) <= TOL_MEAN
        if kernel in ("k1", "k6"):
            rgb_p, w_p = (k1.render_rays_reference(mlp, o, d, t) if kernel == "k1" else
                          k1.apply_nerf_render_reference(mlp, x3, d_enc, t))
            for a, c in zip(got[:2], (rgb_p, w_p)):
                assert float((a - c).abs().max()) <= TOL_MAX
                assert float((a - c).abs().mean()) <= TOL_MEAN
        if kernel == "k5":
            out_p = mlp(x2, d2)
            assert float((got[0] - out_p).abs().max()) <= K5_PREDS_MAX
            assert float((got[0] - out_p).abs().mean()) <= K5_PREDS_MEAN
    if kernel in ("k2", "k3"):
        grads, want, tol = got, k1.render_rays_reference_vjp(mlp, o, d, t, g_rgb, g_w), K2_TOL_REL
    elif kernel == "k6":
        grads, want, tol = got[2:], k1.apply_nerf_render_reference_vjp(
            mlp, x3, d_enc, t, g_rgb), K2_TOL_REL
    elif kernel == "k5":
        grads, want, tol = got[1:], k5.apply_nerf_mlp_reference_vjp(
            mlp, x2, d2, g5, False)[0], K5_TOL_REL
    else:
        return
    for (name, _), a, c in zip(mlp.named_parameters(), grads, want):
        assert _rel_l2(a, c) <= tol, (name, _rel_l2(a, c))


@pytest.mark.parametrize("hidden", WIDE)
def test_wide_k6_and_k5_match_plain(dev, hidden):
    """K6 (forward, backward) and K5 (forward, backward without input
    gradients: the card's path above 256) at 320, 512, 640 and 1024
    against their plain versions."""
    mlp = _wide_mlp(dev, hidden, seed=34)
    b, s = 257, 64
    o, d, t = _rays(dev, b, s, seed=9)
    pts = o[:, None, :] + d[:, None, :] * t[..., None]
    x_enc = encode_position(pts, 10).to(torch.bfloat16).contiguous()
    d_enc = encode_position(d / d.norm(dim=-1, keepdim=True), 4)[:, None, :].expand(
        b, s, -1).to(torch.bfloat16).contiguous()
    gen = torch.Generator().manual_seed(10)
    g_rgb = torch.randn((b, 3), generator=gen).to(dev)
    with torch.no_grad():
        rgb, w, preds = k1.launch_k6_fwd(mlp, x_enc, d_enc, t, train=True)
        got = k1.launch_k6_bwd(mlp, x_enc, d_enc, t, preds, g_rgb)
        torch.cuda.synchronize()
        rgb_p, w_p = k1.apply_nerf_render_reference(mlp, x_enc, d_enc, t)
    for a, c in ((rgb, rgb_p), (w, w_p)):
        assert float((a - c).abs().max()) <= TOL_MAX
        assert float((a - c).abs().mean()) <= TOL_MEAN
    want = k1.apply_nerf_render_reference_vjp(mlp, x_enc, d_enc, t, g_rgb)
    for (name, _), a, c in zip(mlp.named_parameters(), got, want):
        assert _rel_l2(a, c) <= K2_TOL_REL, (name, _rel_l2(a, c))
    x2, d2 = x_enc.reshape(b * s, -1), d_enc.reshape(b * s, -1)
    g5 = (torch.randn((b * s, 4), generator=gen) * 1e-2).to(dev)
    with torch.no_grad():
        out = k5.launch_k5_fwd(mlp, x2, d2)
        grads, dx, dd = k5.launch_k5_bwd(mlp, x2, d2, g5, False, False)
        torch.cuda.synchronize()
        out_p = mlp(x2, d2)
    assert dx is None and dd is None
    assert float((out - out_p).abs().max()) <= K5_PREDS_MAX
    assert float((out - out_p).abs().mean()) <= K5_PREDS_MEAN
    want, _, _ = k5.apply_nerf_mlp_reference_vjp(mlp, x2, d2, g5, False)
    for (name, _), a, c in zip(mlp.named_parameters(), grads, want):
        assert _rel_l2(a, c) <= K5_TOL_REL, (name, _rel_l2(a, c))


@pytest.mark.parametrize("hidden", WIDE)
@pytest.mark.parametrize("b,s", [(4096, 64), (333, 160), (1001, 24)])
def test_wide_k4_matches_plain(dev, hidden, b, s):
    """K4 at 8 x 320 (tables padded to 512), 8 x 512, 8 x 640 (padded to
    1024) and 8 x 1024 against its plain version on the same qparams, at
    K1's gates; two launches the same bits."""
    qp, o, d, t = _k4_setup(dev, (8, hidden, 4), b, s, seed=24)
    rgb, w = k4.render_rays_fused_quant(qp, o, d, t)
    again = k4.render_rays_fused_quant(qp, o, d, t)
    torch.cuda.synchronize()
    rgb_p, w_p = k4.render_rays_reference_quant(qp, o, d, t)
    assert torch.equal(rgb, again[0]) and torch.equal(w, again[1])
    for got, want in ((rgb, rgb_p), (w, w_p)):
        assert bool(torch.isfinite(got).all())
        assert float((got - want).abs().max()) <= TOL_MAX
        assert float((got - want).abs().mean()) <= TOL_MEAN


@pytest.mark.parametrize("hidden", [512, 1024])
def test_wide_k4_exact_beyond_two_to_the_22(dev, hidden):
    """K4 at 8 x 512 and 8 x 1024 on ``k4_adversarial.adversarial_case``:
    every trunk layer after the first, the head and the branch accumulate
    beyond 2^22 (the layer after the skip and the branch exactly k *
    127^2), where K4 converts with cvt.rn.f32.s32; within K4's gates (max
    1e-3, mean 1e-5), which the magic number there misses by 10x
    (``test_torch_wide.py`` checks that on the CPU)."""
    qp, o, d, t = k4_adversarial.adversarial_case(dev, hidden=hidden)
    rgb, w = k4.render_rays_fused_quant(qp, o, d, t)
    torch.cuda.synchronize()
    rgb_p, w_p = k4.render_rays_reference_quant(qp, o, d, t)
    for got, want in ((rgb, rgb_p), (w, w_p)):
        assert bool(torch.isfinite(got).all())
        assert float((got - want).abs().max()) <= 1e-3
        assert float((got - want).abs().mean()) <= 1e-5

