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
from nerf_keras_tpu_torch.ops.kernels import fused_mlp as k5
from nerf_keras_tpu_torch.ops.kernels import fused_render as k1
from nerf_keras_tpu_torch.ops.kernels import pdf_union as k7
from nerf_keras_tpu_torch.ops.kernels import quant_render as k4
from nerf_keras_tpu_torch.ops import quant
from nerf_keras_tpu_torch.ops.rays import pose_spherical
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


@pytest.mark.parametrize("b,s", [(333, 100), (1000, 24), (257, 160)])
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
@pytest.mark.parametrize("b,s", [(333, 100), (1000, 24), (257, 160)])
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
    """Hidden 96 has no wgmma instantiation: K5 raises, nothing falls back."""
    mlp, x_enc, d_enc, g = _k5_setup(dev, (4, 96, 2), 256, seed=11)
    with pytest.raises(NotImplementedError, match="hidden"):
        k5.launch_k5_fwd(mlp, x_enc, d_enc)
    with pytest.raises(NotImplementedError, match="hidden"):
        k5.launch_k5_bwd(mlp, x_enc, d_enc, g, True, True)


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
    qp, o, d, t = _k4_setup(dev, (2, 96, 4), 16, 8, seed=23)
    with pytest.raises(NotImplementedError, match="hidden 96"):
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
