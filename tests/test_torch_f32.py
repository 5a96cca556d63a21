"""COMPUTE_DTYPE=float32 on the kernels' path, on the CPU.

On CUDA a float32 MLP runs the f32 kernels (``csrc/fused_render_f32.cu``,
``ops/kernels/fused_f32.py``); on the CPU every wrapper takes its plain
version.  Here:

* The dispatch as a pure function (``fused_render.kernel_route``): which
  kernels a (compute dtype, hidden width, device) maps to, and at what
  width; the limits (hidden 512 for bf16, 256 for float32 and for K5's
  input gradients, L_XYZ 20, L_DIR 10) raise ``NotImplementedError``
  naming themselves and the ROADMAP item.
* ``check_train_support`` accepts float32 (on any device).
* The f32 backward's weight-gradient plan (``dw_tiles``, ``dw_splits``,
  ``dw_blocks``): every (layer, k tile, n tile, sample tile) of a chunk
  covered by exactly one block, no split empty, and what it gives at
  ``chip_smoke.py``'s shapes.
* The f32 pack (``pack_f32``: each layer's forward matrix, its transpose
  and the biases) and workspace layout against numpy, and ``unpack_grads``
  on a backward's flat f32 dW/db laid out as the kernel writes them.
* One float32 parity step (both ``STOP_PDF_GRADIENT`` modes: K1/K2's and
  K5's paths) and one proposal step of the port's ``Trainer`` on the CPU
  against the JAX step at float32 with replayed draws, at hidden 24 (no
  kernel instantiation's width: the f32 kernels take the model's own
  widths), as ``tests/test_torch_train_coarse.py`` and
  ``tests/test_torch_train.py`` replay them, with their tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_keras_tpu.engine import step as jstep
from nerf_keras_tpu_torch.engine import step as pstep
from nerf_keras_tpu_torch.models.mlp import NeRFMLP, randomize_biases_
from nerf_keras_tpu_torch.ops.kernels import fused_f32
from nerf_keras_tpu_torch.ops.kernels import fused_mlp as k5
from nerf_keras_tpu_torch.ops.kernels import fused_render as k1
from nerf_keras_tpu_torch.ops.kernels import quant_render as k4
from test_torch_train import _cfg as _proposal_cfg
from test_torch_train import _check_step_matches_jax
from test_torch_train_coarse import (
    FAR,
    GRAD_TOL,
    NEAR,
    _batch,
    _cfg,
    _draws,
    _grab_grads,
    _jax_state,
    _leaves,
    _port,
)

torch.set_num_threads(1)

CPU = torch.device("cpu")
F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("dtype,hidden,device,want", [
    (F32, 96, "cuda", ("f32", 96)),
    (F32, 256, "cuda", ("f32", 256)),
    (F32, 8, "cuda", ("f32", 8)),
    (BF16, 8, "cuda", ("wgmma", 64)),
    (BF16, 16, "cuda", ("wgmma", 64)),
    (BF16, 64, "cuda", ("wgmma", 64)),
    (BF16, 96, "cuda", ("wgmma", 128)),
    (BF16, 192, "cuda", ("wgmma", 256)),
    (BF16, 256, "cuda", ("wgmma", 256)),
    (BF16, 257, "cuda", ("wgmma", 512)),
    (BF16, 512, "cuda", ("wgmma", 512)),
    (BF16, 513, "cuda", ("wgmma", 1024)),
    (BF16, 960, "cuda", ("wgmma", 1024)),
    (BF16, 1024, "cuda", ("wgmma", 1024)),
    (BF16, 320, "cpu", ("plain", 320)),
    (BF16, 1024, "cpu", ("plain", 1024)),
    (F32, 96, "cpu", ("plain", 96)),
])
def test_kernel_route(dtype, hidden, device, want):
    assert k1.kernel_route(dtype, hidden, device) == want


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("hidden", [257, 320, 512])
def test_wider_than_256_raises_naming_the_limit(dtype, hidden):
    """Above 256 a float32 MLP still raises on CUDA, naming 256 and the
    ROADMAP item; a bf16 one runs on the hidden-512 kernels (257-511
    zero-padded to 512)."""
    if dtype == BF16:
        assert k1.kernel_route(dtype, hidden, "cuda") == ("wgmma", 512)
        return
    with pytest.raises(NotImplementedError, match=r"up to 256.*ROADMAP.md queue 2 A3"):
        k1.kernel_route(dtype, hidden, "cuda")


@pytest.mark.parametrize("hidden", [513, 640, 1024])
def test_bf16_wider_than_512_raises_naming_the_limit(hidden):
    """A bf16 MLP of 513-1024 units runs on CUDA on the hidden-1024
    kernels (zero-padded to 1024) for every kernel that pads to an
    instantiation (K1-K6, K4); one unit more than 1024 raises naming 1024
    and the ROADMAP item."""
    assert k1.kernel_route(BF16, hidden, "cuda") == ("wgmma", 1024)
    assert k1.kernel_width(hidden, k4.K4_HIDDEN) == 1024
    wider = hidden + 512 if hidden < 1024 else hidden + 1
    with pytest.raises(NotImplementedError, match=r"up to 1024.*ROADMAP.md queue 2 A3"):
        k1.kernel_route(BF16, wider, "cuda")
    with pytest.raises(NotImplementedError, match=r"up to 1024.*ROADMAP.md queue 2 A3"):
        k1.kernel_width(wider, k4.K4_HIDDEN)


@pytest.mark.parametrize("hidden,raises", [(256, False), (257, True), (512, True)])
def test_k5_input_gradients_wider_than_256_raise(hidden, raises):
    """K5 with input gradients (STOP_PDF_GRADIENT=false) takes bf16 MLPs
    up to 256 on CUDA and raises above, naming 256 and the ROADMAP item,
    before any launch; on the CPU the plain version runs at any width."""
    mlp = NeRFMLP(num_layers=2, hidden_dim=hidden, skip_layer=4, l_xyz=2, l_dir=1)
    if raises:
        with pytest.raises(NotImplementedError,
                           match=r"input gradients.*up to 256.*ROADMAP.md queue 2 A3"):
            k1.check_input_grads(mlp)
    else:
        k1.check_input_grads(mlp)
    x = torch.zeros((3, mlp.xyz_dim), dtype=BF16, requires_grad=True)
    d = torch.zeros((3, mlp.dir_dim), dtype=BF16, requires_grad=True)
    out = k5.apply_nerf_mlp_fused(mlp, x, d, need_input_grads=True)
    out.sum().backward()
    assert x.grad.shape == x.shape


@pytest.mark.parametrize("hidden,want", [(8, 32), (32, 32), (48, 64), (96, 128), (192, 256),
                                         (257, 512), (320, 512), (512, 512), (513, 1024),
                                         (960, 1024), (1024, 1024)])
def test_k4_pads_to_its_instantiations(hidden, want):
    assert k1.kernel_width(hidden, k4.K4_HIDDEN) == want


@pytest.mark.parametrize("l_xyz,l_dir,ok", [(20, 10, True), (16, 6, True), (21, 4, False),
                                            (10, 11, False)])
def test_encoding_limits(l_xyz, l_dir, ok):
    if ok:
        k1.check_encodings(l_xyz, l_dir)
        return
    with pytest.raises(NotImplementedError, match=r"L_XYZ <= 20, L_DIR <= 10.*queue 2 A3"):
        k1.check_encodings(l_xyz, l_dir)


@pytest.mark.parametrize("sampler", ["coarse", "proposal"])
def test_check_train_support_accepts_float32_on_cuda(sampler):
    """The check no longer depends on the device: a float32 config (which
    it refused on CUDA before the f32 kernels) passes."""
    cfg = _cfg() if sampler == "coarse" else _proposal_cfg()
    assert cfg.compute_dtype == "float32"
    pstep.check_train_support(cfg)


def _mlp(hidden=24, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return randomize_biases_(NeRFMLP(num_layers=5, hidden_dim=hidden, skip_layer=2, l_xyz=4,
                                     l_dir=2, compute_dtype=F32, generator=gen), gen)


def test_f32_pack_and_workspace_layout():
    """Each layer's forward matrix W (k, n) padded to 64 columns, its
    transpose (n, k) padded to 64 columns, and the biases after all of
    them (each padded to 4), at the model's true widths; the workspace
    holds every layer's input and output, f32."""
    mlp = _mlp()
    pack = fused_f32.pack_f32(mlp, CPU)
    data = pack.data.numpy()
    layers = k1._dense_layers(mlp)
    assert pack.desc.shape == (len(layers), 5)
    for (wt, b), (k, n, f_off, t_off, b_off) in zip(layers, pack.desc):
        wt = wt.detach().numpy()
        assert (n, k) == wt.shape
        ldf, ldt = -(-n // 64) * 64, -(-k // 64) * 64
        f = data[f_off:f_off + k * ldf].reshape(k, ldf)
        t = data[t_off:t_off + n * ldt].reshape(n, ldt)
        np.testing.assert_array_equal(f[:, :n], wt.T)
        np.testing.assert_array_equal(t[:, :k], wt)
        assert not f[:, n:].any() and not t[:, k:].any()
        np.testing.assert_array_equal(data[b_off:b_off + n], b.detach().numpy())
        assert f_off % 4 == 0 and t_off % 4 == 0 and b_off >= pack.b0
    assert pack.b0 + pack.total_b == data.size
    lay = fused_f32.workspace_layout(pack)
    assert lay[:, 1].tolist() == pack.desc[:, 0].tolist()
    assert lay[:, 3].tolist() == pack.desc[:, 1].tolist()
    assert lay[1:, 0].tolist() == np.cumsum(lay[:-1, 1]).tolist()
    assert lay[1:, 4].tolist() == np.cumsum(lay[:-1, 1] * lay[:-1, 3]).tolist()
    assert fused_f32.bytes_per_sample(pack) == 4 * int(lay[:, 1].sum() + lay[:, 3].sum())


def _f32_layout(hidden, l_xyz=10, l_dir=4):
    mlp = NeRFMLP(num_layers=8, hidden_dim=hidden, skip_layer=4, l_xyz=l_xyz, l_dir=l_dir,
                  compute_dtype=F32)
    pack = fused_f32.pack_f32(mlp, CPU)
    return pack, fused_f32.workspace_layout(pack)


@pytest.mark.parametrize("hidden,l_xyz,l_dir,b,s,slots", [
    (256, 10, 4, 4096, 192, 132),  # chip_smoke.py's f32 phase
    (256, 20, 10, 1000, 24, 132),
    (96, 16, 6, 300, 48, 132),
    (17, 4, 2, 333, 100, 7),
    (64, 10, 4, 5, 3, 132),        # one sample tile
])
def test_dw_blocks_cover_every_tile_once(hidden, l_xyz, l_dir, b, s, slots):
    """The dW product's blocks (f32_dw_kernel's grid: output tile x split)
    cover every (layer, 128-row tile, 128-column tile, 64-sample tile) of a
    chunk exactly once, and no split is empty."""
    pack, layout = _f32_layout(hidden, l_xyz, l_dir)
    rays = k1.chunk_plan(b, s, fused_f32.bytes_per_sample(pack))[0][1]
    ntiles = -(-rays * s // fused_f32.ROWS)
    nsplit = fused_f32.dw_splits(fused_f32.dw_tiles(layout), ntiles, slots)
    blocks = fused_f32.dw_blocks(layout, ntiles, nsplit)
    assert len(blocks) == fused_f32.dw_tiles(layout) * nsplit
    seen = {}
    for li, k0, n0, t0, t1 in blocks:
        k, n = int(layout[li, 1]), int(layout[li, 3])
        assert k0 % 128 == 0 and n0 % 128 == 0 and k0 < k and n0 < n
        assert t0 < t1  # no empty split
        for t in range(t0, t1):
            seen[(li, k0, n0, t)] = seen.get((li, k0, n0, t), 0) + 1
    want = {(li, k0, n0, t) for li, (k, n) in enumerate(layout[:, [1, 3]].tolist())
            for k0 in range(0, k, 128) for n0 in range(0, n, 128) for t in range(ntiles)}
    assert set(seen) == want and set(seen.values()) == {1}


def test_dw_plan_at_the_smokes_shapes():
    """At 8x256, B = 4,096, S = 192 (chip_smoke.py's f32 phase) a chunk is
    174 rays (522 tiles), the dW product 42 output tiles a split, and the
    plan takes 3 splits: 126 blocks, one wave on an H100's 132 SMs."""
    pack, layout = _f32_layout(256)
    assert fused_f32.bytes_per_sample(pack) == 20_084
    plan = k1.chunk_plan(4096, 192, fused_f32.bytes_per_sample(pack))
    assert (len(plan), plan[0][1]) == (24, 174)
    assert fused_f32.dw_tiles(layout) == 42
    assert fused_f32.dw_splits(42, 522, 132) == 3
    assert fused_f32.dw_splits(42, 14, 132) == 3   # the last, short chunk keeps 3 splits
    # More slots than blocks of one split: the splits grow to fill whole waves.
    assert fused_f32.dw_splits(4, 40, 132) == 20
    assert fused_f32.dw_splits(1, 1, 132) == 1


def test_f32_unpack_grads_is_exact():
    """The f32 backward's flat dW (each layer's (k, n) row-major) and db (the
    pack's bias layout) come back in ``parameters()`` order, f32, exactly."""
    mlp = _mlp(seed=1)
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(size=(16, mlp.xyz_dim)), dtype=F32)
    d = torch.tensor(rng.normal(size=(16, mlp.dir_dim)), dtype=F32)
    (mlp(x, d) * torch.tensor(rng.normal(size=(16, 4)), dtype=F32)).sum().backward()
    pack = fused_f32.pack_f32(mlp, CPU)
    lay = fused_f32.workspace_layout(pack)
    dw = torch.zeros(int((lay[:, 1].astype(np.int64) * lay[:, 3]).sum()))
    db = torch.zeros(pack.total_b)
    grads = [(lyr.weight.grad, lyr.bias.grad) for lyr in mlp.trunk]
    grads.append((torch.cat([mlp.feature.weight.grad, mlp.sigma.weight.grad]),
                  torch.cat([mlp.feature.bias.grad, mlp.sigma.bias.grad])))
    grads += [(mlp.branch.weight.grad, mlp.branch.bias.grad), (mlp.rgb.weight.grad, mlp.rgb.bias.grad)]
    for (gw, gb), (k, n, _, _, b_off), (_, _, _, _, off) in zip(grads, pack.desc, lay):
        dw[off:off + k * n] = gw.T.reshape(-1)
        db[b_off - pack.b0:b_off - pack.b0 + n] = gb
    got = fused_f32.unpack_grads(mlp, pack, lay, dw, db)
    for (name, p), g in zip(mlp.named_parameters(), got):
        assert g.dtype == F32 and torch.equal(g, p.grad), name


@pytest.mark.parametrize("stop", [True, False])
def test_f32_parity_step_matches_jax(stop, monkeypatch):
    """One parity step at float32, hidden 24 (the f32 kernels' own widths),
    against the JAX step with its draws replayed: metrics and every
    gradient leaf (STOP_PDF_GRADIENT: K1/K2's path; without it K5's)."""
    cfg = _cfg(hidden_dim=24, stop_pdf_gradient=stop)
    st = _jax_state(cfg, 2)
    key = jax.random.PRNGKey(19)
    batch = _batch(3, cfg.batch_size)
    jbatch = tuple(jnp.asarray(v) for v in batch)
    _, jm = jstep.make_train_step(cfg, NEAR, FAR)(st, jbatch, key)
    with monkeypatch.context() as m:
        m.setattr(jstep, "make_optimizer", lambda c: _grab_grads())
        grads = jstep.make_train_step(cfg, NEAR, FAR)(
            st._replace(opt_state=_grab_grads().init(st.params)), jbatch, key)[0].opt_state
    tr = _port(cfg, st)
    pm = tr.train_step(batch, draws=_draws(cfg, key, 2, cfg.batch_size))
    merr = max(abs(float(pm[k]) / float(jm[k]) - 1.0) for k in ("loss_coarse", "loss", "psnr"))
    assert merr <= 5e-4, merr
    jg, pg = _leaves(grads), _leaves(tr.params_tree(grad=True))
    assert len(jg) == len(pg)
    gerr = [float(np.abs(c - a).max() / max(np.abs(a).max(), 1e-12)) for a, c in zip(jg, pg)]
    assert max(gerr) <= GRAD_TOL, gerr


def test_f32_proposal_step_matches_jax(monkeypatch):
    """One proposal-recipe step at float32, hidden 24, against the JAX step
    (``tests/test_torch_train.py``'s replay and tolerances)."""
    _check_step_matches_jax(_proposal_cfg(hidden_dim=24), 3, monkeypatch)
