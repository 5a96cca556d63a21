"""The offline-distilled proposal sampler against the JAX package's.

* ``NeRFMLP.sigma_logits`` against ``apply_nerf_sigma``: float32 to 1e-5,
  bfloat16 to 2e-2 relative (the products round their operands to bf16
  on both sides but sum in another order, which can flip a hidden
  activation's rounding).
* ``distill_proposal`` from the JAX init with the JAX run's ``jax.random``
  draws replayed, 20 steps: per-leaf relative L2 and the final loss to
  1e-4 in float32, 2e-2 in bfloat16 (where the targets themselves differ
  by bf16 roundings).
* ``Trainer.render_rays(sampler='proposal')``, float and int8, against the
  JAX ``Trainer`` with the same distilled net and int8 tables carried
  across: rgb 5e-3, depth 2e-2 (the render tests' tolerance: the fine
  samples follow ``sample_pdf``, ulps apart).
* The guards of ``tests/test_proposal.py``: no render before a build, no
  BatchNorm, no ``ns_fine=0``, and new weights drop the net.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_keras_tpu.config import NeRFConfig
from nerf_keras_tpu.engine.trainer import Trainer as JaxTrainer
from nerf_keras_tpu.models.mlp import apply_nerf_sigma, init_nerf_params
from nerf_keras_tpu.ops import encode_position as jax_encode
from nerf_keras_tpu.ops import proposal as jprop
from nerf_keras_tpu.utils.checkpoint import save_checkpoint
from nerf_keras_tpu_torch.engine.trainer import Trainer
from nerf_keras_tpu_torch.models.mlp import NeRFMLP
from nerf_keras_tpu_torch.ops.encoding import encode_position
from nerf_keras_tpu_torch.ops.proposal import distill_proposal
from nerf_keras_tpu_torch.ops.quant import qparams_to_jax
from nerf_keras_tpu_torch.ops.rays import pose_spherical

torch.set_num_threads(1)

L_XYZ, L_DIR, SKIP = 6, 3, 2
NEAR, FAR = 2.0, 6.0
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
DISTILL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _fine_params(seed):
    """A 4x64 fine MLP with noise on every leaf and the sigma bias at +1, so
    the density varies along the rays."""
    params = init_nerf_params(jax.random.PRNGKey(seed), num_layers=4, hidden_dim=64,
                              skip_layer=SKIP, l_xyz=L_XYZ, l_dir=L_DIR)
    rng = np.random.default_rng(seed)

    def bump(path, x):
        x = np.asarray(x) + rng.normal(size=x.shape).astype(np.float32) * 0.05
        return x + 1.0 if jax.tree_util.keystr(path) == "['sigma']['b']" else x

    return jax.tree_util.tree_map_with_path(bump, params)


def _rays(n, seed=0):
    rng = np.random.default_rng(seed)
    o = (np.tile([0, 0, 4.0], (n, 1)) + rng.normal(size=(n, 3)) * 0.2).astype(np.float32)
    d = -o / np.linalg.norm(o, axis=-1, keepdims=True) + rng.normal(size=(n, 3)) * 0.2
    return o, d.astype(np.float32)


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_sigma_logits_matches_apply_nerf_sigma(dtype):
    jdt, tdt = DTYPES[dtype]
    params = _fine_params(0)
    pts = np.random.default_rng(1).uniform(-1.5, 1.5, (500, 3)).astype(np.float32)
    x_enc = np.asarray(jax_encode(jnp.asarray(pts), L_XYZ))
    want = np.asarray(apply_nerf_sigma(params, jnp.asarray(x_enc).astype(jdt),
                                       compute_dtype=jdt, skip_layer=SKIP))
    mlp = NeRFMLP.from_jax_params(jax.device_get(params), skip_layer=SKIP, compute_dtype=tdt)
    with torch.no_grad():
        got = mlp.sigma_logits(torch.tensor(x_enc).to(tdt)).numpy()
        full = mlp(torch.tensor(x_enc).to(tdt), torch.zeros((500, mlp.dir_dim)).to(tdt))
    assert got.shape == (500,) and got.dtype == np.float32
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    else:
        assert _rel_l2(got, want) <= 2e-2
    # Raw logits: negative values survive (no ReLU), and the full forward's
    # sigma column is the same function.
    assert (got < 0).any()
    np.testing.assert_array_equal(full[:, 3].numpy(), got)


def _jax_draws(seed, steps, batch, n_rays, l_xyz=4, hidden=64, depth=3):
    """``distill_proposal``'s init and draws, rebuilt as ``proposal.py``
    makes them inside its scan."""
    k_init, k_scan = jax.random.split(jax.random.PRNGKey(seed))
    init = jprop.init_proposal(k_init, l_xyz=l_xyz, hidden=hidden, depth=depth)

    def draw(k):
        k_ray, k_t = jax.random.split(k)
        return (jax.random.randint(k_ray, (batch,), 0, n_rays),
                jax.random.uniform(k_t, (batch,), jnp.float32, NEAR, FAR))

    idx, t = jax.vmap(draw)(jax.random.split(k_scan, steps))
    return {"init": jax.device_get(init), "idx": np.asarray(idx, np.int64),
            "t": np.asarray(t)}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_distill_proposal_matches_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    params = _fine_params(2)
    o, d = _rays(300, seed=3)
    steps, batch = 20, 256

    def jax_sigma(pts):
        return apply_nerf_sigma(params, jax_encode(pts, L_XYZ).astype(jdt),
                                compute_dtype=jdt, skip_layer=SKIP)

    want, want_loss = jprop.distill_proposal(
        jax.random.PRNGKey(5), jax_sigma, o, d, NEAR, FAR, steps=steps, batch=batch)
    mlp = NeRFMLP.from_jax_params(jax.device_get(params), skip_layer=SKIP, compute_dtype=tdt)
    losses = []
    net, loss = distill_proposal(
        lambda pts: mlp.sigma_logits(encode_position(pts, L_XYZ).to(tdt)),
        torch.tensor(o), torch.tensor(d), NEAR, FAR, steps=steps, batch=batch,
        draws=_jax_draws(5, steps, batch, 300), losses_out=losses)
    tol = DISTILL_TOL[dtype]
    assert len(losses) == steps and losses[-1] == loss
    assert abs(loss - want_loss) <= tol * abs(want_loss)
    got_leaves = jax.tree_util.tree_leaves(net.to_jax_params())
    want_leaves = jax.tree_util.tree_leaves(jax.device_get(want))
    assert len(got_leaves) == len(want_leaves) == 6
    for g, w in zip(got_leaves, want_leaves):
        assert g.shape == w.shape
        assert _rel_l2(g, np.asarray(w)) <= tol
    assert loss < losses[0]
    assert not any(p.requires_grad for p in net.parameters())


def test_distill_proposal_draws_from_its_generator():
    """Without ``draws`` the init and every step's draws come from the
    generator: the same seed gives the same net, another seed another."""
    params = _fine_params(4)
    mlp = NeRFMLP.from_jax_params(jax.device_get(params), skip_layer=SKIP,
                                  compute_dtype=torch.float32)
    o, d = (torch.tensor(x) for x in _rays(50))

    def run(seed):
        net, loss = distill_proposal(
            lambda pts: mlp.sigma_logits(encode_position(pts, L_XYZ)), o, d, NEAR, FAR,
            steps=5, batch=64, generator=torch.Generator().manual_seed(seed))
        return net.to_jax_params()["layers"][0]["w"], loss

    a, b, c = run(1), run(1), run(2)
    np.testing.assert_array_equal(a[0], b[0])
    assert a[1] == b[1] and not np.array_equal(a[0], c[0])
    with pytest.raises(ValueError, match="draws"):
        distill_proposal(lambda pts: pts[:, 0], o, d, NEAR, FAR, steps=5, batch=64,
                         draws=_jax_draws(0, 4, 64, 50))


def _cfg(**kw):
    base = dict(batch_size=64, ns_coarse=8, ns_fine=16, num_layers=4, hidden_dim=64,
                skip_layer=SKIP, l_xyz=L_XYZ, l_dir=L_DIR, height=20, width=20,
                compute_dtype="float32", use_pallas=False)
    base.update(kw)
    return NeRFConfig(**base).validate()


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """A JAX Trainer with a distilled net and the port's on the same
    checkpoint, the net carried to the port and the port's int8 tables to
    JAX (one calibration: JAX's costs ~9 s of CPU)."""
    cfg = _cfg()
    jt = JaxTrainer(cfg, NEAR, FAR)
    fine = _fine_params(6)
    coarse = _fine_params(7)
    jt.replace_params({"coarse": coarse, "fine": fine})
    path = str(tmp_path_factory.mktemp("distill") / "m.ckpt.npz")
    save_checkpoint(path, jax.device_get(jt.state), cfg, scene={"near": NEAR, "far": FAR})
    o, d = (np.asarray(x) for x in jt.pose_rays(pose_spherical(30.0, -30.0, 4.0), 20, 20, 24.0))
    jt.build_proposal_sampler(o, d, steps=30, batch=256)
    pt = Trainer(cfg, NEAR, FAR, device="cpu").restore(path)
    pt._install_proposal(jax.device_get(jt._pparams), jt._prop_l_xyz)
    pt.quantize_for_inference(o, d)
    jt._install_quant(qparams_to_jax(pt.qparams))
    return cfg, jt, pt, path, (o, d)


@pytest.mark.parametrize("quant", [False, True])
def test_proposal_render_matches_jax(pair, quant):
    cfg, jt, pt, _, (o, d) = pair
    # 400 rays in chunks of 96: the last chunk is padded with dummy rays.
    want = jt.render_rays(o, d, chunk=96, sampler="proposal", quant=quant)
    got = pt.render_rays(o, d, chunk=96, sampler="proposal", quant=quant)
    assert sorted(got) == sorted(want) == ["depth_fine", "rgb_fine"]
    for k, tol in (("rgb_fine", 5e-3), ("depth_fine", 2e-2)):
        assert got[k].shape == want[k].shape and np.isfinite(got[k]).all()
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=tol, rtol=0, err_msg=k)
    # Not the coarse-sampled render, but close to it.
    coarse = pt.render_rays(o, d, chunk=96, keys=("rgb_fine",), quant=quant)["rgb_fine"]
    assert not np.array_equal(coarse, got["rgb_fine"])
    assert np.sqrt(np.mean((coarse - got["rgb_fine"]) ** 2)) < 0.05
    frame = pt.render_image(pose_spherical(30.0, -30.0, 4.0), 20, 20, 24.0, chunk=96,
                            sampler="proposal", quant=quant)
    np.testing.assert_array_equal(frame["rgb"].reshape(-1, 3), got["rgb_fine"])


def test_proposal_render_guards(pair, tmp_path):
    cfg, jt, pt, path, (o, d) = pair
    fresh = Trainer(cfg, NEAR, FAR, device="cpu").restore(path)
    assert not fresh.proposal_ready and not fresh.online_proposal
    with pytest.raises(RuntimeError, match="build_proposal_sampler"):
        fresh.render_rays(o, d, chunk=64, sampler="proposal")
    with pytest.raises(ValueError, match="sampler"):
        fresh.render_rays(o, d, chunk=64, sampler="grid")
    fresh.build_proposal_sampler(o, d, steps=3, batch=64)
    assert fresh.proposal_ready and len(fresh.distill_losses) == 3
    with pytest.raises(ValueError, match="fine only"):
        fresh.render_rays(o, d, chunk=64, sampler="proposal", full=True)
    with pytest.raises(ValueError, match="fine only"):
        fresh.render_rays(o, d, chunk=64, sampler="proposal", keys=("weights_fine",))
    with pytest.raises(ValueError, match="no coarse outputs"):
        fresh.render_rays(o, d, chunk=64, sampler="proposal", keys=("rgb_coarse",))
    with pytest.raises(ValueError, match="no coarse outputs"):
        fresh.render_image(pose_spherical(0.0, -30.0, 4.0), 8, 8, 9.6, sampler="proposal",
                           include_coarse=True)
    with pytest.raises(RuntimeError, match="quantize_for_inference"):
        fresh.render_rays(o, d, chunk=64, sampler="proposal", quant=True)
    # New weights drop the net: restore, replace_params, train_step.
    fresh.restore(path)
    assert not fresh.proposal_ready
    fresh.build_proposal_sampler(o, d, steps=2, batch=64)
    fresh.replace_params(fresh.params_tree())
    assert not fresh.proposal_ready
    fresh.build_proposal_sampler(o, d, steps=2, batch=64)
    rng = np.random.default_rng(0)
    fresh.train_step((rng.uniform(0, 1, (64, 3)).astype(np.float32), o[:64], d[:64]))
    assert not fresh.proposal_ready
    with pytest.raises(RuntimeError, match="build_proposal_sampler"):
        fresh.render_rays(o, d, chunk=64, sampler="proposal")

    bn = Trainer(_cfg(batch_norm=True), NEAR, FAR, device="cpu")
    with pytest.raises(ValueError, match="BatchNorm"):
        bn.build_proposal_sampler(o, d, steps=1, batch=8)
    with pytest.raises(ValueError, match="BatchNorm"):
        bn.eval_params["fine"].sigma_logits(torch.zeros((2, 3 + 6 * L_XYZ)))
    no_fine = Trainer(_cfg(ns_fine=0), NEAR, FAR, device="cpu")
    with pytest.raises(ValueError, match="ns_fine"):
        no_fine.build_proposal_sampler(o, d, steps=1, batch=8)
    online = Trainer(_cfg(train_sampler="proposal", prop_anneal_steps=10), NEAR, FAR,
                     device="cpu")
    assert online.proposal_ready and online.online_proposal
    with pytest.raises(ValueError, match="already carry"):
        online.build_proposal_sampler(o, d, steps=1, batch=8)


def test_build_subsamples_and_distills_the_eval_weights(pair, monkeypatch):
    """``build_proposal_sampler`` draws its rays as the JAX ``Trainer``
    (``default_rng(seed).choice``) and distills the EMA shadow when EMA is
    on, through ``sigma_logits`` on the compute-dtype encoding."""
    cfg, jt, _, path, (o, d) = pair
    import nerf_keras_tpu_torch.engine.trainer as ptrainer

    seen = {}

    def spy(sigma_fn, origins, directions, near, far, **kw):
        seen.update(o=origins.numpy(), sigma=sigma_fn(origins[:7] + directions[:7] * 3.0))
        return distill_proposal(sigma_fn, origins, directions, near, far, **kw)

    monkeypatch.setattr(ptrainer, "distill_proposal", spy)
    ema_cfg = _cfg(ema_decay=0.9)
    tr = Trainer(ema_cfg, NEAR, FAR, device="cpu").restore(path)
    shadow = jax.tree_util.tree_map(lambda x: np.asarray(x) * 0.5, tr.params_tree())
    ptrainer._load(tr.ema, shadow)
    tr.build_proposal_sampler(o, d, calib_rays=50, seed=3, steps=1, batch=8)
    idx = np.random.default_rng(3).choice(o.shape[0], 50, replace=False)
    np.testing.assert_array_equal(seen["o"], o[idx])
    pts = jnp.asarray(o[idx][:7] + d[idx][:7] * 3.0)
    want = apply_nerf_sigma(shadow["fine"], jax_encode(pts, L_XYZ), compute_dtype=jnp.float32,
                            skip_layer=SKIP)
    np.testing.assert_allclose(seen["sigma"].numpy(), np.asarray(want), atol=1e-5, rtol=0)
