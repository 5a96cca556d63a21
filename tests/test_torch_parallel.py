"""The port's data parallelism over rays (``nerf_keras_tpu_torch/parallel``).

Two real gloo processes on the CPU (``parallel/audit.run_two_process_smoke``;
the port takes each kernel's plain version there) train a few steps at tiny
widths (2 layers, hidden 16, 4 + 8 samples, global batch 32, float32):

* the two ranks' metrics agree to 1e-6 and their parameters, EMA and
  BatchNorm statistics bit for bit;
* the first step's reduced gradients and metrics equal one port process on
  the concatenated batch with the same draws (per leaf max |diff| over the
  leaf's largest entry <= 1e-5, metrics rtol 1e-5: only the float32
  summation is split), and the JAX train step on the same global batch with
  its own draws replayed (5e-4, the tolerances of
  ``tests/test_torch_train_coarse.py``).  Measured at these inputs: the
  gradients 1.3e-7 to 1.8e-6 of one process and 7.1e-7 to 6.7e-6 of JAX,
  the metrics 9e-8 to 1.2e-7 relative to one process and up to 2.2e-6 to
  JAX;
* the collectives: one all-reduce of exactly sum(numel) + N_METRICS
  elements a step (BatchNorm: 1 + 4 per BN layer), none on the render.

In-process: the launch environment's checks and the mesh-shape repairs
(a mesh other than the world size, a world the model axis does not
divide, and a batch that does not divide raise; tensor parallelism is
``tests/test_torch_tensor_parallel.py``'s).  A tiny two-rank ``cli.train_synthetic`` run
checks that rank 0 alone writes.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerf_keras_tpu.config import NeRFConfig as JaxConfig
from nerf_keras_tpu.engine import step as jstep
from nerf_keras_tpu_torch.cli import train_synthetic
from nerf_keras_tpu_torch.config import NeRFConfig
from nerf_keras_tpu_torch.engine import step as pstep
from nerf_keras_tpu_torch.engine.trainer import Trainer
from nerf_keras_tpu_torch.parallel import distributed, mesh as pmesh
from nerf_keras_tpu_torch.parallel.audit import free_port, run_two_process_smoke
from nerf_keras_tpu_torch.profile_train import bench_batch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
NEAR, FAR = 2.0, 6.0
LR = 5e-3
RANK_TOL = 1e-6      # the two ranks' metrics (their parameters: bit for bit)
SPLIT_TOL = 1e-5     # the ranks against one port process on the whole batch
JAX_TOL = 5e-4       # against the JAX step (test_torch_train_coarse.py)
TIMEOUT = 120

BASE = dict(batch_size=32, ns_coarse=4, ns_fine=8, num_layers=2, hidden_dim=16,
            skip_layer=4, l_xyz=4, l_dir=2, compute_dtype="float32", use_pallas=False,
            learning_rate=LR, height=8, width=8)
CASES = {
    # No EMA: the render is then of the trained parameters, which a
    # one-process trainer can load (replace_params resets the shadow).
    "parity": dict(start=3),
    "parity_white_dist": dict(start=2, white_bkgd=True, distortion_loss_mult=1e-4,
                              ema_decay=0.9),
    "proposal": dict(start=5, train_sampler="proposal", distortion_loss_mult=1e-4,
                     prop_anneal_steps=10, prop_explore=0.03, ema_decay=0.9),
    "bn": dict(start=3, batch_norm=True, ema_decay=0.9),
}


def _kw(case):
    kw = dict(BASE, **CASES[case])
    kw.pop("start")
    return kw


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _grab_grads():
    """An optax transform whose state after ``update`` is the gradients."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g),
    )


def _jax_draws(cfg, key, step, b):
    """The uniforms the JAX train step draws at ``step`` over the global
    batch (``step.py:935``; the chain's per-level splits for proposal)."""
    key_t, key_pdf = jax.random.split(jax.random.fold_in(key, step))
    out = {"t": torch.as_tensor(np.array(jax.random.uniform(key_t, (b, cfg.ns_coarse))))}
    if cfg.train_sampler != "proposal":
        out["pdf"] = torch.as_tensor(np.array(
            jax.random.uniform(key_pdf, (b, cfg.ns_fine), dtype=jnp.float32)))
        return out
    chain, k = [], key_pdf
    for i in range(cfg.prop_levels):
        k, sub = jax.random.split(k)
        n = cfg.ns_fine if i == cfg.prop_levels - 1 else (cfg.prop_samples or cfg.ns_coarse)
        chain.append(torch.as_tensor(np.array(jax.random.uniform(sub, (b, n), dtype=jnp.float32))))
    out["chain"] = chain
    return out


def _jax_state(cfg, step):
    st = jstep.init_train_state(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(3)

    def bias(x):  # nonzero biases, so the bias paths are under test
        x = np.asarray(x, np.float32)
        if x.ndim != 1:
            return jnp.asarray(x)
        return jnp.asarray(x + (rng.normal(size=x.shape) * 0.1).astype(np.float32))

    return st._replace(params=jax.tree_util.tree_map(bias, st.params),
                       step=jnp.asarray(step, jnp.int32))


def _grad_errors(want, got):
    """Per leaf max |diff| over the leaf's largest entry; a leaf whose
    gradient is 0 in exact arithmetic (a bias feeding a BatchNorm layer:
    the batch mean subtracts it) over its model's largest entry."""
    errs = []
    for name in want:
        w, g = _leaves(want[name]), _leaves(got[name])
        assert len(w) == len(g)
        model_max = max(float(np.abs(a).max()) for a in w)
        for a, c in zip(w, g):
            scale = float(np.abs(a).max())
            errs.append(float(np.abs(c - a).max()) / (scale if scale >= 1e-6 * model_max
                                                      else model_max))
    return max(errs)


def _rel(a, b):
    return abs(a / b - 1.0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_ranks_equal_one_process_and_jax(case, monkeypatch):
    """Two gloo ranks, 16 rays each, 3 steps from the JAX state at step
    ``start`` (the first with the JAX step's draws): the ranks agree, and
    the first step's reduced gradients and global metrics equal one port
    process on the 32 rays and the JAX step; one all-reduce of exactly
    the parameters + 3 metrics (BatchNorm: 1 + 4 per BN layer); the
    BatchNorm running statistics are the global batch's, on both ranks."""
    kw = _kw(case)
    jcfg = JaxConfig(**kw).validate()
    pcfg = NeRFConfig(**kw).validate()
    start = CASES[case]["start"]
    st = _jax_state(jcfg, start)
    key = jax.random.PRNGKey(11)
    batch = bench_batch(jcfg.batch_size, seed=1)
    draws = _jax_draws(jcfg, key, start, jcfg.batch_size)

    jbatch = tuple(jnp.asarray(x) for x in batch)
    new_st, jm = jax.jit(jstep.make_train_step(jcfg, NEAR, FAR))(st, jbatch, key)
    with monkeypatch.context() as m:
        m.setattr(jstep, "make_optimizer", lambda c: _grab_grads())
        jgrads = jax.jit(jstep.make_train_step(jcfg, NEAR, FAR))(
            st._replace(opt_state=_grab_grads().init(st.params)), jbatch, key)[0].opt_state

    params, bn = _np(st.params), (_np(st.bn) if pcfg.batch_norm else None)
    ranks = run_two_process_smoke(
        "cpu", cfg_overrides=kw, timeout=TIMEOUT, near=NEAR, far=FAR, batch=batch,
        draws=draws, params=params, bn=bn, start_step=start, steps=3, render_rays=20,
        render_chunk=8)
    a, b = ranks
    assert (a["rank"], b["rank"], a["world"], a["backend"]) == (0, 1, 2, "gloo")
    for ma, mb in zip(a["metrics"], b["metrics"]):
        for k in ma:
            assert _rel(mb[k], ma[k]) <= RANK_TOL, (k, ma, mb)
    assert a["digest"] == b["digest"]
    for x, y in zip(_leaves(a["params"]), _leaves(b["params"])):
        np.testing.assert_array_equal(x, y)

    one = Trainer(pcfg, NEAR, FAR, device="cpu")
    one.replace_params(params, bn)
    one.step = start
    om = one.train_step(batch, draws=draws)
    ograds = one.params_tree(grad=True)
    for k in ("loss_coarse", "loss", "psnr"):
        assert _rel(a["metrics"][0][k], float(om[k])) <= SPLIT_TOL, k
        assert _rel(a["metrics"][0][k], float(jm[k])) <= JAX_TOL, k
    assert _grad_errors(ograds, a["grads"]) <= SPLIT_TOL
    assert _grad_errors(_np(jgrads), a["grads"]) <= JAX_TOL

    n_params = sum(p.numel() for p in pstep.params_of(one.params))
    n_bn = 2 * (pcfg.num_layers + 1) if pcfg.batch_norm else 0
    bn_elements = 2 * (pcfg.num_layers * pcfg.hidden_dim + pcfg.hidden_dim // 2)
    assert a["audit"]["all_reduce_count"] == 1 + 4 * n_bn == (25 if pcfg.batch_norm else 1)
    assert a["audit"]["all_reduce_elements"] == (
        n_params + pstep.N_METRICS + 4 * (bn_elements if pcfg.batch_norm else 0))
    # One chunk of 8 rays = 4 a rank; 20 rays in 3 chunks; rgb + depth of
    # both passes (the proposal render: fine only).
    maps = 2 if pcfg.train_sampler == "proposal" else 4
    assert a["render_collectives"] == {
        "all_reduce": 0, "all_gather": 3 * maps, "broadcast": 0, "broadcast_object": 0,
        "all_reduce_elements": 0, "all_gather_elements": 3 * 8 * (4 if maps == 2 else 8),
        "broadcast_elements": 0, "broadcast_object_elements": 0}
    for k in a["render"]:
        np.testing.assert_array_equal(a["render"][k], b["render"][k])

    if pcfg.batch_norm:
        for x, y, z, j in zip(_leaves(a["bn_first"]), _leaves(b["bn_first"]),
                              _leaves(one.bn_tree()), _leaves(new_st.bn)):
            np.testing.assert_array_equal(x, y)
            np.testing.assert_allclose(x, z, rtol=0, atol=1e-6)
            np.testing.assert_allclose(x, j, rtol=0, atol=1e-6)
        assert max(float(np.abs(x - y).max()) for x, y in
                   zip(_leaves(a["bn_first"]), _leaves(bn))) > 1e-4  # they moved
    if not pcfg.ema_decay:
        # The gathered render is the one-process render of the same weights.
        final = Trainer(pcfg, NEAR, FAR, device="cpu").replace_params(a["params"], a["bn"])
        final.step = start + 3
        want = final.render_rays(batch[1][:20], batch[2][:20], chunk=8)
        for k, v in want.items():
            np.testing.assert_allclose(a["render"][k], v, rtol=0, atol=1e-6)


def test_two_ranks_draw_the_one_process_stream():
    """Without replayed draws every rank draws the global uniforms from the
    shared seeded generator and keeps its rows: the two-rank step equals
    the one-process step on the concatenated batch, the parity step and
    the proposal step's two-level chain alike."""
    for extra in ({}, dict(train_sampler="proposal", prop_levels=2, prop_samples=6,
                           prop_anneal_steps=10)):
        kw = dict(BASE, **extra)
        pcfg = NeRFConfig(**kw).validate()
        batch = bench_batch(pcfg.batch_size, seed=2)
        a, _ = run_two_process_smoke("cpu", cfg_overrides=kw, timeout=TIMEOUT, near=NEAR,
                                     far=FAR, batch=batch, steps=1)
        one = Trainer(pcfg, NEAR, FAR, device="cpu")
        om = one.train_step(batch)
        for k in om:
            assert _rel(a["metrics"][0][k], float(om[k])) <= SPLIT_TOL, k
        assert _grad_errors(one.params_tree(grad=True), a["grads"]) <= SPLIT_TOL


@pytest.mark.parametrize("case", ["parity", "proposal_two_levels", "shared_t"])
def test_rank_draws_are_rows_of_the_global_draws(case):
    """``rank_draws`` of rank r of 4 is rows [8r, 8r + 8) of what one
    process draws from the same seed, in the one-process order."""
    extra = {"parity": {},
             "proposal_two_levels": dict(train_sampler="proposal", prop_levels=2,
                                         prop_samples=6),
             "shared_t": dict(sampling_mode="shared")}[case]
    cfg = NeRFConfig(**dict(BASE, **extra)).validate()
    world, b = 4, cfg.batch_size
    whole = pstep.rank_draws(cfg, pmesh.Mesh(1, 1, 0, 0, torch.device("cpu")), b, None,
                             torch.Generator().manual_seed(5), "cpu")
    gen = torch.Generator().manual_seed(5)
    shared = cfg.sampling_mode == "shared"
    t = torch.rand((cfg.ns_coarse,) if shared else (b, cfg.ns_coarse), generator=gen)
    torch.testing.assert_close(whole["t"], t, rtol=0, atol=0)
    for r in range(world):
        part = pstep.rank_draws(cfg, pmesh.Mesh(world, 1, r, 0, torch.device("cpu")),
                                b // world, None, torch.Generator().manual_seed(5), "cpu")
        rows = slice(8 * r, 8 * r + 8)
        torch.testing.assert_close(part["t"], whole["t"] if shared else whole["t"][rows],
                                   rtol=0, atol=0)
        key = "chain" if "chain" in whole else "pdf"
        wl = whole[key] if key == "chain" else [whole[key]]
        pl = part[key] if key == "chain" else [part[key]]
        assert len(wl) == len(pl) == (2 if key == "chain" else 1)
        for w, p in zip(wl, pl):
            torch.testing.assert_close(p, w[rows], rtol=0, atol=0)


@pytest.mark.parametrize("n,world,rank,want", [(32, 4, 1, (8, 16)), (32, 2, 0, (0, 16)),
                                               (6, 3, 2, (4, 6))])
def test_local_rows_follow_rank_order(n, world, rank, want):
    rows = pmesh.local_rows(n, pmesh.Mesh(world, 1, rank, 0, torch.device("cpu")))
    assert (rows.start, rows.stop) == want


def test_local_rows_refuse_a_ragged_batch():
    with pytest.raises(ValueError, match="not divisible"):
        pmesh.local_rows(33, pmesh.Mesh(2, 1, 0, 0, torch.device("cpu")))


@pytest.mark.parametrize("data,model,world,error", [
    (2, 1, 1, ValueError), (8, 1, 4, ValueError), (1, 1, 2, ValueError),
    (0, 1, 1, ValueError), (-1, 2, 3, ValueError), (2, 2, 2, ValueError),
    (1, 2, 4, ValueError), (1, 0, 1, ValueError)])
def test_mesh_shapes_the_port_cannot_run_raise(data, model, world, error):
    with pytest.raises(error):
        pmesh.check_mesh_shape(data, model, world)


@pytest.mark.parametrize("data,world", [(-1, 1), (-1, 4), (4, 4), (1, 1)])
def test_mesh_shape_resolves_to_the_world(data, world):
    assert pmesh.check_mesh_shape(data, 1, world) == world


@pytest.mark.parametrize("field,value,error", [("mesh_data", 2, ValueError),
                                               ("mesh_model", 2, ValueError)])
def test_trainer_refuses_a_mesh_it_cannot_run(field, value, error):
    """One process: MESH_DATA=2 needs two ranks, MESH_MODEL=2 a world that
    2 divides; both raise instead of training on one device."""
    cfg = NeRFConfig(**dict(BASE, **{field: value})).validate()
    with pytest.raises(error):
        Trainer(cfg, NEAR, FAR, device="cpu")


def test_trainer_refuses_a_batch_the_ranks_cannot_split():
    cfg = NeRFConfig(**dict(BASE, batch_size=33)).validate()
    with pytest.raises(ValueError, match="divisible"):
        Trainer(cfg, NEAR, FAR, mesh=pmesh.Mesh(2, 1, 0, 0, torch.device("cpu")))


@pytest.mark.parametrize("field,value,error", [("MESH_DATA", 2, ValueError),
                                               ("MESH_MODEL", 2, ValueError)])
def test_cli_refuses_a_mesh_it_cannot_run(tmp_path, field, value, error):
    cfg = tmp_path / "mesh.json"
    cfg.write_text(json.dumps({"BATCH_SIZE": 32, "WITH_GCS": False, field: value}))
    with pytest.raises(error):
        train_synthetic.main(["--config", str(cfg), "--run-dir", str(tmp_path / "run"),
                              "--device", "cpu"])
    assert not (tmp_path / "run").exists()


def _clear_launch_env(monkeypatch):
    for k in distributed.TRIO + distributed.TORCHRUN:
        monkeypatch.delenv(k, raising=False)


def test_partial_env_trio_raises(monkeypatch):
    """A partial NERF_* trio is a misconfigured launch: it raises naming
    the missing variable, before any process group starts."""
    _clear_launch_env(monkeypatch)
    monkeypatch.setenv("NERF_COORDINATOR", "127.0.0.1:9999")
    monkeypatch.setenv("NERF_NUM_PROCESSES", "2")
    with pytest.raises(RuntimeError, match="NERF_PROCESS_ID"):
        distributed.maybe_initialize("cpu")
    monkeypatch.setenv("NERF_PROCESS_ID", "")
    with pytest.raises(RuntimeError, match="NERF_PROCESS_ID"):
        distributed.maybe_initialize("cpu")
    assert not torch.distributed.is_initialized()


def test_no_launch_env_is_one_process(monkeypatch):
    _clear_launch_env(monkeypatch)
    assert distributed.maybe_initialize("cpu") is False
    assert distributed.process_info() == (0, 1)
    assert pmesh.config_mesh(-1, 1) is None
    with pytest.raises(RuntimeError, match="maybe_initialize"):
        pmesh.make_mesh()


def test_torchrun_env_is_a_launch(monkeypatch):
    _clear_launch_env(monkeypatch)
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "29500")
    assert distributed.launch_env() == ("env://", 4, 3)
    monkeypatch.setenv("NERF_COORDINATOR", "localhost:1234")
    monkeypatch.setenv("NERF_NUM_PROCESSES", "2")
    monkeypatch.setenv("NERF_PROCESS_ID", "1")
    assert distributed.launch_env() == ("tcp://localhost:1234", 2, 1)


def test_two_rank_cli_run_writes_from_rank_zero_only(tmp_path):
    """``cli.train_synthetic`` as two gloo ranks (the NERF_* trio), one
    epoch: each rank prints its rank and the same global epoch metrics;
    rank 0's run dir gets the checkpoint, history and panels, and rank 1
    (pointed at another run dir) writes nothing."""
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps({
        "BATCH_SIZE": 128, "NS_COARSE": 8, "NS_FINE": 8, "HEIGHT": 16, "WIDTH": 16,
        "L_XYZ": 4, "L_DIR": 2, "NUM_LAYERS": 2, "HIDDEN_DIM": 16, "SKIP_LAYER": 4,
        "EPOCHS": 1, "LEARNING_RATE": 0.005, "BATCH_NORM": False, "WITH_GCS": False,
        "COMPUTE_DTYPE": "float32", "EVAL_EVERY": 1}))
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               NERF_COORDINATOR=f"localhost:{free_port()}", NERF_NUM_PROCESSES="2")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "nerf_keras_tpu_torch.cli.train_synthetic", "--config",
         str(cfg), "--run-dir", str(tmp_path / f"run{r}"), "--device", "cpu"],
        env=dict(env, NERF_PROCESS_ID=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], [err[-2000:] for _, err in logs]
    outs = [out for out, _ in logs]
    for r, out in enumerate(outs):
        assert f"rank {r}/2" in out
        # 9 train views of 16x16 = 2,304 rays: 1,152 a rank, 18 steps of 64.
        assert "rays: train=1152" in out
    epochs = [[line.split(" (")[0] for line in out.splitlines() if line.startswith("epoch ")]
              for out in outs]
    vals = [[line for line in out.splitlines() if line.startswith("  val:")] for out in outs]
    assert len(epochs[0]) == 1 and epochs[0] == epochs[1] and vals[0] == vals[1]
    names = sorted(os.listdir(tmp_path / "run0"))
    assert "nerf_l2_d16_n16_ep1.ckpt.npz" in names and "history_l2_d16_n16_ep1.json" in names
    assert sorted(os.listdir(tmp_path / "run0" / "images")) == ["000.png"]
    assert not (tmp_path / "run1").exists()

