"""Tensor parallelism in the port: ``MESH_MODEL > 1``, the Megatron split
of the NeRF MLPs over the model axis of a ``(data, model)`` mesh
(``parallel/mesh.py``, ``models/mlp.py``).

Real gloo processes on the CPU (``parallel/audit.run_ranks``; the kernels'
plain versions) at tiny widths: 6 layers, hidden 16, skip 4, ``L_XYZ`` 4,
``L_DIR`` 2, 4 + 8 samples, global batch 32, float32.  Layer 5 then reads
the 16 + 27 = 43-wide skip concat, which 2 does not divide: it stays
whole, so the replicated fallback runs.  Two launches, each once per
pytest run (shared by the pytest workers through a file lock):

* ``(1, 2)``, several jobs in turn: five train cases (parity, proposal,
  ``STOP_PDF_GRADIENT=false``, BatchNorm, a union-free step with the aux
  pass) from the JAX state at a step, the first step with the JAX step's
  draws; a one-process checkpoint resumed; the int8 tables, the distilled
  net, their cache and the renders; ``cli.evaluate``, ``cli.infer`` and
  the server.
* ``(2, 2)``: BatchNorm without ``STOP_PDF_GRADIENT`` (the data group's
  moments and the encodings' gradients through the split).

Held to: one port process on the same batch and draws (the first step's
reduced gradients, each leaf's max |diff| over its largest entry, and the
metrics, 1e-5 relative: only the float32 summation order of the split
products differs; the parameters after 3 steps to 1e-5); the JAX
one-device train step with its draws replayed (5e-4, as
``tests/test_torch_parallel.py``); the collectives, element for element.
In one process: ``param_layout`` against the JAX ``nerf_param_shardings``
leaf for leaf.  A two-rank ``cli.train_synthetic`` with ``MESH_MODEL: 2``
writes from rank 0 only.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from nerf_keras_tpu.config import NeRFConfig as JaxConfig
from nerf_keras_tpu.engine import step as jstep
from nerf_keras_tpu.engine.trainer import Trainer as JaxTrainer
from nerf_keras_tpu.models.mlp import init_nerf_params
from nerf_keras_tpu.parallel.mesh import make_mesh, nerf_param_shardings
from nerf_keras_tpu_torch.cli import evaluate, infer
from nerf_keras_tpu_torch.config import NeRFConfig, load_config
from nerf_keras_tpu_torch.engine import step as pstep
from nerf_keras_tpu_torch.engine.trainer import Trainer
from nerf_keras_tpu_torch.models.mlp import NeRFMLP, random_params
from nerf_keras_tpu_torch.ops.freq_anneal import fold_nerf_params, freq_window
from nerf_keras_tpu_torch.ops.rays import pose_spherical
from nerf_keras_tpu_torch.parallel import mesh as pmesh
from nerf_keras_tpu_torch.parallel.audit import artifact_digests, free_port, run_ranks
from nerf_keras_tpu_torch.profile_train import bench_batch
from nerf_keras_tpu_torch.utils.checkpoint import _flatten
from nerf_keras_tpu_torch.utils.gif import decode_gif
from tests.test_torch_dp_infer import _once
from tests.test_torch_parallel import _grab_grads, _grad_errors, _jax_state, _leaves, _np, _rel

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
NEAR, FAR = 2.0, 6.0
SPLIT_TOL = 1e-5     # against one port process on the same batch and draws
JAX_TOL = 5e-4       # against the JAX one-device step
TIMEOUT = 300
KW = dict(batch_size=32, ns_coarse=4, ns_fine=8, num_layers=6, hidden_dim=16,
          skip_layer=4, l_xyz=4, l_dir=2, compute_dtype="float32", use_pallas=False,
          learning_rate=5e-3, height=8, width=8)
CASES = {
    "parity": dict(start=3),
    "proposal": dict(start=5, train_sampler="proposal", distortion_loss_mult=1e-4,
                     prop_anneal_steps=10, prop_explore=0.03, ema_decay=0.9),
    "no_stop_pdf": dict(start=2, stop_pdf_gradient=False),
    "bn": dict(start=3, batch_norm=True, ema_decay=0.9),
    "union_free_aux": dict(start=4, train_sampler="proposal", prop_union=False,
                           prop_aux_samples=4, prop_anneal_steps=10),
}
MESH22_CASE = dict(start=2, stop_pdf_gradient=False, batch_norm=True)
BATCH = bench_batch(32, seed=1)
KEY = 11
FOCAL = 9.6
CHUNK = 24
DISTILL = dict(steps=6, batch=64)
RAW = {"BATCH_SIZE": 32, "NS_COARSE": 4, "NS_FINE": 8, "HEIGHT": 8, "WIDTH": 8, "L_XYZ": 4,
       "L_DIR": 2, "NUM_LAYERS": 6, "HIDDEN_DIM": 16, "SKIP_LAYER": 4,
       "COMPUTE_DTYPE": "float32", "USE_PALLAS": False, "WITH_GCS": False}
REQUESTS = [("GET", "/render?theta=10&width=8&height=8"), ("GET", "/stats")]


def _kw(extra: dict) -> dict:
    kw = dict(KW, **extra)
    kw.pop("start")
    return kw


def _jax_draws(cfg, step, b):
    """The JAX train step's uniforms at ``step`` over the global batch: t,
    then the fine draw, or (proposal) the chain key split into (chain,
    aux) on a step with the aux pass, one split per level."""
    key_t, key_pdf = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(KEY), step))
    out = {"t": torch.as_tensor(np.array(jax.random.uniform(key_t, (b, cfg.ns_coarse))))}
    if cfg.train_sampler != "proposal":
        out["pdf"] = torch.as_tensor(np.array(jax.random.uniform(key_pdf, (b, cfg.ns_fine))))
        return out
    if pstep.aux_samples(cfg, step):
        key_pdf, key_aux = jax.random.split(key_pdf)
        out["aux"] = torch.as_tensor(np.array(
            jax.random.uniform(key_aux, (b, cfg.prop_aux_samples))))
    chain, k = [], key_pdf
    for i in range(cfg.prop_levels):
        k, sub = jax.random.split(k)
        n = cfg.ns_fine if i == cfg.prop_levels - 1 else (cfg.prop_samples or cfg.ns_coarse)
        chain.append(torch.as_tensor(np.array(jax.random.uniform(sub, (b, n)))))
    out["chain"] = chain
    return out


def _state(jcfg, start):
    """The JAX state at ``start`` with nonzero biases, the sigma heads' at
    +1 (a field dense enough that every model's gradient is nonzero: at
    6 layers with BatchNorm the fine sigma sits below 0 everywhere
    otherwise, and its gradients are exactly 0)."""
    st = _jax_state(jcfg, start)
    params = dict(st.params)
    for name in ("coarse", "fine"):
        if name in params:
            params[name] = dict(params[name], sigma=dict(
                params[name]["sigma"], b=params[name]["sigma"]["b"] + 1.0))
    return st._replace(params=params)


def _train_job(extra: dict, model: int, data: int = 1, **more) -> dict:
    """A train job of ``extra``'s case over the mesh, from the JAX state at
    its start step, the first step with the JAX draws."""
    kw = _kw(extra)
    jcfg = JaxConfig(**kw).validate()
    st = _state(jcfg, extra["start"])
    return dict({"cfg": NeRFConfig(**kw, mesh_data=data, mesh_model=model).validate(),
                 "batch": BATCH, "draws": _jax_draws(jcfg, extra["start"], 32),
                 "params": _np(st.params), "bn": _np(st.bn) if kw.get("batch_norm") else None,
                 "start_step": extra["start"], "steps": 3, "render_rays": 20,
                 "render_chunk": 8}, **more)


def _one_cfg(**extra):
    return NeRFConfig(**dict(KW, **extra)).validate()


def _params():
    params = random_params(_one_cfg(), seed=3)
    for tree in params.values():  # a denser field than sigma at 0
        tree["sigma"]["b"] = tree["sigma"]["b"] + 1.0
    return params


def _rays(theta):
    tr = Trainer(_one_cfg(), NEAR, FAR, device="cpu")
    o, d = tr.pose_rays(pose_spherical(theta, -30.0, 4.0), 8, 8, FOCAL)
    return o.numpy(), d.numpy()


def _cli_argv(work, config, out):
    common = ["--config", str(work / config), "--checkpoint", str(work / "one.ckpt.npz"),
              "--device", "cpu", "--quant", "int8"]
    return {"evaluate": common + ["--out", f"{out}/eval.json"],
            "infer": common + ["--frames", "2", "--out", f"{out}/v.mp4"],
            "serve": common}


def _files(root):
    return {os.path.relpath(os.path.join(d, f), root): open(os.path.join(d, f), "rb").read()
            for d, _, files in os.walk(root) for f in files}


@pytest.fixture(scope="module")
def mesh12(tmp_path_factory):
    """The ``(1, 2)`` launch: ``{'jobs': {name: [rank records]}, 'work': dir,
    'files': {out: files}, 'one': one process's CLI results}``."""
    def build(work):
        names = list(CASES)
        jobs = [_train_job(CASES[c], 2, save=str(work / f"{c}.ckpt.npz")) for c in names]
        one = Trainer(_one_cfg(), NEAR, FAR, device="cpu").replace_params(_params())
        one.train_step(BATCH)
        one.save(str(work / "one.ckpt.npz"), scene={"near": NEAR, "far": FAR, "focal": FOCAL})
        tp_cfg = _one_cfg(mesh_model=2)
        names += ["restore", "infer", "cli"]
        jobs.append({"cfg": tp_cfg, "batch": BATCH, "restore": str(work / "one.ckpt.npz"),
                     "steps": 1})
        jobs.append({"cfg": tp_cfg, "params": _params(), "infer": {
            "calib": _rays(30.0), "distill": DISTILL, "rays": _rays(10.0), "chunk": CHUNK,
            "cache": str(work / "tp.infer.npz")}})
        (work / "tp.json").write_text(json.dumps(dict(RAW, MESH_MODEL=2)))
        (work / "one.json").write_text(json.dumps(RAW))
        for out in ("r0", "r1", "one"):
            (work / out).mkdir()
        argv = _cli_argv(work, "tp.json", str(work / "r{rank}"))
        jobs.append({"cfg": tp_cfg, "cli": [
            ("evaluate", argv["evaluate"]), ("infer", argv["infer"]),
            ("serve", argv["serve"] + ["--port", str(free_port())], REQUESTS)]})
        records = run_ranks(2, {"device": "cpu", "backend": None, "near": NEAR, "far": FAR,
                                "jobs": jobs}, TIMEOUT)
        argv1 = _cli_argv(work, "one.json", str(work / "one"))
        single = {"evaluate": evaluate.run_evaluation(argv1["evaluate"]),
                  "infer": infer.run_inference(argv1["infer"])}
        return {"jobs": {n: [r[i] for r in records] for i, n in enumerate(names)},
                "work": str(work),
                "files": {out: _files(work / out) for out in ("r0", "r1", "one")},
                "one": single}

    return _once(tmp_path_factory, "tp_mesh12", build)


@pytest.fixture(scope="module")
def mesh22(tmp_path_factory):
    """The ``(2, 2)`` launch: the four ranks' records."""
    def build(work):
        return run_ranks(4, {"device": "cpu", "backend": None, "near": NEAR, "far": FAR,
                             **_train_job(MESH22_CASE, 2, 2)}, TIMEOUT)

    return _once(tmp_path_factory, "tp_mesh22", build)


def _jax_step(extra):
    """The JAX one-device step at the case's start: ``(metrics, grads)``."""
    jcfg = JaxConfig(**_kw(extra)).validate()
    st = _state(jcfg, extra["start"])
    key = jax.random.PRNGKey(KEY)
    jbatch = tuple(jnp.asarray(x) for x in BATCH)
    _, jm = jax.jit(jstep.make_train_step(jcfg, NEAR, FAR))(st, jbatch, key)
    real = jstep.make_optimizer
    jstep.make_optimizer = lambda c: _grab_grads()
    try:
        grads = jax.jit(jstep.make_train_step(jcfg, NEAR, FAR))(
            st._replace(opt_state=_grab_grads().init(st.params)), jbatch, key)[0].opt_state
    finally:
        jstep.make_optimizer = real
    return jm, _np(grads)


def _one_process(extra, steps=1):
    """One port process from the same state with the same draws, after
    ``steps`` steps: ``(trainer, first metrics, first gradients)``."""
    job = _train_job(extra, 1)
    one = Trainer(_one_cfg(**{k: v for k, v in extra.items() if k != "start"}), NEAR, FAR,
                  device="cpu")
    one.replace_params(job["params"], job["bn"])
    one.step = extra["start"]
    om = one.train_step(BATCH, draws=job["draws"])
    grads = one.params_tree(grad=True)
    for _ in range(steps - 1):
        one.train_step(BATCH)
    return one, om, grads


def _check_first_step(recs, extra):
    one, om, ograds = _one_process(extra)
    jm, jgrads = _jax_step(extra)
    for rec in recs:
        for k in ("loss_coarse", "loss", "psnr"):
            assert _rel(rec["metrics"][0][k], float(om[k])) <= SPLIT_TOL, k
            assert _rel(rec["metrics"][0][k], float(jm[k])) <= JAX_TOL, k
        assert _grad_errors(ograds, rec["grads"]) <= SPLIT_TOL
        assert _grad_errors(jgrads, rec["grads"]) <= JAX_TOL


@pytest.mark.parametrize("case", sorted(CASES))
def test_first_step_matches_one_process_and_jax(mesh12, case):
    """Both ranks' first-step metrics and reduced gradients (gathered whole)
    equal one port process's to 1e-5 and the JAX one-device step's to
    5e-4; without ``STOP_PDF_GRADIENT`` the coarse leaves' gradients run
    through ``sample_pdf`` and the split (the encodings' cotangent summed
    over the model group)."""
    _check_first_step(mesh12["jobs"][case], CASES[case])


def _bn_fed_biases(params: dict) -> set:
    """Paths of the biases a BatchNorm layer normalises away (of a BN model,
    each trunk layer's, the branch's, and the feature layer's, a constant
    shift of the branch's input): their gradient is 0 in exact arithmetic,
    and Adam turns the float32 noise in it into steps of the learning
    rate's size."""
    return {f"['{name}']['{layer}']['b']" if isinstance(layer, str)
            else f"['{name}']['trunk'][{layer}]['b']"
            for name, tree in params.items() if "gamma" in tree.get("trunk", [{}])[0]
            for layer in [*range(len(tree["trunk"])), "branch", "feature"]}


def _flat_layout(tree, prefix: str = "") -> dict:
    """``{path: kind}`` of a ``param_layout`` tree, the paths ``_flatten``'s."""
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree)
                for k, v in _flat_layout(tree[key], f"{prefix}['{key}']").items()}
    if isinstance(tree, list):
        return {k: v for i, x in enumerate(tree)
                for k, v in _flat_layout(x, f"{prefix}[{i}]").items()}
    return {prefix: tree}


@pytest.mark.parametrize("case", sorted(CASES))
def test_three_steps_match_one_process(mesh12, case):
    """After 3 steps (the last two drawn from the shared generator) the
    parameters gathered whole equal one port process's to 1e-5 (BatchNorm:
    but the biases it normalises away), the ranks' metrics agree to 1e-6,
    every replicated leaf is bit-identical on both model ranks, and the
    render of 20 rays equals one process's to 1e-5 (BatchNorm: 1e-3)."""
    a, b = mesh12["jobs"][case]
    assert (a["data_rank"], a["model_rank"], b["data_rank"], b["model_rank"]) == (0, 0, 0, 1)
    for ma, mb in zip(a["metrics"], b["metrics"]):
        for k in ma:
            assert _rel(mb[k], ma[k]) <= 1e-6, k
    assert sorted(a["replicated"]) == sorted(b["replicated"])
    for k, v in a["replicated"].items():
        np.testing.assert_array_equal(v, b["replicated"][k], err_msg=k)
    one, _, _ = _one_process(CASES[case], steps=3)
    want, got = _flatten(one.params_tree(), ""), _flatten(a["params"], "")
    skip = _bn_fed_biases(a["params"])
    assert len(skip) == (16 if CASES[case].get("batch_norm") else 0)
    for k, v in want.items():
        if k not in skip:
            np.testing.assert_allclose(got[k], v, rtol=0, atol=SPLIT_TOL, err_msg=k)
        np.testing.assert_array_equal(got[k], _flatten(b["params"], "")[k])
    # BatchNorm: the render reads the EMA shadow of the biases left out
    # above against running statistics of the trained ones, which no longer
    # cancel exactly; measured 6.4e-5.
    tol = 1e-3 if skip else SPLIT_TOL
    render = one.render_rays(BATCH[1][:20], BATCH[2][:20], chunk=8)
    for k, v in render.items():
        np.testing.assert_allclose(a["render"][k], v, rtol=0, atol=tol, err_msg=k)
        np.testing.assert_array_equal(a["render"][k], b["render"][k])


# At 6x16, skip 4, on two model ranks: layers 0, 2, 4 and the feature are
# column-split, 1, 3 and sigma row-split, layer 5 (43 wide) and the branch
# and rgb whole.  A forward: 3 all-reduces (layers 1, 3 and sigma: 16, 16
# and 1 wide) and 2 all-gathers (after layer 4, and the feature: 16 wide);
# a backward: 3 all-reduces (the inputs of layers 2 and 4, and of the
# heads: 16 wide), 4 with the encodings' gradients (27 wide).
def _model_pass(n: int, backward: bool = False, input_grads: bool = False) -> dict:
    ar = 3 + (3 if backward else 0) + (1 if backward and input_grads else 0)
    ar_el = n * (33 + (48 if backward else 0) + (27 if backward and input_grads else 0))
    return {"all_reduce": ar, "all_reduce_elements": ar_el, "all_gather": 2,
            "all_gather_elements": n * 32}


def _add(*parts):
    return {k: sum(p[k] for p in parts) for k in parts[0]}


def _step_model(case: str) -> dict:
    extra, b = CASES[case], 32
    if extra.get("train_sampler") == "proposal":
        if extra.get("prop_union", True):
            return _model_pass(b * 12, True)
        return _add(_model_pass(b * 8, True), _model_pass(b * 4, True))
    return _add(_model_pass(b * 4, True),
                _model_pass(b * 12, True, not extra.get("stop_pdf_gradient", True)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_collectives_are_pinned(mesh12, case):
    """A step's collectives, element for element: one all-reduce over the
    data group of this rank's leaves (its blocks of the split ones) and
    the 3 metrics (BatchNorm: 1 + 4 per layer), and the split passes'
    all-reduces and all-gathers over the model group; the render of 20 rays
    in 3 chunks of 8 makes no all-reduce over the data group (one rank a
    data group: it gathers each map of 8 rays), and 3 all-reduces and 2
    all-gathers over the model group a pass."""
    extra = CASES[case]
    one, _, _ = _one_process(extra)
    n_whole = sum(p.numel() for p in pstep.params_of(one.params))
    for rec in mesh12["jobs"][case]:
        audit = rec["audit"]
        model = {k: audit["model"][k] for k in _step_model(case)}
        assert model == _step_model(case)
        assert audit["model"]["broadcast"] == 0
        n_local = audit["all_reduce_elements"] - pstep.N_METRICS
        if extra.get("batch_norm"):
            # 6 trunk layers of 16 (3 of them split: 8 a rank), the branch's 8.
            n_local -= 4 * 2 * (3 * 8 + 3 * 16 + 8)
            assert audit["all_reduce_count"] == 1 + 4 * 14
        else:
            assert audit["all_reduce_count"] == 1
        assert n_whole > n_local > n_whole // 2
        proposal = extra.get("train_sampler") == "proposal"
        passes = ([_model_pass(8 * 12)] if proposal and extra.get("prop_union", True)
                  else [_model_pass(8 * 8)] if proposal
                  else [_model_pass(8 * 4), _model_pass(8 * 12)])
        want = {k: 3 * v for k, v in _add(*passes).items()}
        assert {k: rec["render_model"][k] for k in want} == want
        maps = 2 if proposal else 4
        assert rec["render_collectives"]["all_reduce"] == 0
        assert rec["render_collectives"]["all_gather"] == 3 * maps


def test_split_leaves_hold_half_the_features(mesh12):
    """Each rank of the model group holds its half of every split leaf:
    their local gradient all-reduce carries the whole model's leaves less
    half of the split ones."""
    rec = mesh12["jobs"]["parity"][0]
    layout = _flat_layout(pmesh.param_layout(rec["params"], 2))
    leaves = _flatten(rec["params"], "")
    assert sorted(layout) == sorted(leaves)
    split = sum(v.size for k, v in leaves.items() if layout[k] is not None)
    whole = sum(v.size for v in leaves.values())
    assert rec["audit"]["all_reduce_elements"] == whole - split // 2 + pstep.N_METRICS


def test_mesh22_matches_one_process_and_jax(mesh22):
    """``(2, 2)``: the data group's BatchNorm moments and the model group's
    split, without ``STOP_PDF_GRADIENT``: every rank's first step equals
    one port process's to 1e-5 and the JAX step's to 5e-4."""
    assert [(r["data_rank"], r["model_rank"]) for r in mesh22] == [(0, 0), (0, 1), (1, 0),
                                                                   (1, 1)]
    _check_first_step(mesh22, MESH22_CASE)


def test_mesh22_replicated_leaves_are_bit_identical(mesh22):
    """Every replicated leaf is the same bits on all four ranks, and the two
    ranks of each data group's model index hold the same blocks (one state
    digest)."""
    for rec in mesh22[1:]:
        for k, v in mesh22[0]["replicated"].items():
            np.testing.assert_array_equal(rec["replicated"][k], v, err_msg=k)
    assert mesh22[0]["digest"] == mesh22[2]["digest"] != mesh22[1]["digest"]
    assert mesh22[1]["digest"] == mesh22[3]["digest"]
    for rec in mesh22:
        for x, y in zip(_leaves(rec["bn"]), _leaves(mesh22[0]["bn"])):
            np.testing.assert_array_equal(x, y)


def test_mesh22_collectives(mesh22):
    """16 rays a data rank: the model group's passes as in ``(1, 2)`` at 16
    rays, and 1 + 4 x 14 all-reduces over the data group."""
    for rec in mesh22:
        want = _add(_model_pass(16 * 4, True), _model_pass(16 * 12, True, True))
        assert {k: rec["audit"]["model"][k] for k in want} == want
        assert rec["audit"]["all_reduce_count"] == 1 + 4 * 14


# ---------------------------------------------------------------------------
# Checkpoints.

@pytest.mark.parametrize("case", ["parity", "bn"])
def test_checkpoint_of_the_split_run_loads_whole(mesh12, case):
    """The checkpoint the ``(1, 2)`` run wrote (rank 0, every rank
    gathering) restores in one port process with the run's parameters,
    EMA and BatchNorm statistics, and in the JAX ``Trainer`` through its
    restore; the two render the same rays to 5e-4."""
    path = os.path.join(mesh12["work"], f"{case}.ckpt.npz")
    rec = mesh12["jobs"][case][0]
    extra = {k: v for k, v in CASES[case].items() if k != "start"}
    pt = Trainer(_one_cfg(**extra), NEAR, FAR, device="cpu").restore(path)
    assert pt.step == CASES[case]["start"] + 3
    for k, v in _flatten(rec["params"], "").items():
        np.testing.assert_array_equal(_flatten(pt.params_tree(), "")[k], v)
    if rec["bn"] is not None:
        for x, y in zip(_leaves(pt.bn_tree()), _leaves(rec["bn"])):
            np.testing.assert_array_equal(x, y)
    jt = JaxTrainer(JaxConfig(**_kw(CASES[case])).validate(), NEAR, FAR,
                    mesh=make_mesh(1, 1, devices=jax.devices()[:1])).restore(path)
    o, d = BATCH[1][:16], BATCH[2][:16]
    want = jt.render_rays(o, d, chunk=16)
    got = pt.render_rays(o, d, chunk=16)
    for k in got:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=0, atol=JAX_TOL,
                                   err_msg=k)


def test_one_process_checkpoint_resumes_under_the_split(mesh12):
    """A one-process checkpoint (with Adam's moments) restored under
    ``(1, 2)`` takes the step one process takes from it: metrics and
    reduced gradients to 1e-5, parameters after it to 1e-5."""
    path = os.path.join(mesh12["work"], "one.ckpt.npz")
    one = Trainer(_one_cfg(), NEAR, FAR, device="cpu").restore(path)
    assert one.step == 1
    om = one.train_step(BATCH)
    for rec in mesh12["jobs"]["restore"]:
        for k in om:
            assert _rel(rec["metrics"][0][k], float(om[k])) <= SPLIT_TOL, k
        assert _grad_errors(one.params_tree(grad=True), rec["grads"]) <= SPLIT_TOL
        for k, v in _flatten(one.params_tree(), "").items():
            np.testing.assert_allclose(_flatten(rec["params"], "")[k], v, rtol=0,
                                       atol=SPLIT_TOL, err_msg=k)


# ---------------------------------------------------------------------------
# int8 tables, the distilled net, the cache and the renders.

@pytest.fixture(scope="module")
def one_infer():
    tr = Trainer(_one_cfg(), NEAR, FAR, device="cpu").replace_params(_params())
    calib = _rays(30.0)
    tr.quantize_for_inference(*calib)
    tr.build_proposal_sampler(*calib, **DISTILL)
    return tr


def test_tables_net_and_digest_are_one_process(mesh12, one_infer):
    """Rank 0 calibrates and distills on the whole weights (gathered on
    both ranks first): both ranks' tables and net, as built and as loaded
    from the cache rank 0 wrote, and ``infer_digest`` are one process's."""
    want = artifact_digests(one_infer)
    for rec in mesh12["jobs"]["infer"]:
        job = rec["infer"]
        assert job["digests"] == job["loaded_digests"] == want
        assert job["infer_digest"] == one_infer.infer_digest()
    assert mesh12["jobs"]["infer"][0]["infer"]["distill_losses"] == one_infer.distill_losses
    fresh = Trainer(_one_cfg(), NEAR, FAR, device="cpu").replace_params(_params())
    fresh.load_inference_artifacts(os.path.join(mesh12["work"], "tp.infer.npz"))
    assert artifact_digests(fresh) == want


@pytest.mark.parametrize("render", ["int8", "proposal_int8"])
def test_int8_render_is_one_process_bit_for_bit(mesh12, one_infer, render):
    """The int8 renders run the replicated tables (K4 on the card) on every
    rank, with no collective over the model group: one process's maps,
    bit for bit."""
    kw = {"quant": True, **({"sampler": "proposal"} if render.startswith("proposal") else {})}
    want = one_infer.render_rays(*_rays(10.0), chunk=CHUNK, **kw)
    for rec in mesh12["jobs"]["infer"]:
        job = rec["infer"]
        for k, v in want.items():
            np.testing.assert_array_equal(job["frames"][render][k], v, err_msg=k)
        assert not any(job["steps"][render]["model"].values())


@pytest.mark.parametrize("render", ["float", "proposal"])
def test_float_render_matches_one_process(mesh12, one_infer, render):
    """The float renders run the split fine (and coarse) MLP: one process's
    maps to 1e-5, and model-group collectives on every chunk."""
    kw = {"sampler": "proposal"} if render == "proposal" else {}
    want = one_infer.render_rays(*_rays(10.0), chunk=CHUNK, **kw)
    for rec in mesh12["jobs"]["infer"]:
        job = rec["infer"]
        for k, v in want.items():
            np.testing.assert_allclose(job["frames"][render][k], v, rtol=0, atol=SPLIT_TOL,
                                       err_msg=k)
        assert job["steps"][render]["model"]["all_gather"] > 0


# ---------------------------------------------------------------------------
# The entry points.

def test_split_entry_points_write_from_rank0_only(mesh12):
    """``cli.evaluate --quant int8``, ``cli.infer --quant int8`` and the
    server under ``MESH_MODEL: 2``: rank 1 writes nothing; the report's
    scores are one process's to 1e-5; the int8 frames, which passed their
    gate, one process's bytes; the server answers from the int8 tables and
    rank 1 follows it."""
    ranks = mesh12["jobs"]["cli"]
    files = mesh12["files"]
    assert files["r1"] == {}
    assert sorted(files["r0"]) == sorted(files["one"])
    evals = [r["cli"][0] for r in ranks]
    want = mesh12["one"]["evaluate"]
    for got in (evals[0]["result"], evals[1]["result"]):
        flat_got, flat_want = _flatten(json.loads(json.dumps(got)), ""), \
            _flatten(json.loads(json.dumps(want)), "")
        assert sorted(flat_got) == sorted(flat_want)
        for k, v in flat_want.items():
            if v.dtype.kind == "f":
                np.testing.assert_allclose(flat_got[k], v, rtol=SPLIT_TOL, err_msg=k)
            else:
                assert (flat_got[k] == v).all(), k
    inf0, inf1 = (r["cli"][1] for r in ranks)
    assert inf1["result"] is None and "int8 gate PASS" in inf0["stdout"]
    assert [n for n in files["one"] if n.endswith(".gif")] == ["v.gif"]
    assert files["r0"]["v.gif"] == files["one"]["v.gif"]
    assert len(decode_gif(files["one"]["v.gif"])[0]) == 2
    serve0, serve1 = (r["cli"][2] for r in ranks)
    png, stats = serve0["result"]
    assert serve1["result"] == [] and png[:8] == b"\x89PNG\r\n\x1a\n"
    assert json.loads(stats)["quant"] == "int8" and "follows rank 0" in serve1["stdout"]


def test_two_rank_cli_train_writes_from_rank_zero_only(tmp_path):
    """``cli.train_synthetic`` with ``MESH_MODEL: 2`` as two gloo ranks,
    one epoch: both ranks train the same rows (one data rank), print the
    same epoch metrics, and rank 0 alone writes the checkpoint, whose
    weights load whole in one process."""
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps({
        "BATCH_SIZE": 128, "NS_COARSE": 8, "NS_FINE": 8, "HEIGHT": 16, "WIDTH": 16,
        "L_XYZ": 4, "L_DIR": 2, "NUM_LAYERS": 4, "HIDDEN_DIM": 16, "SKIP_LAYER": 2,
        "EPOCHS": 1, "LEARNING_RATE": 0.005, "BATCH_NORM": False, "WITH_GCS": False,
        "COMPUTE_DTYPE": "float32", "EVAL_EVERY": 1, "MESH_MODEL": 2}))
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
        assert f"rank {r}/2" in out and "MESH_MODEL=2" in out
        # 9 train views of 16x16 = 2,304 rays, all on the one data rank.
        assert "rays: train=2304" in out
    epochs = [[line.split(" (")[0] for line in out.splitlines() if line.startswith("epoch ")]
              for out in outs]
    vals = [[line for line in out.splitlines() if line.startswith("  val:")] for out in outs]
    assert len(epochs[0]) == 1 and epochs[0] == epochs[1] and vals[0] == vals[1]
    names = sorted(os.listdir(tmp_path / "run0"))
    ckpt = "nerf_l4_d16_n16_ep1.ckpt.npz"
    assert ckpt in names and not (tmp_path / "run1").exists()
    whole = dataclasses.replace(load_config(str(cfg)), mesh_model=1)
    pt = Trainer(whole, NEAR, FAR, device="cpu").restore(str(tmp_path / "run0" / ckpt))
    assert pt.params_tree()["fine"]["trunk"][0]["w"].shape == (27, 16)


# ---------------------------------------------------------------------------
# In one process: the layout and the shapes.

def _spec_kind(spec: P, ndim: int) -> str | None:
    if spec == P():
        return None
    if ndim == 1:
        assert spec == P("model")
        return "col"
    return {P(None, "model"): "col", P("model", None): "row"}[spec]


LAYOUTS = {
    "8x256": dict(num_layers=8, hidden_dim=256, l_xyz=10, l_dir=4),
    "tiny": dict(num_layers=6, hidden_dim=16, l_xyz=4, l_dir=2),
    "tiny_bn": dict(num_layers=6, hidden_dim=16, l_xyz=4, l_dir=2, batch_norm=True),
    "width_30": dict(num_layers=5, hidden_dim=30, l_xyz=4, l_dir=2),
}


@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("shape", sorted(LAYOUTS))
def test_param_layout_is_jax_nerf_param_shardings(shape, model):
    """``param_layout`` gives each leaf JAX's spec: column (``P(None,
    'model')``, a vector's ``P('model')``), row (``P('model', None)``) or
    replicated, at 8x256 (layer 5's 319 inputs stay whole), the tiny
    widths, and a width 4 does not divide (30: every column split of the
    4-rank axis falls back to whole, as does the 93-wide skip layer)."""
    kw = dict(skip_layer=4, **LAYOUTS[shape])
    bn = kw.pop("batch_norm", False)
    params = {name: jax.tree_util.tree_map(np.asarray, init_nerf_params(
        jax.random.PRNGKey(i), batch_norm=bn, **kw)) for i, name in enumerate(("coarse",
                                                                                "fine"))}
    want = nerf_param_shardings(make_mesh(8 // model, model), params)
    got = pmesh.param_layout(params, model)
    w_leaves = _flatten(params, "")
    w_specs = dict(zip(w_leaves, jax.tree_util.tree_leaves(
        want, is_leaf=lambda x: isinstance(x, P))))
    g = _flat_layout(got)
    assert sorted(g) == sorted(w_specs)
    for k, spec in w_specs.items():
        assert g[k] == _spec_kind(spec, w_leaves[k].ndim), k
    if shape == "8x256":
        trunk = got["fine"]["trunk"]
        assert [t["w"] for t in trunk] == ["col", "row", "col", "row", "col", None, "col",
                                           "row"]


def test_param_layout_replicates_the_proposal_nets():
    """A ``{'proposal', 'fine'}`` tree: the proposal net whole, as JAX's."""
    cfg = JaxConfig(**dict(KW, train_sampler="proposal")).validate()
    params = jax.tree_util.tree_map(np.asarray, jstep.init_train_state(
        jax.random.PRNGKey(0), cfg).params)
    want = nerf_param_shardings(make_mesh(4, 2), params)
    got = pmesh.param_layout(params, 2)
    assert all(v is None for v in _flat_layout(got["proposal"]).values())
    assert all(s == P() for s in jax.tree_util.tree_leaves(
        want["proposal"], is_leaf=lambda x: isinstance(x, P)))
    assert got["fine"]["trunk"][0]["w"] == "col"


@pytest.mark.parametrize("data,model,world,want", [(-1, 2, 4, 2), (2, 2, 4, 2), (1, 4, 4, 1),
                                                   (-1, 4, 4, 1), (1, 2, 2, 1)])
def test_mesh_shapes_with_a_model_axis_resolve(data, model, world, want):
    assert pmesh.check_mesh_shape(data, model, world) == want


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("hidden", [16, 15])
def test_anneal_fold_scales_each_rank_block(hidden, rank):
    """The frequency-anneal fold of a split MLP is the whole MLP's fold,
    blocked: at hidden 15 the 42-wide skip layer is row-split, so each rank
    scales its half of the skip concat's inputs (the window lands in rank
    1's half)."""
    kw = dict(num_layers=6, hidden_dim=hidden, skip_layer=4, l_xyz=4, l_dir=2,
              compute_dtype=torch.float32)
    mesh = pmesh.Mesh(1, 2, 0, rank, torch.device("cpu"))
    whole = NeRFMLP(**kw, generator=torch.Generator().manual_seed(0))
    split = NeRFMLP(**kw, generator=torch.Generator().manual_seed(0), mesh=mesh)
    assert split.kinds[5] == ("row" if hidden == 15 else None)
    window = freq_window(4, 0.3)
    want, got = fold_nerf_params(whole, window), fold_nerf_params(split, window)
    assert len(got) == len(want) == 2
    for (w_whole, s_whole), (w_split, s_split), layer in zip(want, got, (0, 5)):
        dim = {"col": 0, "row": 1}.get(split.kinds[layer])
        folded = pmesh.shard(w_whole * s_whole[None, :], dim, mesh)
        torch.testing.assert_close(w_split * s_split[None, :], folded, rtol=0, atol=0)


def test_pallas_under_a_model_axis_still_raises():
    """``USE_PALLAS: true`` with ``MESH_MODEL > 1`` is refused, as in the
    JAX config: its fused kernel shards rays over the data axis only."""
    with pytest.raises(ValueError, match="MESH_MODEL"):
        NeRFConfig(**dict(KW, use_pallas=True, mesh_model=2)).validate()
