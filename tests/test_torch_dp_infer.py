"""Scoring, rendering and serving on every rank of a data mesh: the int8
tables, the distilled proposal net and the ``.infer.npz`` cache under
``torch.distributed`` (``Trainer``, ``parallel/mesh.share_from_main``),
and ``cli.evaluate``, ``cli.infer`` and the server launched as two ranks.

Real gloo processes on the CPU (``parallel/audit.run_ranks``; the kernels'
plain versions) at tiny widths: 2 layers, hidden 16, 4 + 8 samples,
float32, as ``tests/test_torch_parallel.py``.  Three launches of two
ranks, each run once per pytest run (shared by the pytest workers
through a file lock):

* ``infer``: calibrate, distill, save the cache from rank 0, load it in a
  new trainer on both ranks (rank 1 is given a path where no file is),
  load a stale and a corrupt file, render float, int8, distilled and
  distilled int8 rays.  Rank 0 builds on exactly one process's rays, so
  every rank's tables and net equal one process's bit for bit, and the
  rays agree with one process within ``RANK_TOL`` (measured 0: each ray
  is computed alone).  Against the JAX ``Trainer`` on its 8-device CPU
  mesh with rank 0's tables and net installed: ``ROADMAP.md`` section
  3's tolerances, 1e-5 rgb where the pass is placed by ``linspace`` alone
  (the coarse pass), 5e-3 rgb where ``sample_pdf`` places it, depth as
  ``tests/test_torch_quant.py`` and ``tests/test_torch_distill.py``.
* ``broken``: each rank installs the tables it calibrates itself, rank 1
  on other rays: its rows miss ``RANK_TOL`` by far more than 10x, so the
  check can fail.
* ``cli``: ``cli.evaluate``, then ``cli.infer`` on its cache, then
  ``cli.infer --reference-weights`` on a Keras file of the same weights,
  then three servers (``serving.main``; rank 0 sends each its requests,
  then SIGTERMs itself): a float one on an NDC checkpoint (a pose it
  cannot render fails after the broadcast), an int8 one (a refused
  request, ``/reload``) and a distilled one, every output path under
  ``r{rank}/``.  Rank 0's report, frames and PNG bytes equal one
  process's; rank 1 writes nothing.
"""

import fcntl
import json
import os
import pickle
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from nerf_keras_tpu.config import NeRFConfig as JaxConfig
from nerf_keras_tpu.engine.trainer import Trainer as JaxTrainer
from nerf_keras_tpu_torch.cli import evaluate, infer
from nerf_keras_tpu_torch.config import NeRFConfig, load_config
from nerf_keras_tpu_torch.engine.trainer import Trainer
from nerf_keras_tpu_torch.models.mlp import random_params
from nerf_keras_tpu_torch.ops.rays import pose_spherical
from nerf_keras_tpu_torch.parallel.audit import artifact_digests, free_port, run_ranks
from nerf_keras_tpu_torch.serving import RenderService, serve
from nerf_keras_tpu_torch.utils.checkpoint import _flatten
from nerf_keras_tpu_torch.utils.gif import decode_gif
from nerf_keras_tpu_torch.utils.infer_cache import StaleArtifactsError
from nerf_keras_tpu_torch.utils.keras_export import export_reference_weights

torch.set_num_threads(1)

NEAR, FAR = 2.0, 6.0
TIMEOUT = 300
RANK_TOL = 1e-6
# Against the JAX Trainer on the same tables or net (ROADMAP.md section 3).
JAX_TOL = {"rgb_coarse": 1e-5, "depth_coarse": 1e-4, "rgb_fine": 5e-3, "depth_fine": 2e-2}
RAW = {"BATCH_SIZE": 32, "NS_COARSE": 4, "NS_FINE": 8, "HEIGHT": 8, "WIDTH": 8, "L_XYZ": 4,
       "L_DIR": 2, "NUM_LAYERS": 2, "HIDDEN_DIM": 16, "SKIP_LAYER": 4,
       "COMPUTE_DTYPE": "float32", "USE_PALLAS": False, "WITH_GCS": False}
KW = dict(batch_size=32, ns_coarse=4, ns_fine=8, height=8, width=8, l_xyz=4, l_dir=2,
          num_layers=2, hidden_dim=16, skip_layer=4, compute_dtype="float32",
          use_pallas=False)
FOCAL = 9.6
CHUNK = 24  # 64 rays a frame: three chunks, the last one padded
DISTILL = dict(steps=6, batch=64)
RENDERS = {"float": {}, "int8": {"quant": True}, "proposal": {"sampler": "proposal"},
           "proposal_int8": {"sampler": "proposal", "quant": True}}


def _once(tmp_path_factory, name, build):
    """``build(dir)`` once per pytest run, shared by the xdist workers
    (the recipe of pytest-xdist's documentation: a file lock in the
    run's shared temporary directory)."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    path = root / f"dp_infer_{name}.pkl"
    with open(root / f"dp_infer_{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            work = root / f"dp_infer_{name}"
            work.mkdir()
            result = build(work)
            with open(path, "wb") as f:
                pickle.dump(result, f)
    with open(path, "rb") as f:
        return pickle.load(f)


def _params():
    """Random weights with the sigma bias at +1: the init's sigma sits at
    0, where the 1e10 terminal delta makes int8 frames jump."""
    params = random_params(NeRFConfig(**KW).validate(), seed=3)
    for tree in params.values():
        tree["sigma"]["b"] = tree["sigma"]["b"] + 1.0
    return params


def _rays(theta):
    cfg = NeRFConfig(**KW).validate()
    tr = Trainer(cfg, NEAR, FAR, device="cpu")
    o, d = tr.pose_rays(pose_spherical(theta, -30.0, 4.0), 8, 8, FOCAL)
    return o.numpy(), d.numpy()


def _one_process():
    """The reference: one process builds on the same rays."""
    tr = Trainer(NeRFConfig(**KW).validate(), NEAR, FAR, device="cpu")
    tr.replace_params(_params())
    calib = _rays(30.0)
    tr.quantize_for_inference(*calib)
    tr.build_proposal_sampler(*calib, **DISTILL)
    return tr


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    def build(work):
        stale_tr = Trainer(NeRFConfig(**KW).validate(), NEAR, FAR, device="cpu")
        stale_tr.quantize_for_inference(*_rays(30.0))  # of other (init) weights
        stale_tr.save_inference_artifacts(str(work / "stale.infer.npz"))
        (work / "corrupt.infer.npz").write_bytes(b"not an npz file")
        spec = {"cfg": NeRFConfig(**KW).validate(), "near": NEAR, "far": FAR,
                "params": _params(), "device": "cpu", "backend": None,
                "infer": {"calib": _rays(30.0), "distill": DISTILL, "rays": _rays(10.0),
                          "chunk": CHUNK, "cache": str(work / "a.infer.npz"),
                          "hidden_from": 1, "stale": str(work / "stale.infer.npz"),
                          "corrupt": str(work / "corrupt.infer.npz")}}
        return [r["infer"] for r in run_ranks(2, spec, TIMEOUT)]

    return _once(tmp_path_factory, "infer", build)


@pytest.fixture(scope="module")
def one():
    return _one_process()


@pytest.mark.parametrize("what", ["qparams", "pparams"])
def test_tables_and_net_are_one_process_bit_for_bit(ranks, one, what):
    """Both ranks' int8 tables and distilled net, as built and as loaded
    from the cache, are one process's (sha256 of every path and byte)."""
    want = artifact_digests(one)[what]
    assert want is not None
    for rec in ranks:
        assert rec["digests"][what] == rec["loaded_digests"][what] == want
    if what == "pparams":
        assert ranks[0]["distill_losses"] == ranks[1]["distill_losses"] == one.distill_losses


@pytest.mark.parametrize("render", sorted(RENDERS))
def test_rays_match_one_process(ranks, one, render):
    """Each rank renders its rows of every chunk and gathers the maps: both
    ranks hold one process's maps."""
    want = one.render_rays(*_rays(10.0), chunk=CHUNK, **RENDERS[render])
    for rec in ranks:
        got = rec["frames"][render]
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert got[k].shape == v.shape and np.isfinite(got[k]).all()
            np.testing.assert_allclose(got[k], v, rtol=0, atol=RANK_TOL, err_msg=k)


@pytest.fixture(scope="module")
def jax_trainer(ranks):
    """The JAX Trainer on its 8-device CPU mesh with the same weights and
    rank 0's tables and net."""
    jt = JaxTrainer(JaxConfig(**KW).validate(), NEAR, FAR)
    jt.replace_params(_params())
    jt._install_quant(ranks[0]["qparams"])
    jt._install_proposal(ranks[0]["pparams"], 4)
    return jt


@pytest.mark.parametrize("render", ["int8", "proposal", "proposal_int8"])
def test_renders_match_jax(ranks, jax_trainer, render):
    o, d = _rays(10.0)
    want = jax_trainer.render_rays(o, d, chunk=CHUNK, **RENDERS[render])
    got = ranks[1]["frames"][render]
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=0, atol=JAX_TOL[k],
                                   err_msg=k)


def _elements(tree) -> int:
    return sum(a.size for a in _flatten(tree, "").values())


@pytest.mark.parametrize("step", ["calibrate", "distill", "load", "stale", "renders"])
def test_collectives_are_exact(ranks, step):
    """Calibration: one header and one broadcast per dtype of the tables
    (int8, float32); distillation: one header and one float32 broadcast of
    the net; the cache load: one header and one broadcast per dtype of
    tables and net; a stale file: the header alone; saving: nothing; a
    render: one all-gather per map and chunk, nothing else.  The same on
    both ranks."""
    a, b = ranks
    q, p = _elements(a["qparams"]), _elements(a["pparams"])
    want = {"calibrate": (1, 2, q), "distill": (1, 1, p), "load": (1, 2, q + p),
            "stale": (1, 0, 0)}
    for rec in ranks:
        got = {k: v["collectives"] for k, v in rec["steps"].items()}
        assert got == {k: v["collectives"] for k, v in a["steps"].items()}
        assert all(not v["launches"] for v in rec["steps"].values())  # plain on the CPU
        assert not any(got["save"].values())
        if step in want:
            calls, broadcasts, elements = want[step]
            c = got[step]
            assert (c["broadcast_object"], c["broadcast"], c["broadcast_elements"]) == (
                calls, broadcasts, elements)
            assert c["all_reduce"] == c["all_gather"] == 0
            continue
        for name, kw in RENDERS.items():
            c = got[name]
            maps = 2 if kw.get("sampler") else 4
            assert (c["all_gather"], c["all_gather_elements"]) == (3 * maps,
                                                                   3 * CHUNK * maps * 2)
            assert c["all_reduce"] == c["broadcast"] == c["broadcast_object"] == 0


def test_a_stale_or_absent_cache_raises_on_every_rank(ranks):
    """Rank 0's verdict reaches both ranks: the same ``StaleArtifactsError``
    for another weights' file, ``FileNotFoundError`` for none, and
    ``load_if_fresh`` installs nothing and notices on rank 0 alone."""
    a, b = ranks
    assert a["stale_error"] == b["stale_error"]
    assert a["stale_error"].startswith(StaleArtifactsError.__name__)
    assert a["absent_error"] == b["absent_error"]
    assert a["absent_error"].startswith("FileNotFoundError")
    assert not a["stale_installed"] and not b["stale_installed"]
    assert "ignoring artifact cache" in a["stale_notice"] and not b["stale_notice"]


def test_a_rank0_failure_fails_every_rank(ranks):
    """A file rank 0 cannot read: rank 0 raises its error and rank 1,
    waiting for the result, raises one naming it, instead of hanging."""
    a, b = ranks
    assert a["corrupt_error"].startswith("ValueError")
    assert b["corrupt_error"].startswith("RuntimeError: rank 0 failed")
    assert a["corrupt_error"].split(": ", 1)[1] in b["corrupt_error"]


def test_a_file_only_rank0_sees_installs_on_both(ranks):
    """Rank 1 is given a path where no cache file is; it installs rank 0's
    tables and net all the same (the digests above), because rank 0 alone
    reads the file."""
    assert ranks[1]["loaded_digests"] == ranks[0]["loaded_digests"]
    assert None not in ranks[1]["loaded_digests"].values()


def test_unshared_calibration_misses_the_gate(tmp_path_factory, one):
    """The broken variant: each rank installs its own calibration, rank 1's
    on other rays.  Rank 0's rows still match one process; rank 1's int8
    rows miss ``RANK_TOL`` by far more than 10x."""
    def build(work):
        spec = {"cfg": NeRFConfig(**KW).validate(), "near": NEAR, "far": FAR,
                "params": _params(), "device": "cpu", "backend": None,
                "infer": {"calib": _rays(30.0), "broken": True,
                          "broken_calib": _rays(200.0), "rays": _rays(10.0), "chunk": CHUNK}}
        return [r["infer"] for r in run_ranks(2, spec, TIMEOUT)]

    a, b = _once(tmp_path_factory, "broken", build)
    assert a["digests"]["qparams"] == artifact_digests(one)["qparams"]
    assert b["digests"]["qparams"] != a["digests"]["qparams"]
    want = one.render_rays(*_rays(10.0), chunk=CHUNK, quant=True)["rgb_fine"]
    got = a["frames"]["int8"]["rgb_fine"]
    rows = [r for c in range(3) for r in range(c * CHUNK + CHUNK // 2, (c + 1) * CHUNK)
            if r < 64]
    own = [r for r in range(64) if r not in rows]
    assert np.abs(got[own] - want[own]).max() <= RANK_TOL
    assert np.abs(got[rows] - want[rows]).max() >= 10 * RANK_TOL


# ---------------------------------------------------------------------------
# The entry points as two ranks.

# Each server's flags (the entry point's and RenderService's), its
# checkpoint and its requests.  The float server's checkpoint is NDC: a pose
# looking up cannot be rendered, and fails on every rank after rank 0 has
# broadcast it.
SERVERS = {
    "serve_float": ("n.ckpt.npz", [], {}, [
        ("GET", "/render?phi=-90&width=8&height=8"),
        ("GET", "/render?phi=30&width=8&height=8"),
        ("GET", "/render?theta=10&phi=-90&width=8&height=8&map=depth"),
        ("GET", "/stats")]),
    "serve_int8": ("m.ckpt.npz", ["--quant", "int8", "--infer-cache", "{out}/s.infer.npz"],
                   {"quant": True, "infer_cache": "{out}/s.infer.npz"}, [
        ("GET", "/render?theta=10&width=8&height=8"),
        ("GET", "/render?theta=20&width=8&height=0"),
        ("POST", "/reload"),
        ("GET", "/render?theta=20&width=8&height=8&map=depth"),
        ("GET", "/stats")]),
    "serve_proposal": ("m.ckpt.npz", ["--sampler", "proposal", "--proposal-steps", "5"],
                       {"sampler": "proposal", "proposal_steps": 5}, [
        ("GET", "/render?theta=10&width=8&height=8"),
        ("GET", "/stats")]),
}
SERVED = {"serve_float": ("none", "coarse", 2, 0), "serve_int8": ("int8", "coarse", 2, 1),
          "serve_proposal": ("none", "proposal", 1, 0)}


def _argv(work, out):
    """The entry points' arguments, outputs under ``out``."""
    common = ["--config", str(work / "tiny.json"), "--checkpoint", str(work / "m.ckpt.npz"),
              "--device", "cpu", "--quant", "int8", "--sampler", "proposal",
              "--proposal-steps", "5"]
    argv = {
        "evaluate": common + ["--infer-cache", f"{out}/c.infer.npz", "--out",
                              f"{out}/eval.json", "--save-images", f"{out}/img"],
        "infer": common + ["--frames", "2", "--depth-video", "--infer-cache",
                           f"{out}/c.infer.npz", "--out", f"{out}/v.mp4"],
        "infer_reference": ["--config", str(work / "tiny.json"), "--reference-weights",
                            str(work / "ref.weights.h5"), "--device", "cpu", "--focal",
                            str(FOCAL), "--frames", "2", "--quant", "int8", "--out",
                            f"{out}/ref.mp4"],
    }
    for name, (ckpt, flags, _, _) in SERVERS.items():
        argv[name] = ["--config", str(work / "tiny.json"), "--checkpoint", str(work / ckpt),
                      "--device", "cpu"] + [f.replace("{out}", out) for f in flags]
    return argv


ENTRIES = ("evaluate", "infer", "infer_reference", *SERVERS)


def _files(root):
    return {os.path.relpath(os.path.join(d, f), root): open(os.path.join(d, f), "rb").read()
            for d, _, files in os.walk(root) for f in files}


def _serve_one_process(work, out, name) -> list:
    """The same requests to one process's server."""
    ckpt, _, kw, requests = SERVERS[name]
    kw = {k: v.replace("{out}", out) if isinstance(v, str) else v for k, v in kw.items()}
    service = RenderService(load_config(str(work / "tiny.json")), str(work / ckpt),
                            device="cpu", **kw)
    server = serve(service, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    bodies = []
    try:
        for method, path in requests:
            req = urllib.request.Request(base + path, method=method,
                                         data=b"" if method == "POST" else None)
            try:
                with urllib.request.urlopen(req, timeout=120) as resp:
                    bodies.append(resp.read())
            except urllib.error.HTTPError as e:
                bodies.append(f"HTTP {e.code}: {e.read().decode()}")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()
    return bodies


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Two ranks of each entry point and one process of each, on one
    checkpoint (the float server's: the same weights, NDC):
    ``{'ranks': records, 'files': {out: files}, 'one': ...}``."""
    def build(work):
        (work / "tiny.json").write_text(json.dumps(RAW))
        tr = Trainer(load_config(str(work / "tiny.json")), NEAR, FAR, device="cpu")
        tr.replace_params(_params())
        scene = {"near": NEAR, "far": FAR, "focal": FOCAL}
        tr.save(str(work / "m.ckpt.npz"), scene=scene)
        tr.save(str(work / "n.ckpt.npz"), scene=dict(scene, ndc=True))
        export_reference_weights(str(work / "ref.weights.h5"), _params(), tr.cfg)
        for out in ("r0", "r1", "one"):
            (work / out).mkdir()
        argv = _argv(work, str(work / "r{rank}"))
        spec = {"cfg": NeRFConfig(**KW).validate(), "near": NEAR, "far": FAR,
                "device": "cpu", "backend": None,
                "cli": [("evaluate", argv["evaluate"]), ("infer", argv["infer"]),
                        ("infer", argv["infer_reference"])]
                + [("serve", argv[name] + ["--port", str(free_port())], requests)
                   for name, (_, _, _, requests) in SERVERS.items()]}
        records = run_ranks(2, spec, TIMEOUT)
        one = _argv(work, str(work / "one"))
        single = {"evaluate": evaluate.run_evaluation(one["evaluate"]),
                  "infer": infer.run_inference(one["infer"]),
                  "infer_reference": infer.run_inference(one["infer_reference"])}
        for name in SERVERS:
            single[name] = _serve_one_process(work, str(work / "one"), name)
        return {"ranks": [dict(zip(ENTRIES, r["cli"])) for r in records],
                "files": {out: _files(work / out) for out in ("r0", "r1", "one")},
                "one": single}

    return _once(tmp_path_factory, "cli", build)


@pytest.mark.parametrize("entry", ENTRIES)
def test_two_rank_entry_points_write_from_rank0_only(cli_runs, entry):
    """Rank 0's report, frames and PNG bytes are one process's; rank 1
    writes nothing (``cli.infer`` finds its cache on rank 0's path alone,
    and both ranks install it).  Each server serves the mode it was
    started in, on both ranks."""
    r0, r1 = (r[entry] for r in cli_runs["ranks"])
    files = cli_runs["files"]
    assert files["r1"] == {}
    assert sorted(files["r0"]) == sorted(files["one"])
    if entry == "evaluate":
        assert r0["result"] == r1["result"] == cli_runs["one"]["evaluate"]
        for name in files["one"]:
            if name.startswith("img/") or name == "eval.json":
                assert files["r0"][name] == files["one"][name], name
        assert "saved inference artifacts" in r0["stdout"]
        assert "saved inference artifacts" not in r1["stdout"]
    elif entry.startswith("infer"):
        videos = ("v.gif", "v_depth.gif") if entry == "infer" else ("ref.gif",)
        assert r1["result"] is None and r0["result"].endswith("/" + videos[0])
        for name in videos:
            assert files["r0"][name] == files["one"][name], name
            assert len(decode_gif(files["one"][name], name)[0]) == 2
        assert ("loaded inference artifacts" in r0["stdout"]) == (entry == "infer")
        assert "frame 2/2" in r0["stdout"] and "frame 2/2" not in r1["stdout"]
    else:
        requests = SERVERS[entry][3]
        bodies, want = r0["result"], cli_runs["one"][entry]
        assert r1["result"] == [] and len(bodies) == len(requests)
        for (method, path), got, exp in zip(requests, bodies, want):
            if path == "/stats":
                stats, exp = json.loads(got), json.loads(exp)
                del stats["mean_render_s"], exp["mean_render_s"]
                assert stats == exp
                assert (stats["quant"], stats["sampler"], stats["requests"],
                        stats["reloads"]) == SERVED[entry]
                continue
            if method == "POST":
                got, exp = json.loads(got), json.loads(exp)
            assert got == exp, path
        assert "follows rank 0" in r1["stdout"]


def test_gates_take_the_same_decision_on_every_rank(cli_runs):
    """Every rank holds the whole gate frames after the gather, so every
    rank prints the same verdicts, at the same PSNR, with no collective of
    its own."""
    for entry, n in (("infer", 2), ("infer_reference", 1), ("serve_int8", 2),
                     ("serve_proposal", 1)):
        gates = [[line for line in r[entry]["stdout"].splitlines() if " gate " in line]
                 for r in cli_runs["ranks"]]
        assert len(gates[0]) == n and gates[0] == gates[1], entry


def test_a_refused_request_keeps_the_ranks_in_step(cli_runs):
    """A request rank 0 refuses (height 0) is refused before the
    broadcast: the followers never see it, and the requests after it
    (``/reload``, a depth map) are served by both ranks as one process
    serves them."""
    bodies = cli_runs["ranks"][0]["serve_int8"]["result"]
    assert bodies[1].startswith("HTTP 500: height, width and chunk must be positive")
    assert isinstance(bodies[3], bytes) and bodies[3] == cli_runs["one"]["serve_int8"][3]
    assert "failed as on rank 0" not in cli_runs["ranks"][1]["serve_int8"]["stdout"]


def test_a_render_failing_after_the_broadcast_keeps_the_ranks_in_step(cli_runs):
    """A pose the NDC model cannot render passes rank 0's checks, is
    broadcast, and fails on both ranks: rank 0 answers 500 as one process
    does, rank 1 says so and follows on, and the next request is served
    by both ranks as one process serves it."""
    bodies = cli_runs["ranks"][0]["serve_float"]["result"]
    want = cli_runs["one"]["serve_float"]
    assert bodies[1] == want[1]
    assert bodies[1].startswith("HTTP 500: NDC rendering requires a forward-facing camera")
    assert ("render failed as on rank 0: NDC rendering requires"
            in cli_runs["ranks"][1]["serve_float"]["stdout"])
    assert isinstance(bodies[2], bytes) and bodies[2] == want[2]
