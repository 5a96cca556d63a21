"""The port's Keras interop (``utils/h5.py``, ``utils/keras_import.py``,
``utils/keras_export.py``, ``cli/export_keras.py`` and ``cli.infer
--reference-weights``) against h5py and the JAX package.

The fixtures are genuine Keras 3 ``save_weights`` output with golden
forwards (``scripts/make_keras_fixture.py``).  Arrays cross every file
format bit for bit, so trees are compared exactly; forwards against the
golden outputs take the fixture's own tolerance (2e-4, as
``tests/test_keras_import.py``), and frames against the JAX CLI one uint8
level (rgb 5e-3, as ``tests/test_torch_infer.py``).
"""

import json
import os

import h5py
import jax
import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

import nerf_keras_tpu.cli.infer as jinfer
from nerf_keras_tpu.cli.export_keras import run_export as jax_run_export
from nerf_keras_tpu.config import NeRFConfig as JaxConfig
from nerf_keras_tpu.config import load_config as jax_load_config
from nerf_keras_tpu.engine.step import init_train_state
from nerf_keras_tpu.utils.checkpoint import save_checkpoint
from nerf_keras_tpu.utils.keras_export import export_reference_weights as jax_export
from nerf_keras_tpu.utils.keras_import import import_reference_weights as jax_import
from nerf_keras_tpu_torch.cli.export_keras import run_export
from nerf_keras_tpu_torch.cli.infer import run_inference
from nerf_keras_tpu_torch.config import NeRFConfig, load_config
from nerf_keras_tpu_torch.engine.trainer import Trainer
from nerf_keras_tpu_torch.models.mlp import NeRFMLP
from nerf_keras_tpu_torch.utils import h5
from nerf_keras_tpu_torch.utils.checkpoint import save_params_npz
from nerf_keras_tpu_torch.utils.keras_export import export_reference_weights
from nerf_keras_tpu_torch.utils.keras_import import import_reference_weights

from torch_videos import capture_videos, video_frames

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
ARCH = dict(num_layers=6, hidden_dim=32, skip_layer=4, l_xyz=10, l_dir=4,
            compute_dtype="float32")
VARIANTS = [False, True]
IDS = ["plain", "bn"]


def _fixture(bn: bool) -> str:
    return os.path.join(FIXTURES, f"ref_tiny_{'bn' if bn else 'plain'}.weights.h5")


def _cfgs(bn: bool, **changes):
    arch = {**ARCH, "batch_norm": bn, **changes}
    return NeRFConfig(**arch), JaxConfig(**arch)


def _h5py_tree(group) -> dict:
    return {k: (_h5py_tree(v) if isinstance(v, h5py.Group) else v[()])
            for k, v in group.items()}


def _h5py_attrs(path: str) -> dict:
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda name, obj: out.__setitem__(name, dict(obj.attrs)))
        out["/"] = dict(f.attrs)
    return out


def assert_same(a, b, where: str = "") -> None:
    """Equal nested dicts/lists with arrays of equal dtype, shape and bytes."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), (where, list(a), list(b))
        for k in a:
            assert_same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert (a.dtype, a.shape) == (b.dtype, b.shape), (where, a.dtype, b.dtype)
        assert a.tobytes() == b.tobytes(), where


def _sorted(tree):
    """A params tree with dict keys in sorted order (the JAX flattening)."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_sorted(t) for t in tree]
    return tree


def _params(cfg: NeRFConfig, seed: int) -> tuple[dict, dict | None]:
    """Seeded ``{'coarse','fine'}`` params with non-zero biases and, for
    BatchNorm, gamma/beta and running statistics off their init."""
    rng = np.random.default_rng(seed)
    params, bn = {}, {}
    for name in ("coarse", "fine"):
        mlp = NeRFMLP(num_layers=cfg.num_layers, hidden_dim=cfg.hidden_dim,
                      skip_layer=cfg.skip_layer, l_xyz=cfg.l_xyz, l_dir=cfg.l_dir,
                      batch_norm=cfg.batch_norm,
                      generator=torch.Generator().manual_seed(seed + len(params)))
        tree = mlp.to_jax_params()
        for layer in [*tree["trunk"], *(tree[k] for k in ("sigma", "feature", "branch",
                                                        "rgb"))]:
            for key in layer:
                if key != "w":
                    layer[key] = layer[key] + rng.normal(0, 0.3, layer[key].shape).astype(
                        np.float32)
        params[name] = tree
        bn[name] = {
            "trunk": [{"mean": rng.normal(0, 0.3, cfg.hidden_dim).astype(np.float32),
                       "var": rng.uniform(0.5, 2.0, cfg.hidden_dim).astype(np.float32)}
                      for _ in range(cfg.num_layers)],
            "branch": {"mean": rng.normal(0, 0.3, cfg.hidden_dim // 2).astype(np.float32),
                       "var": rng.uniform(0.5, 2.0, cfg.hidden_dim // 2).astype(np.float32)},
        }
    return params, (bn if cfg.batch_norm else None)


# ---------------------------------------------------------------------------
# The HDF5 reader and writer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bn", VARIANTS, ids=IDS)
def test_reader_matches_h5py_on_the_fixtures(bn):
    with h5py.File(_fixture(bn), "r") as f:
        want = _h5py_tree(f)
    got = h5.read_tree(_fixture(bn))
    assert_same(got, want)
    assert got["coarse_model"]["layers"]["dense"]["vars"]["0"].dtype == np.float32


@pytest.mark.parametrize("bn", VARIANTS, ids=IDS)
def test_reader_reads_a_full_structure_jax_file(bn, tmp_path):
    """The JAX exporter at 8 layers: with BatchNorm each ``layers`` group
    has 35 children, over several symbol-table nodes."""
    _, jcfg = _cfgs(bn, num_layers=8, hidden_dim=16)
    cfg, _ = _cfgs(bn, num_layers=8, hidden_dim=16)
    params, stats = _params(cfg, seed=4)
    path = str(tmp_path / "full.weights.h5")
    jax_export(path, params, jcfg, bn_state=stats)
    with h5py.File(path, "r") as f:
        want = _h5py_tree(f)
    got = h5.read_tree(path)
    assert_same(got, want)
    assert len(got["fine_model"]["layers"]) == (35 if bn else 17)


def _refused_file(path: str, kind: str) -> None:
    data = np.arange(6, dtype=np.float32).reshape(2, 3)
    libver = "latest" if kind == "latest" else "earliest"
    with h5py.File(path, "w", libver=libver) as f:
        g = f.create_group("m/layers/dense/vars")
        if kind == "chunked_gzip":
            g.create_dataset("0", data=data, chunks=(1, 3), compression="gzip")
        elif kind == "int":
            g.create_dataset("0", data=data.astype(np.int32))
        elif kind == "big_endian":
            g.create_dataset("0", data=data.astype(">f4"))
        elif kind == "float16":
            g.create_dataset("0", data=data.astype(np.float16))
        elif kind == "soft_link":
            g.create_dataset("0", data=data)
            f["m/alias"] = h5py.SoftLink("/m/layers")
        else:
            g.create_dataset("0", data=data)


@pytest.mark.parametrize("kind,match", [
    ("latest", "superblock version [23]"),
    ("chunked_gzip", "filter pipeline|chunked"),
    ("int", "datatype class 0"),
    ("big_endian", "big or VAX-endian"),
    ("float16", "2-byte float"),
    ("soft_link", "cache type 2"),
])
def test_reader_refuses_what_it_does_not_read(kind, match, tmp_path):
    path = str(tmp_path / f"{kind}.h5")
    _refused_file(path, kind)
    with pytest.raises(ValueError, match=match) as e:
        h5.read_tree(path)
    assert str(e.value).startswith(path)


def test_writer_refuses_other_dtypes_and_names(tmp_path):
    path = str(tmp_path / "x.h5")
    with pytest.raises(ValueError, match="int64"):
        h5.write_tree(path, {"a": np.arange(3)})
    with pytest.raises(ValueError, match="link name"):
        h5.write_tree(path, {"a/b": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="not a group"):
        h5.write_tree(path, {"a": np.zeros(3, np.float32)}, {"/a": {"name": "x"}})


_names = st.text(alphabet="abcdefghijklmnopqrstuvwxyz_0123456789", min_size=1,
                 max_size=12)
_arrays = st.builds(
    lambda shape, seed, wide: np.random.default_rng(seed).normal(size=shape).astype(
        np.float64 if wide else np.float32),
    st.lists(st.integers(0, 3), max_size=3).map(tuple), st.integers(0, 2**16),
    st.booleans())
_trees = st.recursive(
    _arrays, lambda kids: st.dictionaries(_names, kids, max_size=6), max_leaves=24)


def _btree_level(path: str, group: str) -> int:
    """The level of the root B-tree node of ``group`` (a root child)."""
    r = h5._Reader(path)
    (root,) = r.u("Q", 64)
    stab = {k: at for k, at, _ in r.messages(root, "/")}[0x11]
    btree, heap = r.u("QQ", stab)
    child = dict(r.btree(btree, r.heap(heap, "/"), "/", 0))[group]
    stab = {k: at for k, at, _ in r.messages(child, group)}[0x11]
    return r.buf[r.u("Q", stab)[0] + 5]


@settings(max_examples=25, deadline=None)
@example(tree={}, wide=300, seed=0)
@given(tree=st.dictionaries(_names, _trees, max_size=4), wide=st.integers(0, 300),
       seed=st.integers(0, 2**16))
def test_writer_round_trips_random_trees_through_h5py(tree, wide, seed, tmp_path_factory):
    """Random group trees of float arrays, and one group of up to 300
    children with random names (a B-tree of level 1 past 32 symbol-table
    nodes of 8), written by the port: h5py reads the same tree, finds every
    name, reads the string attributes; the port reads back what h5py
    reads."""
    rng = np.random.default_rng(seed)
    alphabet = np.array(list("abcdefghijklmnopqrstuvwxyz_0123456789"))
    names = set()
    while len(names) < wide:
        names.add("".join(rng.choice(alphabet, rng.integers(1, 12))))
    tree = {"t": tree, "w": {n: rng.normal(size=(2,)).astype(np.float32) for n in names}}
    path = str(tmp_path_factory.mktemp("rt") / "t.h5")
    h5.write_tree(path, tree, {"/w": {"name": "wide"}, "/": {"name": "root"}})
    with h5py.File(path, "r") as f:
        got = _h5py_tree(f)
        assert all(n in f["w"] for n in names) and "~" not in f["w"]
        assert f["w"].attrs["name"] == "wide" and f.attrs["name"] == "root"
    ordered = lambda t: ({k: ordered(t[k]) for k in sorted(t, key=str.encode)}  # noqa: E731
                         if isinstance(t, dict) else t)
    assert_same(got, ordered(tree))
    assert_same(h5.read_tree(path), got)
    assert _btree_level(path, "w") == (1 if wide > 2 * h5.INTERNAL_K * 2 * h5.LEAF_K else 0)


# ---------------------------------------------------------------------------
# Import and export
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bn", VARIANTS, ids=IDS)
def test_import_matches_jax(bn):
    cfg, jcfg = _cfgs(bn)
    params, stats = import_reference_weights(_fixture(bn), cfg)
    jparams, jstats = jax_import(_fixture(bn), jcfg)
    assert_same(_sorted(params), _sorted(jparams))
    if bn:
        assert_same(stats, jstats)
    else:
        assert stats is None and jstats is None


@pytest.mark.parametrize("bn", VARIANTS, ids=IDS)
def test_golden_forward(bn):
    """The imported weights reproduce the reference model's outputs in
    inference mode (BatchNorm on its imported running statistics)."""
    cfg, _ = _cfgs(bn)
    params, stats = import_reference_weights(_fixture(bn), cfg)
    golden = np.load(os.path.join(FIXTURES, "ref_tiny_golden.npz"))
    for which in ("coarse", "fine"):
        mlp = NeRFMLP.from_jax_params(params[which], skip_layer=4,
                                      compute_dtype=torch.float32,
                                      bn_state=None if stats is None else stats[which])
        with torch.no_grad():
            out = mlp(torch.as_tensor(golden["x_enc"]), torch.as_tensor(golden["d_enc"]))
        np.testing.assert_allclose(out.numpy(), golden[f"out_{which}_{IDS[bn]}"],
                                   rtol=2e-4, atol=2e-4)


def _no_model_file(path: str) -> str:
    h5.write_tree(path, {"vars": {}, "fine_model": {"layers": {}}})
    return path


@pytest.mark.parametrize("case", ["layers", "shape", "bn_on_plain", "plain_on_bn",
                                  "missing_group"])
def test_import_refusals_match_jax(case, tmp_path):
    """The JAX importer's errors, of the same type with the same text."""
    file, bn, changes = {
        "layers": (_fixture(False), False, dict(num_layers=8)),
        "shape": (_fixture(False), False, dict(l_xyz=4)),
        "bn_on_plain": (_fixture(False), True, {}),
        "plain_on_bn": (_fixture(True), False, {}),
        "missing_group": (None, False, {}),
    }[case]
    file = file or _no_model_file(str(tmp_path / "none.weights.h5"))
    cfg, jcfg = _cfgs(bn, **changes)
    errors = []
    for fn, c in ((import_reference_weights, cfg), (jax_import, jcfg)):
        with pytest.raises((KeyError, ValueError)) as e:
            fn(file, c)
        errors.append((e.type, str(e.value)))
    assert errors[0] == errors[1]
    assert errors[0][0] is (KeyError if case == "missing_group" else ValueError)


def test_export_refuses_a_proposal_state_as_jax(tmp_path):
    cfg, jcfg = _cfgs(False)
    params, _ = _params(cfg, seed=1)
    params = {"proposal": {"w": np.zeros((3, 3), np.float32)}, "fine": params["fine"]}
    errors = []
    for fn, c in ((export_reference_weights, cfg), (jax_export, jcfg)):
        with pytest.raises(ValueError, match="proposal") as e:
            fn(str(tmp_path / "x.weights.h5"), params, c)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port", "port_to_port"])
@pytest.mark.parametrize("bn", VARIANTS, ids=IDS)
def test_round_trip_across_packages(bn, direction, tmp_path):
    cfg, jcfg = _cfgs(bn)
    params, stats = _params(cfg, seed=7)
    path = str(tmp_path / "rt.weights.h5")
    writer, reader = {
        "port_to_jax": ((export_reference_weights, cfg), (jax_import, jcfg)),
        "jax_to_port": ((jax_export, jcfg), (import_reference_weights, cfg)),
        "port_to_port": ((export_reference_weights, cfg), (import_reference_weights, cfg)),
    }[direction]
    writer[0](path, params, writer[1], bn_state=stats)
    got, got_stats = reader[0](path, reader[1])
    assert_same(_sorted(got), _sorted(params))
    if bn:
        assert_same(got_stats, stats)
    else:
        assert got_stats is None


@pytest.mark.parametrize("bn", VARIANTS, ids=IDS)
def test_export_writes_the_jax_exporters_file(bn, tmp_path):
    """h5py reads the same groups, datasets and ``name`` attributes (as
    ``str``) from the port's file as from the JAX exporter's."""
    cfg, jcfg = _cfgs(bn)
    params, stats = _params(cfg, seed=2)
    ours, theirs = str(tmp_path / "ours.weights.h5"), str(tmp_path / "jax.weights.h5")
    export_reference_weights(ours, params, cfg, bn_state=stats)
    jax_export(theirs, params, jcfg, bn_state=stats)
    attrs = _h5py_attrs(ours)
    assert attrs == _h5py_attrs(theirs)
    assert attrs["vars"] == {"name": "ne_rf_trainer"} and isinstance(
        attrs["fine_model/layers/dense_3/vars"]["name"], str)
    with h5py.File(ours, "r") as a, h5py.File(theirs, "r") as b:
        assert_same(_h5py_tree(a), _h5py_tree(b))


# ---------------------------------------------------------------------------
# The CLIs
# ---------------------------------------------------------------------------

TINY = {"BATCH_SIZE": 64, "NS_COARSE": 8, "NS_FINE": 16, "HEIGHT": 16, "WIDTH": 16,
        "L_XYZ": 6, "L_DIR": 3, "NUM_LAYERS": 4, "HIDDEN_DIM": 32, "SKIP_LAYER": 2,
        "EPOCHS": 1, "LEARNING_RATE": 5e-4, "BATCH_NORM": False, "WITH_GCS": False,
        "COMPUTE_DTYPE": "float32"}


def _config(tmp_path, **changes) -> str:
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps({**TINY, **changes}))
    return str(path)


def test_export_cli_exports_the_ema_shadow(tmp_path):
    """A JAX-written EMA checkpoint (run dir resolution, sidecar config):
    the exported file holds the shadow, and equals the JAX CLI's export."""
    cfg_path = _config(tmp_path, EMA_DECAY=0.9)
    jcfg = jax_load_config(cfg_path)
    state = jax.device_get(init_train_state(jax.random.PRNGKey(0), jcfg))
    shadow = jax.tree_util.tree_map(lambda a: np.asarray(a) + 1.0, state.params)
    run_dir = tmp_path / "run"
    run_dir.mkdir()
    save_checkpoint(str(run_dir / "tiny.ckpt.npz"), state._replace(ema=shadow), jcfg)
    ours, theirs = str(tmp_path / "ours.weights.h5"), str(tmp_path / "jax.weights.h5")
    assert run_export(["--config", cfg_path, "--checkpoint", str(run_dir), "--out", ours,
                       "--device", "cpu"]) == ours
    jax_run_export(["--config", cfg_path, "--checkpoint", str(run_dir), "--out", theirs])
    got, _ = import_reference_weights(ours, load_config(cfg_path))
    assert_same(_sorted(got), _sorted(jax.tree_util.tree_map(np.asarray, shadow)))
    with h5py.File(ours, "r") as a, h5py.File(theirs, "r") as b:
        assert_same(_h5py_tree(a), _h5py_tree(b))




@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_infer_reference_weights(quant, tmp_path, monkeypatch, capsys):
    """``--reference-weights``: the frames of the same params installed
    through ``--checkpoint`` (no sidecar scene either way: the Lego
    defaults), bit for bit, float and int8; the float frames within one
    uint8 level of the JAX CLI's on the same file (its int8 path runs
    the Pallas kernel interpreted, ~20 s on a CPU; ``tests/test_torch_quant.py``
    holds the int8 render to it)."""
    videos = capture_videos(monkeypatch)
    cfg_path = _config(tmp_path)
    cfg = load_config(cfg_path)
    params, _ = _params(cfg, seed=3)
    for tree in params.values():
        tree["sigma"]["b"] = tree["sigma"]["b"] + 1.0  # a dense field
    weights = str(tmp_path / "ref.weights.h5")
    export_reference_weights(weights, params, cfg)
    ckpt = str(tmp_path / "same.ckpt.npz")
    save_params_npz(ckpt, params, cfg)
    extra = ["--quant", "int8", "--quant-gate-db", "0"] if quant else []
    base = ["--config", cfg_path, "--frames", "2", "--chunk", "128", *extra]
    ours = run_inference(base + ["--reference-weights", weights, "--device", "cpu",
                                 "--out", str(tmp_path / "r.mp4")])
    text = capsys.readouterr().out
    assert f"imported reference weights {weights}" in text and "Lego-scene defaults" in text
    assert ("int8 gate PASS" in text) == quant
    same = run_inference(base + ["--checkpoint", ckpt, "--device", "cpu",
                                 "--out", str(tmp_path / "c.mp4")])
    ours, same = video_frames(videos, ours, 2), video_frames(videos, same, 2)
    for a, b in zip(ours, same):
        assert a.shape == (16, 16, 3)
        np.testing.assert_array_equal(a, b)
    assert ours[0].std() > 1.0 and not np.array_equal(ours[0], ours[1])
    if quant:
        return
    captured = {}
    monkeypatch.setattr(jinfer, "write_video",
                        lambda path, frames, fps: captured.setdefault(path, frames) and path)
    jinfer.run_inference(base + ["--reference-weights", weights, "--platform", "cpu",
                                 "--out", str(tmp_path / "j.mp4")])
    theirs = captured[str(tmp_path / "j.mp4")]
    assert len(theirs) == 2
    for a, c in zip(ours, theirs):
        assert np.abs(a.astype(np.int16) - np.asarray(c, np.int16)).max() <= 1


@pytest.mark.parametrize("case", ["neither", "both", "proposal", "export_proposal"])
def test_cli_exits(case, tmp_path):
    cfg_path = _config(tmp_path)
    weights = str(tmp_path / "ref.weights.h5")
    export_reference_weights(weights, _params(load_config(cfg_path), seed=0)[0],
                             load_config(cfg_path))
    if case == "export_proposal":
        prop = _config(tmp_path, TRAIN_SAMPLER="proposal")
        trainer = Trainer(load_config(prop), 2.0, 6.0, device="cpu")
        trainer.save(str(tmp_path / "p.ckpt.npz"))
        with pytest.raises(SystemExit, match="no coarse MLP"):
            run_export(["--config", prop, "--checkpoint", str(tmp_path / "p.ckpt.npz"),
                        "--out", str(tmp_path / "p.weights.h5"), "--device", "cpu"])
        assert not os.path.exists(tmp_path / "p.weights.h5")
        return
    argv = {"neither": [],
            "both": ["--checkpoint", "x.ckpt.npz", "--reference-weights", weights],
            "proposal": ["--reference-weights", weights]}[case]
    config = _config(tmp_path, TRAIN_SAMPLER="proposal") if case == "proposal" else cfg_path
    match = "coarse\\+fine pair" if case == "proposal" else "exactly one of"
    with pytest.raises(SystemExit, match=match):
        run_inference(["--config", config, "--device", "cpu", *argv])


# ---------------------------------------------------------------------------
# Live Keras
# ---------------------------------------------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("bn", VARIANTS, ids=IDS)
def test_live_keras_both_ways(bn, tmp_path):
    """A fresh reference-architecture Keras model ``load_weights`` the
    port's file and reproduces the port MLP's forward; the model's own
    ``save_weights`` file, read by the port, reproduces the model's."""
    pytest.importorskip("keras")
    import scripts.make_keras_fixture as mk

    cfg, _ = _cfgs(bn)
    params, stats = _params(cfg, seed=5)
    path = str(tmp_path / "ours.weights.h5")
    export_reference_weights(path, params, cfg, bn_state=stats)
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (2, 3, cfg.xyz_dim)).astype(np.float32)
    d = rng.normal(0, 1, (2, 3, cfg.dir_dim)).astype(np.float32)

    def port_forward(p, s):
        outs = []
        for which in ("coarse", "fine"):
            mlp = NeRFMLP.from_jax_params(p[which], skip_layer=cfg.skip_layer,
                                          compute_dtype=torch.float32,
                                          bn_state=None if s is None else s[which])
            with torch.no_grad():
                outs.append(mlp(torch.as_tensor(x), torch.as_tensor(d)).numpy())
        return outs

    t = mk.make_trainer(bn=bn)
    t([x, d])
    t.load_weights(path)
    for got, want in zip(t([x, d], training=False), port_forward(params, stats)):
        np.testing.assert_allclose(np.asarray(got), want, rtol=2e-4, atol=2e-4)

    mk.randomize(t, seed=13)
    theirs = str(tmp_path / "keras.weights.h5")
    t.save_weights(theirs)
    for got, want in zip(port_forward(*import_reference_weights(theirs, cfg)),
                         t([x, d], training=False)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-4, atol=2e-4)
