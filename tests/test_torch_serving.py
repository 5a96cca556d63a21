"""The port's render server: endpoints, agreement with the JAX server, the
PNG codec, and the import rule (no JAX in the port)."""

import ast
import json
import pathlib
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from nerf_keras_tpu.config import NeRFConfig
from nerf_keras_tpu.engine.trainer import Trainer as JaxTrainer
from nerf_keras_tpu.serving import RenderService as JaxRenderService
from nerf_keras_tpu.utils.checkpoint import save_checkpoint
from nerf_keras_tpu_torch.serving import RenderService, serve
from nerf_keras_tpu_torch.utils.png import decode_png, encode_png

# Tier-1 runs several pytest workers on a few cores.  With torch's
# default pool (one OpenMP thread per core) a JAX training test in a
# sibling worker aborted; one thread is plenty at these sizes.
torch.set_num_threads(1)

CFG = NeRFConfig(
    batch_size=64, ns_coarse=8, ns_fine=8, num_layers=6, hidden_dim=32,
    skip_layer=4, height=8, width=8, compute_dtype="float32",
).validate()
PORT_ROOT = pathlib.Path(__file__).resolve().parents[1] / "nerf_keras_tpu_torch"


def _write(jt, path):
    save_checkpoint(str(path), jax.device_get(jt.state), CFG,
                    scene={"near": 2.0, "far": 6.0})


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = tmp_path_factory.mktemp("srv") / "model.ckpt.npz"
    jt = JaxTrainer(CFG, 2.0, 6.0)
    _write(jt, path)
    return str(path)


@pytest.fixture(scope="module")
def service(ckpt):
    return RenderService(CFG, ckpt, device="cpu")


def test_png_matches_the_jax_server(ckpt, service):
    """Same checkpoint, same request: the port's PNG (stdlib encoder)
    decodes to within +-2 levels of the JAX server's (PIL) — the fine
    pass's sample positions differ by float ulps (test_torch_render.py)."""
    jax_svc = JaxRenderService(CFG, ckpt, 2.0, 6.0)
    for map_name in ("rgb", "depth"):
        kw = dict(theta=30.0, phi=-30.0, radius=4.0, height=8, width=8,
                  chunk=64, map_name=map_name)
        ours = decode_png(service.render_png(**kw))
        theirs = decode_png(jax_svc.render_png(**kw))
        assert ours.shape == theirs.shape
        assert ours.shape == ((8, 8, 3) if map_name == "rgb" else (8, 8))
        assert np.abs(ours.astype(int) - theirs.astype(int)).max() <= 2


def test_http_endpoints(service):
    server = serve(service, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        before = service.stats()["requests"]
        assert urllib.request.urlopen(f"{base}/healthz").read() == b"ok"
        png = urllib.request.urlopen(
            f"{base}/render?theta=10&height=6&width=7&chunk=16"
        ).read()
        assert decode_png(png).shape == (6, 7, 3)
        depth = urllib.request.urlopen(
            f"{base}/render?theta=10&height=6&width=7&map=depth"
        ).read()
        assert decode_png(depth).shape == (6, 7)
        stats = json.loads(urllib.request.urlopen(f"{base}/stats").read())
        assert stats["requests"] == before + 2
        assert stats["quant"] == "none" and stats["sampler"] == "coarse"
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"{base}/render?map=acc&height=4&width=4")
        assert e.value.code == 500
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"{base}/nope")
        assert e.value.code == 404
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()


def test_reload_picks_up_a_newer_checkpoint(tmp_path):
    """POST /reload on a server pointed at a run directory installs the
    newest checkpoint and renders with it."""
    jt = JaxTrainer(CFG, 2.0, 6.0)
    _write(jt, tmp_path / "nerf_ep1.ckpt.npz")
    svc = RenderService(CFG, str(tmp_path), device="cpu")
    assert svc.checkpoint.endswith("nerf_ep1.ckpt.npz")
    kw = dict(theta=0.0, phi=-30.0, radius=4.0, height=6, width=6, chunk=64)
    first = decode_png(svc.render_png(**kw))

    rng = np.random.default_rng(0)
    jt.state = jt.state._replace(params=jax.tree_util.tree_map(
        lambda x: np.asarray(x) + rng.normal(size=x.shape).astype(np.float32) * 0.3,
        jt.state.params,
    ))
    _write(jt, tmp_path / "nerf_ep10.ckpt.npz")
    server = serve(svc, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.server_address[1]}/reload", method="POST"
        )
        result = json.loads(urllib.request.urlopen(req).read())
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert result["changed"] and result["checkpoint"].endswith("nerf_ep10.ckpt.npz")
    assert svc.stats()["reloads"] == 1
    assert not np.array_equal(decode_png(svc.render_png(**kw)), first)


@pytest.fixture(scope="module")
def dense_ckpt(tmp_path_factory):
    """A checkpoint of a denser field than the init (sigma biases +1, noise
    on every leaf): at the init's sigma of 0 the 1e10 terminal delta makes
    int8 and proposal frames jump (tests/test_torch_quant.py)."""
    jt = JaxTrainer(CFG, 2.0, 6.0)
    rng = np.random.default_rng(3)

    def bump(path, x):
        x = np.asarray(x) + rng.normal(size=x.shape).astype(np.float32) * 0.05
        return x + 1.0 if jax.tree_util.keystr(path).endswith("['sigma']['b']") else x

    jt.state = jt.state._replace(params=jax.tree_util.tree_map_with_path(
        bump, jax.device_get(jt.state.params)))
    path = tmp_path_factory.mktemp("dense") / "model.ckpt.npz"
    _write(jt, path)
    return str(path)


@pytest.mark.parametrize("quant", [False, True])
def test_proposal_sampler_serves_from_the_jax_cache(dense_ckpt, tmp_path, capsys,
                                                    monkeypatch, quant):
    """``--sampler proposal`` (with and without int8) on a coarse-trained
    checkpoint: the JAX server starts first and writes its cache; the
    port's server loads it (the same net and tables, no distillation or
    calibration) and serves PNGs within +-2 levels of the JAX server's."""
    import nerf_keras_tpu_torch.engine.trainer as ptrainer

    cache = str(tmp_path / "model.infer.npz")
    kw = dict(quant=quant, sampler="proposal", sampler_gate_db=0.0, quant_gate_db=0.0,
              proposal_steps=10, infer_cache=cache)
    jax_svc = JaxRenderService(CFG, dense_ckpt, 2.0, 6.0, **kw)
    assert jax_svc.use_sampler == "proposal"
    capsys.readouterr()

    def refuse(*args, **kwargs):
        raise AssertionError("the port rebuilt an artifact the cache holds")

    monkeypatch.setattr(ptrainer, "distill_proposal", refuse)
    monkeypatch.setattr(ptrainer, "calibrate_render", refuse)
    svc = RenderService(CFG, dense_ckpt, device="cpu", **kw)
    out = capsys.readouterr().out
    assert f"loaded inference artifacts from {cache}" in out
    assert "saved inference artifacts" not in out and "gate PASS" in out
    assert svc.use_sampler == "proposal" and svc.use_quant == quant
    stats = svc.stats()
    assert stats["sampler"] == "proposal" and stats["quant"] == ("int8" if quant else "none")
    for map_name in ("rgb", "depth"):
        req = dict(theta=30.0, phi=-30.0, radius=4.0, height=8, width=8, chunk=64,
                   map_name=map_name)
        ours = decode_png(svc.render_png(**req))
        theirs = decode_png(jax_svc.render_png(**req))
        assert ours.shape == theirs.shape
        assert np.abs(ours.astype(int) - theirs.astype(int)).max() <= 2
    # The served frame is the proposal-sampled one, not the coarse one.
    req = dict(theta=30.0, phi=-30.0, radius=4.0, height=8, width=8)
    coarse = RenderService(CFG, dense_ckpt, device="cpu", quant=quant, quant_gate_db=0.0,
                           infer_cache=cache)
    assert coarse.use_sampler == "coarse"
    assert not np.array_equal(decode_png(svc.render_png(**req)),
                              decode_png(coarse.render_png(**req)))
    assert svc.reload()["sampler"] == "proposal"


def test_infer_cache_round_trip(dense_ckpt, tmp_path, capsys):
    """The first start distills and saves; a restart loads instead (the
    file is unchanged); a cache of other weights is ignored with a notice
    and overwritten."""
    cache = str(tmp_path / "model.infer.npz")
    kw = dict(sampler="proposal", sampler_gate_db=0.0, proposal_steps=10, infer_cache=cache)
    svc = RenderService(CFG, dense_ckpt, device="cpu", **kw)
    assert svc.trainer.proposal_ready and svc.use_sampler == "proposal"
    out = capsys.readouterr().out
    assert "saved inference artifacts" in out and "loaded" not in out
    first = np.load(cache)["__digest__"].item()
    assert first == svc.trainer.infer_digest()

    again = RenderService(CFG, dense_ckpt, device="cpu", **kw)
    out = capsys.readouterr().out
    assert "loaded inference artifacts" in out and "saved inference artifacts" not in out
    assert again.trainer.proposal_ready
    assert np.load(cache)["__digest__"].item() == first

    other = tmp_path / "other.ckpt.npz"
    _write(JaxTrainer(CFG, 2.0, 6.0), other)
    RenderService(CFG, str(other), device="cpu", **kw)
    out = capsys.readouterr().out
    assert "ignoring artifact cache" in out and "different weights" in out
    assert "saved inference artifacts" in out
    assert np.load(cache)["__digest__"].item() != first


@pytest.mark.parametrize(
    "shape", [(5, 7), (5, 7, 1), (4, 6, 2), (3, 9, 3), (6, 2, 4)]
)
def test_png_round_trip(shape):
    img = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    out = decode_png(encode_png(img))
    np.testing.assert_array_equal(out, img.squeeze(-1) if shape[-1:] == (1,) else img)


def _filtered_png(img: np.ndarray, ftype: int) -> bytes:
    """A PNG whose every row uses filter ``ftype``, filtered byte by byte
    as the PNG specification writes it."""
    import struct
    import zlib

    h, w, c = img.shape
    rows = img.reshape(h, w * c).astype(int)
    out = []
    for y in range(h):
        prev = rows[y - 1] if y else np.zeros(w * c, int)
        line = [ftype]
        for x in range(w * c):
            a = rows[y, x - c] if x >= c else 0
            b = prev[x]
            cc = prev[x - c] if x >= c else 0
            pred = [0, a, b, (a + b) // 2][ftype] if ftype < 4 else None
            if ftype == 4:
                p = a + b - cc
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else cc)
            line.append((rows[y, x] - pred) % 256)
        out.append(bytes(line))

    def chunk(kind, data):
        crc = zlib.crc32(kind + data) & 0xFFFFFFFF
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)

    color = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_png_decodes_every_filter(ftype):
    """Each of the five row filters (PIL chooses among them per row)."""
    y, x = np.mgrid[0:9, 0:11]
    rng = np.random.default_rng(ftype)
    img = np.stack([x * 23, y * 29, (x + y) * 11], -1) + rng.integers(0, 40, (9, 11, 3))
    img = img.astype(np.uint8)
    np.testing.assert_array_equal(decode_png(_filtered_png(img, ftype)), img)
    rgba = np.concatenate([img, img[..., :1]], axis=-1)
    np.testing.assert_array_equal(decode_png(_filtered_png(rgba, ftype)), rgba)


def test_png_decodes_pil_output():
    import io

    from PIL import Image

    y, x = np.mgrid[0:32, 0:40]
    rng = np.random.default_rng(1)
    img = np.stack([x * 6, y * 7, (x + y) * 3], -1) + rng.integers(0, 4, (32, 40, 3))
    img = img.astype(np.uint8)
    for optimize in (False, True):
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="PNG", optimize=optimize)
        np.testing.assert_array_equal(decode_png(buf.getvalue()), img)


def _imports(path: pathlib.Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.append(node.module)
    return names


def test_port_imports_no_jax():
    """Neither the port nor chip_smoke.py imports JAX or any module of the
    JAX package or of ``experimental/``, not even the JAX package's
    stdlib-only config (the port keeps its own copy), nor PIL, OpenCV,
    matplotlib, fsspec, h5py, keras or tensorflow, which the card's machine lacks (the
    port reads and writes Keras files with ``utils/h5.py``); the port's data loaders
    import no ``urllib`` (they never download).  A source scan: the test
    process imports JAX itself, so sys.modules cannot tell."""
    smoke = PORT_ROOT.parent / "chip_smoke.py"
    files = sorted(PORT_ROOT.rglob("*.py")) + [smoke]
    assert len(files) > 10
    bad = []
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "flax", "optax", "PIL", "cv2", "matplotlib", "fsspec",
                       "nerf_keras_tpu", "experimental", "h5py", "keras", "tensorflow"):
                bad.append(f"{path.relative_to(PORT_ROOT.parent)}: {name}")
            if top == "urllib" and path.is_relative_to(PORT_ROOT / "data"):
                bad.append(f"{path.relative_to(PORT_ROOT.parent)}: {name}")
    assert len(list((PORT_ROOT / "data").rglob("*.py"))) >= 5
    assert {p.name for p in (PORT_ROOT / "parallel").glob("*.py")} >= {
        "distributed.py", "mesh.py", "audit.py"}
    assert not bad, bad
