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


@pytest.mark.parametrize("kwargs", [{"quant": True, "sampler": "proposal"},
                                    {"sampler": "proposal"}])
def test_unported_modes_raise(ckpt, kwargs):
    """The offline-distilled proposal sampler is not ported yet, with or
    without int8 (``--quant int8`` alone: tests/test_torch_quant.py)."""
    with pytest.raises(NotImplementedError, match="not yet ported.*later PR"):
        RenderService(CFG, ckpt, device="cpu", **kwargs)


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
    stdlib-only config (the port keeps its own copy).  A source scan: the test process imports JAX itself, so
    sys.modules cannot tell."""
    smoke = PORT_ROOT.parent / "chip_smoke.py"
    files = sorted(PORT_ROOT.rglob("*.py")) + [smoke]
    assert len(files) > 10
    bad = []
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "flax", "optax", "PIL", "nerf_keras_tpu",
                       "experimental"):
                bad.append(f"{path.relative_to(PORT_ROOT.parent)}: {name}")
    assert not bad, bad
