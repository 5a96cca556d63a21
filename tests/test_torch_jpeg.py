"""The port's JPEG decoder (``utils/jpeg.py``), LANCZOS resize
(``utils/image.resize_lanczos_u8``) and the LLFF ``minify`` built on them,
held to PIL 12.1.0 and to the JAX package (which reads and minifies
captures through PIL).

* Decoding is bit for bit PIL's ``Image.open(f).convert("RGB")`` on every
  file of ``tests/fixtures/torch_jpeg/`` and on JPEGs written here from
  seeded images over subsampling (4:4:4, 4:2:2, 4:2:0, 4:4:0, gray),
  quality, optimised tables, restart intervals and small odd sizes, each
  baseline and progressive.  PIL cannot write 4:4:0; OpenCV writes those
  files (and progressive ones through its own libjpeg), PIL still decodes
  them.  Progressive scripts libjpeg never writes (non-interleaved DC
  scans, a DC refinement alone, a DQT between scans that a latched
  component ignores, DHT and DRI between scans) come from
  ``torch_jpeg_fixtures.custom_script``.
* Every refused kind (arithmetic, SOF10, lossless, 12-bit, CMYK, YCCK,
  Adobe RGB, truncated, DNL, several scans in a sequential frame,
  progressive scripts libjpeg rejects or warns about, one that leaves a
  coefficient incomplete) raises ``ValueError`` naming the file and the
  marker or field.
* ``resize_lanczos_u8`` is bit for bit ``Image.resize(..., LANCZOS)``.
* ``minify``, ``load_llff_data`` and ``prepare_fern_data`` on a capture
  that ships only ``images/*.jpg`` give the JAX package's images exactly
  and its rays within ``test_torch_llff.py``'s 1e-6; the Blender loader
  reads ``.jpg`` frames as the JAX one does; ``cli.train_fern`` trains such
  a capture on the CPU.
* ``goldens.json`` (what ``chip_smoke.py`` checks on the card's machine,
  which has no PIL) is what PIL computes from the committed files.
"""

import io
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import torch_jpeg_fixtures as fx
from nerf_keras_tpu.data import blender as jblender
from nerf_keras_tpu.data import llff as jllff
from nerf_keras_tpu.ops.rays import pose_spherical
from nerf_keras_tpu_torch.data import blender as pblender
from nerf_keras_tpu_torch.data import llff as pllff
from nerf_keras_tpu_torch.data.synthetic import forward_facing_views
from nerf_keras_tpu_torch.utils import hostbuild, jpeg
from nerf_keras_tpu_torch.utils.image import resize_lanczos_u8
from nerf_keras_tpu_torch.utils.png import decode_png

torch.set_num_threads(1)

ATOL = 1e-6  # test_torch_llff.py's tolerance on rays


def _pil_rgb(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as img:
        return np.asarray(img.convert("RGB"))


def _port_rgb(data: bytes, name: str = "x.jpg") -> np.ndarray:
    img = jpeg.decode_jpeg(data, name)
    return np.repeat(img[..., None], 3, axis=-1) if img.ndim == 2 else img


def _assert_same(got: np.ndarray, want: np.ndarray, what: str) -> None:
    assert got.shape == want.shape and got.dtype == np.uint8, (what, got.shape, want.shape)
    diff = got.astype(np.int16) - want
    assert not diff.any(), f"{what}: {np.count_nonzero(diff)} values differ, max {abs(diff).max()}"


# --- the committed fixtures --------------------------------------------------

def test_goldens_are_what_pil_computes():
    """``goldens.json`` against PIL on the committed files, and the fixture
    directory under 400 KB."""
    stored = json.loads(fx.GOLDENS.read_text())
    fresh = fx.pil_goldens()
    assert stored["decode"] == fresh["decode"]
    assert stored["minify"] == fresh["minify"]
    assert stored["minify_progressive"] == fresh["minify_progressive"]
    assert len(stored["decode"]) == (len(fx.CASES) + 1 + len(fx.PROGRESSIVE_CASES)
                                     + 2 * fx.CAPTURE_VIEWS)
    assert len(stored["minify"]) == len(stored["minify_progressive"]) == fx.CAPTURE_VIEWS
    files = [p for p in fx.FIXTURES.rglob("*") if p.is_file()]
    progressive = [p for p in files
                   if "capture_progressive" in p.parts or p.name.startswith("prog_")]
    size = sum(p.stat().st_size for p in files if p not in progressive)
    assert size < 400_000, size
    size = sum(p.stat().st_size for p in progressive)
    assert size < 400_000, size


@pytest.mark.parametrize("rel", sorted(json.loads(fx.GOLDENS.read_text())["decode"]))
def test_fixture_decodes_as_pil(rel):
    data = (fx.FIXTURES / rel).read_bytes()
    got = _port_rgb(data, rel)
    _assert_same(got, _pil_rgb(data), rel)
    assert fx.digest(got) == json.loads(fx.GOLDENS.read_text())["decode"][rel]


def test_fixture_cases_cover_the_layouts():
    """The cases hold what their names say: sampling factors, restart
    intervals, optimised tables, EXIF orientation 6 (not applied)."""
    def sof_sampling(data):
        i = data.index(b"\xff\xc0")
        nf = data[i + 9]
        return [data[i + 11 + 3 * c] for c in range(nf)]

    case = lambda n: (fx.FIXTURES / "cases" / f"{n}.jpg").read_bytes()  # noqa: E731
    assert sof_sampling(case("s444_q90")) == [0x11, 0x11, 0x11]
    assert sof_sampling(case("s422_q90")) == [0x21, 0x11, 0x11]
    assert sof_sampling(case("s420_q90")) == [0x22, 0x11, 0x11]
    assert sof_sampling(case("s440_q90")) == [0x12, 0x11, 0x11]
    assert len(sof_sampling(case("gray_q90"))) == 1
    for n in ("s420_restart", "s422_restart_rows"):
        assert b"\xff\xdd" in case(n) and b"\xff\xd0" in case(n)
    assert case("s420_optimize") != case("s420_q90")
    exif = case("s420_exif_comment")
    assert b"Exif" in exif and b"\xff\xfe" in exif
    with Image.open(io.BytesIO(exif)) as img:
        assert img.getexif()[0x0112] == 6
        assert img.size == (65, 41)  # PIL's open rotates nothing
    assert _port_rgb(exif).shape == (41, 65, 3)


# --- JPEGs written here --------------------------------------------------------

SIZES = [(37, 53), (1, 1), (2, 3), (17, 3), (16, 32), (9, 71)]


def _write(img: np.ndarray, layout: str, quality: int, optimize: bool,
           restart: int) -> bytes:
    if layout == "4:4:0":  # PIL cannot write it
        import cv2

        ok, enc = cv2.imencode(".jpg", img[..., ::-1], [
            cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_OPTIMIZE, int(optimize),
            cv2.IMWRITE_JPEG_RST_INTERVAL, restart,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440])
        assert ok
        return enc.tobytes()
    buf = io.BytesIO()
    opts = dict(quality=quality, optimize=optimize, restart_marker_blocks=restart)
    if layout == "gray":
        Image.fromarray(img[..., 0]).save(buf, "JPEG", **opts)
    else:
        Image.fromarray(img).save(buf, "JPEG", subsampling=layout, **opts)
    return buf.getvalue()


@pytest.mark.parametrize("restart", [0, 2])
@pytest.mark.parametrize("optimize", [False, True])
@pytest.mark.parametrize("quality", [50, 95])
@pytest.mark.parametrize("layout", ["4:4:4", "4:2:2", "4:2:0", "4:4:0", "gray"])
def test_written_jpegs_decode_as_pil(layout, quality, optimize, restart):
    for i, (h, w) in enumerate(SIZES):
        img = fx.case_image(h, w, seed=1000 + 7 * i + quality)
        data = _write(img, layout, quality, optimize, restart)
        _assert_same(_port_rgb(data), _pil_rgb(data), f"{layout} q{quality} {h}x{w}")


def _write_progressive(img: np.ndarray, layout: str, quality: int, optimize: bool,
                       restart: int) -> bytes:
    if layout.startswith("cv2"):  # OpenCV's own libjpeg, its 4:4:0 too
        import cv2

        sampling = {"cv2 4:2:0": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
                    "cv2 4:4:0": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}[layout]
        ok, enc = cv2.imencode(".jpg", img[..., ::-1], [
            cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_OPTIMIZE, int(optimize),
            cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_RST_INTERVAL, restart,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling])
        assert ok
        return enc.tobytes()
    buf = io.BytesIO()
    opts = dict(quality=quality, optimize=optimize, restart_marker_blocks=restart,
                progressive=True)
    if layout == "gray":
        Image.fromarray(img[..., 0]).save(buf, "JPEG", **opts)
    else:
        Image.fromarray(img).save(buf, "JPEG", subsampling=layout, **opts)
    return buf.getvalue()


@pytest.mark.parametrize("restart", [0, 2])
@pytest.mark.parametrize("optimize", [False, True])
@pytest.mark.parametrize("quality", [50, 95])
@pytest.mark.parametrize("layout", ["4:4:4", "4:2:2", "4:2:0", "gray", "cv2 4:2:0",
                                    "cv2 4:4:0"])
def test_written_progressive_jpegs_decode_as_pil(layout, quality, optimize, restart):
    for i, (h, w) in enumerate(SIZES):
        img = fx.case_image(h, w, seed=2000 + 7 * i + quality)
        data = _write_progressive(img, layout, quality, optimize, restart)
        assert b"\xff\xc2" in data
        _assert_same(_port_rgb(data), _pil_rgb(data), f"progressive {layout} q{quality} "
                                                       f"{h}x{w}")


@pytest.mark.parametrize("sampling", [(1, 1), (2, 1), (2, 2), (1, 2), "gray"])
def test_custom_progressive_scripts_decode_as_pil(sampling):
    """Scripts libjpeg's encoders never write: Y's DC alone at Al = 1 and
    refined alone, Cb and Cr's DC interleaved, each AC band alone over the
    component's own block grid (not the MCU-padded one), restart intervals
    set and cleared, DHT and DQT between scans."""
    for i, (h, w) in enumerate(SIZES + [(40, 33)]):
        img = fx.case_image(h, w, seed=3000 + i)
        data = fx.custom_script(img[..., 0] if sampling == "gray" else img,
                                (1, 1) if sampling == "gray" else sampling)
        _assert_same(_port_rgb(data), _pil_rgb(data), f"custom {sampling} {h}x{w}")


def test_dqt_between_scans_keeps_the_latched_table(monkeypatch):
    """In ``prog_custom_s420`` a DQT after Y's first scan redefines the
    table all three components name: Y keeps the table it latched, as
    libjpeg keeps it; a decoder that re-read the table at each scan would
    differ from PIL."""
    data = (fx.FIXTURES / "cases" / "prog_custom_s420.jpg").read_bytes()
    want = _pil_rgb(data)
    _assert_same(_port_rgb(data), want, "latched")
    real = jpeg._Frame.scan_header

    def relatch(self, *args):
        self.latched = [False] * len(self.latched)
        return real(self, *args)

    monkeypatch.setattr(jpeg._Frame, "scan_header", relatch)
    assert (np.abs(_port_rgb(data).astype(int) - want) > 8).any()


def test_large_progressive_frame_decodes_as_pil():
    img = fx.case_image(1512, 2016, seed=6)
    data = _write_progressive(img, "4:2:0", 90, False, 0)
    _assert_same(_port_rgb(data), _pil_rgb(data), "progressive 1512x2016")


def test_large_frame_decodes_as_pil():
    """A camera-sized frame (4:2:0, 1512x2016): many restart-free MCU rows,
    16-bit-deep coefficient sums, and the speed of the C++ scan."""
    img = fx.case_image(1512, 2016, seed=5)
    data = _write(img, "4:2:0", 90, False, 0)
    _assert_same(_port_rgb(data), _pil_rgb(data), "1512x2016")


# --- what the decoder refuses ---------------------------------------------------

def _baseline(**opts) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(fx.case_image(37, 53, seed=3)).save(buf, "JPEG", quality=90, **opts)
    return buf.getvalue()


def _patched(data: bytes, marker: bytes, offset: int, value: int) -> bytes:
    out = bytearray(data)
    out[data.index(marker) + offset] = value
    return bytes(out)


def _script(scans, sof: int = 0xC2) -> bytes:
    """A 3-component frame of ``fx.ProgressiveWriter`` and the scans
    ``scans(writer)`` appends."""
    q = fx.quant_table(8)
    w = fx.ProgressiveWriter(fx.case_image(21, 27, seed=8), (2, 2), [q, q, q], sof=sof)
    scans(w)
    return w.finish()


def _refused_cases():
    base = _baseline()
    sos = base.index(b"\xff\xda")
    buf = io.BytesIO()
    Image.fromarray(fx.case_image(37, 53, seed=3)).convert("CMYK").save(buf, "JPEG")
    cmyk = buf.getvalue()
    adobe = cmyk.index(b"Adobe")
    ycck = cmyk[:adobe + 11] + b"\x02" + cmyk[adobe + 12:]
    # The first DHT table's counts with three codes of length 1 (two fit),
    # the total unchanged.
    dht = bytearray(base)
    counts = base.index(b"\xff\xc4") + 5
    dht[counts], dht[counts + 2] = 3, base[counts + 2] - 3
    prog = _baseline(progressive=True)
    sos2 = prog.index(b"\xff\xda", prog.index(b"\xff\xda") + 2)
    return {
        "arithmetic": (_patched(base, b"\xff\xc0", 1, 0xC9), "SOF9 \\(arithmetic"),
        "sof10": (_patched(prog, b"\xff\xc2", 1, 0xCA),
                  "SOF10 \\(arithmetic progressive\\)"),
        "incomplete-band": (prog[:prog.rindex(b"\xff\xda")] + b"\xff\xd9",
                            "progressive scans leave coefficient 1 of component 1 "
                            "incomplete \\(refined only to Al=1"),
        "dnl": (prog[:sos2] + b"\xff\xdc\x00\x04\x00\x25" + prog[sos2:], "DNL"),
        "ac-two-components": (_script(lambda w: (w.dc([0, 1, 2]), w.ac([0, 1], 1, 63))),
                              "Ss=1 Se=63 Ah=0 Al=0: an AC scan holds one component"),
        "bad-refinement": (_script(lambda w: (w.dc([0, 1, 2], al=2),
                                              w.dc_refine([0, 1, 2], 2, al=0))),
                           "Ss=0 Se=0 Ah=2 Al=0: a refinement scan has Al = Ah - 1"),
        "dc-mixed": (_script(lambda w: (w.dc([0], al=1), w.dc_refine([0, 1], 1))),
                     "a DC scan mixing first and refinement passes: component 2, "
                     "coefficient 0 is unsent"),
        "ac-before-dc": (_script(lambda w: w.ac([0], 1, 63)),
                         "an AC scan of component 1 before its first DC scan"),
        "sequential-two-scans": (_script(lambda w: (w.sequential([0]), w.sequential([1, 2])),
                                         sof=0xC1),
                                 "SOS: a scan of 1 of the frame's 3 components"),
        "lossless": (_patched(base, b"\xff\xc0", 1, 0xC3), "SOF3 \\(lossless\\)"),
        "12-bit": (_patched(base, b"\xff\xc0", 4, 12), "SOF0: 12-bit samples"),
        "cmyk": (cmyk, "4 components \\(CMYK/YCCK\\)"),
        "ycck": (ycck, "4 components \\(CMYK/YCCK\\)"),
        "adobe-rgb": (_baseline(keep_rgb=True), "Adobe APP14 transform=0"),
        "truncated-scan": (base[:sos + (len(base) - sos) // 2], "truncated data"),
        "truncated-header": (base[:sos - 40], "truncated data"),
        "no-eoi": (base[:-2], "truncated data: the file ends before the EOI"),
        "huffman-overflow": (bytes(dht), "DHT: code counts overflow"),
        "not-a-jpeg": (b"\xff\xd9" + base[2:], "neither a PNG nor a JPEG"),
    }


@pytest.mark.parametrize("kind", sorted(_refused_cases()))
def test_refused_jpegs_raise_naming_the_file(tmp_path, kind):
    data, what = _refused_cases()[kind]
    path = tmp_path / f"frame_{kind}.jpg"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=f"frame_{kind}.jpg: .*{what}"):
        pllff._read_image(str(path))


def test_refused_kinds_are_what_they_claim():
    """PIL reads (or rejects as the port does) each refused file: the
    refusals are of real streams, not of files no decoder reads."""
    cases = _refused_cases()
    # libjpeg only warns about these: PIL decodes them (the incomplete band
    # with block smoothing).
    for kind in ("incomplete-band", "dc-mixed", "ac-before-dc", "sequential-two-scans"):
        assert _pil_rgb(cases[kind][0]).shape[2] == 3, kind
    # ... and rejects these.
    for kind in ("ac-two-components", "bad-refinement"):
        with pytest.raises(OSError):
            _pil_rgb(cases[kind][0])
    assert cases["sof10"][0].count(b"\xff\xca") == 1
    assert cases["dnl"][0].count(b"\xff\xdc") == 1
    with Image.open(io.BytesIO(cases["cmyk"][0])) as img:
        assert img.mode == "CMYK"
    with Image.open(io.BytesIO(cases["adobe-rgb"][0])) as img:
        assert img.mode == "RGB"
    with pytest.raises(OSError):
        _pil_rgb(cases["truncated-scan"][0])


def test_decoder_without_gxx_names_the_compiler(monkeypatch, tmp_path):
    monkeypatch.setattr(jpeg, "_lib", None)
    monkeypatch.setattr(jpeg, "library_path", lambda: tmp_path / "missing.so")
    monkeypatch.setattr(hostbuild.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        jpeg.decode_jpeg(_baseline(), "x.jpg")


# --- LANCZOS -------------------------------------------------------------------

@pytest.mark.parametrize("factor", [2, 4, 8])
@pytest.mark.parametrize("size", [(37, 53), (101, 67), (250, 331)])
def test_resize_lanczos_matches_pil(size, factor):
    h, w = size
    img = np.random.default_rng(h * factor).integers(0, 256, (h, w, 3), dtype=np.uint8)
    want = np.asarray(Image.fromarray(img).resize((w // factor, h // factor),
                                                  Image.LANCZOS))
    _assert_same(resize_lanczos_u8(img, w // factor, h // factor), want, f"{size}/{factor}")
    gray = np.asarray(Image.fromarray(img[..., 1]).resize((w // factor, h // factor),
                                                          Image.LANCZOS))
    _assert_same(resize_lanczos_u8(img[..., 1], w // factor, h // factor), gray, "gray")


@pytest.mark.parametrize("out", [(53, 10), (10, 37), (80, 74), (7, 5)])
def test_resize_lanczos_one_axis_and_upscale_matches_pil(out):
    img = fx.case_image(37, 53, seed=11)
    want = np.asarray(Image.fromarray(img).resize(out, Image.LANCZOS))
    _assert_same(resize_lanczos_u8(img, *out), want, str(out))


# --- LLFF captures shipped as JPEGs -----------------------------------------------

@pytest.fixture(scope="module")
def jpeg_captures(tmp_path_factory):
    """Two copies of the committed JPEG-only capture, one minified by the
    JAX package (PIL), one by the port."""
    root = tmp_path_factory.mktemp("jpeg_capture")
    src = fx.FIXTURES / "capture"
    ours, theirs = root / "port", root / "jax"
    shutil.copytree(src, ours)
    shutil.copytree(src, theirs)
    assert pllff.minify(str(ours), 8) == str(ours / "images_8")
    assert jllff.minify(str(theirs), 8) == str(theirs / "images_8")
    return str(ours), str(theirs)


def test_minify_writes_what_jax_writes(jpeg_captures):
    ours, theirs = jpeg_captures
    names = sorted(p.name for p in (fx.FIXTURES / "capture" / "images").iterdir())
    assert len(names) == fx.CAPTURE_VIEWS
    goldens = json.loads(fx.GOLDENS.read_text())["minify"]
    for name in names:
        stem = name[:-4]
        with open(f"{ours}/images_8/{stem}.png", "rb") as f:
            got = decode_png(f.read())
        with Image.open(f"{theirs}/images_8/{stem}.png") as img:
            want = np.asarray(img)
        _assert_same(got, want, name)
        assert got.shape == (63, 84, 3)
        assert fx.digest(got) == goldens[f"capture/images/{name}"]
    # A second call finds the frames and writes nothing.
    stamps = lambda: {p.name: p.stat().st_mtime_ns  # noqa: E731
                      for p in Path(ours, "images_8").iterdir()}
    before = stamps()
    assert pllff.minify(ours, 8) == f"{ours}/images_8" and stamps() == before


@pytest.mark.parametrize("factor", [8, 1])
def test_load_llff_data_on_jpegs_matches_jax(jpeg_captures, factor):
    ours, theirs = jpeg_captures
    got = pllff.load_llff_data(ours, factor=factor)
    want = jllff.load_llff_data(theirs, factor=factor)
    np.testing.assert_array_equal(got[0], want[0])  # images exactly
    for a, b in zip(got[1:4], want[1:4]):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)
    assert got[4] == want[4]
    h, w = (63, 84) if factor == 8 else (504, 672)
    assert got[0].shape == (fx.CAPTURE_VIEWS, h, w, 3) and got[0].std() > 0.05


@pytest.mark.parametrize("size", [(378 // 6, 504 // 6), (24, 32)])
def test_prepare_fern_data_on_jpegs_matches_jax(jpeg_captures, size):
    ours, theirs = jpeg_captures
    got = pllff.prepare_fern_data(*size, basedir=ours)
    want = jllff.prepare_fern_data(*size, basedir=theirs)
    assert got[2] == want[2] and got[3] == want[3]
    for a, b in zip(got[:2], want[:2]):
        assert (a.height, a.width, len(a)) == (b.height, b.width, len(b))
        for x, y in ((a.pixels, b.pixels), (a.origins, b.origins),
                     (a.directions, b.directions)):
            np.testing.assert_allclose(x, y, atol=ATOL, rtol=0)
    assert got[0].num_images == fx.CAPTURE_VIEWS - 1 and got[1].num_images == 1


def test_minify_of_empty_images_raises_as_jax(tmp_path):
    """No frames in ``images/``: both packages create ``images_8/`` and the
    loader raises the same count error."""
    msgs = []
    for pkg, name in ((pllff, "port"), (jllff, "jax")):
        root = tmp_path / name
        (root / "images").mkdir(parents=True)
        shutil.copy(fx.FIXTURES / "capture" / "poses_bounds.npy", root)
        with pytest.raises(ValueError, match="0 images in .*images_8 but 8 poses") as e:
            pkg.load_llff_data(str(root))
        assert (root / "images_8").is_dir()
        msgs.append(str(e.value).replace(name, ""))
    assert msgs[0] == msgs[1]


# --- Blender frames in JPEG -------------------------------------------------------

def _jpeg_scene(root, gray_frame: bool):
    """A 2-frame train split whose ``file_path``s name ``.jpg`` files (one
    gray), and a 1-frame val split."""
    for split, n in (("train", 2), ("val", 1)):
        (root / split).mkdir(parents=True)
        frames = []
        for i in range(n):
            img = fx.case_image(24, 30, seed=40 + i + 10 * (split == "val"))
            path = root / split / f"r_{i}.jpg"
            if gray_frame and i == 1:
                Image.fromarray(img[..., 0]).save(path, "JPEG", quality=90)
            else:
                Image.fromarray(img).save(path, "JPEG", quality=90)
            frames.append({"file_path": f"./{split}/r_{i}.jpg",
                           "transform_matrix": pose_spherical(90.0 * i, -30.0, 4.0).tolist()})
        (root / f"transforms_{split}.json").write_text(
            json.dumps({"camera_angle_x": 0.69, "frames": frames}))


@pytest.mark.parametrize("white", [True, False])
def test_blender_jpeg_frames_match_jax(tmp_path, white):
    _jpeg_scene(tmp_path, gray_frame=True)
    for split in ("train", "val"):
        got = pblender.load_blender_split(str(tmp_path), split, white_bkgd=white)
        want = jblender.load_blender_split(str(tmp_path), split, white_bkgd=white)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]
    got = pblender.prepare_blender_data(12, 15, str(tmp_path), white_bkgd=white)
    want = jblender.prepare_blender_data(12, 15, str(tmp_path), white_bkgd=white)
    for a, b in zip(got[:2], want[:2]):
        for x, y in ((a.pixels, b.pixels), (a.origins, b.origins),
                     (a.directions, b.directions)):
            np.testing.assert_allclose(x, y, atol=ATOL, rtol=0)


# --- the training CLI on a JPEG-only capture --------------------------------------

def test_train_fern_on_jpeg_capture(tmp_path, capsys):
    """``cli.train_fern`` on a capture with only ``images/*.jpg`` (5 views
    of 96x128, minified by 8 on the way): ``images_8/`` appears, the printed
    rays are the JAX loader's, the loss is finite and falls."""
    from nerf_keras_tpu_torch.cli import train_fern
    from nerf_keras_tpu_torch.utils.metrics import History

    cap = tmp_path / "cap"
    (cap / "images").mkdir(parents=True)
    frames, poses_bounds = forward_facing_views(5, 96, 128, 120.0)
    for i, rgb in enumerate(frames):
        Image.fromarray(rgb).save(cap / "images" / f"IMG_{i:04d}.JPG", "JPEG", quality=90)
    np.save(cap / "poses_bounds.npy", poses_bounds)
    config = tmp_path / "fern.json"
    config.write_text(json.dumps({
        "BATCH_SIZE": 64, "NS_COARSE": 8, "NS_FINE": 16, "HEIGHT": 12, "WIDTH": 16,
        "L_XYZ": 4, "L_DIR": 2, "NUM_LAYERS": 4, "HIDDEN_DIM": 16, "SKIP_LAYER": 2,
        "EPOCHS": 2, "LEARNING_RATE": 0.005, "BATCH_NORM": False, "WITH_GCS": False,
        "COMPUTE_DTYPE": "float32", "EVAL_EVERY": 1}))
    tr = train_fern.main(["--config", str(config), "--data-dir", str(cap), "--run-dir",
                          str(tmp_path / "run"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert sorted(p.name for p in (cap / "images_8").iterdir()) == [
        f"IMG_{i:04d}.png" for i in range(5)]
    _, _, (near, far), focal = jllff.prepare_fern_data(12, 16, basedir=str(cap))
    assert f"rays: train=768 val=192 near={near:.3f} far={far:.3f} focal={focal:.2f}" in out
    assert tr.step == 2 * 12
    history = History.load(str(tmp_path / "run" / "history_l4_d16_n24_ep2.json"))
    assert np.isfinite(history.losses).all() and history.losses[1] < history.losses[0]
