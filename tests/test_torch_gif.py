"""The port's GIF writer and reader (``nerf_keras_tpu_torch/utils/gif.py``)
against PIL 12.1.0 and the JAX package's ``write_video``, which writes its
GIF through PIL where no mp4 encoder imports.

* ``write_video`` returns ``<stem>.gif`` in both packages.
* A frame of at most 256 colours, and every gray frame, comes back bit for
  bit through PIL's reader and through ``decode_gif``.
* Above 256 colours each frame's PSNR through PIL's reader is at least
  PIL's own GIF's minus 0.3 dB: smooth frames, uniform noise and frames
  that ``cli.infer`` renders.
* The structure PIL reads (frames after merging repeats, each frame's
  ``duration``, ``loop``, size) is the JAX package's file's.
* ``decode_gif`` equals PIL's decode on both packages' files and on
  hand-built streams (sub-rectangles, transparency, disposal 1 and 2,
  interlacing, indices past the table), and refuses disposal 3, a code
  past the LZW table, a missing colour table and truncation by name.
"""

import io as _io
import re
import struct
import sys

import numpy as np
import pytest
from PIL import Image

from nerf_keras_tpu.utils import viz as jviz
from nerf_keras_tpu_torch.utils import gif
from nerf_keras_tpu_torch.utils import viz as pviz

SLACK_DB = 0.3


@pytest.fixture
def no_mp4(monkeypatch):
    """Both packages' ``write_video`` without an mp4 encoder, as on the
    card's machine."""
    monkeypatch.setitem(sys.modules, "imageio.v2", None)


def _write_both(tmp_path, frames, fps=30, name="clip"):
    """(port file, JAX package file) for the same frames."""
    ours = pviz.write_video(str(tmp_path / f"{name}_port.mp4"), frames, fps=fps)
    theirs = jviz.write_video(str(tmp_path / f"{name}_jax.mp4"), frames, fps=fps)
    return ours, theirs


def _pil_read(path):
    """PIL's frames (as RGB), each frame's duration, loop and size."""
    im = Image.open(path)
    frames, durations = [], []
    for i in range(im.n_frames):
        im.seek(i)
        frames.append(np.asarray(im.convert("RGB")))
        durations.append(im.info.get("duration", 0))
    return frames, durations, im.info.get("loop"), im.size


def _rgb(frame):
    return frame if frame.ndim == 3 else np.repeat(frame[..., None], 3, axis=-1)


def _distinct(frames):
    """The frames without consecutive repeats, as RGB."""
    return [_rgb(f) for i, f in enumerate(frames) if i == 0 or not np.array_equal(f, frames[i - 1])]


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return np.inf if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def _smooth(h, w, phase):
    y, x = np.mgrid[0:h, 0:w] / max(h, w)
    rgb = np.stack([np.sin(6 * x + phase), np.cos(5 * y - phase),
                    np.sin(4 * (x + y) + 2 * phase)], -1)
    return np.round((0.5 + 0.5 * rgb) * 255).astype(np.uint8)


def _lossless_frames(kind):
    rng = np.random.default_rng(1)
    if kind == "rgb_few":  # 8 x 8 x 4 levels = 256 colours at most
        return [(rng.integers(0, [8, 8, 4], (24, 30, 3)) * [36, 36, 85]).astype(np.uint8)
                for _ in range(3)]
    if kind == "rgb_256":  # exactly 256
        base = np.arange(256, dtype=np.uint32)
        keys = rng.choice(1 << 24, 256, replace=False)
        frames = []
        for _ in range(3):
            idx = rng.permutation(np.concatenate([base, rng.integers(0, 256, 320 - 256)]))
            k = keys[idx].reshape(16, 20)
            frames.append(np.stack([k >> 16, (k >> 8) & 255, k & 255], -1).astype(np.uint8))
        return frames
    if kind == "gray":  # 2-D, as the depth video's frames
        return [(rng.integers(0, 120, (40, 50)) * 2 + 1).astype(np.uint8) for _ in range(3)]
    if kind == "gray_full":  # every level in each frame
        return [rng.permutation(np.tile(np.arange(256, dtype=np.uint8), 10)).reshape(40, 64)
                for _ in range(3)]
    raise KeyError(kind)


def test_write_video_returns_the_gif_in_both_packages(tmp_path, no_mp4):
    frames = [np.full((20, 24, 3), 40 * i, np.uint8) for i in range(3)]
    ours, theirs = _write_both(tmp_path, frames)
    assert ours == str(tmp_path / "clip_port.gif")
    assert theirs == str(tmp_path / "clip_jax.gif")
    with open(ours, "rb") as f:
        assert f.read(6) == b"GIF89a"


def test_write_video_gif_errors_surface(tmp_path, no_mp4):
    """Only the mp4 attempt falls back: a frame the GIF cannot hold raises."""
    with pytest.raises(ValueError, match=r"\(H, W\) or \(H, W, 3\)"):
        pviz.write_video(str(tmp_path / "v.mp4"), [np.zeros((4, 4, 4), np.uint8)])
    with pytest.raises(ValueError, match="no frames"):
        pviz.write_video(str(tmp_path / "v.mp4"), [])


@pytest.mark.parametrize("kind", ["rgb_few", "rgb_256", "gray", "gray_full"])
def test_lossless_round_trip(tmp_path, no_mp4, kind):
    frames = _lossless_frames(kind)
    ours, theirs = _write_both(tmp_path, frames)
    for path in (ours, theirs):
        got = _pil_read(path)[0]
        assert len(got) == len(frames)
        for g, f in zip(got, frames):
            np.testing.assert_array_equal(g, _rgb(f))
    decoded = gif.read_gif(ours)[0]
    for g, f in zip(decoded, frames):
        np.testing.assert_array_equal(g, _rgb(f))
    for f in frames:
        np.testing.assert_array_equal(gif.palette_mapping(f), _rgb(f))


def test_pil_misreads_its_own_gray_gif_where_frame0_is_the_ramp(tmp_path, no_mp4):
    """PIL's writer gives a gray frame with every level the table 0..255,
    which PIL's reader keeps as a gray image, and then writes a later
    frame's raw indices into it: the JAX package's file reads back wrong
    there, ``decode_gif`` reads it as PIL does, and the port's file (its
    tables sorted descending, never the ramp) reads back exact."""
    rng = np.random.default_rng(2)
    ramp = np.tile(np.arange(256, dtype=np.uint8), (20, 1))
    frames = [ramp, (rng.integers(0, 5, (20, 256)) * 50).astype(np.uint8), ramp]
    ours, theirs = _write_both(tmp_path, frames)
    pil_theirs = _pil_read(theirs)[0]
    assert not np.array_equal(pil_theirs[1], _rgb(frames[1]))
    for a, b in zip(gif.read_gif(theirs)[0], pil_theirs):
        np.testing.assert_array_equal(a, b)
    for g, f in zip(_pil_read(ours)[0], frames):
        np.testing.assert_array_equal(g, _rgb(f))


@pytest.fixture(scope="module")
def rendered(tmp_path_factory):
    """Frames the port's ``cli.infer`` renders (48x48, coarse+fine, a
    dense field) from a checkpoint of the tests' recipe."""
    import json

    import jax
    import torch

    import nerf_keras_tpu_torch.cli.infer as pinfer
    from nerf_keras_tpu.config import load_config as jax_load_config
    from nerf_keras_tpu.engine.step import init_train_state
    from nerf_keras_tpu.utils.checkpoint import save_checkpoint

    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("rendered")
    cfg = {"BATCH_SIZE": 64, "NS_COARSE": 8, "NS_FINE": 16, "HEIGHT": 48, "WIDTH": 48,
           "L_XYZ": 6, "L_DIR": 3, "NUM_LAYERS": 4, "HIDDEN_DIM": 64, "SKIP_LAYER": 2,
           "EPOCHS": 1, "LEARNING_RATE": 5e-4, "BATCH_NORM": False, "WITH_GCS": False,
           "COMPUTE_DTYPE": "float32"}
    cfg_path = tmp / "tiny.json"
    cfg_path.write_text(json.dumps(cfg))
    jcfg = jax_load_config(str(cfg_path))
    state = jax.device_get(init_train_state(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(0)

    def bump(path, x):
        x = np.asarray(x) + rng.normal(size=x.shape).astype(np.float32) * 0.3
        return x + 1.0 if jax.tree_util.keystr(path).endswith("['sigma']['b']") else x

    state = state._replace(params=jax.tree_util.tree_map_with_path(bump, state.params))
    ckpt = str(tmp / "tiny.ckpt.npz")
    save_checkpoint(ckpt, state, jcfg, scene={"near": 2.0, "far": 6.0, "focal": 60.0})
    captured = {}
    real = pinfer.write_video

    def capture(path, frames, fps=30):
        captured["frames"] = [np.asarray(f) for f in frames]
        return real(path, frames, fps=fps)

    pinfer.write_video = capture
    try:
        pinfer.run_inference(["--config", str(cfg_path), "--checkpoint", ckpt, "--frames",
                              "3", "--chunk", "1024", "--out", str(tmp / "r.mp4"),
                              "--device", "cpu"])
    finally:
        pinfer.write_video = real
    return captured["frames"]


def _lossy_frames(kind, rendered):
    if kind == "smooth":
        return [_smooth(200, 200, p) for p in (0.0, 0.3, 0.6)]
    if kind == "noise":
        rng = np.random.default_rng(3)
        return [rng.integers(0, 256, (120, 160, 3), np.uint8) for _ in range(3)]
    return rendered


@pytest.mark.parametrize("kind", ["smooth", "noise", "rendered"])
def test_psnr_within_slack_of_pils(tmp_path, no_mp4, kind, request):
    frames = _lossy_frames(kind, request.getfixturevalue("rendered") if kind == "rendered"
                           else None)
    assert all(len(np.unique(f.reshape(-1, 3), axis=0)) > 256 for f in frames)
    ours, theirs = _write_both(tmp_path, frames)
    got, want = _pil_read(ours)[0], _pil_read(theirs)[0]
    assert len(got) == len(want) == len(frames)
    for g, w, f in zip(got, want, frames):
        assert _psnr(g, f) >= _psnr(w, f) - SLACK_DB, (_psnr(g, f), _psnr(w, f))
    for d, f in zip(gif.read_gif(ours)[0], frames):
        np.testing.assert_array_equal(d, gif.palette_mapping(f))


def _structure_frames(kind):
    rng = np.random.default_rng(4)
    if kind == "repeat_inside":  # 9 frames, frame 3 repeats frame 2: 8 frames, one of 60 ms
        frames = [(rng.integers(0, 8, (20, 24, 3)) * 30).astype(np.uint8) for _ in range(9)]
        frames[3] = frames[2].copy()
        return frames, 30
    if kind == "repeat_runs":  # repeats at both ends and a run of three
        a, b, c = (_smooth(30, 40, p) for p in (0.0, 0.5, 1.0))
        return [a, a, b, b, b, c, c], 30
    if kind == "all_same":  # one frame of the summed delay
        return [_smooth(30, 40, 0.2)] * 4, 30
    if kind == "gray_fps7":  # 142 ms a frame: 14 cs, reads as 140
        frames = [(rng.integers(0, 60, (18, 22)) * 4).astype(np.uint8) for _ in range(4)]
        frames[2] = frames[1].copy()
        return frames, 7
    if kind == "sub_rectangle":  # a small change: a later frame covers its box
        base = _smooth(32, 48, 0.1)
        moved = base.copy()
        moved[5:9, 30:40] = [255, 0, 0]
        return [base, moved, base], 30
    raise KeyError(kind)


@pytest.mark.parametrize("kind", ["repeat_inside", "repeat_runs", "all_same", "gray_fps7",
                                  "sub_rectangle"])
def test_structure_matches_the_jax_file(tmp_path, no_mp4, kind):
    frames, fps = _structure_frames(kind)
    ours, theirs = _write_both(tmp_path, frames, fps=fps)
    _, d_ours, loop_ours, size_ours = _pil_read(ours)
    _, d_theirs, loop_theirs, size_theirs = _pil_read(theirs)
    assert d_ours == d_theirs and loop_ours == loop_theirs == 0
    assert size_ours == size_theirs == frames[0].shape[1::-1]
    assert len(d_ours) == len(_distinct(frames))
    got, durations, loop = gif.read_gif(ours)
    assert durations == d_ours and loop == 0
    for g, f in zip(got, gif.shown_frames(frames)):
        np.testing.assert_array_equal(g, f)
    if kind == "repeat_inside":
        assert d_ours == [30, 30, 60, 30, 30, 30, 30, 30]


@pytest.mark.parametrize("kind", ["smooth", "noise", "gray", "gray_full", "rgb_few",
                                  "repeat_inside", "all_same", "sub_rectangle"])
def test_decode_gif_equals_pil_on_both_packages_files(tmp_path, no_mp4, kind):
    """The JAX package's files carry what PIL writes: delta frames as
    sub-rectangles with local tables and a transparency index, and a
    single frame interlaced."""
    if kind in ("smooth", "noise"):
        frames = _lossy_frames(kind, None)
    elif kind in ("repeat_inside", "all_same", "sub_rectangle"):
        frames = _structure_frames(kind)[0]
    else:
        frames = _lossless_frames(kind)
    for path in _write_both(tmp_path, frames):
        got, durations, loop = gif.read_gif(path)
        want, d_want, loop_want, size = _pil_read(path)
        assert len(got) == len(want) and durations == d_want and loop == loop_want
        for g, w in zip(got, want):
            assert g.shape == (size[1], size[0], 3)
            np.testing.assert_array_equal(g, w)


# ------------------------------------------------------- hand-built streams


def _interlaced(index):
    order = [y for start, step in ((0, 8), (4, 8), (2, 4), (1, 2))
             for y in range(start, index.shape[0], step)]
    return index[order]


def _padded(table):
    bits = max(1, (len(table) // 3 - 1).bit_length())
    return bits, table + bytes(3 * (1 << bits) - len(table))


def build_gif(size, global_table, frames, background=0, loop=0, trailer=True):
    """A GIF from parts: each frame a dict of ``index`` (2-D) and optional
    ``at``, ``table``, ``t``, ``disposal``, ``delay`` (cs), ``interlace``,
    ``mcs``, ``data`` (image data in place of the LZW of ``index``)."""
    w, h = size
    out = [b"GIF89a"]
    flags = 0
    if global_table is not None:
        bits, global_table = _padded(global_table)
        flags = 0x80 | (bits - 1)
    out.append(struct.pack("<HHBBB", w, h, flags, background, 0))
    if global_table is not None:
        out.append(global_table)
    if loop is not None:
        out.append(b"!\xff\x0bNETSCAPE2.0" + struct.pack("<BBHB", 3, 1, loop, 0))
    for f in frames:
        index = np.asarray(f["index"], np.uint8)
        fh, fw = index.shape
        x0, y0 = f.get("at", (0, 0))
        t, disposal = f.get("t"), f.get("disposal", 0)
        if "delay" in f or t is not None or disposal:
            out.append(b"!\xf9\x04" + struct.pack("<BHBB", (disposal << 2) | (t is not None),
                                                  f.get("delay", 0), t or 0, 0))
        lflags, table = 0, f.get("table")
        if table is not None:
            bits, table = _padded(table)
            lflags = 0x80 | (bits - 1)
        if f.get("interlace"):
            lflags |= 0x40
            index = _interlaced(index)
        out.append(b"," + struct.pack("<HHHHB", x0, y0, fw, fh, lflags))
        if table is not None:
            out.append(table)
        mcs = f.get("mcs", 8)
        out.append(bytes([mcs]) + f.get("data", gif.lzw_blocks(index, mcs)))
    if trailer:
        out.append(b";")
    return b"".join(out)


def _hand_built(kind):
    rng = np.random.default_rng(5)

    def table(n):
        return rng.integers(0, 256, (n, 3), np.uint8).tobytes()

    def index(h, w, n):
        return rng.integers(0, n, (h, w))

    g16 = table(16)
    ramp = bytes(np.repeat(np.arange(256, dtype=np.uint8), 3))
    return {
        "disposal2_transparent": build_gif((20, 18), g16, [
            dict(index=index(18, 20, 16), delay=3),
            dict(index=index(8, 9, 8), at=(3, 4), table=table(8), t=2, disposal=2, delay=3),
            dict(index=index(5, 5, 8), at=(10, 10), table=table(8), delay=3),
            dict(index=index(5, 5, 8), at=(1, 10), table=table(8), t=7, delay=4)]),
        "disposal2_background": build_gif((20, 18), g16, [
            dict(index=index(18, 20, 16), delay=3, disposal=2),
            dict(index=index(8, 9, 8), at=(3, 4), table=table(8), disposal=2, delay=3),
            dict(index=index(5, 5, 8), at=(10, 10), table=table(8), delay=3)], background=5),
        "frame0_transparent": build_gif((20, 18), g16, [
            dict(index=index(10, 12, 16), at=(2, 3), t=4, disposal=2),
            dict(index=index(8, 9, 8), at=(3, 4), table=table(8), t=1, disposal=1),
            dict(index=index(5, 5, 8), at=(10, 10))]),
        "past_the_table": build_gif((20, 18), g16[:12], [
            dict(index=index(18, 20, 200)),
            dict(index=index(8, 9, 256), at=(3, 4), table=table(3), t=250, disposal=2),
            dict(index=index(8, 9, 256), at=(3, 4), table=table(3))]),
        "interlaced": build_gif((21, 37), g16, [
            dict(index=index(37, 21, 16), interlace=True),
            dict(index=index(19, 9, 8), at=(3, 4), table=table(8), interlace=True)]),
        "small_code_size": build_gif((20, 18), g16[:12], [
            dict(index=index(18, 20, 4), mcs=2),
            dict(index=index(3, 3, 4), mcs=3, table=table(4))], loop=None),
        "gray_ramp_then_tables": build_gif((20, 18), ramp, [
            dict(index=index(18, 20, 256)),
            dict(index=index(8, 9, 8), at=(3, 4), table=table(8), t=2, disposal=2),
            dict(index=index(5, 5, 8), at=(10, 10), table=table(8), t=3),
            dict(index=index(5, 5, 8), at=(0, 0), table=table(8))]),
        "gray_ramp_local": build_gif((20, 18), None, [
            dict(index=index(18, 20, 16), table=ramp[:48]),
            dict(index=index(8, 9, 8), at=(3, 4), table=table(8), disposal=2),
            dict(index=index(4, 4, 8), at=(1, 1), table=table(8), t=0)], background=3),
    }[kind]


@pytest.mark.parametrize("kind", ["disposal2_transparent", "disposal2_background",
                                  "frame0_transparent", "past_the_table", "interlaced",
                                  "small_code_size", "gray_ramp_then_tables",
                                  "gray_ramp_local"])
def test_decode_gif_equals_pil_on_hand_built_streams(kind):
    data = _hand_built(kind)
    got, durations, loop = gif.decode_gif(data)
    want, d_want, loop_want, _ = _pil_read(_io.BytesIO(data))
    assert len(got) == len(want) and durations == d_want and loop == loop_want
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _refused(kind):
    rng = np.random.default_rng(6)
    g16 = rng.integers(0, 256, (16, 3), np.uint8).tobytes()
    first = dict(index=rng.integers(0, 16, (18, 20)))
    good = build_gif((20, 18), g16, [first, dict(index=rng.integers(0, 16, (12, 12)))])
    if kind == "disposal_3":
        return build_gif((20, 18), g16, [first, dict(index=first["index"][:4, :4],
                                                     disposal=3)]), \
            r"graphic control extension of frame 1 .*disposal method 3"
    if kind == "code_past_the_table":
        # 9-bit codes: clear (256), then 300 with 258 the next free entry.
        bits = 256 | (300 << 9)
        data = bytes([3, bits & 255, (bits >> 8) & 255, bits >> 16, 0])
        return build_gif((20, 18), g16, [first, dict(index=np.zeros((4, 4)), data=data)]), \
            r"frame 1 .*image data: LZW code 300 is past the table \(258 entries\)"
    if kind == "no_colour_table":
        return build_gif((20, 18), None, [first]), r"frame 0 .*no colour table"
    if kind == "truncated_image":
        return good[:len(good) - 20], r"frame 1 .*truncated"
    if kind == "no_trailer":
        return good[:-1], r"byte \d+: the file ends before its trailer \(truncated\)"
    if kind == "outside_the_screen":
        return build_gif((20, 18), g16, [first, dict(index=np.zeros((4, 4)), at=(18, 0))]), \
            r"frame 1 .*outside the 20x18 screen"
    if kind == "end_code_early":
        bits = 256 | (257 << 9)  # clear, then the end code, 9 bits each
        data = bytes([3, bits & 255, (bits >> 8) & 255, bits >> 16, 0])
        return build_gif((20, 18), g16, [first, dict(index=np.zeros((4, 4)), data=data)]), \
            r"frame 1 .*end code comes before the image's last pixel"
    raise KeyError(kind)


@pytest.mark.parametrize("kind", ["disposal_3", "code_past_the_table", "no_colour_table",
                                  "truncated_image", "no_trailer", "outside_the_screen",
                                  "end_code_early"])
def test_decode_gif_refuses_by_name(kind):
    data, message = _refused(kind)
    with pytest.raises(ValueError, match=r"^clip\.gif: " + message):
        gif.decode_gif(data, name="clip.gif")


def test_read_gif_names_the_file(tmp_path):
    path = tmp_path / "broken.gif"
    path.write_bytes(_refused("disposal_3")[0])
    with pytest.raises(ValueError, match=f"^{re.escape(str(path))}: graphic control "
                                         f"extension of frame 1"):
        gif.read_gif(str(path))


@pytest.mark.parametrize("kind", ["smooth", "noise", "gray"])
def test_same_frames_same_bytes(kind):
    frames = _lossless_frames(kind) if kind == "gray" else _lossy_frames(kind, None)
    first = gif.encode_gif(frames, 33)
    assert gif.encode_gif([f.copy() for f in frames], 33) == first
    assert first[:6] == b"GIF89a" and first[-1:] == b";"


def test_lzw_round_trip_across_table_resets():
    """Enough codes to fill the 12-bit table many times, at each code size."""
    rng = np.random.default_rng(7)
    for mcs in (2, 5, 8):
        n = 1 << mcs
        table = np.stack([np.arange(n), np.full(n, 7), np.full(n, 9)], -1).astype(np.uint8)
        index = rng.integers(0, n, (300, 257)).astype(np.uint8)
        index[:40] = index[0, 0]  # a long run: codes grow to 12 bits early
        data = build_gif((257, 300), table.tobytes(), [dict(index=index, mcs=mcs)],
                         loop=None)
        got = gif.decode_gif(data)[0][0]
        np.testing.assert_array_equal(got, table[index])
        want = _pil_read(_io.BytesIO(data))[0][0]
        np.testing.assert_array_equal(got, want)
