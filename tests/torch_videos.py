"""The frames the port's ``cli.infer`` hands to ``write_video``, shared by
the CPU tests that read a run's video: each test takes the frames as they
were rendered, and checks that the file written holds them (the mp4 where
imageio has ffmpeg, else the port's GIF, which decodes to the writer's own
palette mapping of each frame)."""

import numpy as np

from nerf_keras_tpu_torch.utils.gif import read_gif, shown_frames


def capture_videos(monkeypatch) -> dict:
    """Wrap ``cli.infer``'s ``write_video``: the returned dict fills with
    ``{path written: [uint8 frames]}`` as runs write."""
    import nerf_keras_tpu_torch.cli.infer as pinfer

    handed = {}
    write = pinfer.write_video

    def capture(path, frames, fps=30):
        written = write(path, frames, fps=fps)
        handed[written] = [np.asarray(f) for f in frames]
        return written

    monkeypatch.setattr(pinfer, "write_video", capture)
    return handed


def video_frames(handed: dict, written: str, n: int) -> list[np.ndarray]:
    """The ``n`` frames a run handed over for the file it wrote, after
    checking that the file holds them."""
    frames = handed[written]
    assert len(frames) == n
    if written.endswith(".mp4"):
        import imageio.v2 as imageio

        assert len(imageio.mimread(written)) == n
        return frames
    assert written.endswith(".gif"), written
    got, durations, loop = read_gif(written)
    want = shown_frames(frames)
    assert len(got) == len(want) and loop == 0 and all(d >= 30 for d in durations)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    return frames
