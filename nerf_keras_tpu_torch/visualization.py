"""Encode the per-epoch training panels into a progress video.

    python -m nerf_keras_tpu_torch.visualization --config <cfg> \
        [--image-dir DIR] [--out PATH]

Counterpart of the root ``visualization.py`` (the reference's
visualization.py:22-37), with its flags and defaults: the PNG panels of
``--image-dir`` (``images/models/<config name>-best``) in name order, to
``--out`` (``<config name>_training.mp4``), an mp4 where imageio with
ffmpeg imports and else the GIF ``<out stem>.gif`` (``utils/viz.
write_video``).  The port's train CLI writes its panels into ``<run
dir>/images`` (or ``images/models/<config name>-<stamp>`` without
``--run-dir``): pass that directory as ``--image-dir``.  Runs on the host
and touches no device.
"""

from __future__ import annotations

import argparse

from nerf_keras_tpu_torch.config import config_name
from nerf_keras_tpu_torch.utils.viz import frames_to_video


def main(argv: list[str] | None = None) -> str:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", type=str, default="config/lego_batch_h256.json")
    p.add_argument("--image-dir", type=str, default=None,
                   help="panel directory (default: images/models/<config>-best)")
    p.add_argument("--out", type=str, default=None)
    args = p.parse_args(argv)

    name = config_name(args.config)
    image_dir = args.image_dir or f"images/models/{name}-best"
    out = args.out or f"{name}_training.mp4"
    written = frames_to_video(image_dir, out, fps=30)
    print(f"video saved to {written}")
    return written


if __name__ == "__main__":
    main()
