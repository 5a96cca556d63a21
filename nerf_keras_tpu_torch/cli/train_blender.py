"""Train on a Blender ``nerf_synthetic`` scene (transforms json + PNGs).

    python -m nerf_keras_tpu_torch.cli.train_blender \
        --config config/lego_batch_h256_tpu.json --data-dir /data/nerf_synthetic/lego \
        --run-dir runs/lego

The counterpart of the root ``train_blender.py`` (default config
``config/lego_batch_h256_tpu.json``, eval every 5 epochs): ``--data-dir``
is the scene directory, or a dataset root with ``--scene`` (default
``lego``); the background follows the config's ``WHITE_BKGD``.
"""

from nerf_keras_tpu_torch.cli.train import run_training
from nerf_keras_tpu_torch.data.blender import prepare_blender_data


def prepare(height, width, data_dir=None, config=None, scene="lego"):
    return prepare_blender_data(
        height, width, path=data_dir, scene=scene,
        white_bkgd=bool(config.white_bkgd) if config is not None else True,
    )


def main(argv=None):
    return run_training(prepare, "config/lego_batch_h256_tpu.json", default_eval_every=5,
                        argv=argv)


if __name__ == "__main__":
    main()
