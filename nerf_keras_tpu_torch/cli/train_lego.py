"""Train on the tiny-Lego npz (``tiny_nerf_data.npz``).

    python -m nerf_keras_tpu_torch.cli.train_lego --data-dir data/tiny_nerf_data.npz

The counterpart of the root ``train_lego.py`` (default config
``config/lego_batch_debug.json``, eval every epoch).  The file must be
present: the port never downloads it (``data/lego.find_lego_npz``).
"""

from nerf_keras_tpu_torch.cli.train import run_training
from nerf_keras_tpu_torch.data.lego import prepare_lego_data


def prepare(height, width, data_dir=None):
    return prepare_lego_data(height, width, path=data_dir)


def main(argv=None):
    return run_training(prepare, "config/lego_batch_debug.json", default_eval_every=1,
                        argv=argv)


if __name__ == "__main__":
    main()
