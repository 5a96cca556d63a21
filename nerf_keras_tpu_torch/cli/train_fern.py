"""Train on an LLFF forward-facing capture (Fern).

    python -m nerf_keras_tpu_torch.cli.train_fern --data-dir <capture> \
        [--config config/fern_batch_h256_tpu.json --run-dir <dir>]

The counterpart of the root ``train_fern.py`` (default config
``config/fern_batch_debug.json``, eval every epoch).  The capture is read
by ``data/llff.prepare_fern_data`` (``--data-dir``, else
``$NERF_LLFF_DIR``): ``poses_bounds.npy`` and PNG frames in
``images_8/``.  ``NDC: true`` configs train on NDC rays with bounds
[0, 1].  ``fern_batch_h256_tpu.json`` sets ``WITH_GCS``, so it needs
``--run-dir``.
"""

from nerf_keras_tpu_torch.cli.train import run_training
from nerf_keras_tpu_torch.data.llff import prepare_fern_data


def prepare(height, width, data_dir=None):
    return prepare_fern_data(height, width, basedir=data_dir)


def main(argv=None):
    return run_training(prepare, "config/fern_batch_debug.json", default_eval_every=1,
                        argv=argv)


if __name__ == "__main__":
    main()
