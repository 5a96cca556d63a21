"""Command-line entry points of the port: ``python -m
nerf_keras_tpu_torch.cli.train_synthetic`` (and ``train_lego``,
``train_blender``) over the shared loop in ``cli/train.py``."""
