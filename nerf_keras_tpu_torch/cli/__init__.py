"""Command-line entry points of the port: ``python -m
nerf_keras_tpu_torch.cli.train_synthetic`` (and ``train_lego``,
``train_blender``, ``train_fern``) over the shared loop in ``cli/train.py``;
``cli.evaluate`` scores a checkpoint on a dataset split and ``cli.infer``
renders a camera path from one to a video."""
