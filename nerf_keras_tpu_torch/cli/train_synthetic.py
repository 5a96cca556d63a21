"""Train on the procedural synthetic scene (no dataset files needed).

    python -m nerf_keras_tpu_torch.cli.train_synthetic \
        --config config/lego_batch_h256_tpu.json --run-dir runs/synth

The counterpart of the root ``train_synthetic.py``: the same default
config (``config/lego_batch_debug.json``), eval cadence and flags
(``--scene sphere|spheres``, ``--views N``); ``--device cpu`` for the CPU.
"""

from nerf_keras_tpu_torch.cli.train import run_training
from nerf_keras_tpu_torch.data.synthetic import prepare_synthetic_data


def prepare(height, width, data_dir=None, scene="sphere", num_views=12):
    return prepare_synthetic_data(height, width, scene=scene, num_views=num_views)


def main(argv=None):
    return run_training(prepare, "config/lego_batch_debug.json", default_eval_every=5,
                        argv=argv)


if __name__ == "__main__":
    main()
