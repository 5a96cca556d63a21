"""A forward-facing capture and a ``cli.train_fern`` run on it, shared by
the CPU tests of the evaluation and inference CLIs (``--data llff``,
``--path spiral``): trained once per test process for each ray space and
removed when the process exits.  Tests read the run and write their
outputs elsewhere."""

import atexit
import functools
import json
import os
import shutil
import tempfile

# 5 views at 12x16 (4 train, 1 holdout), 2 epochs of 12 steps.
CONFIG = {"BATCH_SIZE": 64, "NS_COARSE": 8, "NS_FINE": 16, "HEIGHT": 12, "WIDTH": 16,
          "L_XYZ": 4, "L_DIR": 2, "NUM_LAYERS": 4, "HIDDEN_DIM": 16, "SKIP_LAYER": 2,
          "EPOCHS": 2, "LEARNING_RATE": 5e-3, "BATCH_NORM": False, "WITH_GCS": False,
          "COMPUTE_DTYPE": "float32", "USE_PALLAS": False}
# NDC with a 40-step anneal: the window is still open at the checkpoint.
NDC = {"NDC": True, "FREQ_ANNEAL_STEPS": 40}


@functools.lru_cache(maxsize=None)
def fern_run(ndc: bool) -> tuple[str, str, str]:
    """``(capture dir, config path, run dir)`` of a world-space or NDC run."""
    from nerf_keras_tpu_torch.cli import train_fern
    from nerf_keras_tpu_torch.data.synthetic import write_forward_facing_capture

    root = tempfile.mkdtemp(prefix="fern_run_")
    atexit.register(shutil.rmtree, root, True)
    capture = write_forward_facing_capture(os.path.join(root, "cap"), 5, 12, 16, 15.0)
    cfg_path = os.path.join(root, "fern.json")
    with open(cfg_path, "w") as f:
        json.dump({**CONFIG, **(NDC if ndc else {})}, f)
    run = os.path.join(root, "run")
    train_fern.main(["--config", cfg_path, "--data-dir", capture, "--run-dir", run,
                     "--device", "cpu"])
    return capture, cfg_path, run
