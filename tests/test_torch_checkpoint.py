"""The port's numpy checkpoint IO against the JAX package's files."""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from nerf_keras_tpu.config import NeRFConfig
from nerf_keras_tpu.engine.trainer import Trainer as JaxTrainer
from nerf_keras_tpu.utils import checkpoint as jckpt
from nerf_keras_tpu_torch.utils import checkpoint as ckpt

# Tier-1 runs several pytest workers on a few cores.  With torch's
# default pool (one OpenMP thread per core) a JAX training test in a
# sibling worker aborted; one thread is plenty at these sizes.
torch.set_num_threads(1)

CFG = NeRFConfig(
    batch_size=64, ns_coarse=4, ns_fine=4, num_layers=6, hidden_dim=16,
    skip_layer=4, height=8, width=8, ema_decay=0.5,
).validate()


@pytest.fixture(scope="module")
def jax_file(tmp_path_factory):
    jt = JaxTrainer(CFG, 2.0, 6.0)
    path = str(tmp_path_factory.mktemp("ck") / "m.ckpt.npz")
    state = jax.device_get(jt.state)
    jckpt.save_checkpoint(path, state, CFG,
                          scene={"near": 2.5, "far": 5.5, "focal": 11.0})
    return path, state


def test_load_reads_the_jax_trees_exactly(jax_file):
    path, state = jax_file
    got = ckpt.load_checkpoint(path)
    assert got["step"] == int(state.step)
    for name, tree in (("params", state.params), ("ema", state.ema)):
        ref = jax.tree_util.tree_leaves_with_path(tree)
        out = jax.tree_util.tree_leaves_with_path(got[name])
        assert [p for p, _ in ref] == [p for p, _ in out]
        for (_, a), (_, b) in zip(ref, out):
            np.testing.assert_array_equal(np.asarray(a), b)


def test_save_writes_the_jax_key_format(jax_file, tmp_path):
    """save_params_npz keys are the JAX keystr paths of the same trees,
    and the sidecar round-trips through both packages' readers."""
    path, state = jax_file
    out = str(tmp_path / "port.ckpt.npz")
    params = jax.tree_util.tree_map(np.asarray, state.params)
    ema = jax.tree_util.tree_map(np.asarray, state.ema)
    ckpt.save_params_npz(out, params, CFG, scene={"near": 2.5, "far": 5.5},
                         step=7, ema=ema)
    ours = np.load(out)
    theirs = np.load(path)
    expected = {k for k in theirs.files if k.startswith((".params", ".ema"))}
    assert set(ours.files) == expected | {".step"}
    for k in expected:
        np.testing.assert_array_equal(ours[k], theirs[k])
    assert ckpt.load_checkpoint(out)["step"] == 7
    assert jckpt.load_checkpoint_config(out) == ckpt.load_checkpoint_config(out) == CFG
    assert ckpt.load_checkpoint_scene(out) == jckpt.load_checkpoint_scene(out)
    assert ckpt.load_checkpoint_scene(out) == {"near": 2.5, "far": 5.5}


def test_resolve_infer_config_matches_jax(jax_file):
    path, _ = jax_file
    user = NeRFConfig(batch_size=64, ns_coarse=4, ns_fine=4, num_layers=6,
                      hidden_dim=16, skip_layer=4, height=8, width=8,
                      white_bkgd=True, lr_final=1e-5).validate()
    ours = ckpt.resolve_infer_config(user, path)
    theirs = jckpt.resolve_infer_config(user, path)
    assert ours == theirs
    assert ours[0].ema_decay == 0.5 and ours[0].white_bkgd is False


@pytest.mark.parametrize("field,value", [
    ("train_sampler", "proposal"), ("ndc", True),
])
def test_unported_render_modes_raise(jax_file, tmp_path, field, value):
    path, state = jax_file
    cfg = dataclasses.replace(CFG, **{field: value}).validate()
    out = str(tmp_path / "x.ckpt.npz")
    ckpt.save_params_npz(out, jax.tree_util.tree_map(np.asarray, state.params), cfg)
    with pytest.raises(NotImplementedError, match="not ported"):
        ckpt.resolve_infer_config(CFG, out)


def test_freq_anneal_window_must_be_identity():
    cfg = dataclasses.replace(CFG, freq_anneal_steps=100).validate()
    ckpt.check_render_support(cfg, step=100)  # past the horizon: identity
    ckpt.check_render_support(dataclasses.replace(cfg, freq_anneal_steps=0), step=3)
    with pytest.raises(NotImplementedError, match="frequency-anneal"):
        ckpt.check_render_support(cfg, step=99)


def test_resolve_checkpoint_prefers_best(tmp_path):
    for name in ("nerf_ep2.ckpt.npz", "nerf_ep10.ckpt.npz", "best.nerf_ep5.ckpt.npz"):
        (tmp_path / name).write_bytes(b"")
    d = str(tmp_path)
    assert ckpt.latest_checkpoint(d) == jckpt.latest_checkpoint(d)
    assert ckpt.latest_checkpoint(d).endswith("nerf_ep10.ckpt.npz")
    assert ckpt.best_checkpoint(d) == jckpt.best_checkpoint(d)
    assert ckpt.resolve_checkpoint(d) == os.path.join(d, "best.nerf_ep5.ckpt.npz")
    assert ckpt.resolve_checkpoint(str(tmp_path / "missing")) is None


def test_bad_keys_raise():
    with pytest.raises(ValueError, match="unparseable"):
        ckpt._parse_key(".params['fine'](0)")
    assert ckpt._parse_key(".params['fine']['trunk'][3]['w']") == [
        "params", "fine", "trunk", 3, "w"]
