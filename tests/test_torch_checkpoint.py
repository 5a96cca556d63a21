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
    # The port's config is its own copy of the class: compare the fields.
    assert (dataclasses.asdict(jckpt.load_checkpoint_config(out))
            == dataclasses.asdict(ckpt.load_checkpoint_config(out))
            == dataclasses.asdict(CFG))
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
    """Render modes this test once held as refused render now, from the
    checkpoint's sidecar: a JAX-written union-free proposal checkpoint (the
    ``proposal`` case) gives the JAX ``Trainer``'s frame, and an NDC
    checkpoint renders in NDC space."""
    from nerf_keras_tpu_torch.engine.trainer import Trainer

    path, state = jax_file
    if value == "proposal":
        _union_free_checkpoint_renders(tmp_path)
        return
    cfg = dataclasses.replace(CFG, **{field: value}).validate()
    out = str(tmp_path / "x.ckpt.npz")
    ckpt.save_params_npz(out, jax.tree_util.tree_map(np.asarray, state.params), cfg)
    # NDC checkpoints render: the sidecar's NDC wins over the user config,
    # as in the JAX package, and the Trainer takes NDC rays.

    ours, notes = ckpt.resolve_infer_config(CFG, out)
    assert (ours, notes) == jckpt.resolve_infer_config(CFG, out)
    assert ours.ndc
    pose = np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 1.5]], np.float32)
    pt = Trainer(ours, 0.0, 1.0, device="cpu").restore(out)
    jt = JaxTrainer(ours, 0.0, 1.0)  # the rays depend on no weights
    for a, b in zip(pt.pose_rays(pose, 8, 8, 9.0), jt.pose_rays(pose, 8, 8, 9.0)):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-6)
    assert np.isfinite(pt.render_image(pose, 8, 8, 9.0)["rgb"]).all()


def _union_free_checkpoint_renders(tmp_path):
    """A ``PROP_UNION=false`` state the JAX package trained one step and
    saved: the sidecar turns the user's coarse config into the union-free
    proposal one (as the JAX ``resolve_infer_config`` does), and the port's
    frame of its EMA weights matches the JAX ``Trainer``'s to the fine
    pass's rgb tolerance, 5e-3 (bf16 MLPs; the placed samples follow the
    proposal weights, as in tests/test_torch_render.py)."""
    from nerf_keras_tpu_torch.engine.trainer import Trainer

    cfg = dataclasses.replace(CFG, train_sampler="proposal", prop_union=False,
                              prop_explore=0.1, ns_fine=8).validate()
    jt = JaxTrainer(cfg, 2.0, 6.0)
    rng = np.random.default_rng(1)
    o = np.tile(np.float32([0, 0, 4.0]), (24, 1))
    d = (rng.normal(size=(24, 3)) * 0.2 - np.float32([0, 0, 1])).astype(np.float32)
    jt.train_step((rng.uniform(0, 1, (CFG.batch_size, 3)).astype(np.float32),
                   np.tile(o[:1], (CFG.batch_size, 1)),
                   np.resize(d, (CFG.batch_size, 3))))
    out = str(tmp_path / "u.ckpt.npz")
    jckpt.save_checkpoint(out, jax.device_get(jt.state), cfg)
    ours, notes = ckpt.resolve_infer_config(CFG, out)
    assert (ours, notes) == jckpt.resolve_infer_config(CFG, out)
    assert ours.train_sampler == "proposal" and not ours.prop_union
    pt = Trainer(ours, 2.0, 6.0, device="cpu").restore(out)
    want = JaxTrainer(ours, 2.0, 6.0).restore(out).render_rays(o, d)
    got = pt.render_rays(o, d)
    assert sorted(got) == sorted(want) == ["depth_fine", "rgb_fine"]
    np.testing.assert_allclose(got["rgb_fine"], want["rgb_fine"], atol=5e-3, rtol=0)
    assert np.isfinite(got["depth_fine"]).all()


def test_freq_anneal_window_must_be_identity(jax_file, tmp_path):
    """A checkpoint inside its frequency-anneal window renders, with the
    window at its step folded into the weights (the JAX Trainer's render of
    the same file); past the horizon the window is the identity."""
    from nerf_keras_tpu_torch.engine.trainer import Trainer

    _, state = jax_file
    cfg = dataclasses.replace(CFG, freq_anneal_steps=100).validate()
    rng = np.random.default_rng(0)
    o = np.tile(np.float32([0, 0, 4.0]), (32, 1))
    d = rng.normal(size=(32, 3)).astype(np.float32) * 0.2 - np.float32([0, 0, 1])
    frames = []
    for step in (30, 100):
        out = str(tmp_path / f"s{step}.ckpt.npz")
        jckpt.save_checkpoint(out, state._replace(step=np.int32(step)), cfg)
        pt = Trainer(cfg, 2.0, 6.0, device="cpu").restore(out)
        jt = JaxTrainer(cfg, 2.0, 6.0).restore(out)
        got = pt.render_rays(o, d, keys=("rgb_fine",))["rgb_fine"]
        want = jt.render_rays(o, d, keys=("rgb_fine",))["rgb_fine"]
        # bf16 MLPs: the fine samples follow the coarse weights (as in
        # tests/test_torch_render.py).
        np.testing.assert_allclose(got, want, atol=5e-3, rtol=0)
        frames.append(got)
    assert np.abs(frames[0] - frames[1]).max() > 2e-2  # the window at step 30 matters


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
