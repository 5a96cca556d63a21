"""A restored port trainer carries on Adam as the JAX package's does.

The JAX trainer's checkpoints hold optax's Adam state at ``.opt_state[0]``
(count, mu, nu), and its learning-rate decay reads Adam's own count, so a
resumed ``LR_FINAL`` run continues its decay.  The JAX step trains N steps
from its init and saves; the port restores that file and takes step N+1
on the same batch with the JAX step's draws replayed (key schedule as in
``tests/test_torch_train.py``).

Tolerance: float32 on both sides; the gradients agree to ~5e-4 of a
leaf's scale (``test_torch_train.py``), so after N steps Adam's update
``lr * mu_hat / (sqrt(nu_hat) + eps)`` agrees to 2% of lr wherever the
first moment is resolved (above 1e-2 of its leaf's largest entry).  A
restarted Adam steps by lr * sign(g) at the schedule's start instead,
about 20% of lr away.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from nerf_keras_tpu.config import NeRFConfig
from nerf_keras_tpu.engine import step as jstep
from nerf_keras_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from nerf_keras_tpu_torch.engine.trainer import Trainer
from nerf_keras_tpu_torch.utils.checkpoint import load_checkpoint, save_params_npz

torch.set_num_threads(1)

NEAR, FAR = 2.0, 6.0
LR = 5e-3
STEPS = 3


def _cfg(**kw):
    base = dict(
        batch_size=20, ns_coarse=8, ns_fine=12, num_layers=4, hidden_dim=32,
        skip_layer=2, l_xyz=4, l_dir=2, compute_dtype="float32", use_pallas=False,
        train_sampler="proposal", distortion_loss_mult=1e-4, prop_anneal_steps=10,
        prop_explore=0.03, ema_decay=0.9, learning_rate=LR, lr_final=1e-4,
        lr_decay_steps=50, height=8, width=8,
    )
    base.update(kw)
    return NeRFConfig(**base).validate()


def _batch(seed, b):
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 1, (b, 3)).astype(np.float32)
    dirs = rng.normal(size=(b, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    origins = (np.tile([0, 0, 4.0], (b, 1)) + rng.normal(size=(b, 3)) * 0.1).astype(np.float32)
    return images, origins, dirs


def _draws(cfg, key, step, b):
    """The uniforms the JAX proposal step draws at ``step`` (one chain level)."""
    key_t, key_pdf = jax.random.split(jax.random.fold_in(key, step))
    _, sub = jax.random.split(key_pdf)
    chain = [torch.as_tensor(np.array(jax.random.uniform(sub, (b, cfg.ns_fine),
                                                         dtype=jnp.float32)))]
    t = torch.as_tensor(np.array(jax.random.uniform(key_t, (b, cfg.ns_coarse))))
    return {"t": t, "chain": chain}


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def test_restore_resumes_adam_and_the_lr_decay(tmp_path):
    cfg = _cfg()
    key = jax.random.PRNGKey(7)
    batch = _batch(1, cfg.batch_size)
    jbatch = tuple(jnp.asarray(x) for x in batch)
    train = jstep.make_train_step(cfg, NEAR, FAR)
    st = jstep.init_train_state(jax.random.PRNGKey(0), cfg)
    for _ in range(STEPS):
        st, _ = train(st, jbatch, key)
    path = str(tmp_path / "jax.ckpt.npz")
    jax_save_checkpoint(path, st, cfg)
    st_next, _ = train(st, jbatch, key)

    tr = Trainer(cfg, NEAR, FAR, device="cpu").restore(path)
    assert tr.step == STEPS and tr.state.opt.count == STEPS
    # The moments as restored, written back by the port: JAX's, exactly.
    again = str(tmp_path / "port.ckpt.npz")
    tr.save(again)
    back = load_checkpoint(again)["opt_state"]
    assert back["count"] == STEPS
    for name in ("mu", "nu"):
        for a, c in zip(_leaves(getattr(st.opt_state[0], name)), _leaves(back[name])):
            np.testing.assert_array_equal(c, a)

    tr.train_step(batch, draws=_draws(cfg, key, STEPS, cfg.batch_size))
    assert tr.step == STEPS + 1 and tr.state.opt.count == STEPS + 1
    mu = _leaves(st_next.opt_state[0].mu)
    for a, c, m in zip(_leaves(st_next.params), _leaves(tr.params_tree()), mu):
        resolved = np.abs(m) > 1e-2 * np.abs(m).max()
        np.testing.assert_allclose(c[resolved], a[resolved], atol=0.02 * LR, rtol=0)


def test_checkpoint_without_adam_state_restores_fresh_adam(tmp_path):
    """A params-only checkpoint (no ``.opt_state``) still restores: Adam
    starts from zero moments at count 0, as a new trainer's."""
    cfg = _cfg()
    src = Trainer(cfg, NEAR, FAR, device="cpu")
    src.train_step(_batch(2, cfg.batch_size))
    path = str(tmp_path / "params.ckpt.npz")
    save_params_npz(path, src.params_tree(), cfg, step=1)
    assert load_checkpoint(path)["opt_state"] is None
    tr = Trainer(cfg, NEAR, FAR, device="cpu").restore(path)
    assert tr.step == 1 and tr.state.opt.count == 0
    assert all(float(v.abs().max()) == 0.0 for v in tr.state.opt.mu + tr.state.opt.nu)
    for a, c in zip(_leaves(src.params_tree()), _leaves(tr.params_tree())):
        np.testing.assert_array_equal(c, a)


def test_replace_params_keeps_adam():
    """New weights keep Adam's count and moments, as the JAX
    ``Trainer.replace_params`` keeps ``opt_state``."""
    cfg = _cfg()
    tr = Trainer(cfg, NEAR, FAR, device="cpu")
    tr.train_step(_batch(3, cfg.batch_size))
    mu = [v.clone() for v in tr.state.opt.mu]
    opt = tr.state.opt
    tr.replace_params(tr.params_tree())
    assert tr.state.opt is opt and opt.count == 1
    assert all(torch.equal(a, b) for a, b in zip(mu, opt.mu))
