"""NeRFMLP against the JAX ``apply_nerf_mlp`` on the same weights.

Tiny width (hidden 32, 6 layers, skip 4, so the skip concat runs).  The
params pytree crosses bit-exactly both ways.  Forward tolerance: atol
1e-5 in float32 (sums of 32-300 products in another order); 3e-2 in
bf16, where the two frameworks' f32 accumulation orders can flip the
bf16 rounding of a hidden activation (relative 4e-3) and the flips
compound over the layers.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_keras_tpu.config import NeRFConfig
from nerf_keras_tpu.models import mlp as jmlp
from nerf_keras_tpu_torch.models import mlp as tmlp
from nerf_keras_tpu_torch.models.mlp import NeRFMLP

# Tier-1 runs several pytest workers on a few cores.  With torch's
# default pool (one OpenMP thread per core) a JAX training test in a
# sibling worker aborted; one thread is plenty at these sizes.
torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
ARCH = dict(num_layers=6, hidden_dim=32, skip_layer=4, l_xyz=10, l_dir=4)


def _jax_params(seed=0, **arch):
    arch = {**ARCH, **arch}
    params = jmlp.init_nerf_params(jax.random.PRNGKey(seed), **arch)
    # non-zero biases so the bias path is exercised too
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + (rng.normal(size=x.shape).astype(np.float32) * 0.1
                                   if x.ndim == 1 else 0.0),
        params,
    )


def _inputs(seed, n=32, l_xyz=10, l_dir=4):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 3 + 6 * l_xyz)).astype(np.float32)
    d = rng.normal(size=(n, 3 + 6 * l_dir)).astype(np.float32)
    return x, d


@pytest.mark.parametrize(
    "num_layers,skip_layer", [(6, 4), (5, 4), (8, 4), (3, 1), (4, 2)]
)
def test_layer_widths_match(num_layers, skip_layer):
    """Trunk/head widths follow the JAX rules, including a skip on the
    last layer (5 layers, skip 4) that widens the heads."""
    args = (num_layers, 32, skip_layer, 63)
    assert tmlp.trunk_input_dims(*args) == jmlp.trunk_input_dims(*args)
    assert tmlp.head_input_dim(*args) == jmlp.head_input_dim(*args)


@pytest.mark.parametrize("num_layers", [6, 5])
def test_jax_params_round_trip_bit_exact(num_layers):
    params = _jax_params(num_layers=num_layers)
    mlp = NeRFMLP.from_jax_params(params, skip_layer=4)
    back = mlp.to_jax_params()
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize(
    "dtype,atol", [("float32", 1e-5), ("bfloat16", 3e-2)]
)
@pytest.mark.parametrize("num_layers", [6, 5])
def test_forward_matches_apply_nerf_mlp(dtype, atol, num_layers):
    params = _jax_params(seed=num_layers, num_layers=num_layers)
    x, d = _inputs(seed=num_layers)
    ref, _ = jmlp.apply_nerf_mlp(
        params, jnp.asarray(x), jnp.asarray(d),
        compute_dtype=jnp.dtype(dtype), skip_layer=4,
    )
    mlp = NeRFMLP.from_jax_params(params, skip_layer=4,
                                  compute_dtype=getattr(torch, dtype))
    with torch.no_grad():
        out = mlp(torch.as_tensor(x), torch.as_tensor(d))
    assert out.dtype == torch.float32 and out.shape == (32, 4)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=atol, rtol=0)


def test_reference_golden_forward():
    """The TF-reference golden outputs (``ref_tiny_golden.npz``) are
    reproduced from the imported reference weights, to the fixture's own
    tolerance (rtol/atol 2e-4, as tests/test_keras_import.py).  The
    golden's BatchNorm half does not apply: BN is not ported, and raises."""
    from nerf_keras_tpu.utils.keras_import import import_reference_weights

    cfg = NeRFConfig(num_layers=6, hidden_dim=32, skip_layer=4, l_xyz=10,
                     l_dir=4, compute_dtype="float32")
    params, _ = import_reference_weights(
        os.path.join(FIXTURES, "ref_tiny_plain.weights.h5"), cfg
    )
    golden = np.load(os.path.join(FIXTURES, "ref_tiny_golden.npz"))
    for which in ("coarse", "fine"):
        mlp = NeRFMLP.from_jax_params(
            jax.tree_util.tree_map(np.asarray, params[which]),
            skip_layer=4, compute_dtype=torch.float32,
        )
        with torch.no_grad():
            out = mlp(torch.as_tensor(golden["x_enc"]),
                      torch.as_tensor(golden["d_enc"]))
        np.testing.assert_allclose(out.numpy(), golden[f"out_{which}_plain"],
                                   rtol=2e-4, atol=2e-4)

    bn_cfg = NeRFConfig(**{**cfg.__dict__, "batch_norm": True})
    bn_params, _ = import_reference_weights(
        os.path.join(FIXTURES, "ref_tiny_bn.weights.h5"), bn_cfg
    )
    with pytest.raises(NotImplementedError, match="BatchNorm"):
        NeRFMLP.from_jax_params(
            jax.tree_util.tree_map(np.asarray, bn_params["fine"]), skip_layer=4
        )
    with pytest.raises(NotImplementedError, match="BATCH_NORM"):
        NeRFMLP(num_layers=2, hidden_dim=16, batch_norm=True)


def test_init_is_glorot_and_seeded():
    a = NeRFMLP(**ARCH, generator=torch.Generator().manual_seed(1))
    b = NeRFMLP(**ARCH, generator=torch.Generator().manual_seed(1))
    for pa, pb in zip(a.parameters(), b.parameters()):
        torch.testing.assert_close(pa, pb, rtol=0, atol=0)
    w = a.trunk[0].weight.detach()
    limit = (6.0 / (w.shape[0] + w.shape[1])) ** 0.5
    assert float(w.abs().max()) <= limit
    assert float(a.trunk[0].bias.detach().abs().max()) == 0.0


def test_load_rejects_wrong_shapes():
    mlp = NeRFMLP(**ARCH)
    params = _jax_params(hidden_dim=16)
    with pytest.raises(ValueError, match="shape"):
        mlp.load_jax_params(params)
