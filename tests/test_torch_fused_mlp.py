"""K5's plain version against the JAX package's K5 (``apply_nerf_mlp_pallas``).

The JAX kernel runs in interpret mode on the CPU with ``tile=64,
bwd_tile=64``, as ``tests/test_pallas.py`` runs it; the port's plain
version is :meth:`NeRFMLP.forward` and its autograd
(``apply_nerf_mlp_reference_vjp``).  Both start from the same JAX
params, with random nonzero biases so the bias paths are under test, and
the same encodings and cotangent, made with numpy.

Tolerances, against the errors the assertions compute (values: max
|diff|; gradients: per leaf, max |diff| over the leaf's largest entry;
measured at these inputs in brackets).  float32, summation order only:
values 1e-5 [6.0e-7], gradients 1e-4 [3.0e-6].  bf16: both sides round
the forward's operands at the same places (values [1.2e-7]), but the
backward rounds its cotangents at other places (the kernel rounds each
dPre before its products and sums the bias gradients in f32; autograd
rounds the gradient at each bf16 cast) and weight gradients come back
rounded to bf16 (parameters [7.8e-3], dx_enc [6.2e-3], dd_enc [2.8e-3]):
values 1e-5, gradients 3e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_keras_tpu.models.mlp import init_nerf_params
from nerf_keras_tpu.ops.pallas.fused_mlp import apply_nerf_mlp_pallas
from nerf_keras_tpu_torch.models.mlp import NeRFMLP
from nerf_keras_tpu_torch.ops.kernels import fused_mlp as k5
from nerf_keras_tpu_torch.ops.kernels import fused_render as k1

# One torch thread beside the JAX workers of the tier-1 run.
torch.set_num_threads(1)

ARCHS = {
    "4x32_skip2": dict(num_layers=4, hidden_dim=32, skip_layer=2, l_xyz=4, l_dir=2),
    # Skip after every layer but the first, the last trunk layer a skip: the
    # heads read [h, x_enc] too, so every product has a skip part.
    "5x32_skip1": dict(num_layers=5, hidden_dim=32, skip_layer=1, l_xyz=3, l_dir=1),
}
TOL = {"float32": (1e-5, 1e-4), "bfloat16": (1e-5, 3e-2)}
# Each need_input_grads mode in each dtype on the 4x32 net; the skip-heavy
# net where its skip parts matter, with input gradients, in bf16.
CASES = [("4x32_skip2", need, dtype) for need in (True, False)
         for dtype in ("float32", "bfloat16")] + [("5x32_skip1", True, "bfloat16")]


def _params(arch, seed=0):
    p = init_nerf_params(jax.random.PRNGKey(seed), **arch)
    rng = np.random.default_rng(seed)

    def leaf(x):
        x = np.asarray(x, np.float32)
        return x + (rng.normal(size=x.shape) * 0.1).astype(np.float32) if x.ndim == 1 else x

    return jax.tree_util.tree_map(leaf, p)


def _inputs(arch, n, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 3 + 6 * arch["l_xyz"])).astype(np.float32)
    d = rng.normal(size=(n, 3 + 6 * arch["l_dir"])).astype(np.float32)
    g = rng.normal(size=(n, 4)).astype(np.float32)
    return x, d, g


def _jax_vjp(params, x, d, g, skip, dtype, need):
    jdt = jnp.dtype(dtype)

    def loss(p, xx, dd):
        out = apply_nerf_mlp_pallas(p, xx, dd, compute_dtype=jdt, skip_layer=skip,
                                    tile=64, bwd_tile=64, need_input_grads=need)
        return jnp.sum(out * g), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        params, jnp.asarray(x, jdt), jnp.asarray(d, jdt))
    return np.asarray(out), grads


def _port(params, arch, dtype):
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return NeRFMLP.from_jax_params(params, skip_layer=arch["skip_layer"], compute_dtype=tdt)


def _tree_of(mlp, grads):
    for p, g in zip(mlp.parameters(), grads):
        p.grad = g
    return mlp.to_jax_params(grad=True)


def _leaf_error(got_tree, want_tree) -> float:
    """The largest per-leaf max |diff| over that leaf's largest entry (the
    figure the module docstring quotes)."""
    got = jax.tree_util.tree_leaves(got_tree)
    want = jax.tree_util.tree_leaves(want_tree)
    assert len(got) == len(want)
    errs = []
    for a, b in zip(got, want):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        assert a.shape == b.shape
        errs.append(float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)))
    return max(errs)


@pytest.mark.parametrize("arch_name,need,dtype", CASES)
def test_plain_k5_matches_jax_kernel(arch_name, need, dtype):
    """Values, parameter gradients and, with need_input_grads, the
    encoding gradients (N = 70: a ragged last tile on the JAX side)."""
    arch = ARCHS[arch_name]
    params = _params(arch)
    x, d, g = _inputs(arch, 70)
    out_j, (gp_j, gx_j, gd_j) = _jax_vjp(params, x, d, g, arch["skip_layer"], dtype, need)

    mlp = _port(params, arch, dtype)
    tdt = mlp.compute_dtype
    xt, dt = torch.tensor(x).to(tdt), torch.tensor(d).to(tdt)
    with torch.no_grad():
        out_p = k5.apply_nerf_mlp_fused(mlp, xt, dt, need_input_grads=need)
    vtol, gtol = TOL[dtype]
    assert out_p.dtype == torch.float32 and out_p.shape == (70, 4)
    verr = float(np.abs(out_p.numpy() - out_j).max())
    assert verr <= vtol, verr

    grads, dx, dd = k5.apply_nerf_mlp_reference_vjp(mlp, xt, dt, torch.tensor(g), need)
    gerr = _leaf_error(_tree_of(mlp, grads), gp_j)
    assert gerr <= gtol, gerr
    if not need:
        assert dx is None and dd is None
        assert float(jnp.abs(gx_j).max()) == 0.0 and float(jnp.abs(gd_j).max()) == 0.0
        return
    assert dx.dtype == tdt and dd.dtype == tdt
    for got, want in ((dx, gx_j), (dd, gd_j)):
        err = _leaf_error([got.float().numpy()], [np.asarray(want, np.float32)])
        assert err <= gtol, err


def test_cpu_takes_the_plain_version_with_autograd():
    """On the CPU the entry point is NeRFMLP.forward (no launch), leading
    dims kept; autograd through it gives the plain backward's gradients."""
    arch = ARCHS["4x32_skip2"]
    params = _params(arch)
    mlp = _port(params, arch, "bfloat16")
    x, d, g = _inputs(arch, 24)
    xt = torch.tensor(x).to(torch.bfloat16).reshape(4, 6, -1).requires_grad_()
    dt = torch.tensor(d).to(torch.bfloat16).reshape(4, 6, -1)
    before = (k5.launches, k5.bwd_launches)
    out = k5.apply_nerf_mlp_fused(mlp, xt, dt, need_input_grads=True)
    assert out.shape == (4, 6, 4)
    (out * torch.tensor(g).reshape(4, 6, 4)).sum().backward()
    assert (k5.launches, k5.bwd_launches) == before
    want, dx, _ = k5.apply_nerf_mlp_reference_vjp(
        mlp, xt.detach().reshape(24, -1), dt.reshape(24, -1), torch.tensor(g))
    for p, w in zip(mlp.parameters(), want):
        torch.testing.assert_close(p.grad, w, rtol=0, atol=1e-2 * float(w.abs().max()))
    torch.testing.assert_close(xt.grad.reshape(24, -1).float(), dx.float(),
                               rtol=0, atol=3e-2 * float(dx.float().abs().max()))


@pytest.mark.parametrize("arch_name", sorted(ARCHS))
def test_input_gradient_pack_has_every_input_column(arch_name):
    """K5's transposed pack with input gradients keeps each layer's whole
    input (layer 0's rows, which K2's pack omits, the skip columns, the
    branch's direction columns); rows are W read the other way."""
    arch = ARCHS[arch_name]
    mlp = _port(_params(arch), arch, "bfloat16")
    k2_pack = k1.pack_weights_bwd(mlp, torch.device("cpu"))
    k5_pack = k1.pack_weights_bwd(mlp, torch.device("cpu"), input_grads=True)
    layers = k1._dense_layers(mlp)
    assert k2_pack.desc[0, 1] == 0 and k5_pack.desc[0, 1] == mlp.xyz_dim
    assert [int(n) for n in k5_pack.desc[:, 1]] == [wt.shape[1] for wt, _ in layers]
    hid = mlp.hidden_dim
    assert int(k5_pack.desc[mlp.num_layers + 1, 1]) == hid + mlp.dir_dim
    # Layer 0 in the full pack: row c (an encoding column), de-interleaved,
    # is column c of W_0 (in, out) = trunk[0].weight.T, in bf16.
    k_pad, n, n_pad, w_off, _ = (int(v) for v in k5_pack.desc[0])
    mat = k5_pack.w[w_off:w_off + n_pad * k_pad].float().reshape(n_pad, k_pad // 16, 16)
    inv = torch.argsort(k1._K_INTERLEAVE)
    mat = mat[..., inv].reshape(n_pad, k_pad)
    want = mlp.trunk[0].weight.detach().T.to(torch.bfloat16).float()  # (in, out)
    torch.testing.assert_close(mat[:n, :hid], want, rtol=0, atol=0)
    assert not mat[n:].any()
