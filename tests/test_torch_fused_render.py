"""K1: the port's plain version against the JAX kernel, and the wrapper.

``render_rays_reference`` is held against the JAX ``render_rays_fused``,
which runs its Pallas kernel in interpret mode on the CPU (the same
weights and rays, made with numpy).  Tolerances: rgb/weights atol 1e-4 in
float32 — the JAX kernel computes cos as ``sin(z + pi/2)``, which
differs by up to ~1e-4 at the top octave (tests/test_pallas.py pins
1e-3 on the raw features); 3e-2 in bf16, where accumulation order can
flip bf16 roundings of hidden activations.  The CUDA kernel itself cannot
run on the CPU; tests/test_torch_cuda.py holds it against this plain version on
the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_keras_tpu.models import mlp as jmlp
from nerf_keras_tpu.ops.pallas.fused_render import render_rays_fused as jax_k1
from nerf_keras_tpu_torch.models.mlp import NeRFMLP, randomize_biases_
from nerf_keras_tpu_torch.ops.kernels import fused_render as k1

# Tier-1 runs several pytest workers on a few cores.  With torch's
# default pool (one OpenMP thread per core) a JAX training test in a
# sibling worker aborted; one thread is plenty at these sizes.
torch.set_num_threads(1)

ARCH = dict(num_layers=6, hidden_dim=32, skip_layer=4, l_xyz=10, l_dir=4)


def _params(seed=0):
    p = jmlp.init_nerf_params(jax.random.PRNGKey(seed), **ARCH)
    return jax.tree_util.tree_map(np.asarray, p)


def _rays(seed, b, s):
    rng = np.random.default_rng(seed)
    o = (rng.normal(size=(b, 3)) * 0.3 + np.array([0.0, 0.0, 4.0])).astype(np.float32)
    d = rng.normal(size=(b, 3)).astype(np.float32)
    t = np.sort(rng.uniform(2.0, 6.0, (b, s)), axis=-1).astype(np.float32)
    return o, d, t


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-4), ("bfloat16", 3e-2)])
@pytest.mark.parametrize("b", [16, 13])  # 13: ragged against the JAX tile
def test_reference_matches_jax_kernel(dtype, atol, b):
    params = _params()
    o, d, t = _rays(b, b, 24)
    rgb_j, w_j = jax_k1(
        params, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t),
        l_xyz=10, l_dir=4, compute_dtype=jnp.dtype(dtype), skip_layer=4,
    )
    mlp = NeRFMLP.from_jax_params(params, skip_layer=4,
                                  compute_dtype=getattr(torch, dtype))
    with torch.no_grad():
        rgb, w = k1.render_rays_reference(
            mlp, torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(t),
            l_xyz=10, l_dir=4, skip_layer=4,
        )
    assert rgb.shape == (b, 3) and w.shape == (b, 24)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(rgb_j), atol=atol, rtol=0)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_j), atol=atol, rtol=0)


def test_cpu_tensors_take_the_plain_version():
    mlp = NeRFMLP(**ARCH)
    o, d, t = (torch.as_tensor(x) for x in _rays(0, 8, 12))
    before = k1.launches
    with torch.no_grad():
        out = k1.render_rays_fused(mlp, o, d, t)
        ref = k1.render_rays_reference(mlp, o, d, t)
    assert k1.launches == before
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_other_devices_raise():
    """Nothing but a CPU tensor takes the plain version."""
    mlp = NeRFMLP(**ARCH)
    o = torch.empty((8, 3), device="meta")
    t = torch.empty((8, 12), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        k1.render_rays_fused(mlp, o, o, t)


def test_arch_mismatch_raises():
    mlp = NeRFMLP(**ARCH)
    o, d, t = (torch.as_tensor(x) for x in _rays(0, 8, 12))
    with pytest.raises(ValueError, match="skip_layer"):
        k1.render_rays_fused(mlp, o, d, t, skip_layer=2)


@pytest.mark.parametrize("num_layers", [6, 5])
def test_pack_matches_mma_fragment_order(num_layers):
    """Reading the pack the way the kernel's B-fragment loads do (row n,
    8 bytes at k-group offset 4*tg holding k = 2tg, 2tg+1, 2tg+8, 2tg+9)
    gives back W^T rounded to bf16, zero-padded; the merged head holds the
    feature columns then sigma.  Biases are nonzero and distinct, so a
    wrong bias offset cannot match."""
    gen = torch.Generator().manual_seed(2)
    mlp = randomize_biases_(NeRFMLP(**{**ARCH, "num_layers": num_layers},
                                    generator=gen), gen)
    pack = k1.pack_weights(mlp, torch.device("cpu"))
    layers = k1._dense_layers(mlp)
    assert pack.desc.shape == (num_layers + 3, 5)
    w = pack.w.float()
    for (wt, b), (k_pad, n, n_pad, w_off, b_off) in zip(layers, pack.desc):
        assert (k_pad % 16, n_pad % 8, w_off % 8) == (0, 0, 0)
        rows = w[w_off:w_off + n_pad * k_pad].reshape(n_pad, k_pad // 16, 4, 4)
        got = torch.zeros(n_pad, k_pad // 16, 16)
        for tg in range(4):
            quad = rows[:, :, tg]
            got[:, :, 2 * tg] = quad[..., 0]
            got[:, :, 2 * tg + 1] = quad[..., 1]
            got[:, :, 2 * tg + 8] = quad[..., 2]
            got[:, :, 2 * tg + 9] = quad[..., 3]
        want = torch.zeros(n_pad, k_pad)
        want[:n, :wt.shape[1]] = wt.detach().to(torch.bfloat16).float()
        torch.testing.assert_close(got.reshape(n_pad, k_pad), want, rtol=0, atol=0)
        bias = torch.zeros(n_pad)
        bias[:n] = b.detach()
        torch.testing.assert_close(pack.b[b_off:b_off + n_pad], bias, rtol=0, atol=0)
    fs_w, _ = layers[num_layers]
    torch.testing.assert_close(fs_w[-1], mlp.sigma.weight[0].detach())
    # The kernel reads the merged head's bias at b_off + column: feature
    # biases, then the sigma bias at column hidden_dim.
    hidden, head_b_off = ARCH["hidden_dim"], int(pack.desc[num_layers, 4])
    torch.testing.assert_close(pack.b[head_b_off:head_b_off + hidden],
                               mlp.feature.bias.detach(), rtol=0, atol=0)
    assert float(pack.b[head_b_off + hidden]) == float(mlp.sigma.bias.detach()[0])
    rgb_b_off = int(pack.desc[num_layers + 2, 4])
    torch.testing.assert_close(pack.b[rgb_b_off:rgb_b_off + 3],
                               mlp.rgb.bias.detach(), rtol=0, atol=0)


def test_pack_is_cached_per_installed_weights():
    mlp = NeRFMLP(**ARCH)
    cpu = torch.device("cpu")
    first = k1.kernel_pack(mlp, cpu)
    assert k1.kernel_pack(mlp, cpu) is first
    mlp.load_jax_params(_params(seed=3))  # in-place copy: new weights
    second = k1.kernel_pack(mlp, cpu)
    assert second is not first
    assert not torch.equal(second.w, first.w)
