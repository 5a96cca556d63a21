"""K7: the port's pdf+union against the JAX package's Pallas kernel.

``sample_pdf_union`` on CPU tensors takes its plain version, the port's
``sorted_union(t, sample_pdf(...))`` chain; these tests hold it against
``experimental/pdf_union.py`` (its Pallas kernel in interpret mode, as
``tests/test_experimental_pdf_union.py`` runs it) in that file's three
cases: the eval grid with adversarial weight rows (all zero, a single
spike, front-loaded mass) at b=20, the flagship S=64 / NF=128, and sorted
uniforms from JAX's own draws.  Tolerance atol 1e-5, the JAX test's.  The
CUDA kernel is held to the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from experimental.pdf_union import sample_pdf_union as jax_union
from experimental.pdf_union import sample_pdf_union_eval as jax_union_eval
from nerf_keras_tpu_torch.ops.kernels import pdf_union as k7

# One torch thread beside the JAX workers of the tier-1 run.
torch.set_num_threads(1)


def _inputs(seed, b, s, cube=False):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(2.0, 6.0, size=(b, s)).astype(np.float32), axis=-1)
    w = rng.uniform(0, 1, size=(b, s)).astype(np.float32)
    return t, w ** 3 if cube else w


def _adversarial(w):
    s = w.shape[1]
    w = w.copy()
    w[0] = 0.0  # uniform pdf through the 1e-5 floor
    w[1] = 0.0
    w[1, s // 2] = 5.0  # a single spike: plateaus in the cdf
    w[2] = 0.0
    w[2, :2] = 1.0  # front-loaded mass
    return w


@pytest.mark.parametrize("case", ["eval_adversarial", "eval_flagship"])
def test_eval_grid_matches_jax_kernel(case):
    if case == "eval_adversarial":
        b, s, nf = 20, 16, 8  # b=20: ray padding at the JAX tile of 24
        t, w = _inputs(9, b, s)
        w = _adversarial(w)
        want = jax_union_eval(jnp.asarray(t), jnp.asarray(w), nf, tile_rays=24)
    else:
        b, s, nf = 16, 64, 128
        t, w = _inputs(3, b, s, cube=True)
        want = jax_union_eval(jnp.asarray(t), jnp.asarray(w), nf)
    got = k7.sample_pdf_union_eval(torch.as_tensor(t), torch.as_tensor(w), nf)
    assert got.shape == (b, s + nf)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    assert (np.diff(got.numpy(), axis=-1) >= 0).all()


def test_sorted_uniforms_match_jax_kernel():
    """Training: sorted uniforms from the JAX key, the same u both sides."""
    b, s, nf = 24, 16, 8
    t, w = _inputs(17, b, s)
    w[0] = 0.0
    u = jnp.sort(jax.random.uniform(jax.random.PRNGKey(5), (b, nf), dtype=jnp.float32), axis=-1)
    want = jax_union(jnp.asarray(t), jnp.asarray(w), nf, u_sorted=u, tile_rays=24)
    got = k7.sample_pdf_union(torch.as_tensor(t), torch.as_tensor(w), nf,
                              u_sorted=torch.as_tensor(np.array(u)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_cpu_wrapper_takes_the_plain_version():
    t, w = (torch.as_tensor(x) for x in _inputs(1, 6, 12))
    before = k7.launches
    got = k7.sample_pdf_union(t, w, 10)
    assert k7.launches == before
    torch.testing.assert_close(got, k7.sample_pdf_union_reference(t, w, 10), rtol=0, atol=0)
    assert k7.sample_pdf_union(t, w, 0) is t
    # Every coarse value is in its row, bit for bit.
    idx = torch.searchsorted(got, t)
    torch.testing.assert_close(got.gather(1, idx), t, rtol=0, atol=0)


def test_other_devices_raise():
    t = torch.empty((4, 8), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        k7.sample_pdf_union(t, t, 4)
