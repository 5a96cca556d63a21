"""K7: the port's pdf+union against the JAX package's Pallas kernel.

``sample_pdf_union`` on CPU tensors takes its plain version, the port's
``sorted_union(t, sample_pdf(...))`` chain; these tests hold it against
``experimental/pdf_union.py`` (its Pallas kernel in interpret mode, as
``tests/test_experimental_pdf_union.py`` runs it) in that file's three
cases: the eval grid with adversarial weight rows (all zero, a single
spike, front-loaded mass) at b=20, the flagship S=64 / NF=128, and sorted
uniforms from JAX's own draws; and in two more: a coarse value repeated
four times with the mass between its equal midpoints (draws tie with it),
and the bench recipe's 64 + 96 on sorted uniforms.  Tolerance atol 1e-5,
the JAX test's.  The CUDA kernel is held to the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``); its merge-path index
arithmetic is modelled here in numpy and held against ``sorted_union`` and
the chain's bins at ties and plateaus.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from experimental.pdf_union import sample_pdf_union as jax_union
from experimental.pdf_union import sample_pdf_union_eval as jax_union_eval
from nerf_keras_tpu_torch.ops.kernels import pdf_union as k7
from nerf_keras_tpu_torch.ops.sampling import sample_pdf, sorted_union

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


def _repeat_coarse(t, w, row=3):
    """Row ``row`` repeats one coarse value four times and puts the mass
    between its equal midpoints, so draws land exactly on it."""
    s = t.shape[1]
    t, w = t.copy(), w.copy()
    t[row, s // 2:s // 2 + 4] = t[row, s // 2]
    w[row] = 0.0
    w[row, s // 2 + 1:s // 2 + 3] = 1.0
    return t, w


@pytest.mark.parametrize("case", ["eval_adversarial", "eval_flagship", "eval_ties"])
def test_eval_grid_matches_jax_kernel(case):
    if case == "eval_adversarial":
        b, s, nf = 20, 16, 8  # b=20: ray padding at the JAX tile of 24
        t, w = _inputs(9, b, s)
        w = _adversarial(w)
        want = jax_union_eval(jnp.asarray(t), jnp.asarray(w), nf, tile_rays=24)
    elif case == "eval_ties":
        b, s, nf = 8, 16, 8
        t, w = _repeat_coarse(*_inputs(21, b, s))
        want = jax_union_eval(jnp.asarray(t), jnp.asarray(w), nf, tile_rays=8)
        assert (np.asarray(want)[3] == t[3, s // 2]).sum() > 4
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


def test_bench_recipe_sorted_uniforms_match_jax_kernel():
    """The bench recipe's 64 + 96 on sorted uniforms from the JAX key, with
    the adversarial rows and a repeated coarse value."""
    b, s, nf = 8, 64, 96
    t, w = _inputs(23, b, s, cube=True)
    t, w = _repeat_coarse(t, _adversarial(w))
    u = jnp.sort(jax.random.uniform(jax.random.PRNGKey(7), (b, nf), dtype=jnp.float32), axis=-1)
    want = jax_union(jnp.asarray(t), jnp.asarray(w), nf, u_sorted=u, tile_rays=8)
    got = k7.sample_pdf_union(torch.as_tensor(t), torch.as_tensor(w), nf,
                              u_sorted=torch.as_tensor(np.array(u)))
    assert got.shape == (b, s + nf)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    assert (got[3] == float(t[3, s // 2])).sum() > 4


# ---- K7's merge path (csrc/pdf_union.cu), modelled in numpy.
LANES = 16  # lanes per ray in the kernel


def _merge_path(a, b, diag):
    """How many of ``a`` are among the first ``diag`` outputs of merging
    ``a`` with ``b``, ``a`` first on ties (the kernel's ``merge_path``)."""
    lo, hi = max(0, diag - len(b)), min(diag, len(a))
    while lo < hi:
        mid = (lo + hi) // 2
        if a[mid] <= b[diag - 1 - mid]:
            lo = mid + 1
        else:
            hi = mid
    return lo


def _merge(a, b):
    """The kernel's merge: each lane walks its contiguous range of outputs
    from its merge-path start.  Per output ``(0, i)`` for ``a[i]`` or
    ``(1, j, i)`` for ``b[j]`` taken after ``i`` elements of ``a``."""
    n = len(a) + len(b)
    per = -(-n // LANES)
    out = [None] * n
    for lane in range(LANES):
        d0 = min(lane * per, n)
        i = _merge_path(a, b, d0)
        j = d0 - i
        for d in range(d0, min(d0 + per, n)):
            if j >= len(b) or (i < len(a) and a[i] <= b[j]):
                out[d] = (0, i)
                i += 1
            else:
                out[d] = (1, j, i)
                j += 1
    return out


def _merge_cases():
    rng = np.random.default_rng(31)
    t = np.sort(rng.uniform(2, 6, 64)).astype(np.float32)
    tf = np.sort(rng.uniform(2, 6, 128)).astype(np.float32)
    tied_t = np.repeat(t[:16], 4)  # every coarse value four times
    tied_tf = np.sort(np.concatenate([t[::4], t[::4], tf[:64]])).astype(np.float32)
    return {"random": (t, tf), "ties": (tied_t, tied_tf), "small": (t[:3], tf[:2]),
            "fine_first": (t[:5] + 10, tf), "coarse_first": (t, tf[:7] + 10)}


@pytest.mark.parametrize("case", ["random", "ties", "small", "fine_first", "coarse_first"])
def test_merge_path_model_is_the_sorted_union(case):
    """The union's merge places t[i] at i + #{t_f < t[i]} and t_f[j] at
    j + #{t <= t_f[j]}, every value once: sorted_union, ties included."""
    t, tf = _merge_cases()[case]
    out = _merge(t, tf)
    row = np.array([t[o[1]] if o[0] == 0 else tf[o[1]] for o in out], dtype=np.float32)
    want = sorted_union(torch.as_tensor(t)[None], torch.as_tensor(tf)[None])[0].numpy()
    np.testing.assert_array_equal(row, want)
    pos_c = [d for d, o in enumerate(out) if o[0] == 0]
    pos_f = [d for d, o in enumerate(out) if o[0] == 1]
    np.testing.assert_array_equal(pos_c, np.arange(len(t)) + np.searchsorted(tf, t, "left"))
    np.testing.assert_array_equal(pos_f, np.arange(len(tf)) + np.searchsorted(t, tf, "right"))


@pytest.mark.parametrize("case", ["random", "spike_plateaus", "u_on_cdf", "few_u"])
def test_merge_path_model_gives_the_chains_bins(case):
    """The bin lookup's merge of the cdf with u records #{cdf <= u} for each
    u: the chain's right-side searchsorted, on cdf plateaus and on u equal
    to a cdf entry."""
    rng = np.random.default_rng(37)
    s, nf = 64, 128
    w = rng.uniform(0, 1, s).astype(np.float32) ** 3
    if case == "spike_plateaus":
        w[:] = 0.0
        w[s // 2] = 1e6  # the floored bins after it add less than half an ulp
    w = torch.as_tensor(w) + 1e-5
    cdf = torch.cat([torch.zeros(1), torch.cumsum(w / w.sum(), 0)]).numpy()
    u = np.sort(rng.uniform(0, 1, nf)).astype(np.float32)
    if case == "spike_plateaus":
        assert (np.diff(cdf) == 0).sum() > 8
        u = np.sort(np.concatenate([cdf[-8:], u[8:]])).astype(np.float32)
    elif case == "u_on_cdf":
        u = np.sort(np.concatenate([cdf[1:-1:2], u[: nf - s // 2]])).astype(np.float32)
    elif case == "few_u":
        u = u[:5]
    bins = np.empty(len(u), dtype=np.int64)
    for o in _merge(cdf, u):
        if o[0] == 1:
            bins[o[1]] = o[2]
    want = torch.searchsorted(torch.as_tensor(cdf), torch.as_tensor(u), right=True).numpy()
    np.testing.assert_array_equal(bins, want)


def test_device_grid_is_made_once():
    """K7's eval grid is made once per (NF, device), by sample_pdf's call."""
    cpu = torch.device("cpu")
    grid = k7.device_grid(96, cpu)
    assert k7.device_grid(96, cpu) is grid
    assert torch.equal(grid, torch.linspace(0.5 / 96, 1.0 - 0.5 / 96, 96, dtype=torch.float32))


def test_float64_chain_is_the_chain_in_float64():
    """The float64 yardstick agrees with the float32 chain within the
    chain's own rounding (1e-3, K7's gate), keeps every coarse value, and
    is float64."""
    t, w = (torch.as_tensor(x) for x in _inputs(29, 32, 64, cube=True))
    w = torch.as_tensor(_adversarial(w.numpy()))
    for u in (None, torch.sort(torch.rand((32, 96), generator=torch.Generator().manual_seed(3)),
                               dim=-1).values):
        nf = 96
        exact = k7.sample_pdf_union_float64(t, w, nf, u)
        assert exact.dtype == torch.float64 and exact.shape == (32, 64 + nf)
        want = k7.sample_pdf_union_reference(t, w, nf, u)
        assert float((exact - want.double()).abs().max()) <= 1e-3
        idx = torch.searchsorted(exact, t.double())
        assert torch.equal(exact.gather(1, idx), t.double())


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
