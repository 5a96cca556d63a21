"""The port's plain ops against their JAX counterparts on the same inputs.

Inputs come from ``np.random.default_rng(seed)`` and go to both packages
as numpy arrays.  Tolerance is atol 1e-6 in float32 (a few ulp of values
in [0, 6]) unless stated; the encoding's top octave takes sin/cos of
arguments up to 2^9 * 6 ~ 3e3 rad, where the two libraries' range
reductions and the f32 rounding of the argument differ by up to about
ulp(3e3) / 2, so the top octaves get atol 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_keras_tpu.ops import encoding as jenc
from nerf_keras_tpu.ops import rays as jrays
from nerf_keras_tpu.ops import sampling as jsamp
from nerf_keras_tpu.ops import volume as jvol
from nerf_keras_tpu_torch.ops import encoding, rays, sampling, volume

# Tier-1 runs several pytest workers on a few cores.  With torch's
# default pool (one OpenMP thread per core) a JAX training test in a
# sibling worker aborted; one thread is plenty at these sizes.
torch.set_num_threads(1)

ATOL = 1e-6
# sample_pdf divides by the chosen bin's cdf increment.  XLA sums and
# scans in another order than torch (blocked cumsum, reciprocal-multiply
# normalisation), so the cdf differs by an ulp or two (~1e-7), which the
# division scales by (bin width / pdf_k): a few 1e-6 on t in [2, 6],
# i.e. ~16 ulp.  The bin choice itself is the same (else errors ~0.1).
SAMPLE_PDF_ATOL = 1e-5


def _t(x):
    return torch.as_tensor(np.array(x))


def _sorted_t(rng, b, s, near=2.0, far=6.0):
    return np.sort(rng.uniform(near, far, (b, s)), axis=-1).astype(np.float32)


@pytest.mark.parametrize("num_freqs", [0, 1, 4, 10])
def test_encode_position(num_freqs):
    rng = np.random.default_rng(num_freqs)
    x = rng.uniform(-6.0, 6.0, (32, 3)).astype(np.float32)
    ref = np.asarray(jenc.encode_position(jnp.asarray(x), num_freqs))
    out = encoding.encode_position(_t(x), num_freqs).numpy()
    assert out.shape == ref.shape == (32, encoding.encoded_width(3, num_freqs))
    # Octaves 0..5 (arguments up to 2^5 * 6 = 192 rad) at atol 1e-6 ...
    lo = 3 + 2 * 3 * min(num_freqs, 6)
    np.testing.assert_allclose(out[:, :lo], ref[:, :lo], atol=ATOL, rtol=0)
    # ... the high octaves at the phase-error bound stated above.
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


def test_pose_spherical_matches():
    for theta, phi, r in [(0.0, -30.0, 4.0), (123.0, -10.0, 3.5), (-45.0, 60.0, 5.0)]:
        np.testing.assert_array_equal(
            rays.pose_spherical(theta, phi, r), jrays.pose_spherical(theta, phi, r)
        )


@pytest.mark.parametrize("hw", [(6, 8), (5, 5)])
def test_get_rays(hw):
    h, w = hw
    pose = jrays.pose_spherical(30.0, -30.0, 4.0)
    jo, jd = jrays.get_rays(h, w, 7.3, pose)
    o, d = rays.get_rays(h, w, 7.3, pose)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=ATOL, rtol=0)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=ATOL, rtol=0)


def test_sample_rays():
    rng = np.random.default_rng(1)
    o = rng.normal(size=(16, 3)).astype(np.float32)
    d = rng.normal(size=(16, 3)).astype(np.float32)
    t = _sorted_t(rng, 16, 12)
    jp, jd = jrays.sample_rays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(t))
    p, dd = rays.sample_rays(_t(o), _t(d), _t(t))
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(dd.numpy(), np.asarray(jd))


@pytest.mark.parametrize("num_samples", [8, 24, 64])
def test_generate_t_vals_center(num_samples):
    ref = np.asarray(jsamp.generate_t_vals(None, 2.0, 6.0, (4,), num_samples, "center"))
    out = sampling.generate_t_vals(2.0, 6.0, (4,), num_samples, "center").numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def test_generate_t_vals_stratified():
    """Different generators draw different numbers, so the jitter is held
    to its contract (one draw inside each bin, reproducible from the seed)
    rather than to the JAX draws."""
    a = sampling.generate_t_vals(2.0, 6.0, (16,), 8, "stratified",
                                 generator=torch.Generator().manual_seed(3))
    b = sampling.generate_t_vals(2.0, 6.0, (16,), 8, "stratified",
                                 generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    base = torch.linspace(2.0, 6.0, 8)
    noise = a - base
    assert bool(((noise >= 0) & (noise < 0.5 + 1e-6)).all())
    with pytest.raises(ValueError, match="unknown sampling mode"):
        sampling.generate_t_vals(2.0, 6.0, (2,), 8, "shared")


def test_sorted_union():
    rng = np.random.default_rng(2)
    a = _sorted_t(rng, 8, 16)
    b = rng.uniform(2.0, 6.0, (8, 12)).astype(np.float32)
    ref = np.asarray(jsamp.sorted_union(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(sampling.sorted_union(_t(a), _t(b)).numpy(), ref)


def _weights(kind, rng, b, s):
    if kind == "random":
        return rng.uniform(0, 1, (b, s)).astype(np.float32)
    if kind == "zeros":
        return np.zeros((b, s), np.float32)
    # plateau: long zero runs around a few spikes -> flat cdf stretches
    w = np.zeros((b, s), np.float32)
    w[:, s // 3] = 1.0
    w[:, s // 3 + 1] = 0.5
    w[::2, -1] = 2.0
    return w


@pytest.mark.parametrize("kind", ["random", "zeros", "plateau"])
@pytest.mark.parametrize("draw", ["deterministic", "injected"])
def test_sample_pdf(kind, draw):
    import jax

    rng = np.random.default_rng(4)
    b, s, f = 16, 24, 16
    t = _sorted_t(rng, b, s)
    t_mid = 0.5 * (t[:, 1:] + t[:, :-1])
    w = _weights(kind, rng, b, s)
    key = jax.random.PRNGKey(7)
    ref = np.asarray(jsamp.sample_pdf(
        key, jnp.asarray(t_mid), jnp.asarray(w), f,
        deterministic=draw == "deterministic",
    ))
    if draw == "deterministic":
        out = sampling.sample_pdf(_t(t_mid), _t(w), f, deterministic=True)
    else:
        # the JAX function's own uniforms, fed to the port
        u = np.asarray(jax.random.uniform(key, (b, f), dtype=jnp.float32))
        out = sampling.sample_pdf(_t(t_mid), _t(w), f, u=_t(u))
    assert out.shape == (b, f)
    np.testing.assert_allclose(out.numpy(), ref, atol=SAMPLE_PDF_ATOL, rtol=0)


def test_sample_pdf_generator_draws():
    """iid uniforms from a seeded generator: reproducible, and every draw
    lands between the first and last midpoint."""
    rng = np.random.default_rng(6)
    t = _t(_sorted_t(rng, 8, 16))
    t_mid = 0.5 * (t[:, 1:] + t[:, :-1])
    w = _t(rng.uniform(0, 1, (8, 16)).astype(np.float32))
    a, b = (sampling.sample_pdf(t_mid, w, 32,
                                generator=torch.Generator().manual_seed(9))
            for _ in range(2))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert bool((a >= t_mid[:, :1]).all() and (a <= t_mid[:, -1:]).all())


def test_sample_pdf_zero_fine():
    out = sampling.sample_pdf(torch.zeros(3, 7), torch.ones(3, 8), 0,
                              deterministic=True)
    assert out.shape == (3, 0)


def test_volume_render_and_background():
    rng = np.random.default_rng(5)
    preds = rng.normal(size=(16, 24, 4)).astype(np.float32) * 3.0
    t = _sorted_t(rng, 16, 24)
    jrgb, jdepth, jw = jvol.volume_render(jnp.asarray(preds), jnp.asarray(t))
    rgb, depth, w = volume.volume_render(_t(preds), _t(t))
    np.testing.assert_allclose(rgb.numpy(), np.asarray(jrgb), atol=ATOL, rtol=0)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=ATOL, rtol=0)
    # depth = sum(w * t) with t up to 6: a few ulp of 6 is ~2e-6
    np.testing.assert_allclose(depth.numpy(), np.asarray(jdepth), atol=4e-6, rtol=0)
    jc = jvol.composite_background(jrgb, jw)
    c = volume.composite_background(rgb, w)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=ATOL, rtol=0)
