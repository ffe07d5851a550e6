"""RNG statistics + sampling distribution tests (SURVEY.md §4: chi-square
vs cosine/GGX pdfs, RNG statistics)."""

import numpy as np
import jax.numpy as jnp

from vkrt.ops import rng as rng_ops
from vkrt.ops import sampling


def _tea_reference(v0, v1):
    """Independent scalar-python TEA for cross-checking the vectorized one."""
    mask = 0xFFFFFFFF
    s0 = 0
    for _ in range(16):
        s0 = (s0 + 0x9E3779B9) & mask
        v0 = (v0 + ((((v1 << 4) & mask) + 0xA341316C) ^ ((v1 + s0) & mask) ^ ((v1 >> 5) + 0xC8013EA4))) & mask
        v1 = (v1 + ((((v0 << 4) & mask) + 0xAD90777D) ^ ((v0 + s0) & mask) ^ ((v0 >> 5) + 0x7E95761E))) & mask
    return v0


def test_tea_matches_scalar_reference():
    pairs = [(0, 0), (1, 0), (123, 456), (0xFFFFFFFF, 7), (98765, 43210)]
    got = rng_ops.tea(
        jnp.asarray([p[0] for p in pairs], jnp.uint32),
        jnp.asarray([p[1] for p in pairs], jnp.uint32),
    )
    want = [_tea_reference(a, b) for a, b in pairs]
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want, np.uint32))


def test_lcg_sequence_matches_glsl():
    # LCG_A*prev + LCG_C, output (prev & 0xFFFFFF) / 2^24 (random.glsl:22-33)
    state = jnp.asarray([1234567], jnp.uint32)
    prev = 1234567
    for _ in range(10):
        state, u = rng_ops.rnd(state)
        prev = (1664525 * prev + 1013904223) & 0xFFFFFFFF
        want = (prev & 0x00FFFFFF) / float(0x01000000)
        assert abs(float(u[0]) - want) < 1e-7


def test_rnd_uniformity():
    state = rng_ops.tea(jnp.arange(20000, dtype=jnp.uint32), jnp.uint32(3))
    _, u = rng_ops.rnd(state)
    u = np.asarray(u)
    assert 0.0 <= u.min() and u.max() < 1.0
    hist, _ = np.histogram(u, bins=20, range=(0, 1))
    expected = len(u) / 20
    chi2 = ((hist - expected) ** 2 / expected).sum()
    assert chi2 < 60  # 19 dof, p ~ 1e-5 cutoff


def test_cosine_hemisphere_distribution():
    n = 50000
    state = rng_ops.tea(jnp.arange(n, dtype=jnp.uint32), jnp.uint32(0))
    z = jnp.asarray([0.0, 0.0, 1.0])
    x = jnp.asarray([1.0, 0.0, 0.0])
    y = jnp.asarray([0.0, 1.0, 0.0])
    _, d = sampling.sampling_hemisphere(state, x, y, z)
    d = np.asarray(d)
    assert (d[:, 2] >= 0).all()
    np.testing.assert_allclose(np.linalg.norm(d, axis=1), 1.0, atol=1e-5)
    # cosine-weighted: E[cos theta] = 2/3
    assert abs(d[:, 2].mean() - 2.0 / 3.0) < 0.01
    # chi-square on cos^2 (which is uniform for cosine-weighted sampling)
    u = d[:, 2] ** 2
    hist, _ = np.histogram(u, bins=16, range=(0, 1))
    expected = n / 16
    chi2 = ((hist - expected) ** 2 / expected).sum()
    assert chi2 < 55


def test_ggx_sampling_mean_matches_pdf():
    # For GGX NDF sampling, CDF(theta) known: cos^2 = (1-u)/(u(a2-1)+1).
    n = 50000
    for rough in (0.3, 0.7):
        alpha2 = (rough * rough) ** 2  # caller passes alpha^2 (rchit:192)
        state = rng_ops.tea(jnp.arange(n, dtype=jnp.uint32), jnp.uint32(9))
        _, h = sampling.sampling_ndf_ggxtr(state, alpha2)
        h = np.asarray(h)
        np.testing.assert_allclose(np.linalg.norm(h, axis=1), 1.0, atol=1e-4)
        # empirical mean of cos theta vs numeric integral of the sampling pdf
        from numpy import trapezoid

        th = np.linspace(0, np.pi / 2, 4096)
        pdf = (
            np.cos(th)
            * np.sin(th)
            * alpha2
            / (np.pi * (np.cos(th) ** 2 * (alpha2 - 1) + 1) ** 2)
        )
        pdf_n = pdf / trapezoid(pdf, th)
        want_mean = trapezoid(np.cos(th) * pdf_n, th)
        assert abs(h[:, 2].mean() - want_mean) < 0.01


def test_create_coordinate_system_orthonormal(rng):
    n = rng.normal(size=(1000, 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    nt, nb = sampling.create_coordinate_system(jnp.asarray(n, jnp.float32))
    nt, nb = np.asarray(nt), np.asarray(nb)
    np.testing.assert_allclose(np.abs(np.sum(nt * n, axis=1)), 0, atol=1e-5)
    np.testing.assert_allclose(np.abs(np.sum(nb * n, axis=1)), 0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(nt, axis=1), 1, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(nb, axis=1), 1, atol=1e-5)
