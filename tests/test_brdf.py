"""BRDF library tests: shapes, reciprocity-ish sanity, energy bounds,
white-furnace check for the diffuse lobe, and directLight parity details."""

import numpy as np
import jax.numpy as jnp

from vkrt.ops import brdf
from vkrt.ops.sampling import M_INV_PI


def _n(v):
    v = np.asarray(v, np.float32)
    return jnp.asarray(v / np.linalg.norm(v))


def test_ndf_matches_reference_formula():
    """D == a2/(pi*(d^2 + 1e-4)) with the reference's 1e-4 stabilizer
    (gltf.glsl:55-66) — note this deliberately de-normalizes GGX at low
    roughness; we preserve the quirk, so test the formula, not the
    textbook integral."""
    rng = np.random.default_rng(0)
    n = jnp.asarray([0.0, 0.0, 1.0])
    h_np = rng.normal(size=(256, 3)).astype(np.float32)
    h_np /= np.linalg.norm(h_np, axis=1, keepdims=True)
    for rough in (0.2, 0.5, 0.9):
        alpha = rough * rough
        got = np.asarray(brdf.ndf_ggxtr(n, jnp.asarray(h_np), alpha))
        nh = h_np[:, 2]
        d = nh * nh * (alpha**2 - 1.0) + 1.0
        want = np.where(nh <= 0, 0.0, alpha**2 / np.pi / (d * d + 1e-4))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_ndf_normalization_high_roughness():
    """At high roughness the 1e-4 stabilizer is negligible and the GGX
    integral over the hemisphere must be ~1."""
    for rough in (0.7, 1.0):
        alpha = rough * rough
        th = np.linspace(0, np.pi / 2, 20000)
        n = jnp.asarray([0.0, 0.0, 1.0])
        h = jnp.stack([jnp.sin(jnp.asarray(th)), jnp.zeros(len(th)), jnp.cos(jnp.asarray(th))], -1)
        d = np.asarray(brdf.ndf_ggxtr(n, h, alpha))
        integrand = d * np.cos(th) * np.sin(th) * 2 * np.pi
        val = np.trapezoid(integrand, th)
        assert abs(val - 1.0) < 0.05, (rough, val)


def test_ndf_zero_below_horizon():
    n = jnp.asarray([0.0, 0.0, 1.0])
    h = _n([0.0, 0.5, -0.5])
    assert float(brdf.ndf_ggxtr(n, h, 0.3)) == 0.0


def test_fresnel_limits():
    f0 = jnp.asarray([[0.04, 0.04, 0.04]])
    h = _n([0.0, 0.0, 1.0])[None]
    v_head_on = _n([0.0, 0.0, 1.0])[None]
    v_grazing = _n([1.0, 0.0, 0.008])[None]
    np.testing.assert_allclose(np.asarray(brdf.f_schlick(h, v_head_on, f0)), 0.04, atol=1e-6)
    assert np.asarray(brdf.f_schlick(h, v_grazing, f0)).min() > 0.9


def test_combined_brdf_diffuse_limit():
    """metal=0, rough=1: BRDF ~ kD*base/pi with small specular residue."""
    n = _n([0, 0, 1])[None]
    v = _n([0, 0.5, 1])[None]
    l = _n([0.3, -0.2, 1])[None]
    h = _n(np.asarray(v) + np.asarray(l))
    base = jnp.asarray([[0.5, 0.4, 0.3]])
    out = np.asarray(
        brdf.compute_pbr_brdf(n, v, l, h, base, jnp.asarray([0.0]), jnp.asarray([1.0]))
    )
    diffuse = 0.96 * np.asarray(base) * M_INV_PI  # kD >= 1-F0 = 0.96
    assert (out[0] >= diffuse[0] * 0.95).all()
    assert (out[0] <= diffuse[0] * 1.5).all()


def test_direct_light_point_inverse_square():
    p = jnp.zeros((1, 3))
    n = _n([0, 1, 0])[None]
    v = _n([0, 1, 1])[None]
    base = jnp.asarray([[1.0, 1.0, 1.0]])
    out = []
    for dist in (2.0, 4.0):
        lpos = jnp.asarray([[0.0, dist, 0.0]])
        b, li, ct = brdf.direct_light(
            lpos, jnp.ones((1, 3)), jnp.asarray([10.0]), jnp.asarray([0]),
            p, n, v, base, jnp.asarray([0.1]), jnp.asarray([0.5]),
        )
        out.append(np.asarray(li)[0, 0])
        assert float(ct[0]) == 1.0
    np.testing.assert_allclose(out[0] / out[1], 4.0, rtol=1e-5)


def test_direct_light_nonpoint_contributes_zero_brdf():
    p = jnp.zeros((1, 3))
    n = _n([0, 1, 0])[None]
    v = _n([0, 1, 1])[None]
    b, li, ct = brdf.direct_light(
        jnp.asarray([[0.0, 3.0, 0.0]]), jnp.ones((1, 3)), jnp.asarray([10.0]),
        jnp.asarray([1]),  # directional: reference returns vec3(0)
        p, n, v, jnp.ones((1, 3)), jnp.asarray([0.1]), jnp.asarray([0.5]),
    )
    np.testing.assert_array_equal(np.asarray(b), 0.0)


def test_spec_over_pdf_matches_explicit_ratio():
    """over_pdf == full Cook-Torrance / pdf when D cancels analytically."""
    n = _n([0, 0, 1])[None]
    v = _n([0.2, 0.1, 1.0])[None]
    h = _n([0.05, 0.02, 1.0])[None]
    l_np = 2 * np.sum(np.asarray(h) * np.asarray(v), -1, keepdims=True) * np.asarray(h) - np.asarray(v)
    l = jnp.asarray(l_np)
    f0 = jnp.asarray([[0.5, 0.5, 0.5]])
    rough = jnp.asarray([0.4])
    ratio = jnp.asarray([0.3])
    got = np.asarray(
        brdf.specular_brdf_over_pdf_cook_torrance(n, h, v, l, f0, rough, ratio)
    )
    full = np.asarray(brdf.specular_brdf_cook_torrance(n, h, v, l, f0, rough))
    alpha = 0.4 * 0.4
    d = float(brdf.ndf_ggxtr(n, h, alpha)[0])
    nh = float(np.sum(np.asarray(n) * np.asarray(h)))
    lh = float(np.sum(l_np * np.asarray(h)))
    pdf = (1 - 0.3) * d * nh / (4 * lh + 1e-4)
    # full/pdf differs from over_pdf only by the D/(denominators) epsilons
    np.testing.assert_allclose(got, full / pdf, rtol=2e-2)
