"""GLTF PBR BRDF library — batched JAX port of ``shaders/gltf.glsl``.

Every quirk of the reference estimator is kept on purpose (the accuracy
target is RMSE parity with the reference, not textbook correctness):
the ``1e-4`` stabilizers, |.| placements, the Schlick-GGX ``k`` remap, and
the ``directLight`` point-light-only evaluation (gltf.glsl:136-154).

Functions take pre-sampled material values (base_color, metallic, roughness)
— texture fetches happen in :mod:`vkrt.ops.texture` before shading, which
keeps these functions pure elementwise arithmetic with no gathers.
"""

from __future__ import annotations

import jax.numpy as jnp

from vkrt.ops.sampling import M_INV_PI
from vkrt.utils.smath import dot, length, normalize


def ndf_ggxtr(n, h, alpha):
    """GGX/Trowbridge-Reitz NDF (gltf.glsl:55-66); 0 when N.H <= 0."""
    a2 = alpha * alpha
    nh = dot(n, h)
    nh2 = nh * nh
    d = nh2 * (a2 - 1.0) + 1.0
    val = a2 * M_INV_PI / (d * d + 1e-4)
    return jnp.where(nh <= 0.0, 0.0, val)


def g_schlick_ggx(nv, k):
    """Schlick-GGX visibility term (gltf.glsl:68-71)."""
    return nv / (nv * (1.0 - k) + k)


def g_smith(n, v, l, k):
    """Smith geometry term with |N.V|,|N.L| (gltf.glsl:73-78)."""
    nv = jnp.abs(dot(n, v))
    nl = jnp.abs(dot(n, l))
    return g_schlick_ggx(nv, k) * g_schlick_ggx(nl, k)


def f_schlick(h, v, f0):
    """Fresnel-Schlick with |H.V| (gltf.glsl:80-83). f0: (...,3)."""
    hv = jnp.abs(dot(h, v))
    return f0 + (1.0 - f0) * jnp.power(jnp.maximum(1.0 - hv, 0.0), 5.0)[..., None]


def _k_direct(roughness):
    """k remap for direct lighting: (r+1)^2/8 (gltf.glsl:88)."""
    return (roughness + 1.0) * (roughness + 1.0) / 8.0


def specular_brdf_cook_torrance(n, h, v, l, f0, roughness):
    """Cook-Torrance specular D*F*G / (4|VN||LN| + 1e-4) (gltf.glsl:85-96)."""
    alpha = roughness * roughness
    k = _k_direct(roughness)
    d = ndf_ggxtr(n, h, alpha)
    g = g_smith(n, v, l, k)
    f = f_schlick(h, v, f0)
    down = 4.0 * jnp.abs(dot(v, n)) * jnp.abs(dot(l, n)) + 1e-4
    return (d * g / down)[..., None] * f


def specular_brdf_over_pdf_cook_torrance(n, h, v, l, f0, roughness, ratio):
    """BRDF/pdf for the GGX-importance-sampled lobe (gltf.glsl:98-109).

    pdf = (1-ratio) * N.H / (4 L.H + 1e-4); D cancels against the NDF sample.
    """
    k = _k_direct(roughness)
    pdf = (1.0 - ratio) * dot(n, h) / (4.0 * dot(l, h) + 1e-4)
    g = g_smith(n, v, l, k)
    f = f_schlick(h, v, f0)
    down = 4.0 * jnp.abs(dot(v, n)) * jnp.abs(dot(l, n)) + 1e-4
    return (g / (down * pdf))[..., None] * f


def compute_pbr_brdf(n, v, l, h, base_color, metallic, roughness):
    """Combined diffuse+specular PBR BRDF (gltf.glsl:111-134).

    kD = (1-F)(1-metalness); diffuse = kD * baseColor/pi; specular is
    Cook-Torrance with F0 = mix(0.04, baseColor, metalness).
    """
    f0 = base_color * metallic[..., None] + 0.04 * (1.0 - metallic[..., None])
    f = f_schlick(h, v, f0)
    spec = specular_brdf_cook_torrance(n, h, v, l, f0, roughness)
    kd = (1.0 - f) * (1.0 - metallic[..., None])
    diffuse = kd * base_color * M_INV_PI
    return diffuse + spec


def direct_light(
    light_pos, light_color, light_intensity, light_type,
    p, n, v, base_color, metallic, roughness,
):
    """Point-light NEE evaluation (gltf.glsl:136-154).

    Returns (brdf, li, cos_theta). Matches the reference: only ``type == 0``
    (point) contributes; Li = color*intensity/d^2; BRDF is zero when
    cos_theta <= 0. All light args broadcast against ray batch.
    """
    ldir = light_pos - p
    d = length(ldir, keepdims=True)
    l = ldir / jnp.maximum(d, 1e-20)
    h = normalize(l + v)
    li = light_color * (light_intensity / jnp.maximum(d[..., 0] * d[..., 0], 1e-20))[..., None]
    cos_theta = jnp.maximum(dot(l, n), 0.0)
    brdf = compute_pbr_brdf(n, v, l, h, base_color, metallic, roughness)
    gate = ((light_type == 0) & (cos_theta > 0.0))[..., None]
    brdf = jnp.where(gate, brdf, 0.0)
    return brdf, li, cos_theta
