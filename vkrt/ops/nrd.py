"""NRD/REBLUR packing math — port of ``shaders/gltf.glsl:156-273``.

The reference carries five denoiser I/O buffers (hello_vulkan.h:199-207) and
ports NRD's front-end packing to GLSL; we port the same math to JAX so our
denoiser (vkrt.models.denoiser — which *finishes* what the reference left
disabled at main.cpp:566-602) consumes the identical contract: oct-encoded
normal+roughness, YCoCg radiance + normalized hit distance, viewZ.
"""

from __future__ import annotations

import jax.numpy as jnp

NRD_FP16_MIN = 1e-7
NRD_FP16_MAX = 65504.0

# REBLUR hit-distance parameters hardcoded in the reference
# (raytraceHybrid.rgen:276, raytrace.rgen:129).
HIT_DIST_PARAMS = (3.0, 1.0, 20.0, -25.0)


def _sign_not_zero(v):
    return jnp.where(v >= 0.0, 1.0, -1.0)


def encode_unit_vector(v, signed: bool = False):
    """Octahedral encode (gltf.glsl:157-165). v: (...,3) -> (...,2)."""
    denom = jnp.sum(jnp.abs(v), axis=-1, keepdims=True)
    v = v / jnp.maximum(denom, 1e-20)
    xy = v[..., :2]
    # GLSL's v.yx: swapped components
    oct_wrap = (1.0 - jnp.abs(jnp.stack([v[..., 1], v[..., 0]], axis=-1))) * _sign_not_zero(xy)
    e = jnp.where(v[..., 2:3] >= 0.0, xy, oct_wrap)
    return e if signed else e * 0.5 + 0.5


def decode_unit_vector(p, signed: bool = False, normalize: bool = True):
    """Octahedral decode (gltf.glsl:178-188)."""
    p = p if signed else p * 2.0 - 1.0
    z = 1.0 - jnp.abs(p[..., 0]) - jnp.abs(p[..., 1])
    t = jnp.clip(-z, 0.0, 1.0)
    xy = p - t[..., None] * _sign_not_zero(p)
    n = jnp.concatenate([xy, z[..., None]], axis=-1)
    if normalize:
        n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
    return n


def pack_normal_and_roughness(n, roughness, material_id):
    """NRD_FrontEnd_PackNormalAndRoughness (gltf.glsl:167-176)."""
    e = encode_unit_vector(n, signed=False)
    return jnp.concatenate(
        [
            e,
            roughness[..., None],
            jnp.clip(material_id / 3.0, 0.0, 1.0)[..., None],
        ],
        axis=-1,
    )


def unpack_normal_and_roughness(p):
    """Returns (normal, roughness, material_id) (gltf.glsl:190-201)."""
    n = decode_unit_vector(p[..., :2], signed=False, normalize=True)
    return n, p[..., 2], p[..., 3]


def linear_to_ycocg(c):
    """(gltf.glsl:203-210)."""
    y = 0.25 * c[..., 0] + 0.5 * c[..., 1] + 0.25 * c[..., 2]
    co = 0.5 * c[..., 0] - 0.5 * c[..., 2]
    cg = -0.25 * c[..., 0] + 0.5 * c[..., 1] - 0.25 * c[..., 2]
    return jnp.stack([y, co, cg], axis=-1)


def ycocg_to_linear(c):
    """(gltf.glsl:212-222)."""
    t = c[..., 0] - c[..., 2]
    r = t + c[..., 1]
    g = c[..., 0] + c[..., 2]
    b = t - c[..., 1]
    return jnp.maximum(jnp.stack([r, g, b], axis=-1), 0.0)


def pack_radiance_and_norm_hit_dist(radiance, norm_hit_dist, sanitize: bool = True):
    """REBLUR_FrontEnd_PackRadianceAndNormHitDist (gltf.glsl:227-244)."""
    if sanitize:
        bad = jnp.any(~jnp.isfinite(radiance), axis=-1, keepdims=True)
        radiance = jnp.where(bad, 0.0, jnp.clip(radiance, 0.0, NRD_FP16_MAX))
        norm_hit_dist = jnp.where(
            ~jnp.isfinite(norm_hit_dist), 0.0, jnp.clip(norm_hit_dist, 0.0, 1.0)
        )
    norm_hit_dist = jnp.where(
        norm_hit_dist != 0.0, jnp.maximum(norm_hit_dist, NRD_FP16_MIN), norm_hit_dist
    )
    return jnp.concatenate(
        [linear_to_ycocg(radiance), norm_hit_dist[..., None]], axis=-1
    )


def unpack_radiance_and_norm_hit_dist(data):
    """REBLUR_BackEnd_UnpackRadianceAndNormHitDist (gltf.glsl:246-251)."""
    return jnp.concatenate(
        [ycocg_to_linear(data[..., :3]), data[..., 3:4]], axis=-1
    )


def hit_distance_normalization(view_z, roughness, params=HIT_DIST_PARAMS):
    """_REBLUR_GetHitDistanceNormalization (gltf.glsl:254-258)."""
    px, py, pz, pw = params
    s = jnp.clip(jnp.exp2(pw * roughness * roughness), 0.0, 1.0)
    return (px + jnp.abs(view_z) * py) * (1.0 + (pz - 1.0) * s)


def norm_hit_dist(hit_dist, view_z, roughness, params=HIT_DIST_PARAMS):
    """REBLUR_FrontEnd_GetNormHitDist (gltf.glsl:260-265)."""
    f = hit_distance_normalization(view_z, roughness, params)
    return jnp.clip(hit_dist / jnp.maximum(f, 1e-20), 0.0, 1.0)
