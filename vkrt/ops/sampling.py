"""Direction sampling: cosine hemisphere, ONB construction, GGX NDF.

Ports the math of ``shaders/random.glsl:35-70`` into batched JAX. RNG draws
are taken in the same order as the GLSL (r1 then r2) so sample sequences have
the same structure; every function takes and returns the explicit LCG state.
"""

from __future__ import annotations

import jax.numpy as jnp

from vkrt.ops.rng import rnd
from vkrt.utils.smath import cross

M_PI = 3.14159265358979323846
M_TWO_PI = 2.0 * M_PI
M_INV_PI = 1.0 / M_PI


def hemisphere_from_uniforms(r1, r2, x, y, z):
    """Cosine-weighted hemisphere direction from two uniforms in [0,1)
    (shaders/random.glsl:35-45, the math after the draws)."""
    sq = jnp.sqrt(r1)
    phi = M_TWO_PI * r2
    cx = (jnp.cos(phi) * sq)[..., None]
    cy = (jnp.sin(phi) * sq)[..., None]
    cz = jnp.sqrt(jnp.maximum(1.0 - r1, 0.0))[..., None]
    return cx * x + cy * y + cz * z


def sampling_hemisphere(state, x, y, z, uniforms=None):
    """Cosine-weighted hemisphere sample around frame (x, y, z=normal).

    Reference shaders/random.glsl:35-45. Returns (state, direction).
    ``uniforms``: optional (r1, r2) overriding the lane draws (correlated
    per-block sampling) — the lane state still advances identically.
    """
    state, r1 = rnd(state)
    state, r2 = rnd(state)
    if uniforms is not None:
        r1, r2 = uniforms
    return state, hemisphere_from_uniforms(r1, r2, x, y, z)


def create_coordinate_system(n):
    """Branchless ONB matching shaders/random.glsl:47-54.

    GLSL picks the tangent by comparing |N.x| vs |N.y|; we evaluate both
    branches and select (the SIMD way). Returns (nt, nb).
    """
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    inv_a = jnp.reciprocal(jnp.sqrt(jnp.maximum(nx * nx + nz * nz, 1e-30)))
    t_a = jnp.stack([nz * inv_a, jnp.zeros_like(nx), -nx * inv_a], axis=-1)
    inv_b = jnp.reciprocal(jnp.sqrt(jnp.maximum(ny * ny + nz * nz, 1e-30)))
    t_b = jnp.stack([jnp.zeros_like(nx), -nz * inv_b, ny * inv_b], axis=-1)
    nt = jnp.where((jnp.abs(nx) > jnp.abs(ny))[..., None], t_a, t_b)
    nb = cross(n, nt)
    return nt, nb


def ggxtr_half_from_uniforms(r1, r2, alpha2):
    """GGX NDF half-vector in local space from two uniforms
    (shaders/random.glsl:56-70, the math after the draws)."""
    cos_theta = jnp.sqrt(
        jnp.maximum((1.0 - r2) / ((alpha2 - 1.0) * r2 + 1.0), 0.0)
    )
    sin_theta = jnp.clip(
        jnp.sqrt(jnp.maximum(1.0 - cos_theta * cos_theta, 0.0)), 0.0, 1.0
    )
    phi = r1 * M_TWO_PI
    return jnp.stack(
        [sin_theta * jnp.cos(phi), sin_theta * jnp.sin(phi), cos_theta],
        axis=-1,
    )


def sampling_ndf_ggxtr(state, alpha2, uniforms=None):
    """GGX NDF half-vector sample in local (tangent) space.

    Reference shaders/random.glsl:56-70. Note the caller passes
    ``alpha*alpha`` with ``alpha = roughness^2`` (raytrace.rchit:191-192), so
    ``alpha2`` here is roughness^4 — reproduced faithfully. Returns
    (state, h_local) with h_local in the (tangent, binormal, normal) frame.
    ``uniforms``: optional (r1, r2) overriding the lane draws (correlated
    per-block sampling) — the lane state still advances identically.
    """
    state, r1 = rnd(state)
    state, r2 = rnd(state)
    if uniforms is not None:
        r1, r2 = uniforms
    return state, ggxtr_half_from_uniforms(r1, r2, alpha2)


def local_to_world(local, tangent, binormal, normal):
    """TBN transform: world = x*T + y*B + z*N (raytrace.rchit:99,192)."""
    return (
        local[..., 0:1] * tangent
        + local[..., 1:2] * binormal
        + local[..., 2:3] * normal
    )
