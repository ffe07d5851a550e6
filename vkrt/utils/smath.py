"""Small batched vector-math helpers.

All functions operate on arrays whose last axis is the vector axis (size 3 or
4) and broadcast over any leading batch axes, so the same code path serves a
single ray and a (H*W*spp,)-batch of rays. fp32 throughout: ray tracing needs
the precision.
"""

from __future__ import annotations

import jax.numpy as jnp


def dot(a, b, keepdims: bool = False):
    return jnp.sum(a * b, axis=-1, keepdims=keepdims)


def length(v, keepdims: bool = False):
    return jnp.sqrt(jnp.maximum(dot(v, v, keepdims=keepdims), 0.0))


def normalize(v, eps: float = 1e-20):
    return v * jnp.reciprocal(jnp.maximum(length(v, keepdims=True), eps))


def cross(a, b):
    return jnp.cross(a, b)


def reflect(incident, normal):
    """GLSL ``reflect(I, N) = I - 2*dot(N, I)*N``."""
    return incident - 2.0 * dot(normal, incident, keepdims=True) * normal


def mix(a, b, t):
    """GLSL ``mix`` — linear interpolation a*(1-t) + b*t."""
    return a * (1.0 - t) + b * t


def _mat3_apply(m3, v):
    """(3,3) @ (...,3) as explicit multiply-adds.

    Written elementwise on purpose: a float32 matmul may run in TF32 on the
    GPU (~1e-3 relative error) — camera and transform math needs full fp32.
    """
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return jnp.stack(
        [
            m3[0, 0] * x + m3[0, 1] * y + m3[0, 2] * z,
            m3[1, 0] * x + m3[1, 1] * y + m3[1, 2] * z,
            m3[2, 0] * x + m3[2, 1] * y + m3[2, 2] * z,
        ],
        axis=-1,
    )


def transform_point(mat4, p):
    """Apply a 4x4 matrix to points with implicit w=1. p: (..., 3)."""
    return _mat3_apply(mat4[:3, :3], p) + mat4[:3, 3]


def project_point(mat4, p):
    """Homogeneous ``mat4 @ (p, 1)`` for points p (..., 3) -> (..., 4), as
    explicit multiply-adds (full fp32, see _mat3_apply)."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    return jnp.stack(
        [mat4[r, 0] * x + mat4[r, 1] * y + mat4[r, 2] * z + mat4[r, 3]
         for r in range(4)],
        axis=-1,
    )


def transform_dir(mat4, d):
    """Apply a 4x4 matrix to directions with implicit w=0. d: (..., 3)."""
    return _mat3_apply(mat4[:3, :3], d)


def transform_normal(inv_mat4, n):
    """Transform a normal by the inverse-transpose convention.

    The reference transforms normals/tangents by multiplying the *row* vector
    with the world-to-object matrix (``vec3(nrm * gl_WorldToObjectEXT)``,
    reference raytrace.rchit:74-76), i.e. (M^-1)^T @ n. ``inv_mat4`` is the
    world-to-object (inverse) matrix.
    """
    return _mat3_apply(jnp.swapaxes(inv_mat4[:3, :3], 0, 1), n)


def luminance(rgb):
    return dot(rgb, jnp.asarray([0.2126, 0.7152, 0.0722], rgb.dtype))
