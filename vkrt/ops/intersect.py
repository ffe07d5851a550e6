"""Ray-triangle (Möller-Trumbore) and ray-AABB intersection, batched.

The software replacement for ``VK_KHR_ray_tracing_pipeline`` hardware
traversal (reference main.cpp:184-191): watertight-enough Möller-Trumbore
with no backface culling (the reference builds its BLAS without culling
flags, hello_vulkan.cpp:1031-1047) and slab-test AABBs for the BVH layer.

Two forms: :func:`mt_block` broadcasts a batch of rays against a block of
triangles, (N, 3) x (T, 3) -> (N, T); :func:`mt_lanes`/:func:`slab_lanes`
take one ray per lane as (x, y, z) component tuples — the form both BVH
walks (the vmapped plain walk and the GPU kernel) share, so the two compute
the same expressions.
"""

from __future__ import annotations

import jax.numpy as jnp

# Matches the rgen's tMin/tMax (raytrace.rgen:36-37).
T_MIN = 1e-3
T_MAX = 1e4
_DET_EPS = 1e-9


def pack_triangles(v0, v1, v2):
    """Precompute (v0, e1, e2) for Möller-Trumbore. Inputs (T, 3)."""
    return v0, v1 - v0, v2 - v0


def mt_block(orig, direction, v0, e1, e2, t_min, t_max):
    """Intersect a batch of rays against a block of triangles.

    orig, direction: (N, 3). v0/e1/e2: (T, 3). t_min/t_max: scalar or (N,).
    Returns (hit (N,T) bool, t (N,T), u (N,T), v (N,T)). Degenerate
    (zero-area) padding triangles never hit (|det| ~ 0).
    """
    o = orig[:, None, :]          # (N,1,3)
    d = direction[:, None, :]     # (N,1,3)
    v0b = v0[None, :, :]          # (1,T,3)
    e1b = e1[None, :, :]
    e2b = e2[None, :, :]

    pvec = jnp.cross(d, e2b)                          # (N,T,3)
    det = jnp.sum(e1b * pvec, axis=-1)                # (N,T)
    inv_det = jnp.where(jnp.abs(det) > _DET_EPS, jnp.reciprocal(det), 0.0)
    tvec = o - v0b
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1b)
    v = jnp.sum(d * qvec, axis=-1) * inv_det
    t = jnp.sum(e2b * qvec, axis=-1) * inv_det

    t_min = jnp.asarray(t_min, orig.dtype)
    t_max = jnp.asarray(t_max, orig.dtype)
    if t_min.ndim:
        t_min = t_min[:, None]
    if t_max.ndim:
        t_max = t_max[:, None]
    hit = (
        (jnp.abs(det) > _DET_EPS)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > t_min)
        & (t < t_max)
    )
    return hit, t, u, v


def ray_aabb(orig, inv_dir, box_min, box_max, t_min, t_max):
    """Slab test. orig/inv_dir broadcast against box_min/box_max (...,3).

    Returns bool: the ray segment [t_min, t_max] overlaps the box. Correct
    for axis-parallel rays via +/-inf from inv_dir (0*inf NaN is avoided by
    the maximum/minimum reductions treating NaN via jnp semantics — callers
    should nudge zero direction components, see safe_inv_dir).
    """
    t0 = (box_min - orig) * inv_dir
    t1 = (box_max - orig) * inv_dir
    tsm = jnp.minimum(t0, t1)
    tbg = jnp.maximum(t0, t1)
    tnear = jnp.maximum(jnp.max(tsm, axis=-1), t_min)
    tfar = jnp.minimum(jnp.min(tbg, axis=-1), t_max)
    return tnear <= tfar


def safe_inv_dir(direction, eps: float = 1e-20):
    """1/d with zero components nudged so the slab test stays finite."""
    d = jnp.where(jnp.abs(direction) < eps, jnp.where(direction < 0, -eps, eps), direction)
    return jnp.reciprocal(d)


def _min3(a, b, c):
    return jnp.minimum(jnp.minimum(a, b), c)


def _max3(a, b, c):
    return jnp.maximum(jnp.maximum(a, b), c)


def slab_lanes(o, inv_d, bmin, bmax, t_min, t_max):
    """:func:`ray_aabb` per lane; every vector argument is an (x, y, z)
    tuple of same-shaped arrays (or scalars)."""
    t0 = [(bmin[k] - o[k]) * inv_d[k] for k in range(3)]
    t1 = [(bmax[k] - o[k]) * inv_d[k] for k in range(3)]
    tnear = jnp.maximum(
        _max3(*(jnp.minimum(a, b) for a, b in zip(t0, t1))), t_min)
    tfar = jnp.minimum(
        _min3(*(jnp.maximum(a, b) for a, b in zip(t0, t1))), t_max)
    return tnear <= tfar


def mt_lanes(o, d, v0, e1, e2, t_min, t_max):
    """:func:`mt_block` for one triangle per lane, on (x, y, z) component
    tuples. Returns (hit, t, u, v)."""
    def cross(a, b):
        return (a[1] * b[2] - a[2] * b[1],
                a[2] * b[0] - a[0] * b[2],
                a[0] * b[1] - a[1] * b[0])

    def dot(a, b):
        # associated like mt_block's jnp.sum reduction (x0, then x1, then
        # x2 onto the running sum), so where the compiler contracts both
        # into fused multiply-adds the two forms round identically
        return a[2] * b[2] + (a[1] * b[1] + a[0] * b[0])

    p = cross(d, e2)
    det = dot(e1, p)
    ok = jnp.abs(det) > _DET_EPS
    inv_det = jnp.where(ok, jnp.reciprocal(det), 0.0)
    tv = (o[0] - v0[0], o[1] - v0[1], o[2] - v0[2])
    u = dot(tv, p) * inv_det
    q = cross(tv, e1)
    v = dot(d, q) * inv_det
    t = dot(e2, q) * inv_det
    hit = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > t_min) & (t < t_max)
    return hit, t, u, v
