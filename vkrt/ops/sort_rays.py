"""Ray reordering for block coherence.

A block of rays traced together (a GPU warp of the traversal kernel) costs
the union of its rays' traversal footprints. Primary rays arrive coherent
(tile order); diffuse bounce rays from the same block share tight origins
but scatter directions over the hemisphere, inflating the footprint. Sorting
rays by (origin Morton cell, direction octant) before tracing re-tiles the
pool so each block covers a small origin region and one direction cone —
the wavefront-path-tracing trick (SURVEY.md §2d) expressed as one
``lax.sort`` + two permutation gathers per trace.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from vkrt.bvh.lbvh import _expand_bits


def ray_sort_keys(origin, direction, lo, hi, dead=None):
    """uint32 key: direction octant << 21 | 21-bit origin Morton.

    OCTANT-MAJOR on purpose: a block's cost is the union of its rays'
    footprints, and for bounce pools (origins already pixel-tile coherent,
    directions hemisphere-random) the footprint union is dominated by
    direction spread — from one surface point, mixed directions see the
    whole scene; one direction cone sees ~1/8th of it. A morton-major key
    (octant in the low bits) groups nothing at 128^3 cell resolution, where
    each cell holds ~1 ray. Octant-major gives 8 direction runs, each
    origin-sorted — blocks hold one cone over a tight origin region.

    ``dead``: optional mask; dead lanes get the max key and compact to the
    tail, where whole blocks of them finish at once.
    """
    p = (origin - lo) / jnp.maximum(hi - lo, 1e-12)
    q = jnp.clip(p * 128.0, 0.0, 127.0).astype(jnp.uint32)
    # 7-bit expand via the 10-bit helper (top bits zero)
    mx = _expand_bits(q[:, 0]) << 2
    my = _expand_bits(q[:, 1]) << 1
    mz = _expand_bits(q[:, 2])
    morton = mx | my | mz
    octant = (
        (direction[:, 0] >= 0).astype(jnp.uint32) * 4
        + (direction[:, 1] >= 0).astype(jnp.uint32) * 2
        + (direction[:, 2] >= 0).astype(jnp.uint32)
    )
    key = (octant << 21) | morton
    if dead is not None:
        key = jnp.where(dead, jnp.uint32(0xFFFFFFFF), key)
    return key


class SortingTracer(NamedTuple):
    """Wraps a tracer; sorts rays for coherence, unsorts results."""

    inner: object
    lo: jnp.ndarray  # (3,) scene bounds
    hi: jnp.ndarray

    def _perm(self, origin, direction, dead=None):
        n = origin.shape[0]
        keys = ray_sort_keys(origin, direction, self.lo, self.hi, dead=dead)
        _, perm = jax.lax.sort(
            (keys, jnp.arange(n, dtype=jnp.int32)), num_keys=1
        )
        return perm

    def closest(self, origin, direction, t_min, t_max, t_lim=None):
        from vkrt.ops.trace import HitInfo

        dead = None if t_lim is None else t_lim < 0
        perm = self._perm(origin, direction, dead)
        o_s = jnp.take(origin, perm, axis=0)
        d_s = jnp.take(direction, perm, axis=0)
        tl_s = None if t_lim is None else jnp.take(t_lim, perm)
        hi = self.inner.closest(o_s, d_s, t_min, t_max, t_lim=tl_s)
        inv = jnp.zeros_like(perm).at[perm].set(
            jnp.arange(perm.shape[0], dtype=perm.dtype)
        )
        return HitInfo(
            hit=jnp.take(hi.hit, inv),
            t=jnp.take(hi.t, inv),
            tri=jnp.take(hi.tri, inv),
            u=jnp.take(hi.u, inv),
            v=jnp.take(hi.v, inv),
        )

    def any(self, origin, direction, t_min, t_max):
        t_max_arr = jnp.broadcast_to(jnp.asarray(t_max, origin.dtype), origin.shape[:1])
        perm = self._perm(origin, direction, dead=t_max_arr <= 0)
        o_s = jnp.take(origin, perm, axis=0)
        d_s = jnp.take(direction, perm, axis=0)
        t_s = jnp.take(t_max_arr, perm)
        hit = self.inner.any(o_s, d_s, t_min, t_s)
        inv = jnp.zeros_like(perm).at[perm].set(
            jnp.arange(perm.shape[0], dtype=perm.dtype)
        )
        return jnp.take(hit, inv)


def make_sorting_tracer(inner, scene) -> SortingTracer:
    import numpy as np

    v0 = np.asarray(scene.tri_v0)
    v1 = v0 + np.asarray(scene.tri_e1)
    v2 = v0 + np.asarray(scene.tri_e2)
    lo = np.minimum(np.minimum(v0, v1), v2).min(0)
    hi = np.maximum(np.maximum(v0, v1), v2).max(0)
    return SortingTracer(
        inner=inner, lo=jnp.asarray(lo, jnp.float32), hi=jnp.asarray(hi, jnp.float32)
    )
