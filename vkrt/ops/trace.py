"""Trace backends: closest-hit and any-hit queries over ray batches.

The software replacement for ``traceRayEXT`` against a KHR acceleration
structure. Three backends share one API:

* ``bruteforce`` — a lax.scan over triangle blocks, each block broadcast
  against the whole ray batch in one fused expression. O(N*T) with no
  gathers and no divergence; the correctness oracle for everything else
  (SURVEY.md §4).
* ``bvh`` — stackless threaded-BVH traversal (hit -> node+1 in DFS order,
  miss -> skip link), one int32 cursor per ray, vmapped lax.while_loop. See
  vkrt.bvh.lbvh for the builder.
* ``kernel`` — the same walk as a per-ray GPU kernel
  (vkrt.ops.bvh_kernel): each lane stops on its own instead of iterating
  until the pool's slowest ray is done.

Hit info mirrors what the rchit stage derives from
(gl_PrimitiveID, barycentrics, gl_HitTEXT) — raytrace.rchit:33-79.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from vkrt.ops.intersect import mt_block, mt_lanes, safe_inv_dir, slab_lanes

TRI_BLOCK = 256  # triangles per scan step in the brute-force backend


class HitInfo(NamedTuple):
    hit: jnp.ndarray      # (N,) bool
    t: jnp.ndarray        # (N,)
    tri: jnp.ndarray      # (N,) int32 (undefined where ~hit)
    u: jnp.ndarray        # (N,)
    v: jnp.ndarray        # (N,)


def _tri_blocks(tri_v0, tri_e1, tri_e2, block: int):
    t = tri_v0.shape[0]
    nb = -(-t // block)
    pad = nb * block - t
    if pad:
        z = jnp.zeros((pad, 3), tri_v0.dtype)
        tri_v0 = jnp.concatenate([tri_v0, z])
        tri_e1 = jnp.concatenate([tri_e1, z])
        tri_e2 = jnp.concatenate([tri_e2, z])
    return (
        tri_v0.reshape(nb, block, 3),
        tri_e1.reshape(nb, block, 3),
        tri_e2.reshape(nb, block, 3),
    )


def trace_closest_bruteforce(
    tri_v0, tri_e1, tri_e2, orig, direction, t_min, t_max
) -> HitInfo:
    """Closest hit by block-scan over all triangles."""
    v0b, e1b, e2b = _tri_blocks(tri_v0, tri_e1, tri_e2, TRI_BLOCK)
    n = orig.shape[0]
    dt = orig.dtype

    init = (
        jnp.full((n,), jnp.inf, dt),       # best t
        jnp.full((n,), -1, jnp.int32),     # best tri
        jnp.zeros((n,), dt),               # u
        jnp.zeros((n,), dt),               # v
    )

    def step(carry, blk):
        bt, btri, bu, bv = carry
        v0, e1, e2, base = blk
        hit, t, u, v = mt_block(orig, direction, v0, e1, e2, t_min, t_max)
        t = jnp.where(hit, t, jnp.inf)
        j = jnp.argmin(t, axis=1)
        tj = jnp.take_along_axis(t, j[:, None], axis=1)[:, 0]
        better = tj < bt
        idx = (base + j).astype(jnp.int32)
        uj = jnp.take_along_axis(u, j[:, None], axis=1)[:, 0]
        vj = jnp.take_along_axis(v, j[:, None], axis=1)[:, 0]
        return (
            jnp.where(better, tj, bt),
            jnp.where(better, idx, btri),
            jnp.where(better, uj, bu),
            jnp.where(better, vj, bv),
        ), None

    bases = jnp.arange(v0b.shape[0]) * TRI_BLOCK
    (bt, btri, bu, bv), _ = jax.lax.scan(step, init, (v0b, e1b, e2b, bases))
    hit = jnp.isfinite(bt)
    return HitInfo(hit=hit, t=jnp.where(hit, bt, 0.0), tri=btri, u=bu, v=bv)


def trace_any_bruteforce(tri_v0, tri_e1, tri_e2, orig, direction, t_min, t_max):
    """Any-hit (shadow/visibility) query. t_max may be per-ray. Returns (N,) bool."""
    v0b, e1b, e2b = _tri_blocks(tri_v0, tri_e1, tri_e2, TRI_BLOCK)
    n = orig.shape[0]

    def step(carry, blk):
        v0, e1, e2 = blk
        hit, _, _, _ = mt_block(orig, direction, v0, e1, e2, t_min, t_max)
        return carry | jnp.any(hit, axis=1), None

    out, _ = jax.lax.scan(step, jnp.zeros((n,), bool), (v0b, e1b, e2b))
    return out


# ---------------------------------------------------------------------------
# BVH backend (threaded DFS layout; see vkrt.bvh.lbvh)
# ---------------------------------------------------------------------------


def _traverse_one(bvh, tri_v0, tri_e1, tri_e2, o, d, t_min, t_max, any_hit: bool):
    """Single-ray traversal; vmapped by callers. bvh fields in DFS order:
    node_min/node_max (M,3), node_skip (M,), node_tri (M,) (-1 = inner).
    The box and triangle tests are the lane forms the GPU kernel uses."""
    inv_d = tuple(safe_inv_dir(d))
    o, d = tuple(o), tuple(d)
    n_nodes = bvh.node_min.shape[0]

    def cond(state):
        node, best_t, _, _, _, done = state
        return (node < n_nodes) & ~done

    def body(state):
        node, best_t, tri, u, v, done = state
        bmin = tuple(jnp.take(bvh.node_min, node, axis=0))
        bmax = tuple(jnp.take(bvh.node_max, node, axis=0))
        leaf_tri = jnp.take(bvh.node_tri, node)
        skip = jnp.take(bvh.node_skip, node)
        box_hit = slab_lanes(o, inv_d, bmin, bmax, t_min,
                             jnp.minimum(best_t, t_max))
        is_leaf = leaf_tri >= 0

        # leaf: test the triangle (only meaningful if box_hit)
        tv0 = tuple(jnp.take(tri_v0, leaf_tri, axis=0))
        te1 = tuple(jnp.take(tri_e1, leaf_tri, axis=0))
        te2 = tuple(jnp.take(tri_e2, leaf_tri, axis=0))
        h, t, uu, vv = mt_lanes(o, d, tv0, te1, te2, t_min, t_max)
        h = h & is_leaf & box_hit
        closer = h & (t < best_t)
        best_t = jnp.where(closer, t, best_t)
        tri = jnp.where(closer, leaf_tri, tri)
        u = jnp.where(closer, uu, u)
        v = jnp.where(closer, vv, v)
        done = done | (closer if any_hit else False)

        descend = box_hit & ~is_leaf
        node = jnp.where(descend, node + 1, skip)
        return node, best_t, tri, u, v, done

    init = (
        jnp.int32(0),
        jnp.asarray(jnp.inf, o[0].dtype),
        jnp.int32(-1),
        jnp.asarray(0.0, o[0].dtype),
        jnp.asarray(0.0, o[0].dtype),
        jnp.asarray(False),
    )
    node, best_t, tri, u, v, done = jax.lax.while_loop(cond, body, init)
    return best_t, tri, u, v


def trace_closest_bvh(bvh, tri_v0, tri_e1, tri_e2, orig, direction, t_min, t_max) -> HitInfo:
    t_min_b = jnp.broadcast_to(jnp.asarray(t_min, orig.dtype), orig.shape[:1])
    t_max_b = jnp.broadcast_to(jnp.asarray(t_max, orig.dtype), orig.shape[:1])
    f = jax.vmap(
        lambda o, d, tn, tx: _traverse_one(
            bvh, tri_v0, tri_e1, tri_e2, o, d, tn, tx, any_hit=False
        )
    )
    best_t, tri, u, v = f(orig, direction, t_min_b, t_max_b)
    hit = jnp.isfinite(best_t)
    return HitInfo(hit=hit, t=jnp.where(hit, best_t, 0.0), tri=tri, u=u, v=v)


def trace_any_bvh(bvh, tri_v0, tri_e1, tri_e2, orig, direction, t_min, t_max):
    t_min_b = jnp.broadcast_to(jnp.asarray(t_min, orig.dtype), orig.shape[:1])
    t_max_b = jnp.broadcast_to(jnp.asarray(t_max, orig.dtype), orig.shape[:1])
    f = jax.vmap(
        lambda o, d, tn, tx: _traverse_one(
            bvh, tri_v0, tri_e1, tri_e2, o, d, tn, tx, any_hit=True
        )
    )
    best_t, _, _, _ = f(orig, direction, t_min_b, t_max_b)
    return jnp.isfinite(best_t)


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

# ``auto`` on the CPU: brute force up to this many triangles, the LBVH walk
# above it. On the GPU ``auto`` takes the traversal kernel at every size
# (see PERF.md for the measurement behind both choices).
BRUTEFORCE_MAX_TRIS = 4096

BACKENDS = ("auto", "bruteforce", "bvh", "kernel")


class Tracer(NamedTuple):
    """Bound trace functions for one scene (+ optional BVH).

    ``tables`` set selects the per-ray traversal kernel over ``bvh``;
    ``interpret`` runs that kernel through the Pallas interpreter (tests).
    """

    tri_v0: jnp.ndarray
    tri_e1: jnp.ndarray
    tri_e2: jnp.ndarray
    bvh: Optional[object]
    tables: Optional[object] = None
    interpret: bool = False

    def _kernel(self, orig, direction, t_min, t_max, any_hit):
        from vkrt.ops.bvh_kernel import traverse

        return traverse(self.tables, orig, direction, t_min, t_max,
                        any_hit=any_hit, interpret=self.interpret)

    def closest(self, orig, direction, t_min, t_max, t_lim=None) -> HitInfo:
        """``t_lim``: optional per-ray tMax override (fused shadow+bounce
        batches pass per-lane limits; mt_block broadcasts (N,) t_max)."""
        if t_lim is not None:
            t_max = t_lim
        if self.tables is not None:
            best_t, tri, u, v = self._kernel(orig, direction, t_min, t_max,
                                             any_hit=False)
            hit = jnp.isfinite(best_t)
            return HitInfo(hit=hit, t=jnp.where(hit, best_t, 0.0), tri=tri,
                           u=u, v=v)
        if self.bvh is None:
            return trace_closest_bruteforce(
                self.tri_v0, self.tri_e1, self.tri_e2, orig, direction, t_min, t_max
            )
        return trace_closest_bvh(
            self.bvh, self.tri_v0, self.tri_e1, self.tri_e2, orig, direction, t_min, t_max
        )

    def any(self, orig, direction, t_min, t_max) -> jnp.ndarray:
        if self.tables is not None:
            best_t, _, _, _ = self._kernel(orig, direction, t_min, t_max,
                                           any_hit=True)
            return jnp.isfinite(best_t)
        if self.bvh is None:
            return trace_any_bruteforce(
                self.tri_v0, self.tri_e1, self.tri_e2, orig, direction, t_min, t_max
            )
        return trace_any_bvh(
            self.bvh, self.tri_v0, self.tri_e1, self.tri_e2, orig, direction, t_min, t_max
        )


def choose_backend(n_tris: int, platform: str) -> str:
    """What ``auto`` resolves to for a scene of ``n_tris`` on ``platform``."""
    if platform == "gpu":
        return "kernel"
    return "bruteforce" if n_tris <= BRUTEFORCE_MAX_TRIS else "bvh"


def build_tracer(tri_v0, tri_e1, tri_e2, backend: str,
                 interpret: bool = False) -> Tracer:
    """A Tracer of a concrete backend over the given triangles."""
    if backend == "bruteforce":
        return Tracer(tri_v0, tri_e1, tri_e2, None)
    from vkrt.bvh.lbvh import build_lbvh

    bvh = build_lbvh(tri_v0, tri_e1, tri_e2)
    if backend == "bvh":
        return Tracer(tri_v0, tri_e1, tri_e2, bvh)
    if backend != "kernel":
        raise ValueError(f"unknown trace backend {backend!r}")
    from vkrt.ops.bvh_kernel import pack_tables

    return Tracer(tri_v0, tri_e1, tri_e2, bvh,
                  tables=pack_tables(bvh, tri_v0, tri_e1, tri_e2),
                  interpret=interpret)


def make_tracer(scene, backend: str = "auto", alpha: bool = False,
                platform: Optional[str] = None):
    """Pick a trace backend for ``scene``.

    ``auto`` resolves through ``choose_backend`` on ``platform`` (default:
    JAX's default backend). ``kernel`` compiles the traversal kernel for
    the GPU and refuses any other platform; the tests reach its interpret
    mode through ``build_tracer(..., interpret=True)``.
    """
    from vkrt.ops.alpha import make_alpha_tracer

    if backend not in BACKENDS:
        raise ValueError(f"unknown trace backend {backend!r}; one of {BACKENDS}")
    platform = platform or jax.default_backend()
    if backend == "auto":
        backend = choose_backend(int(scene.tri_v0.shape[0]), platform)
    if backend == "kernel" and platform != "gpu":
        raise ValueError(
            f"the 'kernel' trace backend needs a GPU (platform is {platform!r})")
    tracer = build_tracer(scene.tri_v0, scene.tri_e1, scene.tri_e2, backend)
    # alpha punch-through wraps ANY backend (opt-in: the reference ships
    # its any-hit shaders unwired, so default-off is reference parity;
    # no-op for scenes without transparent materials either way)
    return make_alpha_tracer(scene, tracer) if alpha else tracer
