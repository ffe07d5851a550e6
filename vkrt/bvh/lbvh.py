"""LBVH: on-device linear BVH build (Morton sort + Karras linking).

The replacement for ``VK_KHR_acceleration_structure`` BLAS/TLAS
builds (reference hello_vulkan.cpp:1001-1047 via nvvk::RaytracingBuilderKHR):

1. triangle AABBs + centroids, 30-bit Morton codes (10 bits/axis),
2. ``jax.lax.sort`` with the leaf index as a second key (the standard
   duplicate-Morton tiebreak, avoiding 64-bit keys),
3. Karras 2012 internal-node range/split computation, fully vectorized
   (every internal node independently from longest-common-prefix queries),
4. per-internal-node AABBs by range-min/max over the sorted leaf boxes with
   a sparse table (O(n log n) one-time build, O(1) per node — no bottom-up
   propagation pass, which would serialize),
5. flattening to a *threaded DFS layout*: nodes in preorder, each carrying a
   skip link, so traversal needs exactly one int32 cursor per ray
   (hit -> node+1, miss -> skip) — the state layout a SIMD/vector machine
   wants. The preorder position is computed in closed form:
   ``dfs = 2*first_leaf + (#ancestors through a left-child edge)`` and
   ``skip = dfs + 2*num_leaves - 1`` (subtrees over contiguous leaf ranges
   are full binary trees), so flattening is also O(n) parallel scatters, not
   a sequential DFS walk.

Everything is jnp on-device; the build itself is jittable.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp


class FlatBVH(NamedTuple):
    """Threaded preorder BVH. M = 2n-1 nodes."""

    node_min: jnp.ndarray   # (M,3) f32
    node_max: jnp.ndarray   # (M,3)
    node_skip: jnp.ndarray  # (M,) i32 preorder index after this subtree
    node_tri: jnp.ndarray   # (M,) i32 triangle id, -1 for inner nodes


def _expand_bits(v):
    """Spread 10 bits to every third bit (Morton helper), uint32."""
    v = v.astype(jnp.uint32)
    v = (v * jnp.uint32(0x00010001)) & jnp.uint32(0xFF0000FF)
    v = (v * jnp.uint32(0x00000101)) & jnp.uint32(0x0F00F00F)
    v = (v * jnp.uint32(0x00000011)) & jnp.uint32(0xC30C30C3)
    v = (v * jnp.uint32(0x00000005)) & jnp.uint32(0x49249249)
    return v


def morton3d(p01):
    """30-bit Morton codes from points normalized to [0,1]^3. (N,3)->(N,)."""
    q = jnp.clip(p01 * 1024.0, 0.0, 1023.0).astype(jnp.uint32)
    return (
        (_expand_bits(q[:, 0]) << 2)
        | (_expand_bits(q[:, 1]) << 1)
        | _expand_bits(q[:, 2])
    )


def _clz32(x):
    """Count leading zeros of uint32, vectorized and branch-free."""
    x = x.astype(jnp.uint32)
    shift = jnp.zeros(x.shape, jnp.int32)
    cur = x
    for s in (16, 8, 4, 2, 1):
        hi = (cur >> s) != 0
        cur = jnp.where(hi, cur >> s, cur)
        shift = shift + jnp.where(hi, s, 0)
    return jnp.where(x == 0, 32, 31 - shift).astype(jnp.int32)


@partial(jax.jit, static_argnames=())
def build_lbvh(tri_v0, tri_e1, tri_e2) -> FlatBVH:
    n = tri_v0.shape[0]
    if n == 1:
        v1 = tri_v0 + tri_e1
        v2 = tri_v0 + tri_e2
        bmin = jnp.minimum(jnp.minimum(tri_v0, v1), v2)
        bmax = jnp.maximum(jnp.maximum(tri_v0, v1), v2)
        return FlatBVH(bmin, bmax, jnp.asarray([1], jnp.int32), jnp.asarray([0], jnp.int32))

    v1 = tri_v0 + tri_e1
    v2 = tri_v0 + tri_e2
    bmin = jnp.minimum(jnp.minimum(tri_v0, v1), v2)
    bmax = jnp.maximum(jnp.maximum(tri_v0, v1), v2)
    centroid = 0.5 * (bmin + bmax)
    lo = jnp.min(centroid, axis=0)
    hi = jnp.max(centroid, axis=0)
    codes = morton3d((centroid - lo) / jnp.maximum(hi - lo, 1e-12))

    # sort leaves by (code, original index)
    idx = jnp.arange(n, dtype=jnp.int32)
    codes_s, tri_id = jax.lax.sort((codes, idx), num_keys=1)
    lmin = jnp.take(bmin, tri_id, axis=0)
    lmax = jnp.take(bmax, tri_id, axis=0)

    # delta(i, j): common-prefix length of keys i and j; -1 out of range.
    codes_i32 = codes_s.astype(jnp.int32)

    def delta(i, j):
        j_ok = (j >= 0) & (j < n)
        jc = jnp.clip(j, 0, n - 1)
        ci = jnp.take(codes_i32, jnp.clip(i, 0, n - 1))
        cj = jnp.take(codes_i32, jc)
        x = (ci ^ cj).astype(jnp.uint32)
        same = x == 0
        # duplicate codes: fall through to index bits (Karras §4)
        d_code = _clz32(x)
        d_idx = 32 + _clz32((i ^ jc).astype(jnp.uint32))
        return jnp.where(j_ok, jnp.where(same, d_idx, d_code), -1)

    i = jnp.arange(n - 1, dtype=jnp.int32)
    d = jnp.sign(delta(i, i + 1) - delta(i, i - 1)).astype(jnp.int32)
    d = jnp.where(d == 0, 1, d)
    delta_min = delta(i, i - d)

    # The three searches run as fori_loops (not Python unrolls): unrolling
    # ~95 delta() calls produced a 10k-equation jaxpr that XLA compiles
    # pathologically slowly; the loops carry identical work in ~1/30 the ops.

    # upper bound by doubling (idempotent once the condition fails)
    def grow_body(_, lmax_len):
        grow = delta(i, i + lmax_len * d) > delta_min
        return jnp.where(grow, jnp.minimum(lmax_len * 2, 1 << 30), lmax_len)

    lmax_len = jax.lax.fori_loop(0, 31, grow_body, jnp.full(n - 1, 2, jnp.int32))

    # binary search the exact other end j = i + l*d
    def lsearch_body(k, l):
        t = lmax_len >> k
        cand = l + t
        ok = (t > 0) & (delta(i, i + cand * d) > delta_min)
        return jnp.where(ok, cand, l)

    l = jax.lax.fori_loop(1, 32, lsearch_body, jnp.zeros(n - 1, jnp.int32))
    j = i + l * d

    # split position gamma by binary search on the node's own prefix
    delta_node = delta(i, j)

    def split_body(_, carry):
        s, t, done = carry
        t = (t + 1) >> 1
        cand = s + t
        ok = (~done) & (delta(i, i + cand * d) > delta_node)
        s = jnp.where(ok, cand, s)
        return s, t, done | (t <= 1)

    s, _, _ = jax.lax.fori_loop(
        0, 32, split_body, (jnp.zeros(n - 1, jnp.int32), l, jnp.zeros(n - 1, bool))
    )
    gamma = i + s * d + jnp.minimum(d, 0)

    first = jnp.minimum(i, j)
    last = jnp.maximum(i, j)
    left_is_leaf = first == gamma
    right_is_leaf = last == gamma + 1
    # global node ids: internal k -> k (k in [0, n-2]); leaf k -> n-1+k
    left_id = jnp.where(left_is_leaf, (n - 1) + gamma, gamma)
    right_id = jnp.where(right_is_leaf, (n - 1) + gamma + 1, gamma + 1)

    m = 2 * n - 1
    parent = jnp.full(m, -1, jnp.int32)
    parent = parent.at[left_id].set(i)
    parent = parent.at[right_id].set(i)
    is_left = jnp.zeros(m, bool).at[left_id].set(True)

    # per-node leaf ranges
    node_first = jnp.concatenate([first, jnp.arange(n, dtype=jnp.int32)])
    node_last = jnp.concatenate([last, jnp.arange(n, dtype=jnp.int32)])

    # count left-child ancestor edges by pointer-jumping up the tree
    def walk(state):
        cur, al = state
        valid = cur >= 0
        curc = jnp.clip(cur, 0, m - 1)
        # a left-child edge counts whenever the current node has a parent
        has_parent = valid & (parent[curc] >= 0)
        al = al + jnp.where(has_parent & is_left[curc], 1, 0)
        cur = jnp.where(valid, parent[curc], cur)
        return cur, al

    def cond(state):
        cur, _ = state
        return jnp.any(cur >= 0)

    cur0 = jnp.arange(m, dtype=jnp.int32)
    _, a_left = jax.lax.while_loop(
        cond, lambda st: walk(st), (cur0, jnp.zeros(m, jnp.int32))
    )

    n_leaves = node_last - node_first + 1
    dfs = 2 * node_first + a_left
    skip = dfs + 2 * n_leaves - 1

    # internal AABBs: range min/max over sorted leaf boxes via sparse table
    levels = max(1, (n - 1).bit_length())
    sp_min = [lmin]
    sp_max = [lmax]
    for k in range(1, levels):
        half = 1 << (k - 1)
        prev_min, prev_max = sp_min[-1], sp_max[-1]
        shifted_min = jnp.concatenate([prev_min[half:], prev_min[-1:].repeat(half, 0)])
        shifted_max = jnp.concatenate([prev_max[half:], prev_max[-1:].repeat(half, 0)])
        sp_min.append(jnp.minimum(prev_min, shifted_min))
        sp_max.append(jnp.maximum(prev_max, shifted_max))
    sp_min = jnp.stack(sp_min)  # (levels, n, 3)
    sp_max = jnp.stack(sp_max)

    length = n_leaves
    # k = floor(log2(length)) via comparisons (exact for ints)
    k_level = jnp.zeros(m, jnp.int32)
    for jbit in range(1, levels):
        k_level = k_level + (length >= (1 << jbit)).astype(jnp.int32)
    a_idx = node_first
    b_idx = node_last - (1 << k_level) + 1
    b_idx = jnp.maximum(b_idx, 0)

    def rmq(table, combine):
        va = table[k_level, a_idx]
        vb = table[k_level, b_idx]
        return combine(va, vb)

    nmin = rmq(sp_min, jnp.minimum)
    nmax = rmq(sp_max, jnp.maximum)

    # scatter into preorder layout
    out_min = jnp.zeros((m, 3), tri_v0.dtype).at[dfs].set(nmin)
    out_max = jnp.zeros((m, 3), tri_v0.dtype).at[dfs].set(nmax)
    out_skip = jnp.zeros((m,), jnp.int32).at[dfs].set(skip)
    leaf_dfs = dfs[n - 1 :]
    out_tri = jnp.full((m,), -1, jnp.int32).at[leaf_dfs].set(tri_id)
    return FlatBVH(out_min, out_max, out_skip, out_tri)
