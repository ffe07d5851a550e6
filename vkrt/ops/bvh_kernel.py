"""Per-ray threaded-BVH traversal kernel for the GPU (Pallas, Triton route).

The software form of what the reference's RT cores do for one raygen thread:
each lane walks the stackless threaded DFS layout of ``vkrt.bvh.lbvh`` on its
own. Cursor, ``best_t``, triangle id and barycentrics stay in registers; node
and triangle rows are gathered by the lane's own index; a program (one block
of ``block`` rays) loops only until its own rays are done, not the whole
pool's slowest ray; an any-hit lane stops at its first occluder.

Contract (the ``Tracer`` API of ``vkrt.ops.trace``):

* per-lane ``t_min``/``t_max`` (scalars broadcast);
* a lane whose limit is not above ``t_min`` (the dead-lane convention: dir 0,
  limit -1) never enters the loop and reports a miss;
* results equal the plain LBVH walk (``trace_closest_bvh``/``trace_any_bvh``):
  same box test against ``min(best_t, t_max)``, same Moller-Trumbore test,
  same visiting order.

The kernel has an interpret mode (``interpret=True``), which is how the CPU
tests run it; the renderer only selects it on a GPU.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl

from vkrt.ops.intersect import mt_lanes, safe_inv_dir, slab_lanes

BLOCK = 64        # rays per program (a power of two for the Triton route)
NODE_STRIDE = 8   # f32 words per node row: min xyz, max xyz, skip, tri
TRI_STRIDE = 9    # f32 words per triangle row: v0 xyz, e1 xyz, e2 xyz


class KernelTables(NamedTuple):
    """Flat device tables the kernel gathers from."""

    nodes: jnp.ndarray  # (M*NODE_STRIDE,) f32; skip/tri bit-cast from int32
    tris: jnp.ndarray   # (T*TRI_STRIDE,) f32
    n_nodes: int


def pack_tables(bvh, tri_v0, tri_e1, tri_e2) -> KernelTables:
    """Flatten a FlatBVH and the triangle arrays into the kernel's tables."""
    as_f32 = partial(lax.bitcast_convert_type, new_dtype=jnp.float32)
    nodes = jnp.concatenate(
        [
            bvh.node_min.astype(jnp.float32),
            bvh.node_max.astype(jnp.float32),
            as_f32(bvh.node_skip.astype(jnp.int32))[:, None],
            as_f32(bvh.node_tri.astype(jnp.int32))[:, None],
        ],
        axis=1,
    )
    tris = jnp.concatenate([tri_v0, tri_e1, tri_e2], axis=1).astype(jnp.float32)
    return KernelTables(nodes.reshape(-1), tris.reshape(-1), int(nodes.shape[0]))


def _traverse_kernel(ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref,
                     tmin_ref, tmax_ref, nodes_ref, tris_ref,
                     t_ref, tri_ref, u_ref, v_ref, *, n_nodes: int,
                     any_hit: bool):
    ox, oy, oz = ox_ref[...], oy_ref[...], oz_ref[...]
    dx, dy, dz = dx_ref[...], dy_ref[...], dz_ref[...]
    tmin, tmax = tmin_ref[...], tmax_ref[...]

    ix, iy, iz = safe_inv_dir(dx), safe_inv_dir(dy), safe_inv_dir(dz)
    live = (tmax > tmin) & ((dx != 0.0) | (dy != 0.0) | (dz != 0.0))
    end = jnp.int32(n_nodes)

    def gather(ref, base, k):
        return ref[base + k]

    def cond(c):
        return jnp.max(jnp.where(c[0] < end, 1, 0)) > 0

    def body(c):
        node, best_t, best_tri, bu, bv = c
        act = node < end
        base = jnp.where(act, node, 0) * NODE_STRIDE
        g = partial(gather, nodes_ref, base)
        skip = lax.bitcast_convert_type(g(6), jnp.int32)
        leaf = lax.bitcast_convert_type(g(7), jnp.int32)
        o, d, inv_d = (ox, oy, oz), (dx, dy, dz), (ix, iy, iz)
        box_hit = act & slab_lanes(o, inv_d, (g(0), g(1), g(2)),
                                   (g(3), g(4), g(5)), tmin,
                                   jnp.minimum(best_t, tmax))
        is_leaf = leaf >= 0

        # Moller-Trumbore against the leaf's triangle
        h = partial(gather, tris_ref, jnp.maximum(leaf, 0) * TRI_STRIDE)
        tri_hit, t, u, v = mt_lanes(o, d, (h(0), h(1), h(2)),
                                    (h(3), h(4), h(5)), (h(6), h(7), h(8)),
                                    tmin, tmax)
        closer = box_hit & is_leaf & tri_hit & (t < best_t)

        best_t = jnp.where(closer, t, best_t)
        best_tri = jnp.where(closer, leaf, best_tri)
        bu = jnp.where(closer, u, bu)
        bv = jnp.where(closer, v, bv)
        nxt = jnp.where(box_hit & ~is_leaf, node + 1, skip)
        if any_hit:
            nxt = jnp.where(closer, end, nxt)
        node = jnp.where(act, nxt, node)
        return node, best_t, best_tri, bu, bv

    init = (
        jnp.where(live, 0, end).astype(jnp.int32),
        jnp.full(ox.shape, jnp.inf, jnp.float32),
        jnp.full(ox.shape, -1, jnp.int32),
        jnp.zeros(ox.shape, jnp.float32),
        jnp.zeros(ox.shape, jnp.float32),
    )
    _, best_t, best_tri, bu, bv = lax.while_loop(cond, body, init)
    t_ref[...] = best_t
    tri_ref[...] = best_tri
    u_ref[...] = bu
    v_ref[...] = bv


def traverse(tables: KernelTables, orig, direction, t_min, t_max, *,
             any_hit: bool, interpret: bool = False, block: int = BLOCK):
    """Run the traversal kernel over a ray pool.

    Returns (best_t (inf on miss), tri (-1 on miss), u, v), each (N,).
    """
    n = orig.shape[0]
    n_pad = -(-n // block) * block
    f32 = jnp.float32

    def lane(x):
        x = jnp.broadcast_to(jnp.asarray(x, f32), (n,))
        return jnp.pad(x, (0, n_pad - n))

    # padding lanes get limit -1: dead on entry
    cols = [lane(orig[:, k]) for k in range(3)]
    cols += [lane(direction[:, k]) for k in range(3)]
    tmax = jnp.pad(jnp.broadcast_to(jnp.asarray(t_max, f32), (n,)),
                   (0, n_pad - n), constant_values=-1.0)
    cols += [lane(t_min), tmax]

    ray_spec = pl.BlockSpec((block,), lambda i: (i,))
    nodes, tris = tables.nodes, tables.tris
    kernel = partial(_traverse_kernel, n_nodes=tables.n_nodes, any_hit=any_hit)
    out_shape = (
        jax.ShapeDtypeStruct((n_pad,), f32),
        jax.ShapeDtypeStruct((n_pad,), jnp.int32),
        jax.ShapeDtypeStruct((n_pad,), f32),
        jax.ShapeDtypeStruct((n_pad,), f32),
    )
    kwargs = {}
    if not interpret:
        from jax.experimental.pallas import triton as pl_triton

        kwargs = dict(
            backend="triton",
            compiler_params=pl_triton.CompilerParams(
                num_warps=max(1, block // 32), num_stages=1),
        )
    outs = pl.pallas_call(
        kernel,
        out_shape=out_shape,
        grid=(n_pad // block,),
        in_specs=[ray_spec] * 8 + [
            pl.BlockSpec(nodes.shape, lambda i: (0,)),
            pl.BlockSpec(tris.shape, lambda i: (0,)),
        ],
        out_specs=(ray_spec,) * 4,
        interpret=interpret,
        name="bvh_any" if any_hit else "bvh_closest",
        **kwargs,
    )(*cols, nodes, tris)
    return tuple(o[:n] for o in outs)
