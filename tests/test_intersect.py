"""Intersection math: Möller-Trumbore vs closed-form cases, AABB slabs."""

import numpy as np
import jax.numpy as jnp

from vkrt.ops.intersect import mt_block, pack_triangles, ray_aabb, safe_inv_dir


def _tri():
    v0 = jnp.asarray([[0.0, 0.0, 0.0]])
    v1 = jnp.asarray([[1.0, 0.0, 0.0]])
    v2 = jnp.asarray([[0.0, 1.0, 0.0]])
    return pack_triangles(v0, v1, v2)


def test_mt_hits_centroid():
    v0, e1, e2 = _tri()
    orig = jnp.asarray([[1 / 3, 1 / 3, 5.0]])
    d = jnp.asarray([[0.0, 0.0, -1.0]])
    hit, t, u, v = mt_block(orig, d, v0, e1, e2, 1e-3, 1e4)
    assert bool(hit[0, 0])
    np.testing.assert_allclose(float(t[0, 0]), 5.0, rtol=1e-6)
    np.testing.assert_allclose(float(u[0, 0]), 1 / 3, rtol=1e-5)
    np.testing.assert_allclose(float(v[0, 0]), 1 / 3, rtol=1e-5)


def test_mt_backface_hits_without_culling():
    v0, e1, e2 = _tri()
    orig = jnp.asarray([[0.2, 0.2, -5.0]])
    d = jnp.asarray([[0.0, 0.0, 1.0]])
    hit, _, _, _ = mt_block(orig, d, v0, e1, e2, 1e-3, 1e4)
    assert bool(hit[0, 0])  # reference builds AS without culling


def test_mt_miss_outside_and_range():
    v0, e1, e2 = _tri()
    orig = jnp.asarray([[2.0, 2.0, 5.0], [0.2, 0.2, 5.0]])
    d = jnp.asarray([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]])
    hit, _, _, _ = mt_block(orig, d, v0, e1, e2, 1e-3, 2.0)  # tmax short
    assert not bool(hit[0, 0])
    assert not bool(hit[1, 0])


def test_mt_degenerate_never_hits():
    z = jnp.zeros((1, 3))
    orig = jnp.asarray([[0.0, 0.0, 1.0]])
    d = jnp.asarray([[0.0, 0.0, -1.0]])
    hit, _, _, _ = mt_block(orig, d, z, z, z, 1e-3, 1e4)
    assert not bool(hit[0, 0])


def test_mt_vs_plane_solution(rng):
    """Random rays vs random triangles, cross-checked against an
    independent plane-intersection + barycentric formulation."""
    t_tris = rng.normal(size=(64, 3, 3)).astype(np.float32)
    origs = rng.normal(size=(128, 3)).astype(np.float32) * 3
    dirs = rng.normal(size=(128, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    v0, e1, e2 = t_tris[:, 0], t_tris[:, 1] - t_tris[:, 0], t_tris[:, 2] - t_tris[:, 0]
    hit, t, u, v = mt_block(
        jnp.asarray(origs), jnp.asarray(dirs),
        jnp.asarray(v0), jnp.asarray(e1), jnp.asarray(e2), 1e-3, 1e4,
    )
    hit, t = np.asarray(hit), np.asarray(t)
    # independent check
    n = np.cross(e1, e2)  # (T,3)
    denom = dirs @ n.T  # (N,T)
    with np.errstate(divide="ignore", invalid="ignore"):
        t_ref = ((v0[None] - origs[:, None]) * n[None]).sum(-1) / denom
    p = origs[:, None] + t_ref[..., None] * dirs[:, None]
    w = p - v0[None]
    d00 = (e1 * e1).sum(-1)
    d01 = (e1 * e2).sum(-1)
    d11 = (e2 * e2).sum(-1)
    dw0 = (w * e1[None]).sum(-1)
    dw1 = (w * e2[None]).sum(-1)
    det = d00 * d11 - d01 * d01
    uu = (d11 * dw0 - d01 * dw1) / det
    vv = (d00 * dw1 - d01 * dw0) / det
    ref_hit = (
        (np.abs(denom) > 1e-6)
        & (t_ref > 1e-3) & (t_ref < 1e4)
        & (uu >= -1e-4) & (vv >= -1e-4) & (uu + vv <= 1 + 1e-4)
    )
    # compare away from numerical edges
    edge = (np.abs(uu) < 1e-3) | (np.abs(vv) < 1e-3) | (np.abs(1 - uu - vv) < 1e-3)
    agree = (hit == ref_hit) | edge
    assert agree.mean() > 0.999
    both = hit & ref_hit
    np.testing.assert_allclose(t[both], t_ref[both], rtol=1e-3, atol=1e-4)


def test_ray_aabb():
    bmin = jnp.asarray([[-1.0, -1.0, -1.0]])
    bmax = jnp.asarray([[1.0, 1.0, 1.0]])
    o = jnp.asarray([[0.0, 0.0, 5.0]])
    d = jnp.asarray([[0.0, 0.0, -1.0]])
    assert bool(ray_aabb(o, safe_inv_dir(d), bmin, bmax, 1e-3, 1e4)[0])
    # pointing away
    assert not bool(ray_aabb(o, safe_inv_dir(-d), bmin, bmax, 1e-3, 1e4)[0])
    # ray starting inside
    o2 = jnp.asarray([[0.0, 0.0, 0.0]])
    assert bool(ray_aabb(o2, safe_inv_dir(d), bmin, bmax, 1e-3, 1e4)[0])
    # axis-parallel ray in plane of slab
    o3 = jnp.asarray([[0.5, 0.5, 5.0]])
    d3 = jnp.asarray([[0.0, 0.0, -1.0]])
    assert bool(ray_aabb(o3, safe_inv_dir(d3), bmin, bmax, 1e-3, 1e4)[0])
    # tmax shorter than distance
    assert not bool(ray_aabb(o, safe_inv_dir(d), bmin, bmax, 1e-3, 1.0)[0])


def test_lane_form_matches_block_form():
    """mt_lanes / slab_lanes (the BVH walks' per-lane form) give the same
    verdicts and the same t, u, v as the broadcast block form."""
    import jax.numpy as jnp
    import numpy as np

    from vkrt.ops.intersect import mt_lanes, slab_lanes

    rng = np.random.default_rng(3)
    n = 512
    o = jnp.asarray(rng.normal(size=(n, 3)) * 2, jnp.float32)
    d = rng.normal(size=(n, 3))
    d = jnp.asarray(d / np.linalg.norm(d, axis=1, keepdims=True), jnp.float32)
    v0 = jnp.asarray(rng.normal(size=(n, 3)), jnp.float32)
    e1 = jnp.asarray(rng.normal(size=(n, 3)), jnp.float32)
    e2 = jnp.asarray(rng.normal(size=(n, 3)), jnp.float32)
    comps = lambda x: tuple(x[:, k] for k in range(3))  # noqa: E731
    hit, t, u, v = mt_lanes(comps(o), comps(d), comps(v0), comps(e1),
                            comps(e2), 1e-3, 1e4)
    blk = [mt_block(o[i:i + 1], d[i:i + 1], v0[i:i + 1], e1[i:i + 1],
                    e2[i:i + 1], 1e-3, 1e4) for i in range(0, n, 37)]
    for j, i in enumerate(range(0, n, 37)):
        bh, bt, bu, bv = (np.asarray(x)[0, 0] for x in blk[j])
        assert bool(hit[i]) == bool(bh)
        if bh:
            np.testing.assert_allclose([t[i], u[i], v[i]], [bt, bu, bv],
                                       rtol=1e-6, atol=1e-7)
    lo = jnp.minimum(v0, v0 + e1)
    hi = jnp.maximum(v0, v0 + e1)
    box = slab_lanes(comps(o), comps(safe_inv_dir(d)), comps(lo), comps(hi),
                     1e-3, 1e4)
    np.testing.assert_array_equal(
        np.asarray(box), np.asarray(ray_aabb(o, safe_inv_dir(d), lo, hi,
                                             1e-3, 1e4)))
