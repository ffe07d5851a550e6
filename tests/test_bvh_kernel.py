"""The per-ray traversal kernel (ops/bvh_kernel.py, Pallas interpret mode on
the CPU) against the brute-force reference, and its wrapper: table packing,
padding to the block, per-lane limits and dead lanes."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from vkrt.ops import bvh_kernel
from vkrt.ops.trace import build_tracer
from vkrt.scene import make_city, make_cornell_box, make_random_soup

SCENES = {
    "cornell": lambda: make_cornell_box(),
    "soup": lambda: make_random_soup(300, seed=3),
    "city": lambda: make_city(grid=4),
    "degenerate": lambda: make_cornell_box(),
}


@pytest.fixture(scope="module")
def tracers():
    """(kernel, bruteforce) per scene, built once per module."""
    out = {}
    for name, make in SCENES.items():
        sc = make()
        tris = (sc.tri_v0, sc.tri_e1, sc.tri_e2)
        out[name] = (build_tracer(*tris, "kernel", interpret=True),
                     build_tracer(*tris, "bruteforce"))
    return out


def _rays(name, n, rng):
    """Rays for a scene. 'degenerate' mixes zero and axis-parallel
    direction components, which the slab test must survive."""
    spread = 1.5 if name == "soup" else (6.0 if name == "city" else 3.0)
    o = rng.normal(size=(n, 3)) * spread
    if name == "city":
        o[:, 1] = np.abs(o[:, 1]) + 0.5
    d = rng.normal(size=(n, 3))
    if name == "degenerate":
        axis = rng.integers(0, 3, size=n)
        d[np.arange(n), axis] = 0.0          # one zero component
        d[: n // 4, :] = 0.0                  # fully axis-parallel rays
        d[np.arange(n // 4), axis[: n // 4]] = rng.choice([-1.0, 1.0], n // 4)
        d[n // 4: n // 4 + 8] = 0.0           # zero direction: never hits
    norm = np.linalg.norm(d, axis=1, keepdims=True)
    d = np.where(norm > 0, d / np.maximum(norm, 1e-30), 0.0)
    return jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32)


def _case(name, case, rng):
    """(orig, dir, t_lim) for one input case."""
    if case == "odd_count":  # not a multiple of the kernel block
        n = 3 * bvh_kernel.BLOCK + 17
        o, d = _rays(name, n, rng)
        return o, d, jnp.full((n,), 1e4, jnp.float32)
    n = 4 * bvh_kernel.BLOCK
    o, d = _rays(name, n, rng)
    lim = jnp.asarray(rng.uniform(0.3, 8.0, size=n), jnp.float32)
    if case == "dead_lanes":  # the bounce pools' dead-lane convention
        dead = jnp.asarray(rng.uniform(size=n) < 0.3)
        o = jnp.where(dead[:, None], 1e30, o)
        d = jnp.where(dead[:, None], 0.0, d)
        lim = jnp.where(dead, -1.0, lim)
    return o, d, lim


@pytest.mark.parametrize("case", ["t_lim", "dead_lanes", "odd_count"])
@pytest.mark.parametrize("query", ["closest", "any"])
@pytest.mark.parametrize("scene", list(SCENES))
def test_kernel_matches_bruteforce(tracers, scene, query, case, rng):
    kernel, ref = tracers[scene]
    o, d, lim = _case(scene, case, rng)
    if query == "any":
        got = np.asarray(kernel.any(o, d, 1e-3, lim))
        want = np.asarray(ref.any(o, d, 1e-3, lim))
        np.testing.assert_array_equal(got, want)
        return
    a = kernel.closest(o, d, 1e-3, 1e4, t_lim=lim)
    b = ref.closest(o, d, 1e-3, 1e4, t_lim=lim)
    np.testing.assert_array_equal(np.asarray(a.hit), np.asarray(b.hit))
    h = np.asarray(b.hit)
    np.testing.assert_allclose(np.asarray(a.t)[h], np.asarray(b.t)[h],
                               rtol=1e-4, atol=1e-5)
    # a differing triangle is only allowed as an equal-t tie (a ray through
    # the shared edge of two triangles, or coplanar faces)
    same = np.asarray(a.tri)[h] == np.asarray(b.tri)[h]
    np.testing.assert_allclose(np.asarray(a.t)[h][~same],
                               np.asarray(b.t)[h][~same], rtol=1e-5, atol=1e-6)
    assert same.mean() > 0.9
    np.testing.assert_allclose(np.asarray(a.u)[h][same],
                               np.asarray(b.u)[h][same], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(np.asarray(a.v)[h][same],
                               np.asarray(b.v)[h][same], rtol=1e-3, atol=1e-4)
    if case == "dead_lanes":
        assert not np.asarray(a.hit)[np.asarray(lim) < 0].any()


def test_kernel_equals_plain_bvh_walk(rng):
    """Same box test, same triangle test, same visiting order: the kernel
    and the vmapped LBVH walk agree lane for lane."""
    sc = make_random_soup(500, seed=9)
    tris = (sc.tri_v0, sc.tri_e1, sc.tri_e2)
    k = build_tracer(*tris, "kernel", interpret=True)
    b = build_tracer(*tris, "bvh")
    o, d = _rays("soup", 300, rng)
    ka, ba = k.closest(o, d, 1e-3, 1e4), b.closest(o, d, 1e-3, 1e4)
    np.testing.assert_array_equal(np.asarray(ka.tri), np.asarray(ba.tri))
    np.testing.assert_allclose(np.asarray(ka.t), np.asarray(ba.t),
                               rtol=1e-6, atol=1e-6)


def test_pack_tables_layout():
    """Node rows carry min/max and the bit-cast skip/tri words; triangle
    rows carry v0, e1, e2."""
    sc = make_cornell_box()
    tr = build_tracer(sc.tri_v0, sc.tri_e1, sc.tri_e2, "kernel",
                      interpret=True)
    t, bvh = tr.tables, tr.bvh
    m = bvh.node_min.shape[0]
    assert t.n_nodes == m
    nodes = np.asarray(t.nodes).reshape(m, bvh_kernel.NODE_STRIDE)
    np.testing.assert_array_equal(nodes[:, 0:3], np.asarray(bvh.node_min))
    np.testing.assert_array_equal(nodes[:, 3:6], np.asarray(bvh.node_max))
    np.testing.assert_array_equal(nodes[:, 6].view(np.int32),
                                  np.asarray(bvh.node_skip))
    np.testing.assert_array_equal(nodes[:, 7].view(np.int32),
                                  np.asarray(bvh.node_tri))
    tris = np.asarray(t.tris).reshape(-1, bvh_kernel.TRI_STRIDE)
    np.testing.assert_array_equal(tris[:, 3:6], np.asarray(sc.tri_e1))


@pytest.mark.parametrize("n", [1, bvh_kernel.BLOCK - 1, bvh_kernel.BLOCK,
                               2 * bvh_kernel.BLOCK + 5])
def test_traverse_shapes_and_padding(n, rng):
    """Outputs come back at the caller's length whatever the padding, with
    the miss convention (t=inf, tri=-1) on lanes that hit nothing."""
    sc = make_cornell_box()
    tr = build_tracer(sc.tri_v0, sc.tri_e1, sc.tri_e2, "kernel",
                      interpret=True)
    o, d = _rays("cornell", n, rng)
    d = d.at[0].set(0.0)  # lane 0 can never hit
    t, tri, u, v = bvh_kernel.traverse(tr.tables, o, d, 1e-3, 1e4,
                                       any_hit=False, interpret=True)
    for x in (t, tri, u, v):
        assert x.shape == (n,)
    assert tri.dtype == jnp.int32
    assert np.isinf(np.asarray(t)[0]) and int(tri[0]) == -1
    hit = np.isfinite(np.asarray(t))
    assert (np.asarray(tri)[hit] >= 0).all()


def test_kernel_under_jit_and_block_size(rng):
    """The wrapper traces under jit, and a smaller block gives the same
    answer (blocks are independent)."""
    sc = make_random_soup(200, seed=4)
    tr = build_tracer(sc.tri_v0, sc.tri_e1, sc.tri_e2, "kernel",
                      interpret=True)
    o, d = _rays("soup", 150, rng)
    f = jax.jit(lambda o, d: bvh_kernel.traverse(
        tr.tables, o, d, 1e-3, 1e4, any_hit=False, interpret=True))
    g = bvh_kernel.traverse(tr.tables, o, d, 1e-3, 1e4, any_hit=False,
                            interpret=True, block=32)
    np.testing.assert_array_equal(np.asarray(f(o, d)[1]), np.asarray(g[1]))
