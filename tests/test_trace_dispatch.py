"""Backend choice (make_tracer / choose_backend by platform and scene size),
the compile-cache location, and the plain backends against each other on
the pools the old kernel tests covered (mixed any-hit pools, empty boxes,
a deep multilevel soup)."""

import os

import numpy as np
import jax.numpy as jnp
import pytest

from vkrt.ops.trace import (
    BRUTEFORCE_MAX_TRIS,
    Tracer,
    build_tracer,
    choose_backend,
    make_tracer,
)
from vkrt.scene import make_cornell_box, make_random_soup
from vkrt.utils import jaxcache


@pytest.fixture(scope="module")
def box():
    return make_cornell_box()


def _rays(n, rng, spread=3.0):
    o = jnp.asarray(rng.normal(size=(n, 3)) * spread, jnp.float32)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, jnp.asarray(d, jnp.float32)


@pytest.mark.parametrize("platform,n_tris,want", [
    ("cpu", 72, "bruteforce"),
    ("cpu", BRUTEFORCE_MAX_TRIS, "bruteforce"),
    ("cpu", BRUTEFORCE_MAX_TRIS + 1, "bvh"),
    ("gpu", 72, "kernel"),
    ("gpu", 143_000, "kernel"),
])
def test_choose_backend_by_platform(platform, n_tris, want):
    assert choose_backend(n_tris, platform) == want


@pytest.mark.parametrize("platform,want_bvh,want_tables", [
    ("cpu", False, False),
    ("gpu", True, True),
])
def test_make_tracer_auto_builds_the_chosen_backend(box, platform, want_bvh,
                                                    want_tables):
    tr = make_tracer(box, "auto", platform=platform)
    assert isinstance(tr, Tracer)
    assert (tr.bvh is not None) == want_bvh
    assert (tr.tables is not None) == want_tables
    assert not tr.interpret  # never the interpreter outside the tests


def test_kernel_backend_refuses_non_gpu(box):
    with pytest.raises(ValueError, match="needs a GPU"):
        make_tracer(box, "kernel", platform="cpu")
    with pytest.raises(ValueError, match="unknown trace backend"):
        make_tracer(box, "pallas")


def test_cache_dir_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv(jaxcache.ENV, str(tmp_path))
    assert jaxcache.cache_dir() == str(tmp_path)


def test_cache_dir_default_is_inside_checkout(monkeypatch):
    monkeypatch.delenv(jaxcache.ENV, raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert jaxcache.cache_dir() == os.path.join(repo, ".jax_cache")
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_cache_not_enabled_on_cpu():
    """CPU executables are machine-specific: enable() leaves them alone."""
    import jax

    before = jax.config.jax_compilation_cache_dir
    assert jaxcache.enable() is False
    assert jax.config.jax_compilation_cache_dir == before


def test_mixed_any_hit_pool(box, rng):
    """A fused pool mixes closest lanes (limit T_MAX) with shadow lanes
    (per-lane limits): each half must equal its own query's answer."""
    bf = make_tracer(box, "bruteforce")
    bv = make_tracer(box, "bvh")
    n = 512
    o, d = _rays(n, rng)
    lim = jnp.asarray(rng.uniform(0.3, 8.0, size=(n,)), jnp.float32)
    mixed = jnp.concatenate([jnp.full((n,), 1e4, jnp.float32), lim])
    got = bv.closest(jnp.concatenate([o, o]), jnp.concatenate([d, d]),
                     1e-3, 1e4, t_lim=mixed)
    ref_c = bf.closest(o, d, 1e-3, 1e4)
    np.testing.assert_array_equal(np.asarray(got.hit)[:n],
                                  np.asarray(ref_c.hit))
    h = np.asarray(ref_c.hit)
    np.testing.assert_allclose(np.asarray(got.t)[:n][h],
                               np.asarray(ref_c.t)[h], rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(got.hit)[n:],
                                  np.asarray(bf.any(o, d, 1e-3, lim)))


def test_empty_boxes_cannot_vote(rng):
    """Every BVH node box is finite and not inverted (an inverted box
    passes the slab test for every ray), and leaf boxes bound their
    triangle."""
    soup = make_random_soup(900, seed=5)
    tr = build_tracer(soup.tri_v0, soup.tri_e1, soup.tri_e2, "bvh")
    lo, hi = np.asarray(tr.bvh.node_min), np.asarray(tr.bvh.node_max)
    assert np.isfinite(lo).all() and np.isfinite(hi).all()
    assert (lo <= hi + 1e-6).all()
    leaf = np.asarray(tr.bvh.node_tri)
    v0 = np.asarray(soup.tri_v0)
    sel = leaf >= 0
    assert (lo[sel] <= v0[leaf[sel]] + 1e-6).all()
    assert (v0[leaf[sel]] <= hi[sel] + 1e-6).all()
    # rays outside the scene's bounds miss everything
    o, d = _rays(64, rng)
    far = jnp.full((64, 3), 1e6, jnp.float32)
    assert not np.asarray(tr.closest(far, d, 1e-3, 1e4).hit).any()


def test_multilevel_soup(rng):
    """A deep tree (17k triangles): the LBVH walk agrees with brute force,
    and parked dead lanes all miss."""
    soup = make_random_soup(17_280, seed=11)
    bf = make_tracer(soup, "bruteforce")
    bv = make_tracer(soup, "bvh")
    o, d = _rays(256, rng, spread=1.5)
    ref = bf.closest(o, d, 1e-3, 1e4)
    got = bv.closest(o, d, 1e-3, 1e4)
    np.testing.assert_array_equal(np.asarray(got.hit), np.asarray(ref.hit))
    h = np.asarray(ref.hit)
    np.testing.assert_allclose(np.asarray(got.t)[h], np.asarray(ref.t)[h],
                               rtol=1e-4, atol=1e-5)
    o_dead = jnp.full((256, 3), 1e30, jnp.float32)
    d_dead = jnp.zeros((256, 3), jnp.float32)
    assert not np.asarray(bv.closest(
        o_dead, d_dead, 1e-3, 1e4,
        t_lim=jnp.full((256,), -1.0, jnp.float32)).hit).any()
