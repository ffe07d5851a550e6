"""The ray-sorting wrapper (ops/sort_rays.py): a pure permutation around
any tracer, so results are identical, and its keys group rays by cell and
octant."""

import numpy as np
import jax.numpy as jnp
import pytest

from vkrt.ops.sort_rays import make_sorting_tracer, ray_sort_keys
from vkrt.ops.trace import make_tracer
from vkrt.scene import make_cornell_box


@pytest.fixture(scope="module")
def box():
    return make_cornell_box()


def _rays(n, rng, spread=3.0):
    o = jnp.asarray(rng.normal(size=(n, 3)) * spread, jnp.float32)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, jnp.asarray(d, jnp.float32)


def test_sorting_tracer_identical_results(box, rng):
    bf = make_tracer(box, "bruteforce")
    st = make_sorting_tracer(bf, box)
    o, d = _rays(2000, rng)
    ref = bf.closest(o, d, 1e-3, 1e4)
    got = st.closest(o, d, 1e-3, 1e4)
    np.testing.assert_array_equal(np.asarray(got.hit), np.asarray(ref.hit))
    np.testing.assert_array_equal(np.asarray(got.tri), np.asarray(ref.tri))
    np.testing.assert_allclose(np.asarray(got.t), np.asarray(ref.t))
    ref_any = bf.any(o, d, 1e-3, 2.0)
    got_any = st.any(o, d, 1e-3, 2.0)
    np.testing.assert_array_equal(np.asarray(got_any), np.asarray(ref_any))


def test_ray_sort_keys_group_by_octant_and_cell(rng):
    lo = jnp.zeros(3)
    hi = jnp.ones(3) * 10
    o = jnp.asarray([[1.0, 1.0, 1.0], [1.01, 1.0, 1.0], [9.0, 9.0, 9.0]])
    d = jnp.asarray([[1.0, 0.0, 0.1], [1.0, 0.0, 0.1], [1.0, 0.0, 0.1]])
    k = np.asarray(ray_sort_keys(o, d, lo, hi))
    assert k[0] == k[1]  # same cell, same octant
    assert k[0] != k[2]  # far cell differs
    d2 = jnp.asarray([[-1.0, 0.0, 0.1]])
    k2 = np.asarray(ray_sort_keys(o[:1], d2, lo, hi))
    assert k2[0] != k[0]  # octant differs

