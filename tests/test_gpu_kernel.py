"""The traversal kernel compiled for the card (Triton route), not the
interpreter: parity with the brute-force reference and a rendered frame.
Marked ``gpu``: skips unless the default device is a GPU."""

import numpy as np
import jax.numpy as jnp
import pytest

from vkrt.ops.trace import make_tracer
from vkrt.scene import make_cornell_box, make_random_soup


@pytest.mark.gpu
@pytest.mark.parametrize("query", ["closest", "any"])
def test_compiled_kernel_matches_bruteforce(gpu, query, rng):
    scene = make_random_soup(2000, seed=5)
    kernel = make_tracer(scene, "kernel")
    ref = make_tracer(scene, "bruteforce")
    assert kernel.tables is not None and not kernel.interpret
    n = 5000
    o = jnp.asarray(rng.normal(size=(n, 3)) * 1.5, jnp.float32)
    d = rng.normal(size=(n, 3))
    d = jnp.asarray(d / np.linalg.norm(d, axis=1, keepdims=True), jnp.float32)
    lim = jnp.asarray(rng.uniform(0.3, 4.0, size=n), jnp.float32)
    if query == "any":
        np.testing.assert_array_equal(np.asarray(kernel.any(o, d, 1e-3, lim)),
                                      np.asarray(ref.any(o, d, 1e-3, lim)))
        return
    a = kernel.closest(o, d, 1e-3, 1e4, t_lim=lim)
    b = ref.closest(o, d, 1e-3, 1e4, t_lim=lim)
    h = np.asarray(b.hit)
    assert (np.asarray(a.hit) == h).mean() > 0.999
    both = h & np.asarray(a.hit)
    np.testing.assert_allclose(np.asarray(a.t)[both], np.asarray(b.t)[both],
                               rtol=1e-4)


@pytest.mark.gpu
def test_engine_frame_on_gpu(gpu):
    from vkrt.config import RenderSettings
    from vkrt.engine import Engine

    eng = Engine(make_cornell_box(), 320, 240, RenderSettings(rt_mode=1))
    assert eng.tracer.tables is not None  # auto picks the kernel on a GPU
    img = np.asarray(eng.render_frame())
    assert np.isfinite(img).all() and img.max() > 0
