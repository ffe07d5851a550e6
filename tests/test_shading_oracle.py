"""The XLA shading stage (models/shading.py, the one shading path) in float32
against the same estimator in float64, on the edge cases the renderer's
material/light tables and bounce loop meet: many materials, many lights, a
pure specular chain, NEE over four bounces.

Equal seeds and equal draws (ops/rng.py emits identical f32 uniforms on both
paths), so the residual is floating-point drift plus the odd lane whose
random walk a rounding flipped onto another branch: bounded as two
populations, like tests/test_accuracy_oracle.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from vkrt.models.pathtracer import pathtrace_frame
from vkrt.models.post import tonemap
from vkrt.ops.trace import make_tracer
from vkrt.scene import make_cornell_box
from vkrt.utils.camera import Camera

W, H = 32, 24


def _edge_scene(n_mats, n_lights, metallic=0.0, roughness=0.6, seed=11):
    """A loose box room plus scattered triangles using exactly ``n_mats``
    materials, lit by ``n_lights`` point lights."""
    import vkrt.utils.gltf as gltf_mod
    from vkrt.scene import _box, scene_from_soup

    rng = np.random.default_rng(seed)
    tris, mat_ids = [], []
    for wall, mid in (
        (((0, 0, -6), (6, 6, 0.3)), 0),
        (((0, -6, 0), (6, 0.3, 6)), 1 % n_mats),
        (((-6, 0, 0), (0.3, 6, 6)), 2 % n_mats),
        (((6, 0, 0), (0.3, 6, 6)), 3 % n_mats),
    ):
        ts = _box(*wall)
        tris.extend(ts)
        mat_ids.extend([mid] * len(ts))
    centers = rng.uniform(-4, 4, (n_mats * 2, 1, 3))
    offs = rng.normal(0, 0.5, (n_mats * 2, 3, 3))
    for k, t in enumerate((centers + offs).astype(np.float32)):
        tris.append(t)
        mat_ids.append(k % n_mats)
    mats = [
        gltf_mod.GltfMaterial(
            np.array([0.2 + 0.8 * (k % 5) / 4, 0.3 + 0.7 * (k % 3) / 2,
                      0.9 - 0.8 * (k % 7) / 6, 1.0], np.float32),
            metallic_factor=metallic, roughness_factor=roughness,
        )
        for k in range(n_mats)
    ]
    lights = [
        gltf_mod.GltfLight(
            rng.uniform(-4, 4, 3).astype(np.float32),
            np.ones(3, np.float32), 40.0 + 10.0 * k, 0,
        )
        for k in range(n_lights)
    ]
    return scene_from_soup(tris, mat_ids, mats, lights)


CASES = {
    # (scene factory, depth, diverged-pixel budget)
    "max_materials": (lambda: _edge_scene(32, 2), 2, 0.01),
    "max_lights": (lambda: _edge_scene(4, 8), 2, 0.01),
    "pure_specular_chain": (
        lambda: _edge_scene(4, 2, metallic=0.99, roughness=0.02), 4, 0.02),
    "nee_depth4": (lambda: make_cornell_box(), 4, 0.02),
}


def _render(scene, dtype, depth):
    cam = jax.tree.map(lambda a: jnp.asarray(a, dtype),
                       Camera().matrices(W, H))
    accum, rays = pathtrace_frame(
        scene, make_tracer(scene, "bruteforce"), cam, 0,
        jnp.zeros((W * H, 3), dtype), jnp.ones(4, dtype), width=W, height=H,
        samples=1, depth=depth, clamp_weights=True,
    )
    return np.asarray(accum, np.float64), float(rays)


@pytest.mark.parametrize("case", list(CASES))
def test_xla_shading_vs_f64_oracle(case):
    make, depth, budget = CASES[case]
    scene = make()
    img32, rays32 = _render(scene, jnp.float32, depth)
    with jax.enable_x64():
        scene64 = jax.tree.map(
            lambda a: jnp.asarray(a, jnp.float64)
            if a.dtype == jnp.float32 else jnp.asarray(a),
            scene,
        )
        img64, _ = _render(scene64, jnp.float64, depth)
    assert np.isfinite(img32).all() and rays32 > 0
    d32 = np.clip(np.asarray(tonemap(jnp.asarray(img32, jnp.float32)),
                             np.float64), 0, 1)
    d64 = np.clip(np.asarray(tonemap(jnp.asarray(img64, jnp.float32)),
                             np.float64), 0, 1)
    err = np.abs(d32 - d64).max(-1)
    diverged = err > 1e-2
    assert diverged.mean() < budget, diverged.mean()
    rmse = float(np.sqrt(np.mean((d32 - d64)[~diverged] ** 2)))
    assert rmse <= 1e-3, rmse
    assert d64.mean() > 0.0
