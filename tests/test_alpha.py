"""Alpha-tested transparency (the reference's unwired any-hit shaders).

Covers the stochastic punch-through re-trace of ops/alpha.py against the
semantics of the reference's raytrace_rahit_todo.glsl:32-38:
transparent materials are skipped with probability 1 - opacity, dissolve==0
always punches through.
"""

import numpy as np
import jax.numpy as jnp

from vkrt.ops.alpha import (
    alpha_closest,
    make_alpha_tracer,
    opacity_at_hit,
    scene_has_alpha,
)
from vkrt.ops.trace import make_tracer
from vkrt.scene import scene_from_soup
from vkrt.utils import gltf as gltf_mod


def _two_quads(front_mat: gltf_mod.GltfMaterial):
    """A front quad (material 1 = ``front_mat``) at z=1 and an opaque back
    quad (material 0) at z=0, both facing +z; rays shot from z=5 down -z."""
    quads = [
        # back quad, opaque white
        ((-2, -2, 0), (2, -2, 0), (2, 2, 0)),
        ((-2, -2, 0), (2, 2, 0), (-2, 2, 0)),
        # front quad
        ((-2, -2, 1), (2, -2, 1), (2, 2, 1)),
        ((-2, -2, 1), (2, 2, 1), (-2, 2, 1)),
    ]
    mats = [
        gltf_mod.GltfMaterial(np.array([1, 1, 1, 1], np.float32), metallic_factor=0.0),
        front_mat,
    ]
    lights = [gltf_mod.GltfLight(np.array([0, 0, 4.0], np.float32),
                                 np.ones(3, np.float32), 50.0, 0)]
    return scene_from_soup(quads, [0, 0, 1, 1], mats, lights)


def _rays(n=64):
    orig = np.zeros((n, 3), np.float32)
    orig[:, 2] = 5.0
    orig[:, 0] = np.linspace(-1.5, 1.5, n)
    d = np.zeros((n, 3), np.float32)
    d[:, 2] = -1.0
    return jnp.asarray(orig), jnp.asarray(d)


def test_opaque_scene_not_wrapped(procedural_cornell):
    assert not scene_has_alpha(procedural_cornell)
    tr = make_tracer(procedural_cornell, "bruteforce")
    assert not hasattr(tr, "with_seed")  # wrapper skipped entirely


def test_opacity_modes():
    front = gltf_mod.GltfMaterial(
        np.array([1, 1, 1, 0.25], np.float32), metallic_factor=0.0,
        alpha_mode=2,
    )
    scene = _two_quads(front)
    assert scene_has_alpha(scene)
    tri = jnp.asarray([0, 2], jnp.int32)  # back (opaque), front (blend .25)
    u = jnp.asarray([0.2, 0.2], jnp.float32)
    v = jnp.asarray([0.2, 0.2], jnp.float32)
    a = np.asarray(opacity_at_hit(scene, tri, u, v))
    np.testing.assert_allclose(a, [1.0, 0.25], atol=1e-6)

    # MASK: alpha .25 under the default .5 cutoff -> opacity 0
    front_mask = gltf_mod.GltfMaterial(
        np.array([1, 1, 1, 0.25], np.float32), metallic_factor=0.0,
        alpha_mode=1,
    )
    scene_m = _two_quads(front_mask)
    a = np.asarray(opacity_at_hit(scene_m, tri, u, v))
    np.testing.assert_allclose(a, [1.0, 0.0], atol=1e-6)


def test_fully_transparent_punches_to_back_quad():
    """alpha=0 BLEND front quad: every ray must land on the back quad with t
    measured from the ORIGINAL origin (rahit dissolve==0 -> always ignore)."""
    front = gltf_mod.GltfMaterial(
        np.array([1, 1, 1, 0.0], np.float32), metallic_factor=0.0, alpha_mode=2,
    )
    scene = _two_quads(front)
    tr = make_tracer(scene, "bruteforce", alpha=True)
    assert hasattr(tr, "with_seed")
    orig, d = _rays()
    hi = tr.closest(orig, d, 1e-3, 100.0)
    assert bool(np.all(np.asarray(hi.hit)))
    # back quad at z=0 -> t = 5 from the original origin
    np.testing.assert_allclose(np.asarray(hi.t), 5.0, atol=1e-3)
    assert bool(np.all(np.asarray(hi.tri) < 2))  # back-quad triangles


def test_two_stacked_transparent_layers():
    """TWO fully-transparent BLEND quads (z=3, z=2) in front of an opaque
    wall (z=0): every ray must punch both layers and land on the wall at
    t=5. Regression for the round-2 double-advance bug, where the second
    round's re-trace origin added the first advance twice and overshot past
    the wall (all rays missed)."""
    clear = gltf_mod.GltfMaterial(
        np.array([1, 1, 1, 0.0], np.float32), metallic_factor=0.0, alpha_mode=2,
    )
    opaque = gltf_mod.GltfMaterial(
        np.array([1, 1, 1, 1], np.float32), metallic_factor=0.0,
    )
    quads = [
        # opaque wall at z=0
        ((-2, -2, 0), (2, -2, 0), (2, 2, 0)),
        ((-2, -2, 0), (2, 2, 0), (-2, 2, 0)),
        # transparent layer at z=2
        ((-2, -2, 2), (2, -2, 2), (2, 2, 2)),
        ((-2, -2, 2), (2, 2, 2), (-2, 2, 2)),
        # transparent layer at z=3
        ((-2, -2, 3), (2, -2, 3), (2, 2, 3)),
        ((-2, -2, 3), (2, 2, 3), (-2, 2, 3)),
    ]
    lights = [gltf_mod.GltfLight(np.array([0, 0, 4.0], np.float32),
                                 np.ones(3, np.float32), 50.0, 0)]
    scene = scene_from_soup(quads, [0, 0, 1, 1, 1, 1], [opaque, clear], lights)
    tr = make_tracer(scene, "bruteforce", alpha=True)
    orig, d = _rays()
    hi = tr.closest(orig, d, 1e-3, 100.0)
    assert bool(np.all(np.asarray(hi.hit)))
    np.testing.assert_allclose(np.asarray(hi.t), 5.0, atol=1e-3)
    assert bool(np.all(np.asarray(hi.tri) < 2))  # wall triangles


def test_opaque_alpha_one_matches_unwrapped():
    """alpha=1 BLEND behaves exactly like an opaque trace (never punches)."""
    front = gltf_mod.GltfMaterial(
        np.array([1, 1, 1, 1.0], np.float32), metallic_factor=0.0, alpha_mode=2,
    )
    scene = _two_quads(front)
    inner = make_tracer(scene, "bruteforce", alpha=True)
    # scene_has_alpha is True (mode 2), so make_tracer wrapped it; compare
    # against the raw inner tracer
    orig, d = _rays()
    hi_a = inner.closest(orig, d, 1e-3, 100.0)
    hi_b = inner.inner.closest(orig, d, 1e-3, 100.0) \
        if hasattr(inner, "inner") else hi_a
    np.testing.assert_allclose(np.asarray(hi_a.t), np.asarray(hi_b.t), atol=1e-6)
    np.testing.assert_array_equal(np.asarray(hi_a.tri), np.asarray(hi_b.tri))
    # front quad at z=1 -> t = 4
    np.testing.assert_allclose(np.asarray(hi_a.t), 4.0, atol=1e-3)


def test_stochastic_punch_rate():
    """alpha=0.3 BLEND: ~30% of rays stop on the front quad, ~70% punch."""
    front = gltf_mod.GltfMaterial(
        np.array([1, 1, 1, 0.3], np.float32), metallic_factor=0.0, alpha_mode=2,
    )
    scene = _two_quads(front)
    tr = make_tracer(scene, "bruteforce", alpha=True)
    n = 4096
    orig = np.zeros((n, 3), np.float32)
    orig[:, 2] = 5.0
    orig[:, 0] = np.linspace(-1.9, 1.9, n)
    d = np.zeros((n, 3), np.float32)
    d[:, 2] = -1.0
    seeds = jnp.arange(n, dtype=jnp.uint32) * jnp.uint32(2654435761)
    hi = tr.with_seed(seeds).closest(jnp.asarray(orig), jnp.asarray(d), 1e-3, 100.0)
    t = np.asarray(hi.t)
    stopped_front = np.isclose(t, 4.0, atol=1e-3)
    punched = np.isclose(t, 5.0, atol=1e-3)
    assert (stopped_front | punched).all()
    rate = stopped_front.mean()
    assert 0.25 < rate < 0.35  # 3-sigma of Binomial(4096, .3) is ~0.021


def test_shadow_through_cutout():
    """A MASK cutout quad between light and floor: shadow rays punch the
    transparent half deterministically — the leaf-texture case, via an
    alpha texture sampled at the hit UV."""
    # texture: left half alpha=0, right half alpha=1
    img = np.full((8, 8, 4), 255, np.uint8)
    img[:, :4, 3] = 0
    images = [gltf_mod.GltfImage(img, "cutout")]
    quads = [
        ((-2, -2, 1), (2, -2, 1), (2, 2, 1)),
        ((-2, -2, 1), (2, 2, 1), (-2, 2, 1)),
    ]
    # UVs spanning the quad: u 0..1 left->right
    uvs = np.array(
        [((0, 0), (1, 0), (1, 1)), ((0, 0), (1, 1), (0, 1))], np.float32
    )
    mat = gltf_mod.GltfMaterial(
        np.array([1, 1, 1, 1], np.float32), base_color_texture=0,
        metallic_factor=0.0, alpha_mode=1, alpha_cutoff=0.5,
    )
    lights = [gltf_mod.GltfLight(np.array([0, 0, 4.0], np.float32),
                                 np.ones(3, np.float32), 50.0, 0)]
    scene = scene_from_soup(quads, [0, 0], [mat], lights, images=images, uvs=uvs)
    tr = make_tracer(scene, "bruteforce", alpha=True)

    # visibility probes from z=0 straight up at +z toward the light: x<0
    # hits the transparent half (u<0.5) -> visible; x>0 is blocked
    n = 32
    orig = np.zeros((n, 3), np.float32)
    orig[:, 0] = np.linspace(-1.8, 1.8, n)
    d = np.zeros((n, 3), np.float32)
    d[:, 2] = 1.0
    blocked = np.asarray(tr.any(jnp.asarray(orig), jnp.asarray(d), 1e-3, 10.0))
    x = orig[:, 0]
    assert not blocked[x < -0.2].any()
    assert blocked[x > 0.2].all()


def test_pathtrace_frame_runs_with_alpha():
    """End-to-end: pathtrace_frame over a scene with a transparent quad
    produces finite radiance (the punch-through loop jits inside the frame)."""
    from vkrt.models.pathtracer import pathtrace_frame
    from vkrt.utils.camera import Camera

    front = gltf_mod.GltfMaterial(
        np.array([1, 1, 1, 0.5], np.float32), metallic_factor=0.0, alpha_mode=2,
    )
    scene = _two_quads(front)
    tr = make_tracer(scene, "bruteforce", alpha=True)
    w, h = 16, 12
    cam = Camera(eye=np.array([0, 0, 5.0]), center=np.zeros(3),
                 up=np.array([0, 1, 0.0])).matrices(w, h)
    accum, rays = pathtrace_frame(
        scene, tr, cam, 0, jnp.zeros((w * h, 3), jnp.float32),
        jnp.ones(4, jnp.float32), width=w, height=h, samples=1, depth=2,
    )
    a = np.asarray(accum)
    assert np.isfinite(a).all()
    assert float(rays) > 0
