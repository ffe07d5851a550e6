"""Instance layer: re-pose a node by splicing its re-baked triangles.

The capability match is the reference's TLAS update on node movement
(createTopLevelAsGltf, hello_vulkan.cpp:1031-1047): after a move, every
backend's rebound structure must trace identically to a from-scratch build
of the moved geometry.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from vkrt.scene_instances import build_instanced, repose, repose_tracer
from vkrt.ops.trace import make_tracer
from vkrt.utils import gltf as gltf_mod


def _cube(center, half=1.0):
    c = np.asarray(center, np.float64)
    p = np.array(
        [[-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
         [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]], np.float32
    ) * half
    quads = [(4, 5, 6, 7), (1, 0, 3, 2), (5, 1, 2, 6),
             (0, 4, 7, 3), (7, 6, 2, 3), (0, 1, 5, 4)]
    idx = []
    for a, b, cq, d in quads:
        idx += [a, b, cq, a, cq, d]
    m = np.eye(4)
    m[:3, 3] = c
    return gltf_mod.GltfPrimitiveInstance(
        positions=p, indices=np.asarray(idx, np.uint32), normals=None,
        tangents=None, uvs=None, material=0, world_matrix=m,
    )


def _doc():
    mats = [gltf_mod.GltfMaterial(np.array([0.8, 0.8, 0.8, 1], np.float32),
                                  metallic_factor=0.0)]
    lights = [gltf_mod.GltfLight(np.array([0, 8, 0.0], np.float32),
                                 np.ones(3, np.float32), 60.0, 0)]
    return gltf_mod.GltfDocument(
        primitives=[_cube((-3, 0, 0)), _cube((3, 0, 0))],
        materials=mats, lights=lights, images=[],
    )


def _probe_rays(n=256):
    rng = np.random.default_rng(7)
    orig = np.zeros((n, 3), np.float32)
    orig[:, 2] = 12.0
    orig[:, 0] = rng.uniform(-7, 7, n)
    orig[:, 1] = rng.uniform(-3, 3, n)
    d = np.zeros((n, 3), np.float32)
    d[:, 2] = -1.0
    return jnp.asarray(orig), jnp.asarray(d)


def _translate(x, y, z):
    m = np.eye(4)
    m[:3, 3] = (x, y, z)
    return m


def test_repose_matches_fresh_build():
    """repose() splices exactly what a from-scratch bake produces."""
    inst = build_instanced(_doc())
    inst2, moved = repose(inst, 1, _translate(3, 2.5, 0))

    doc_fresh = _doc()
    doc_fresh.primitives[1].world_matrix = _translate(3, 2.5, 0)
    fresh = build_instanced(doc_fresh).scene

    for name in ("tri_v0", "tri_e1", "tri_e2", "corner_normal",
                 "corner_tangent", "tri_uv_density"):
        np.testing.assert_allclose(
            np.asarray(getattr(inst2.scene, name)),
            np.asarray(getattr(fresh, name)), atol=1e-6,
            err_msg=name,
        )
    s, e = inst.prim_ranges[1]
    assert moved[s:e].all() and not moved[:s].any()


def test_repose_oracle_tracer_sees_move():
    inst = build_instanced(_doc())
    tr = make_tracer(inst.scene, "bruteforce")
    o, d = _probe_rays()
    before = tr.closest(o, d, 1e-3, 100.0)

    inst2, moved = repose(inst, 1, _translate(3, 0, -6))
    tr2 = repose_tracer(tr, inst2, moved)
    after = tr2.closest(o, d, 1e-3, 100.0)

    # the moved cube's front face goes z=1 -> z=-5; from origin z=12 the
    # hit distance becomes 17 (was 11)
    x = np.asarray(o)[:, 0]
    y = np.asarray(o)[:, 1]
    sel = (np.abs(x - 3) < 0.8) & (np.abs(y) < 0.8)
    assert np.asarray(before.hit)[sel].all()
    assert np.asarray(after.hit)[sel].all()
    np.testing.assert_allclose(np.asarray(before.t)[sel], 11.0, atol=1e-3)
    np.testing.assert_allclose(np.asarray(after.t)[sel], 17.0, atol=1e-3)
    # the static cube is untouched
    sel0 = (np.abs(x + 3) < 0.8) & (np.abs(y) < 0.8)
    np.testing.assert_allclose(
        np.asarray(after.t)[sel0], np.asarray(before.t)[sel0], atol=1e-6
    )


@pytest.mark.parametrize("backend", ["bvh", "kernel"])
def test_repose_tracer_traces_like_oracle(backend):
    """A re-posed BVH-backed tracer (the plain walk, and the traversal
    kernel through the Pallas interpreter) keeps its backend and traces
    the moved geometry like brute force."""
    from vkrt.ops.trace import build_tracer

    inst = build_instanced(_doc())
    sc = inst.scene
    tr = build_tracer(sc.tri_v0, sc.tri_e1, sc.tri_e2, backend,
                      interpret=True)

    inst2, moved = repose(inst, 0, _translate(-3, -1, -4))
    tr2 = repose_tracer(tr, inst2, moved)
    assert (tr2.tables is not None) == (backend == "kernel")
    assert tr2.interpret == tr.interpret
    bf = make_tracer(inst2.scene, "bruteforce")

    o, d = _probe_rays(128)
    ref = bf.closest(o, d, 1e-3, 100.0)
    got = tr2.closest(o, d, 1e-3, 100.0)
    np.testing.assert_array_equal(np.asarray(got.hit), np.asarray(ref.hit))
    h = np.asarray(ref.hit)
    np.testing.assert_allclose(
        np.asarray(got.t)[h], np.asarray(ref.t)[h], rtol=1e-5, atol=1e-5
    )
    # the moved-triangle mask covers exactly the moved primitive's range
    s, e = inst.prim_ranges[0]
    assert moved[s:e].all() and moved.sum() == e - s


def test_engine_set_node_transform():
    """End-to-end: move a node through the Engine and the image changes where
    (and only where) the node moved."""
    from vkrt.config import RenderSettings
    from vkrt.engine import Engine
    from vkrt.utils.camera import Camera

    inst = build_instanced(_doc())
    cam = Camera(eye=np.array([0, 0, 12.0]), center=np.zeros(3),
                 up=np.array([0, 1, 0.0]))
    e = Engine(inst, 48, 32, RenderSettings(rt_mode=1, samples=1, depth=1,
                                            backend="bruteforce"), cam)
    img_before = np.asarray(e.render_frame()).reshape(32, 48, 3)

    e.set_node_transform(1, _translate(3, 0, -40))  # move right cube far away
    assert e.frame == -1  # accumulation restarted
    img_after = np.asarray(e.render_frame()).reshape(32, 48, 3)

    # left half (static cube) identical; right half changed
    np.testing.assert_allclose(
        img_after[:, :20], img_before[:, :20], atol=1e-6
    )
    assert np.abs(img_after[:, 28:] - img_before[:, 28:]).max() > 1e-3
