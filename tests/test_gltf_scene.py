"""GLTF parsing + scene build tests against the in-repo Cornell asset
(SURVEY.md §4: 13 nodes / 9 meshes / 9 materials / 1 point light)."""

import numpy as np
import pytest

from vkrt.scene import (
    FALLBACK_LIGHTS,
    build_scene,
    find_reference_cornell,
    make_cornell_box,
    make_random_soup,
    srgb_to_linear,
)
from vkrt.utils import gltf as gltf_mod

CORNELL = find_reference_cornell()
needs_cornell = pytest.mark.skipif(
    CORNELL is None, reason="the reference's cornell.gltf is not in the checkout"
)


@needs_cornell
def test_cornell_parse_counts():
    doc = gltf_mod.parse_gltf(CORNELL)
    assert len(doc.materials) == 9
    assert len(doc.lights) == 1
    assert doc.lights[0].type == 0  # point
    assert doc.lights[0].intensity == 100
    np.testing.assert_allclose(doc.lights[0].position, [0, 4.5, 0])
    # 10 drawable primitive instances (9 meshes, cube_1 instanced twice)
    assert len(doc.primitives) == 10


@needs_cornell
def test_cornell_scene_arrays(cornell_scene):
    sc = cornell_scene
    assert sc.num_tris % 64 == 0
    v0 = np.asarray(sc.tri_v0)
    # the box spans roughly [-5.05, 5.05]
    assert v0.min() > -6 and v0.max() < 6
    # emissive light panel material present (factor 10,10,10)
    assert np.asarray(sc.mat_emissive).max() == 10.0
    # normals unit length where triangles are real
    n = np.asarray(sc.corner_normal).reshape(-1, 3)
    ln = np.linalg.norm(n, axis=1)
    real = ln > 0.5
    np.testing.assert_allclose(ln[real], 1.0, atol=1e-4)


@needs_cornell
def test_instancing_bakes_world_transforms():
    doc = gltf_mod.parse_gltf(CORNELL)
    # two nodes instance mesh 'cube_1' at y=-5 and y=+5 (floor and ceiling)
    floors = [p for p in doc.primitives if abs(p.world_matrix[1, 3]) == 5.0]
    assert len(floors) == 2


def test_fallback_light_rig():
    """A scene with no KHR lights gets the hardcoded 8-light rig
    (hello_vulkan.cpp:247-321)."""
    soup = make_random_soup(10)
    doc = gltf_mod.GltfDocument(
        primitives=[
            gltf_mod.GltfPrimitiveInstance(
                positions=np.asarray(np.random.default_rng(0).normal(size=(9, 3)), np.float32),
                indices=np.arange(9, dtype=np.uint32),
                normals=None, tangents=None, uvs=None,
                material=0, world_matrix=np.eye(4),
            )
        ],
        materials=[gltf_mod.GltfMaterial(np.ones(4, np.float32))],
        lights=[],
        images=[],
    )
    sc = build_scene(doc)
    assert sc.num_lights == len(FALLBACK_LIGHTS) == 8
    np.testing.assert_allclose(np.asarray(sc.light_intensity), 50.0)
    del soup


def test_srgb_decode_bounds():
    x = np.linspace(0, 1, 64, dtype=np.float32)
    y = srgb_to_linear(x)
    assert y[0] == 0.0
    np.testing.assert_allclose(y[-1], 1.0, atol=1e-6)
    assert (np.diff(y) > 0).all()
    np.testing.assert_allclose(srgb_to_linear(np.float32(0.5)), 0.2140411, atol=1e-4)


def test_procedural_cornell_builds():
    sc = make_cornell_box()
    assert sc.num_tris >= 96
    assert sc.num_lights == 1


def test_png_roundtrip(tmp_path):
    from vkrt.utils.png import decode_png, encode_png

    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (33, 47, 4), np.uint8)
    out = decode_png(encode_png(img))
    np.testing.assert_array_equal(out, img)
    rgb = rng.integers(0, 255, (16, 16, 3), np.uint8)
    out = decode_png(encode_png(rgb))
    np.testing.assert_array_equal(out[..., :3], rgb)
    np.testing.assert_array_equal(out[..., 3], 255)
