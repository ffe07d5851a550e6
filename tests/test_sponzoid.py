"""Sponzoid: the generated Sponza-LAYOUT disk asset.

The suite's config 8 renders this asset at scale; here the small (tess=1)
variant drives the identical loader-to-image path: .gltf + external .bin
+ external PNG texture URIs -> parse_gltf -> build_scene -> Engine,
asserting the properties the Sponza asset class exercises (multiple
textured materials, tangent-carrying normal mapping, KHR lights).
Reference stack: tinygltf + stb_image loading, hello_vulkan.cpp:445-513.
"""

import numpy as np

from vkrt.config import RenderSettings
from vkrt.engine import Engine
from vkrt.utils.camera import Camera
from vkrt.utils.gltf import parse_gltf
from vkrt.utils.sponzoid import load_sponzoid, write_sponzoid


def test_sponzoid_asset_layout(tmp_path):
    path = write_sponzoid(str(tmp_path), tess=1)
    doc = parse_gltf(path)
    assert len(doc.primitives) == 4          # one per material
    assert len(doc.materials) == 4
    assert len(doc.lights) == 5              # KHR point rig
    assert len(doc.images) == 6              # 4 base color + 2 normal maps
    # every image decoded from its external URI (not a placeholder)
    for im in doc.images:
        assert im.data.shape[0] >= 256 and im.data.shape[-1] == 4
    # tangents present on every primitive
    for pr in doc.primitives:
        assert pr.tangents is not None
        assert np.abs(pr.tangents[:, :3]).max() > 0.9
    ntris = sum(len(pr.indices) // 3 for pr in doc.primitives)
    assert ntris > 20_000


def test_sponzoid_render_smoke(tmp_path):
    scene = load_sponzoid(str(tmp_path), tess=1)
    assert scene.num_tris > 20_000
    assert scene.num_lights == 5
    # normal maps wired: stone floor (mat 0) and brick (mat 2)
    assert int(scene.mat_normal_tex[0]) >= 0
    assert int(scene.mat_normal_tex[2]) >= 0
    cam = Camera(eye=np.array([0.0, 6.0, 26.0]),
                 center=np.array([0.0, 5.0, 0.0]),
                 up=np.array([0.0, 1.0, 0.0]))
    eng = Engine(scene, 64, 36, RenderSettings(rt_mode=0, use_gi=False), cam)
    img = np.asarray(eng.render(frames=1), np.float32)
    assert np.isfinite(img).all()
    assert img.max() > 0.0
    # the hall shows texture/material variation, not a flat fill
    assert img[8:28, 8:56].std() > 10.0
    # load_sponzoid caches: second call must reuse the on-disk asset
    scene2 = load_sponzoid(str(tmp_path), tess=1)
    assert scene2.num_tris == scene.num_tris
