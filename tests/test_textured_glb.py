"""End-to-end textured-asset golden.

Builds a REAL binary .glb in-test — embedded PNG baseColor + normal-map
images, TANGENT attributes, KHR_lights_punctual — and drives the full
pipeline file -> parse_gltf (GLB branch, PNG decode) -> build_scene (sRGB,
mip atlas, tangent bake) -> render (texture fetch + TBN normal mapping) in
both modes. The reference exercises this stack via Sponza-class assets
(createTextureImages, hello_vulkan.cpp:445-513); cornell.gltf has no
textures, so this is the coverage for real textured assets.
"""

import json
import os
import struct

import numpy as np
import jax.numpy as jnp

from vkrt.utils.gltf import parse_gltf
from vkrt.utils.png import encode_png
from vkrt.scene import build_scene
from vkrt.config import RenderSettings
from vkrt.engine import Engine
from vkrt.utils.camera import Camera


def _checker_png(n=16):
    img = np.zeros((n, n, 4), np.uint8)
    t = (np.arange(n)[:, None] // 4 + np.arange(n)[None, :] // 4) % 2
    img[..., 0] = np.where(t, 220, 40)
    img[..., 1] = np.where(t, 60, 180)
    img[..., 2] = 40
    img[..., 3] = 255
    return encode_png(img)


def _normalmap_png(n=16):
    """Diagonal-ramp tangent-space normal map (non-trivial xy)."""
    img = np.zeros((n, n, 4), np.uint8)
    xs = np.linspace(-0.4, 0.4, n, dtype=np.float32)
    nx = np.broadcast_to(xs[None, :], (n, n))
    ny = np.broadcast_to(xs[:, None], (n, n))
    nz = np.sqrt(1.0 - nx**2 - ny**2)
    img[..., 0] = ((nx * 0.5 + 0.5) * 255).astype(np.uint8)
    img[..., 1] = ((ny * 0.5 + 0.5) * 255).astype(np.uint8)
    img[..., 2] = ((nz * 0.5 + 0.5) * 255).astype(np.uint8)
    img[..., 3] = 255
    return encode_png(img)


def _build_glb(path):
    """A quad (2 tris) facing +z with full attributes + 2 textures."""
    positions = np.array(
        [[-2, -2, 0], [2, -2, 0], [2, 2, 0], [-2, 2, 0]], np.float32
    )
    normals = np.array([[0, 0, 1]] * 4, np.float32)
    tangents = np.array([[1, 0, 0, 1]] * 4, np.float32)
    uvs = np.array([[0, 1], [1, 1], [1, 0], [0, 0]], np.float32)
    indices = np.array([0, 1, 2, 0, 2, 3], np.uint16)

    base_png = _checker_png()
    nrm_png = _normalmap_png()

    def pad4(b, fill=b"\x00"):
        return b + fill * ((4 - len(b) % 4) % 4)

    bin_parts, views, offset = [], [], 0

    def add_view(data: bytes):
        nonlocal offset
        data = pad4(data)
        views.append({"buffer": 0, "byteOffset": offset, "byteLength": len(data)})
        bin_parts.append(data)
        offset += len(data)
        return len(views) - 1

    v_pos = add_view(positions.tobytes())
    v_nrm = add_view(normals.tobytes())
    v_tan = add_view(tangents.tobytes())
    v_uv = add_view(uvs.tobytes())
    v_idx = add_view(indices.tobytes())
    v_base = add_view(base_png)
    v_nmap = add_view(nrm_png)

    doc = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": [0, 1]}],
        "nodes": [
            {"mesh": 0},
            {
                "extensions": {"KHR_lights_punctual": {"light": 0}},
                "translation": [0.0, 0.0, 4.0],
            },
        ],
        "extensions": {
            "KHR_lights_punctual": {
                "lights": [{"type": "point", "color": [1, 1, 1], "intensity": 60.0}]
            }
        },
        "extensionsUsed": ["KHR_lights_punctual"],
        "meshes": [{
            "primitives": [{
                "attributes": {"POSITION": 0, "NORMAL": 1, "TANGENT": 2,
                               "TEXCOORD_0": 3},
                "indices": 4,
                "material": 0,
            }]
        }],
        "accessors": [
            {"bufferView": v_pos, "componentType": 5126, "count": 4,
             "type": "VEC3", "min": [-2, -2, 0], "max": [2, 2, 0]},
            {"bufferView": v_nrm, "componentType": 5126, "count": 4, "type": "VEC3"},
            {"bufferView": v_tan, "componentType": 5126, "count": 4, "type": "VEC4"},
            {"bufferView": v_uv, "componentType": 5126, "count": 4, "type": "VEC2"},
            {"bufferView": v_idx, "componentType": 5123, "count": 6, "type": "SCALAR"},
        ],
        "bufferViews": views,
        "buffers": [{"byteLength": offset}],
        "images": [
            {"bufferView": v_base, "mimeType": "image/png", "name": "base"},
            {"bufferView": v_nmap, "mimeType": "image/png", "name": "nrm"},
        ],
        "samplers": [{}],
        "textures": [{"source": 0, "sampler": 0}, {"source": 1, "sampler": 0}],
        "materials": [{
            "pbrMetallicRoughness": {
                "baseColorTexture": {"index": 0},
                "metallicFactor": 0.0,
                "roughnessFactor": 0.9,
            },
            "normalTexture": {"index": 1},
        }],
    }
    js = pad4(json.dumps(doc).encode(), b" ")
    bin_blob = b"".join(bin_parts)
    total = 12 + 8 + len(js) + 8 + len(bin_blob)
    with open(path, "wb") as f:
        f.write(struct.pack("<4sII", b"glTF", 2, total))
        f.write(struct.pack("<I4s", len(js), b"JSON"))
        f.write(js)
        f.write(struct.pack("<I4s", len(bin_blob), b"BIN\x00"))
        f.write(bin_blob)


def _scene(tmp_path):
    p = os.path.join(str(tmp_path), "tex.glb")
    _build_glb(p)
    return build_scene(parse_gltf(p))


def test_glb_textures_decoded(tmp_path):
    scene = _scene(tmp_path)
    assert scene.num_tris >= 2
    assert scene.tex_rgba.shape[0] == 2           # both images decoded
    assert int(scene.tex_size[0, 0]) == 16
    assert int(scene.mat_base_tex[0]) == 0
    assert int(scene.mat_normal_tex[0]) == 1
    # sRGB applied to baseColor but NOT the normal map: the normal map's
    # stored 0.5 must round-trip to ~0.5 linear
    k_n = int(scene.mat_normal_tex[0])
    mid = float(scene.tex_rgba[k_n, 8, 8, 2])
    assert 0.75 < mid <= 1.0  # nz close to 1 encoded ~.97; linear-kept
    # tangents survived into per-corner storage
    assert float(jnp.abs(scene.corner_tangent[0, :, 0]).max()) > 0.9


def test_textured_render_golden(tmp_path):
    """Hybrid + path renders of the textured quad: deterministic, and the
    checker must show (distinct colors across the face)."""
    scene = _scene(tmp_path)
    cam = Camera(eye=np.array([0, 0, 6.0]), center=np.zeros(3),
                 up=np.array([0, 1, 0.0]))
    imgs = {}
    for name, settings in (
        ("hybrid", RenderSettings(rt_mode=0, use_gi=False)),
        ("path", RenderSettings(rt_mode=1, samples=1, depth=2)),
    ):
        e = Engine(scene, 48, 36, settings, cam)
        img = e.render(frames=2)
        imgs[name] = img
        a = np.asarray(img, np.float32)
        assert np.isfinite(a).all()
        # the checker produces at least two clearly distinct face colors
        center = a[10:26, 14:34]
        assert center.std() > 10.0, f"{name}: no texture variation visible"

    # determinism anchor: same render twice = same bytes
    e2 = Engine(scene, 48, 36, RenderSettings(rt_mode=1, samples=1, depth=2), cam)
    again = e2.render(frames=2)
    np.testing.assert_array_equal(imgs["path"], again)


def test_jpeg_external_texture_sponza_layout(tmp_path):
    """Sponza ships as .gltf + external .bin + external JPEG textures
    (the reference loads them through stb_image, hello_vulkan.cpp:445-513).
    Build that exact layout in-test: a .gltf JSON referencing a relative
    ``textures/base.jpg`` URI, decode (PIL JPEG branch of
    gltf._decode_image), and render through the CLI-equivalent path."""
    import io

    from PIL import Image

    # a red/blue checker as JPEG (lossy: assert colors approximately)
    n = 32
    t = (np.arange(n)[:, None] // 8 + np.arange(n)[None, :] // 8) % 2
    rgb = np.zeros((n, n, 3), np.uint8)
    rgb[..., 0] = np.where(t, 210, 30)
    rgb[..., 2] = np.where(t, 40, 200)
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, format="JPEG", quality=92)
    os.makedirs(os.path.join(str(tmp_path), "textures"))
    jpg_rel = os.path.join("textures", "base.jpg")
    with open(os.path.join(str(tmp_path), jpg_rel), "wb") as f:
        f.write(buf.getvalue())

    positions = np.array(
        [[-2, -2, 0], [2, -2, 0], [2, 2, 0], [-2, 2, 0]], np.float32
    )
    uvs = np.array([[0, 1], [1, 1], [1, 0], [0, 0]], np.float32)
    indices = np.array([0, 1, 2, 0, 2, 3], np.uint16)
    bin_blob = positions.tobytes() + uvs.tobytes() + indices.tobytes()
    with open(os.path.join(str(tmp_path), "scene.bin"), "wb") as f:
        f.write(bin_blob)
    doc = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{
            "attributes": {"POSITION": 0, "TEXCOORD_0": 1},
            "indices": 2, "material": 0,
        }]}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 4,
             "type": "VEC3", "min": [-2, -2, 0], "max": [2, 2, 0]},
            {"bufferView": 1, "componentType": 5126, "count": 4,
             "type": "VEC2"},
            {"bufferView": 2, "componentType": 5123, "count": 6,
             "type": "SCALAR"},
        ],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": positions.nbytes},
            {"buffer": 0, "byteOffset": positions.nbytes,
             "byteLength": uvs.nbytes},
            {"buffer": 0, "byteOffset": positions.nbytes + uvs.nbytes,
             "byteLength": indices.nbytes},
        ],
        "buffers": [{"uri": "scene.bin", "byteLength": len(bin_blob)}],
        "images": [{"uri": jpg_rel.replace(os.sep, "/"), "name": "base"}],
        "samplers": [{}],
        "textures": [{"source": 0, "sampler": 0}],
        "materials": [{"pbrMetallicRoughness": {
            "baseColorTexture": {"index": 0},
            "metallicFactor": 0.0, "roughnessFactor": 0.9,
        }}],
    }
    gltf_path = os.path.join(str(tmp_path), "scene.gltf")
    with open(gltf_path, "w") as f:
        json.dump(doc, f)

    parsed = parse_gltf(gltf_path)
    assert parsed.images[0].data.shape == (n, n, 4)
    # JPEG decoded (not the 1x1 white placeholder): both checker colors
    # present, within lossy tolerance, alpha opaque
    px = parsed.images[0].data.astype(np.int32)
    assert abs(int(px[4, 4, 2]) - 200) < 30   # blue cell
    assert abs(int(px[4, 12, 0]) - 210) < 30  # red cell
    assert (px[..., 3] == 255).all()

    scene = build_scene(parsed)
    cam = Camera(eye=np.array([0, 0, 6.0]), center=np.zeros(3),
                 up=np.array([0, 1, 0.0]))
    e = Engine(scene, 48, 36, RenderSettings(rt_mode=0, use_gi=False), cam)
    img = np.asarray(e.render(frames=1), np.float32)
    assert np.isfinite(img).all()
    center = img[10:26, 14:34]
    assert center.std() > 10.0, "JPEG texture not visible in render"


def test_normal_map_changes_shading(tmp_path):
    """With the ramp normal map, shading must differ from a flat-normal
    render of the same geometry (TBN path actually perturbs normals)."""
    p = os.path.join(str(tmp_path), "tex.glb")
    _build_glb(p)
    doc = parse_gltf(p)
    scene_nm = build_scene(doc)
    # strip the normal map
    doc.materials[0].normal_texture = -1
    scene_flat = build_scene(doc)

    cam = Camera(eye=np.array([0, 0, 6.0]), center=np.zeros(3),
                 up=np.array([0, 1, 0.0]))
    s = RenderSettings(rt_mode=0, use_gi=False)
    img_nm = np.asarray(Engine(scene_nm, 48, 36, s, cam).render(frames=1), np.float32)
    img_flat = np.asarray(Engine(scene_flat, 48, 36, s, cam).render(frames=1), np.float32)
    assert np.abs(img_nm - img_flat).max() > 2.0
