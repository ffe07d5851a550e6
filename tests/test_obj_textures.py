"""OBJ loader parity + texture sampling path tests."""

import numpy as np
import jax.numpy as jnp
import pytest

from vkrt.ops.texture import build_mip_pyramid, sample_texture
from vkrt.utils.obj import load_obj_scene, parse_obj

OBJ = """
mtllib test.mtl
v 0 0 0
v 1 0 0
v 0 1 0
v 1 1 0
vn 0 0 1
vt 0 0
vt 1 0
vt 0 1
usemtl red
f 1/1/1 2/2/1 3/3/1
usemtl blue
f -3/-3/-1 -2/-2/-1 -1/-1/-1
f 1 2 4 3
"""

MTL = """
newmtl red
Kd 1 0 0
Ns 50
newmtl blue
Kd 0 0 1
Ke 0.5 0.5 0.5
"""


def _write(tmp_path):
    (tmp_path / "test.mtl").write_text(MTL)
    p = tmp_path / "scene.obj"
    p.write_text(OBJ)
    return str(p)


def test_obj_parse(tmp_path):
    doc = parse_obj(_write(tmp_path))
    prim = doc.primitives[0]
    # 2 single triangles + 1 quad fan-triangulated into 2 = 4 tris
    assert len(prim.indices) == 4 * 3
    assert len(doc.materials) == 2
    np.testing.assert_allclose(doc.materials[0].base_color_factor[:3], [1, 0, 0])
    np.testing.assert_allclose(doc.materials[1].emissive_factor, 0.5)


def test_obj_scene_build(tmp_path):
    sc = load_obj_scene(_write(tmp_path))
    assert sc.num_tris % 64 == 0
    mats = np.asarray(sc.tri_mat[:4])
    assert mats[0] == 0 and mats[1] == 1  # per-face materials
    # fallback light rig injected (no lights in OBJ)
    assert sc.num_lights == 8


def test_bilinear_sampling_exact_texels():
    # 2x2 texture: distinct corner colors; sampling at texel centers
    tex = np.zeros((1, 2, 2, 4), np.float32)
    tex[0, 0, 0] = [1, 0, 0, 1]
    tex[0, 0, 1] = [0, 1, 0, 1]
    tex[0, 1, 0] = [0, 0, 1, 1]
    tex[0, 1, 1] = [1, 1, 0, 1]
    size = jnp.asarray([[2, 2]], jnp.int32)
    uv = jnp.asarray([[0.25, 0.25], [0.75, 0.25], [0.25, 0.75], [0.75, 0.75]])
    idx = jnp.zeros(4, jnp.int32)
    out = np.asarray(sample_texture(jnp.asarray(tex), size, idx, uv))
    np.testing.assert_allclose(out[0], [1, 0, 0, 1], atol=1e-6)
    np.testing.assert_allclose(out[1], [0, 1, 0, 1], atol=1e-6)
    np.testing.assert_allclose(out[2], [0, 0, 1, 1], atol=1e-6)
    np.testing.assert_allclose(out[3], [1, 1, 0, 1], atol=1e-6)


def test_bilinear_interpolates_and_wraps():
    tex = np.zeros((1, 1, 2, 4), np.float32)
    tex[0, 0, 0] = [0, 0, 0, 1]
    tex[0, 0, 1] = [1, 1, 1, 1]
    size = jnp.asarray([[2, 1]], jnp.int32)
    mid = np.asarray(
        sample_texture(jnp.asarray(tex), size, jnp.zeros(1, jnp.int32),
                       jnp.asarray([[0.5, 0.5]]))
    )
    np.testing.assert_allclose(mid[0, :3], 0.5, atol=1e-6)
    # u wraps: uv 1.25 == 0.25
    a = sample_texture(jnp.asarray(tex), size, jnp.zeros(1, jnp.int32),
                       jnp.asarray([[1.25, 0.5]]))
    b = sample_texture(jnp.asarray(tex), size, jnp.zeros(1, jnp.int32),
                       jnp.asarray([[0.25, 0.5]]))
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)


def test_missing_texture_returns_white():
    tex = jnp.zeros((1, 1, 1, 4))
    size = jnp.asarray([[1, 1]], jnp.int32)
    out = np.asarray(
        sample_texture(tex, size, jnp.asarray([-1]), jnp.asarray([[0.3, 0.7]]))
    )
    np.testing.assert_allclose(out, 1.0)


def test_mip_pyramid():
    img = np.random.default_rng(0).random((8, 4, 4)).astype(np.float32)
    levels = build_mip_pyramid(img)
    assert [l.shape[:2] for l in levels] == [(8, 4), (4, 2), (2, 1), (1, 1)]
    np.testing.assert_allclose(levels[-1][0, 0], img.mean(axis=(0, 1)), rtol=1e-5)


def test_textured_scene_renders():
    """End-to-end: a textured quad lights up with the texture's color."""
    import jax.numpy as jnp

    from vkrt.scene import build_scene
    from vkrt.utils import gltf as gltf_mod
    from vkrt.config import RenderSettings
    from vkrt.engine import Engine
    from vkrt.utils.camera import Camera

    # checkerboard texture
    img = np.zeros((8, 8, 4), np.uint8)
    img[::2, ::2] = [255, 0, 0, 255]
    img[1::2, 1::2] = [255, 0, 0, 255]
    img[img[..., 3] == 0] = [0, 255, 0, 255]
    quad = np.asarray(
        [[-2, -2, 0], [2, -2, 0], [2, 2, 0], [-2, 2, 0]], np.float32
    )
    doc = gltf_mod.GltfDocument(
        primitives=[
            gltf_mod.GltfPrimitiveInstance(
                positions=quad,
                indices=np.asarray([0, 1, 2, 0, 2, 3], np.uint32),
                normals=np.tile([0, 0, 1.0], (4, 1)).astype(np.float32),
                tangents=None,
                uvs=np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32),
                material=0,
                world_matrix=np.eye(4),
            )
        ],
        materials=[
            gltf_mod.GltfMaterial(
                base_color_factor=np.ones(4, np.float32),
                base_color_texture=0,
                metallic_factor=0.0,
            )
        ],
        lights=[
            gltf_mod.GltfLight(np.asarray([0, 0, 5.0], np.float32),
                               np.ones(3, np.float32), 50.0, 0)
        ],
        images=[gltf_mod.GltfImage(img)],
    )
    scene = build_scene(doc)
    e = Engine(scene, 32, 32, RenderSettings(rt_mode=0, use_ao=False),
               Camera(eye=(0, 0, 6)))
    out = np.asarray(e.render_frame()).reshape(32, 32, 3)
    center = out[8:24, 8:24]
    assert center[..., 0].max() > 0.05  # red squares lit
    assert center[..., 1].max() > 0.05  # green squares lit
    # red and green dominate their own squares (texture actually sampled)
    assert (center[..., 0] > center[..., 1]).any()
    assert (center[..., 1] > center[..., 0]).any()


def test_mip_atlas_pack_and_lod_sampling():
    from vkrt.ops.texture import pack_mip_atlas, sample_texture_lod

    # 8x8 texture: level0 checker, coarser levels converge to gray
    img = np.zeros((8, 8, 4), np.uint8)
    img[::2, ::2] = 255
    img[1::2, 1::2] = 255
    img[..., 3] = 255
    atlas, lsize, loff, nlev = pack_mip_atlas([img])
    assert nlev[0] == 4  # 8 -> 4 -> 2 -> 1
    assert tuple(lsize[0, 0]) == (8, 8) and tuple(lsize[0, 3]) == (1, 1)

    uv = jnp.asarray([[0.31, 0.77]])
    idx = jnp.zeros(1, jnp.int32)
    args = (jnp.asarray(atlas), jnp.asarray(lsize), jnp.asarray(loff),
            jnp.asarray(nlev), idx, uv)
    # highest level = overall mean (~0.5 for a checker, 1.0 alpha)
    top = np.asarray(sample_texture_lod(*args, jnp.asarray([10.0])))
    np.testing.assert_allclose(top[0, :3], 0.5, atol=0.02)
    # level 0 equals the plain bilinear sampler
    from vkrt.ops.texture import sample_texture

    lvl0 = np.asarray(sample_texture_lod(*args, jnp.asarray([0.0])))
    plain = np.asarray(sample_texture(
        jnp.asarray(img[None].astype(np.float32) / 255.0),
        jnp.asarray([[8, 8]], jnp.int32), idx, uv,
    ))
    np.testing.assert_allclose(lvl0, plain, atol=1e-5)
    # fractional lod sits between its neighbors
    l15 = np.asarray(sample_texture_lod(*args, jnp.asarray([1.5])))
    l1 = np.asarray(sample_texture_lod(*args, jnp.asarray([1.0])))
    l2 = np.asarray(sample_texture_lod(*args, jnp.asarray([2.0])))
    assert ((np.minimum(l1, l2) - 1e-5 <= l15) & (l15 <= np.maximum(l1, l2) + 1e-5)).all()
    # missing texture stays white
    white = np.asarray(sample_texture_lod(
        *args[:4], jnp.asarray([-1]), uv, jnp.asarray([2.0])))
    np.testing.assert_allclose(white, 1.0)


def test_gbuffer_uses_mips_for_distant_surfaces():
    """A checkerboard quad seen at distance must sample a coarse mip in the
    G-buffer (gray), while a close-up view keeps the checker contrast."""
    import jax.numpy as jnp

    from vkrt.scene import build_scene
    from vkrt.utils import gltf as gltf_mod
    from vkrt.config import RenderSettings
    from vkrt.engine import Engine
    from vkrt.utils.camera import Camera

    img = np.zeros((64, 64, 4), np.uint8)
    img[::2, ::2] = 255
    img[1::2, 1::2] = 255
    img[..., 3] = 255
    quad = np.asarray([[-4, -4, 0], [4, -4, 0], [4, 4, 0], [-4, 4, 0]], np.float32)
    doc = gltf_mod.GltfDocument(
        primitives=[gltf_mod.GltfPrimitiveInstance(
            positions=quad, indices=np.asarray([0, 1, 2, 0, 2, 3], np.uint32),
            normals=np.tile([0, 0, 1.0], (4, 1)).astype(np.float32),
            tangents=None,
            uvs=np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32),
            material=0, world_matrix=np.eye(4),
        )],
        materials=[gltf_mod.GltfMaterial(
            base_color_factor=np.ones(4, np.float32), base_color_texture=0,
            metallic_factor=0.0,
        )],
        lights=[gltf_mod.GltfLight(np.asarray([0, 0, 50.0], np.float32),
                                   np.ones(3, np.float32), 2000.0, 0)],
        images=[gltf_mod.GltfImage(img)],
    )
    scene = build_scene(doc)

    def hit_albedo_var(eye_z):
        e = Engine(scene, 32, 32,
                   RenderSettings(rt_mode=0, use_ao=False, use_shadows=False),
                   Camera(eye=(0, 0, eye_z)))
        e.render_frame()
        alb_r = np.asarray(e.gbuffer.color[:, 3])
        hit = np.abs(np.asarray(e.gbuffer.normal[:, 2])) > 0.5  # quad pixels
        assert hit.any()
        return float(alb_r[hit].var()), float(alb_r[hit].mean())

    far_var, far_mean = hit_albedo_var(150.0)
    near_var, near_mean = hit_albedo_var(5.0)
    # far pixels average whole checker cells -> gray, low variance;
    # near pixels stay bimodal black/white
    assert far_var < near_var * 0.5, (far_var, near_var)
    assert abs(far_mean - 0.5) < 0.1


def test_aniso_matches_trilinear_when_isotropic():
    """Isotropic footprints degrade sample_texture_aniso to trilinear: on a
    texture linear in u, symmetric major-axis taps average to the center."""
    from vkrt.ops.texture import (
        pack_mip_atlas, sample_texture_aniso, sample_texture_lod,
    )

    w = h = 32
    ramp = np.broadcast_to(
        np.linspace(0, 255, w)[None, :, None], (h, w, 4)
    ).astype(np.uint8)
    args = pack_mip_atlas([ramp])
    args = tuple(jnp.asarray(a) for a in args)
    uv = jnp.asarray([[0.43, 0.58], [0.2, 0.8]], jnp.float32)
    idx = jnp.zeros((2,), jnp.int32)
    # one-pixel footprint = one texel at 32x32 -> 1/32 in uv, both axes
    g = jnp.full((2, 2), 1.0 / 32.0, jnp.float32) * jnp.asarray([[1, 0], [1, 0]], jnp.float32)
    gx = jnp.stack([jnp.full((2,), 1 / 32.0), jnp.zeros(2)], axis=-1)
    gy = jnp.stack([jnp.zeros(2), jnp.full((2,), 1 / 32.0)], axis=-1)
    del g
    a = np.asarray(sample_texture_aniso(*args, idx, uv, gx, gy))
    t = np.asarray(sample_texture_lod(*args, idx, uv, jnp.zeros(2)))
    np.testing.assert_allclose(a, t, atol=0.02)


def test_aniso_preserves_detail_across_minor_axis():
    """A grazing footprint (long in v, short in u) must keep u-contrast that
    isotropic filtering at the major-axis LOD destroys — the point of the
    reference's 4x anisotropic sampler (hello_vulkan.cpp:452-454)."""
    from vkrt.ops.texture import (
        pack_mip_atlas, sample_texture_aniso, sample_texture_lod,
    )

    w = h = 64
    # vertical stripes, period 4 (2 on / 2 off): varies along u only —
    # they survive level 0-1 of the mip chain and vanish by level 2
    stripes = np.zeros((h, w, 4), np.uint8)
    stripes[:, 0::4] = 255
    stripes[:, 1::4] = 255
    args = pack_mip_atlas([stripes])
    args = tuple(jnp.asarray(a) for a in args)
    n = 33
    uv = jnp.stack([
        jnp.linspace(0.2, 0.3, n), jnp.full((n,), 0.5)
    ], axis=-1).astype(jnp.float32)
    idx = jnp.zeros((n,), jnp.int32)
    # footprint: 1 texel along u, 4 texels along v (grazing floor, exactly
    # the 4x aniso ratio) -> minor-axis lod 0, four taps along v
    gx = jnp.tile(jnp.asarray([[1 / 64.0, 0.0]], jnp.float32), (n, 1))
    gy = jnp.tile(jnp.asarray([[0.0, 4 / 64.0]], jnp.float32), (n, 1))
    an = np.asarray(sample_texture_aniso(*args, idx, uv, gx, gy))[:, 0]
    # an isotropic sampler must use the MAJOR axis (lod 2) to avoid
    # v-aliasing — which flattens the period-4 u-stripes to their mean
    iso = np.asarray(sample_texture_lod(*args, idx, uv, jnp.full((n,), 2.0)))[:, 0]
    assert an.std() > 4 * max(iso.std(), 1e-6)
    # and the means agree (energy conservation)
    assert abs(an.mean() - iso.mean()) < 0.1


def test_aniso_two_tap_quality():
    """The 2-tap fan (VKRT_ANISO_TAPS=2 / taps=2): must degrade to
    trilinear at isotropic footprints (taps collapse inside one texel) and
    stay within a quality bound of the 4-tap fan at anisotropic ones."""
    from vkrt.ops.texture import (
        pack_mip_atlas, sample_texture_aniso, sample_texture_lod,
    )

    w = h = 32
    ramp = np.broadcast_to(
        np.linspace(0, 255, w)[None, :, None], (h, w, 4)
    ).astype(np.uint8)
    args = tuple(jnp.asarray(a) for a in pack_mip_atlas([ramp]))
    uv = jnp.asarray([[0.43, 0.58], [0.2, 0.8]], jnp.float32)
    idx = jnp.zeros((2,), jnp.int32)
    gx = jnp.stack([jnp.full((2,), 1 / 32.0), jnp.zeros(2)], axis=-1)
    gy = jnp.stack([jnp.zeros(2), jnp.full((2,), 1 / 32.0)], axis=-1)
    a2 = np.asarray(sample_texture_aniso(*args, idx, uv, gx, gy, taps=2))
    t = np.asarray(sample_texture_lod(*args, idx, uv, jnp.zeros(2)))
    np.testing.assert_allclose(a2, t, atol=0.02)

    # anisotropic grazing footprint: 2 taps vs 4 taps stay close on a
    # smooth ramp (the fan only redistributes samples along the major axis)
    n = 17
    uv = jnp.stack([
        jnp.linspace(0.3, 0.7, n), jnp.full((n,), 0.5)
    ], axis=-1).astype(jnp.float32)
    idx = jnp.zeros((n,), jnp.int32)
    gx = jnp.tile(jnp.asarray([[1 / 32.0, 0.0]], jnp.float32), (n, 1))
    gy = jnp.tile(jnp.asarray([[0.0, 4 / 32.0]], jnp.float32), (n, 1))
    a2 = np.asarray(sample_texture_aniso(*args, idx, uv, gx, gy, taps=2))
    a4 = np.asarray(sample_texture_aniso(*args, idx, uv, gx, gy, taps=4))
    assert np.abs(a2 - a4).max() < 0.05, np.abs(a2 - a4).max()


def test_aniso_taps_env_validation():
    """Unsupported VKRT_ANISO_TAPS values must raise at import, not
    silently fall back to 4 taps mid-trace."""
    import importlib
    import os

    import vkrt.ops.texture as tex

    saved = os.environ.get("VKRT_ANISO_TAPS")
    try:
        os.environ["VKRT_ANISO_TAPS"] = "8"
        with pytest.raises(ValueError):
            importlib.reload(tex)
    finally:
        if saved is None:
            os.environ.pop("VKRT_ANISO_TAPS", None)
        else:
            os.environ["VKRT_ANISO_TAPS"] = saved
        importlib.reload(tex)


def test_gbuffer_aniso_grazing_plane():
    """End to end: the textured G-buffer pass at a grazing view renders
    finite, detail-bearing texels through the aniso path."""
    import jax.numpy as jnp  # noqa: F401

    from vkrt.scene import build_scene
    from vkrt.utils import gltf as gltf_mod
    from vkrt.config import RenderSettings
    from vkrt.engine import Engine
    from vkrt.utils.camera import Camera

    img = np.zeros((16, 16, 4), np.uint8)
    img[:, ::2] = [255, 255, 255, 255]
    # a big floor quad in the xz plane, viewed nearly edge-on
    quad = np.asarray(
        [[-8, 0, -8], [8, 0, -8], [8, 0, 8], [-8, 0, 8]], np.float32
    )
    doc = gltf_mod.GltfDocument(
        primitives=[
            gltf_mod.GltfPrimitiveInstance(
                positions=quad,
                indices=np.asarray([0, 1, 2, 0, 2, 3], np.uint32),
                normals=np.tile([0, 1.0, 0], (4, 1)).astype(np.float32),
                tangents=None,
                uvs=np.asarray([[0, 0], [8, 0], [8, 8], [0, 8]], np.float32),
                material=0,
                world_matrix=np.eye(4),
            )
        ],
        materials=[
            gltf_mod.GltfMaterial(
                base_color_factor=np.ones(4, np.float32),
                base_color_texture=0,
                metallic_factor=0.0,
            )
        ],
        lights=[
            gltf_mod.GltfLight(np.asarray([0, 6, 0.0], np.float32),
                               np.ones(3, np.float32), 80.0, 0)
        ],
        images=[gltf_mod.GltfImage(img)],
    )
    scene = build_scene(doc)
    cam = Camera(eye=(0.0, 0.4, 9.0), center=(0.0, 0.0, 0.0))
    e = Engine(scene, 64, 48, RenderSettings(rt_mode=0, use_ao=False), cam)
    out = np.asarray(e.render_frame(), np.float32).reshape(48, 64, 3)
    assert np.isfinite(out).all()
    # near rows (bottom of frame) keep stripe contrast; far rows converge to
    # the stripe average instead of aliasing to one stripe color: row-to-row
    # mean is stable at depth
    floor = out[:, :, 0]
    far = floor[26:32]
    assert far[far > 0].size > 0
    row_means = [r[r > 0].mean() for r in far if (r > 0).any()]
    assert np.std(row_means) < 0.25 * np.mean(row_means)
