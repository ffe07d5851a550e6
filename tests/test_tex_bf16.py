"""bf16 texture atlas (VKRT_TEX_BF16) parity: the half-byte atlas must stay
within bf16 quantization error of the f32 path end to end.

The storage dtype is read at scene BUILD time (scene._tex_store_dtype); the
cast back to f32 sits after the gather (ops/texture._gather_texel) so all
filtering/BRDF math is unchanged — the only error source is the one-time
texel quantization (8-bit mantissa vs 8-bit sources => |err| <= ~0.4% of
value, before lighting).
"""

import numpy as np
import jax.numpy as jnp

from vkrt.utils import gltf as gltf_mod


def _textured_doc():
    rng = np.random.RandomState(3)
    img = rng.randint(0, 256, (16, 16, 4), np.uint8)
    img[..., 3] = 255
    quad = np.asarray(
        [[-2, -2, 0], [2, -2, 0], [2, 2, 0], [-2, 2, 0]], np.float32
    )
    return gltf_mod.GltfDocument(
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


def test_bf16_atlas_dtype_and_sample_parity(monkeypatch):
    from vkrt.scene import build_scene
    from vkrt.ops.texture import sample_texture, sample_texture_lod

    doc = _textured_doc()
    monkeypatch.setenv("VKRT_TEX_BF16", "0")  # f32 leg (bf16 is the default)
    s32 = build_scene(doc)
    monkeypatch.setenv("VKRT_TEX_BF16", "1")
    s16 = build_scene(doc)
    assert s16.tex_mip_atlas.dtype == jnp.bfloat16
    # level 0 is EXEMPT from bf16: alpha-MASK cutoff comparisons read it
    # (ops/alpha.py), and quantization could flip visibility for alpha
    # values landing exactly at alpha_cutoff
    assert s16.tex_rgba.dtype == jnp.float32
    assert s32.tex_mip_atlas.dtype == jnp.float32

    n = 257
    rng = np.random.RandomState(11)
    uv = jnp.asarray(rng.rand(n, 2) * 3.0 - 1.0, jnp.float32)
    idx = jnp.zeros((n,), jnp.int32)
    a = sample_texture(s32.tex_rgba, s32.tex_size, idx, uv)
    b = sample_texture(s16.tex_rgba, s16.tex_size, idx, uv)
    assert a.dtype == b.dtype == jnp.float32
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    lod = jnp.asarray(rng.rand(n) * 4.0, jnp.float32)
    a = sample_texture_lod(s32.tex_mip_atlas, s32.tex_level_size,
                           s32.tex_level_off, s32.tex_n_levels, idx, uv, lod)
    b = sample_texture_lod(s16.tex_mip_atlas, s16.tex_level_size,
                           s16.tex_level_off, s16.tex_n_levels, idx, uv, lod)
    assert float(jnp.max(jnp.abs(a - b))) <= 1.0 / 128.0


def test_bf16_atlas_render_parity(monkeypatch):
    """End-to-end hybrid render: bf16 vs f32 image error bounded by texel
    quantization through the (linear) lighting chain."""
    from vkrt.scene import build_scene
    from vkrt.config import RenderSettings
    from vkrt.engine import Engine
    from vkrt.utils.camera import Camera

    doc = _textured_doc()
    monkeypatch.setenv("VKRT_TEX_BF16", "0")  # f32 leg (bf16 is the default)
    s32 = build_scene(doc)
    monkeypatch.setenv("VKRT_TEX_BF16", "1")
    s16 = build_scene(doc)

    outs = []
    for sc in (s32, s16):
        e = Engine(sc, 32, 32, RenderSettings(rt_mode=0, use_ao=False),
                   Camera(eye=(0, 0, 6)))
        outs.append(np.asarray(e.render_frame()).reshape(32, 32, 3))
    err = np.abs(outs[0] - outs[1]).max()
    # tonemapped [0,1]-ish output; a ~0.4% linear texel error stays small
    assert err <= 0.02, err
