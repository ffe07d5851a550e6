"""Scene representation: flat SoA device arrays.

The analog of the reference's device scene — where Vulkan binds a
``SceneDesc`` table of 8 buffer device addresses (host_device.h:107-117,
hello_vulkan.cpp:363-379) plus descriptor-set texture arrays, we carry one
pytree of jnp arrays through every jitted render function. World transforms
are baked into the triangle soup at load time (the single-level-BVH-with-
instances-flattened design from SURVEY.md §7.2): per-ray work then needs no
per-instance matrix fetch, and per-corner shading attributes are laid out by
triangle so a hit shades with exactly one gather by triangle id.

Per-triangle corner attributes replace the reference's vertex-index
indirection (raytrace.rchit:49-66): slightly more HBM, one less gather per
hit, and a layout XLA vectorizes cleanly.
"""

from __future__ import annotations

import os
from typing import List, NamedTuple, Optional

import numpy as np
import jax.numpy as jnp

from vkrt.utils import gltf as gltf_mod

TRI_PAD = 64  # pad triangle count to a lane-friendly multiple


def _tex_store_dtype(dtype):
    """Mip-atlas storage dtype — bfloat16 BY DEFAULT (VKRT_TEX_BF16=0
    restores f32): texture fetch is random-gather-bound, so halving the
    texel bytes cuts the cost of the 32-gather aniso fetch (whether it pays
    on the GPU is not yet measured; ROADMAP); filtering math stays f32 (ops/texture._gather_texel casts after the
    gather). Quality: bf16's 8-bit mantissa vs 8-bit source texels is a
    <=0.4% texel error, invisible through the BRDF and bounded by test
    (tests/test_tex_bf16.py).

    ``tex_rgba`` (level 0, the path tracer / alpha-test array) is exempt
    and stays f32: bf16 quantization could flip an alpha-MASK cutoff
    comparison for alpha values landing exactly at alpha_cutoff
    (ops/alpha.py reads it), and level-0 fetches are not the dominant
    texture cost (the hybrid aniso fan over the mip atlas is)."""
    if os.environ.get("VKRT_TEX_BF16", "1") == "1":
        return jnp.bfloat16
    return dtype


class SceneArrays(NamedTuple):
    """Flat scene. T triangles (padded), M materials, L lights, K textures."""

    # geometry (world space, Möller-Trumbore precomputed)
    tri_v0: jnp.ndarray        # (T,3) f32
    tri_e1: jnp.ndarray        # (T,3)
    tri_e2: jnp.ndarray        # (T,3)
    # per-corner shading attributes
    corner_normal: jnp.ndarray   # (T,3,3)
    corner_tangent: jnp.ndarray  # (T,3,4)  xyz + handedness w
    corner_uv: jnp.ndarray       # (T,3,2)
    tri_mat: jnp.ndarray         # (T,) i32
    # materials SoA — GltfPBRMaterial (host_device.h:119-129)
    mat_base_color: jnp.ndarray    # (M,4)
    mat_base_tex: jnp.ndarray      # (M,) i32  (-1 = none)
    mat_metallic: jnp.ndarray      # (M,)
    mat_roughness: jnp.ndarray     # (M,)
    mat_mr_tex: jnp.ndarray        # (M,) i32
    mat_normal_tex: jnp.ndarray    # (M,) i32
    mat_emissive: jnp.ndarray      # (M,3)
    mat_emissive_tex: jnp.ndarray  # (M,) i32
    mat_alpha_mode: jnp.ndarray    # (M,) i32: 0 opaque / 1 mask / 2 blend
    mat_alpha_cutoff: jnp.ndarray  # (M,) f32 (MASK mode)
    # lights SoA — GltfLight (host_device.h:131-137)
    light_pos: jnp.ndarray        # (L,3)
    light_color: jnp.ndarray      # (L,3)
    light_intensity: jnp.ndarray  # (L,)
    light_type: jnp.ndarray       # (L,) i32
    # textures: stacked, padded to common (TH,TW); linear color space
    tex_rgba: jnp.ndarray  # (K,TH,TW,4) f32 (level 0; exempt from bf16 —
    #                        alpha-MASK cutoffs compare against it)
    tex_size: jnp.ndarray  # (K,2) i32  (w,h)
    # full mip chains (hello_vulkan.cpp:499) packed side-by-side per texture
    tex_mip_atlas: jnp.ndarray   # (K,TH,2*TW,4) bf16 by default (f32 under
    #                              VKRT_TEX_BF16=0; cast to f32 post-gather
    #                              in ops/texture._gather_texel)
    tex_level_size: jnp.ndarray  # (K,L,2) i32
    tex_level_off: jnp.ndarray   # (K,L) i32
    tex_n_levels: jnp.ndarray    # (K,) i32
    # per-triangle sqrt(uv area / world area): texels-per-world-unit when
    # multiplied by the texture width; drives mip LOD selection
    tri_uv_density: jnp.ndarray  # (T,) f32

    @property
    def num_tris(self) -> int:
        return self.tri_v0.shape[0]

    @property
    def num_lights(self) -> int:
        return self.light_pos.shape[0]


# The hardcoded fallback point-light rig used when a scene ships no
# KHR_lights_punctual lights (hello_vulkan.cpp:247-321, Sponza-tuned).
FALLBACK_LIGHTS = [
    ((1.0, 5.0, -1.33), (1.0, 1.0, 1.0), 50.0, 0),
    ((0.0, 3.0, 67.0), (1.0, 0.01, 0.1), 50.0, 0),
    ((-1.3, 7.62, 59.0), (1.0, 1.0, 1.0), 50.0, 0),
    ((2.4, 2.05, 40.6), (1.0, 1.0, 1.0), 50.0, 0),
    ((-0.33, 6.85, 30.0), (1.0, 1.0, 1.0), 50.0, 0),
    ((-6.2, 9.6, 20.18), (1.0, 1.0, 1.0), 50.0, 0),
    ((-0.23, 6.93, 12.21), (1.0, 1.0, 0.0), 50.0, 0),
    ((0.24, 3.03, 49.94), (0.0, 0.0, 1.0), 50.0, 0),
]


def srgb_to_linear(c: np.ndarray) -> np.ndarray:
    """Piecewise sRGB EOTF (what R8G8B8A8_SRGB sampling does in hardware)."""
    c = np.asarray(c, np.float32)
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4).astype(
        np.float32
    )


def _flat_normals(v0, v1, v2):
    n = np.cross(v1 - v0, v2 - v0)
    ln = np.linalg.norm(n, axis=-1, keepdims=True)
    return n / np.maximum(ln, 1e-20)


def _compute_tangents(positions, normals, uvs, indices):
    """Per-vertex tangents from UV gradients (the nvh::GltfScene fallback for
    meshes without TANGENT attributes — cornell.gltf has none). Returns (V,4)."""
    v = positions
    t_accum = np.zeros_like(v)
    i0, i1, i2 = indices[0::3], indices[1::3], indices[2::3]
    e1 = v[i1] - v[i0]
    e2 = v[i2] - v[i0]
    duv1 = uvs[i1] - uvs[i0]
    duv2 = uvs[i2] - uvs[i0]
    det = duv1[:, 0] * duv2[:, 1] - duv2[:, 0] * duv1[:, 1]
    r = np.where(np.abs(det) > 1e-12, 1.0 / np.where(det == 0, 1, det), 0.0)[:, None]
    tan = (e1 * duv2[:, 1:2] - e2 * duv1[:, 1:2]) * r
    for idx in (i0, i1, i2):
        np.add.at(t_accum, idx, tan)
    # Gram-Schmidt per vertex, with an ONB fallback for degenerate tangents
    n = normals
    t = t_accum - n * np.sum(t_accum * n, axis=-1, keepdims=True)
    ln = np.linalg.norm(t, axis=-1, keepdims=True)
    bad = ln[:, 0] < 1e-8
    if bad.any():
        # createCoordinateSystem-style fallback (shaders/random.glsl:47-54)
        nb = n[bad]
        alt = np.where(
            (np.abs(nb[:, 0:1]) > np.abs(nb[:, 1:2])),
            np.stack([nb[:, 2], np.zeros(len(nb)), -nb[:, 0]], -1),
            np.stack([np.zeros(len(nb)), -nb[:, 2], nb[:, 1]], -1),
        )
        t[bad] = alt
        ln = np.linalg.norm(t, axis=-1, keepdims=True)
    t = t / np.maximum(ln, 1e-20)
    return np.concatenate([t, np.ones((len(v), 1), np.float32)], axis=-1)


def _bake_primitive(prim):
    """World-bake one glTF primitive: returns (v0, v1, v2, corner_normal,
    corner_tangent, corner_uv, mat_ids) as numpy arrays. This is the unit of
    instance re-pose (scene_instances): a node transform change re-runs ONLY
    its primitives through this function."""
    m = prim.world_matrix.astype(np.float64)
    inv = np.linalg.inv(m)
    pos = prim.positions @ m[:3, :3].T + m[:3, 3]
    idx = prim.indices.astype(np.int64)
    tri = idx.reshape(-1, 3)
    v0, v1, v2 = pos[tri[:, 0]], pos[tri[:, 1]], pos[tri[:, 2]]

    if prim.normals is not None:
        # normal transform: n * W2O == (M^-1)^T n (raytrace.rchit:74)
        nrm = prim.normals @ inv[:3, :3]
        ln = np.linalg.norm(nrm, axis=-1, keepdims=True)
        nrm = nrm / np.maximum(ln, 1e-20)
        cn = np.stack([nrm[tri[:, 0]], nrm[tri[:, 1]], nrm[tri[:, 2]]], axis=1)
    else:
        fn = _flat_normals(v0, v1, v2)
        cn = np.repeat(fn[:, None, :], 3, axis=1)

    uv = prim.uvs if prim.uvs is not None else np.zeros((len(pos), 2), np.float32)
    cuv = np.stack([uv[tri[:, 0]], uv[tri[:, 1]], uv[tri[:, 2]]], axis=1)

    if prim.tangents is not None:
        tg_xyz = prim.tangents[:, :3] @ inv[:3, :3]  # like normals (rchit:76)
        ln = np.linalg.norm(tg_xyz, axis=-1, keepdims=True)
        tg_xyz = tg_xyz / np.maximum(ln, 1e-20)
        tg = np.concatenate([tg_xyz, prim.tangents[:, 3:4]], axis=-1)
    else:
        vertex_n = (
            prim.normals @ inv[:3, :3]
            if prim.normals is not None
            else np.zeros((len(pos), 3), np.float32)
        )
        ln = np.linalg.norm(vertex_n, axis=-1, keepdims=True)
        vertex_n = np.where(ln > 1e-12, vertex_n / np.maximum(ln, 1e-20), [0, 0, 1.0])
        tg = _compute_tangents(pos.astype(np.float32), vertex_n.astype(np.float32), uv, idx)
    ctg = np.stack([tg[tri[:, 0]], tg[tri[:, 1]], tg[tri[:, 2]]], axis=1)

    # materialIndex clamped with max(0, idx) as in raytrace.rchit:38
    mat_id = max(0, prim.material)
    return v0, v1, v2, cn, ctg, cuv, np.full(len(tri), mat_id, np.int32)


def _uv_density(v0, v1, v2, cuv):
    """Per-triangle sqrt(uv area / world area) for mip LOD selection."""
    e1f = (v1 - v0).astype(np.float64)
    e2f = (v2 - v0).astype(np.float64)
    world_area = 0.5 * np.linalg.norm(np.cross(e1f, e2f), axis=-1)
    duv1 = (cuv[:, 1] - cuv[:, 0]).astype(np.float64)
    duv2 = (cuv[:, 2] - cuv[:, 0]).astype(np.float64)
    uv_area = 0.5 * np.abs(duv1[:, 0] * duv2[:, 1] - duv1[:, 1] * duv2[:, 0])
    return np.sqrt(
        np.where(world_area > 1e-20, uv_area / np.maximum(world_area, 1e-20), 0.0)
    ).astype(np.float32)


def build_scene(
    doc: gltf_mod.GltfDocument,
    pad_to: int = TRI_PAD,
    dtype=jnp.float32,
) -> SceneArrays:
    """Flatten a parsed glTF document into SceneArrays (bake world xforms)."""
    all_v0, all_v1, all_v2 = [], [], []
    all_n, all_tg, all_uv, all_mat = [], [], [], []

    for prim in doc.primitives:
        v0, v1, v2, cn, ctg, cuv, mat_ids = _bake_primitive(prim)
        all_v0.append(v0)
        all_v1.append(v1)
        all_v2.append(v2)
        all_n.append(cn)
        all_tg.append(ctg)
        all_uv.append(cuv)
        all_mat.append(mat_ids)

    v0 = np.concatenate(all_v0).astype(np.float32)
    v1 = np.concatenate(all_v1).astype(np.float32)
    v2 = np.concatenate(all_v2).astype(np.float32)
    cn = np.concatenate(all_n).astype(np.float32)
    ctg = np.concatenate(all_tg).astype(np.float32)
    cuv = np.concatenate(all_uv).astype(np.float32)
    mat = np.concatenate(all_mat)

    n_tri = len(v0)
    n_pad = (-n_tri) % pad_to
    if n_pad:
        z3 = np.zeros((n_pad, 3), np.float32)
        v0, v1, v2 = (np.concatenate([a, z3]) for a in (v0, v1, v2))
        cn = np.concatenate([cn, np.zeros((n_pad, 3, 3), np.float32)])
        ctg = np.concatenate([ctg, np.zeros((n_pad, 3, 4), np.float32)])
        cuv = np.concatenate([cuv, np.zeros((n_pad, 3, 2), np.float32)])
        mat = np.concatenate([mat, np.zeros(n_pad, np.int32)])

    mats = doc.materials
    lights = doc.lights
    if not lights:
        lights = [
            gltf_mod.GltfLight(np.asarray(p, np.float32), np.asarray(c, np.float32), i, t)
            for (p, c, i, t) in FALLBACK_LIGHTS
        ]

    # texture atlas: decode to linear float, pad to common size
    srgb_images = set()
    for mt in mats:  # getImageFormat: baseColor/emissive sources are sRGB
        if mt.base_color_texture >= 0:
            srgb_images.add(mt.base_color_texture)
        if mt.emissive_texture >= 0:
            srgb_images.add(mt.emissive_texture)
    images = [im.data for im in doc.images]
    if not images:
        images = [np.full((1, 1, 4), 255, np.uint8)]  # dummy white (hello_vulkan.cpp:458-466)
    th = max(im.shape[0] for im in images)
    tw = max(im.shape[1] for im in images)
    tex = np.zeros((len(images), th, tw, 4), np.float32)
    tex_size = np.zeros((len(images), 2), np.int32)
    for k, im in enumerate(images):
        f = im.astype(np.float32) / 255.0
        if k in srgb_images:
            f = np.concatenate([srgb_to_linear(f[..., :3]), f[..., 3:]], axis=-1)
        tex[k, : im.shape[0], : im.shape[1]] = f
        tex_size[k] = (im.shape[1], im.shape[0])

    from vkrt.ops.texture import pack_mip_atlas

    atlas, level_size, level_off, n_levels = pack_mip_atlas(
        images, [k in srgb_images for k in range(len(images))]
    )

    density = _uv_density(v0, v1, v2, cuv)

    # Convert dtypes HOST-side so every jnp.asarray below is a pure device
    # transfer. jnp.asarray(x, dtype) with a mismatched dtype dispatches an
    # on-device convert_element_type — each its own tiny compile.
    def dev(x, dt=dtype):
        from vkrt.utils.hostmirror import register

        h = np.asarray(x, dtype=np.dtype(dt))
        # keep the host copy: scene_is_textured / scene_has_alpha read
        # these back with asnumpy() (utils/hostmirror.py)
        return register(jnp.asarray(h), h)

    return SceneArrays(
        tri_v0=dev(v0),
        tri_e1=dev(v1 - v0),
        tri_e2=dev(v2 - v0),
        corner_normal=dev(cn),
        corner_tangent=dev(ctg),
        corner_uv=dev(cuv),
        tri_mat=dev(mat, jnp.int32),
        mat_base_color=dev(np.stack([m.base_color_factor for m in mats])),
        mat_base_tex=dev([m.base_color_texture for m in mats], jnp.int32),
        mat_metallic=dev([m.metallic_factor for m in mats]),
        mat_roughness=dev([m.roughness_factor for m in mats]),
        mat_mr_tex=dev([m.metallic_roughness_texture for m in mats], jnp.int32
        ),
        mat_normal_tex=dev([m.normal_texture for m in mats], jnp.int32),
        mat_emissive=dev(np.stack([m.emissive_factor for m in mats])),
        mat_emissive_tex=dev([m.emissive_texture for m in mats], jnp.int32),
        mat_alpha_mode=dev([m.alpha_mode for m in mats], jnp.int32),
        mat_alpha_cutoff=dev([m.alpha_cutoff for m in mats]),
        light_pos=dev(np.stack([l.position for l in lights])),
        light_color=dev(np.stack([l.color for l in lights])),
        light_intensity=dev([l.intensity for l in lights]),
        light_type=dev([l.type for l in lights], jnp.int32),
        tex_rgba=dev(tex),  # f32 always, see _tex_store_dtype
        tex_size=dev(tex_size, jnp.int32),
        tex_mip_atlas=dev(atlas, _tex_store_dtype(dtype)),
        tex_level_size=dev(level_size, jnp.int32),
        tex_level_off=dev(level_off, jnp.int32),
        tex_n_levels=dev(n_levels, jnp.int32),
        tri_uv_density=dev(density),
    )


def load_scene(path: str) -> SceneArrays:
    """GLTF file -> SceneArrays (loadGltfScene equivalent)."""
    return build_scene(gltf_mod.parse_gltf(path))


def scene_is_textured(scene: SceneArrays) -> bool:
    """True if any material references a texture.

    Evaluated at trace time on the closure-captured (concrete) scene so
    untextured scenes compile shading without the texture-gather passes.
    Conservatively True if the scene arrays are tracers.
    """
    try:
        from vkrt.utils.hostmirror import asnumpy as _np_of

        return bool(
            (_np_of(scene.mat_base_tex) >= 0).any()
            or (_np_of(scene.mat_mr_tex) >= 0).any()
            or (_np_of(scene.mat_normal_tex) >= 0).any()
            or (_np_of(scene.mat_emissive_tex) >= 0).any()
        )
    except Exception:
        return True


def _tex_slot_used(mat_tex_idx) -> bool:
    """Static per-slot texture gate: does ANY material use this slot?

    Same contract as scene_is_textured (concrete closure-captured arrays,
    conservatively True for tracers). Skipping an unused slot's fetch is
    bit-identical — a fetch over all-(-1) indices returns white/identity —
    and drops the path tracer's 4-fetch fan to the slots the scene
    actually has."""
    try:
        from vkrt.utils.hostmirror import asnumpy as _np_of

        return bool((_np_of(mat_tex_idx) >= 0).any())
    except Exception:
        return True


# ---------------------------------------------------------------------------
# Procedural scenes (the bench/test substitutes for assets the reference
# config lists but does not ship: Sponza, fireplace, suntemple).
# ---------------------------------------------------------------------------


def _quad(a, b, c, d):
    """Two triangles for quad a-b-c-d (counter-clockwise)."""
    return [(a, b, c), (a, c, d)]


def _box(center, half, rot_y: float = 0.0):
    cx, cy, cz = center
    hx, hy, hz = half
    corners = np.array(
        [
            [-hx, -hy, -hz], [hx, -hy, -hz], [hx, hy, -hz], [-hx, hy, -hz],
            [-hx, -hy, hz], [hx, -hy, hz], [hx, hy, hz], [-hx, hy, hz],
        ]
    )
    if rot_y:
        c, s = np.cos(rot_y), np.sin(rot_y)
        r = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        corners = corners @ r.T
    corners = corners + np.array([cx, cy, cz])
    p = corners
    tris = []
    tris += _quad(p[4], p[5], p[6], p[7])  # +z
    tris += _quad(p[1], p[0], p[3], p[2])  # -z
    tris += _quad(p[5], p[1], p[2], p[6])  # +x
    tris += _quad(p[0], p[4], p[7], p[3])  # -x
    tris += _quad(p[7], p[6], p[2], p[3])  # +y
    tris += _quad(p[0], p[1], p[5], p[4])  # -y
    return tris


def _boxes(centers, halves, rots):
    """Vectorized ``_box`` over N boxes: (N,3),(N,3),(N,) -> (N*12,3,3) f64
    triangles, equal to ``np.concatenate([_box(c,h,r) for ...])`` (same
    corner order, same rotate-then-translate op order). A per-box Python
    loop dominated the host build of the 399k-tri city."""
    centers = np.asarray(centers, np.float64)
    halves = np.asarray(halves, np.float64)
    rots = np.asarray(rots, np.float64)
    signs = np.array(
        [
            [-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
            [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1],
        ],
        np.float64,
    )
    corners = signs[None, :, :] * halves[:, None, :]  # (N,8,3)
    c, s = np.cos(rots), np.sin(rots)
    zero, one = np.zeros_like(c), np.ones_like(c)
    # _box's r = [[c,0,s],[0,1,0],[-s,0,c]]; corners @ r.T, batched
    r = np.stack(
        [
            np.stack([c, zero, s], -1),
            np.stack([zero, one, zero], -1),
            np.stack([-s, zero, c], -1),
        ],
        axis=1,
    )  # (N,3,3)
    corners = np.matmul(corners, np.swapaxes(r, 1, 2))
    corners = corners + centers[:, None, :]
    # the 12 (a,b,c) corner index triples _box emits, in order
    quads = [(4, 5, 6, 7), (1, 0, 3, 2), (5, 1, 2, 6),
             (0, 4, 7, 3), (7, 6, 2, 3), (0, 1, 5, 4)]
    tri_idx = np.array(
        [t for a, b, c_, d in quads for t in ((a, b, c_), (a, c_, d))],
        np.int64,
    )  # (12,3)
    return corners[:, tri_idx, :].reshape(-1, 3, 3)


def _boxes_uvs(halves, tiles):
    """Vectorized ``_box_uvs``: (N,3),(N,) -> (N*12,3,2) f64, equal to
    ``np.concatenate([_box_uvs(h, t) for ...])``."""
    halves = np.asarray(halves, np.float64)
    tiles = np.asarray(tiles, np.float64)
    hx, hy, hz = halves[:, 0], halves[:, 1], halves[:, 2]
    # per-face (su, sv) extents, matching _box_uvs's face order
    su = np.stack([2 * hx, 2 * hx, 2 * hz, 2 * hz, 2 * hx, 2 * hx], -1)
    sv = np.stack([2 * hy, 2 * hy, 2 * hy, 2 * hy, 2 * hz, 2 * hz], -1)
    su = su * tiles[:, None]  # (N,6)
    sv = sv * tiles[:, None]
    zero = np.zeros_like(su)
    # quad corners a=(0,0) b=(su,0) c=(su,sv) d=(0,sv); tris (a,b,c),(a,c,d)
    u = np.stack([zero, su, su, zero, su, zero], -1)   # (N,6,6)
    v = np.stack([zero, zero, sv, zero, sv, sv], -1)
    uv = np.stack([u, v], -1)                          # (N,6,6,2)
    return uv.reshape(-1, 2, 3, 2).reshape(-1, 3, 2)


def _box_uvs(half, tile: float = 1.0):
    """Per-corner UVs matching _box's 12 triangles: each face mapped 0..extent
    so textures tile with world size."""
    hx, hy, hz = half
    out = []

    def quad_uv(su, sv):
        a, b, c, d = (0, 0), (su, 0), (su, sv), (0, sv)
        out.extend([(a, b, c), (a, c, d)])

    quad_uv(2 * hx * tile, 2 * hy * tile)  # +z
    quad_uv(2 * hx * tile, 2 * hy * tile)  # -z
    quad_uv(2 * hz * tile, 2 * hy * tile)  # +x
    quad_uv(2 * hz * tile, 2 * hy * tile)  # -x
    quad_uv(2 * hx * tile, 2 * hz * tile)  # +y
    quad_uv(2 * hx * tile, 2 * hz * tile)  # -y
    return out


def _procedural_textures():
    """Checker / brick / window-grid images for the city stand-in."""
    rng = np.random.default_rng(42)
    checker = np.zeros((64, 64, 4), np.uint8)
    checker[..., :3] = 110
    checker[:32, :32, :3] = 190
    checker[32:, 32:, :3] = 190
    checker[..., 3] = 255

    brick = np.full((64, 64, 4), 150, np.uint8)
    brick[..., :3] = (160, 82, 60)
    for row in range(0, 64, 16):
        brick[row : row + 2, :, :3] = 200  # mortar lines
        off = 0 if (row // 16) % 2 == 0 else 16
        for col in range(off, 64, 32):
            brick[row : row + 16, col : col + 2, :3] = 200
    brick[..., :3] = np.clip(
        brick[..., :3].astype(np.int16) + rng.integers(-12, 12, (64, 64, 1)), 0, 255
    ).astype(np.uint8)
    brick[..., 3] = 255

    windows = np.full((64, 64, 4), 70, np.uint8)
    windows[..., :3] = (90, 95, 105)
    for row in range(4, 64, 16):
        for col in range(4, 64, 16):
            windows[row : row + 8, col : col + 8, :3] = (30, 40, 70)
    windows[..., 3] = 255
    return [
        gltf_mod.GltfImage(checker, "checker"),
        gltf_mod.GltfImage(brick, "brick"),
        gltf_mod.GltfImage(windows, "windows"),
    ]


def scene_from_soup(
    tris: List,
    mat_ids: List[int],
    materials: List[gltf_mod.GltfMaterial],
    lights: List[gltf_mod.GltfLight],
    images: Optional[List[gltf_mod.GltfImage]] = None,
    uvs: Optional[np.ndarray] = None,
) -> SceneArrays:
    """Assemble SceneArrays from python triangle lists (flat normals).

    ``uvs``: optional (T, 3, 2) per-corner texture coordinates."""
    arr = np.asarray(tris, np.float32)  # (T,3,3)
    doc = gltf_mod.GltfDocument(
        primitives=[
            gltf_mod.GltfPrimitiveInstance(
                positions=arr.reshape(-1, 3),
                indices=np.arange(arr.size // 3, dtype=np.uint32),
                normals=None,
                tangents=None,
                uvs=None if uvs is None else np.asarray(uvs, np.float32).reshape(-1, 2),
                material=0,
                world_matrix=np.eye(4),
            )
        ],
        materials=materials,
        lights=lights,
        images=images or [],
    )
    built = build_scene(doc)
    mat = np.zeros(built.tri_mat.shape[0], np.int32)
    mat[: len(mat_ids)] = mat_ids
    from vkrt.utils.hostmirror import register

    return built._replace(tri_mat=register(jnp.asarray(mat), mat))


def make_cornell_box() -> SceneArrays:
    """Procedural Cornell-style box: used when the reference's
    media/scenes/cornell.gltf is not reachable. Dimensions mirror the real
    asset (10-unit box, light at y=4.5, camera at z=15 looking in)."""
    mats = [
        gltf_mod.GltfMaterial(np.array([0.73, 0.73, 0.73, 1], np.float32), metallic_factor=0.0),
        gltf_mod.GltfMaterial(np.array([1.0, 0.0, 0.0, 1], np.float32), metallic_factor=0.0),
        gltf_mod.GltfMaterial(np.array([0.05, 1.0, 0.0, 1], np.float32), metallic_factor=0.0),
        gltf_mod.GltfMaterial(
            np.array([1.0, 1.0, 1.0, 1], np.float32),
            metallic_factor=0.0,
            roughness_factor=0.0,
            emissive_factor=np.array([10.0, 10.0, 10.0], np.float32),
        ),
        # boxes: diffuse-ish. NOTE metallic=1 + the reference's GGX
        # weight math (gltf.glsl:98-109, pdf can approach 0 with cosTheta
        # < 0) produces unbounded negative fireflies — faithful to the
        # reference but poison for convergence statistics, so the
        # procedural test scene stays away from that corner.
        gltf_mod.GltfMaterial(
            np.array([0.5, 0.5, 0.5, 1], np.float32),
            metallic_factor=0.0,
            roughness_factor=0.9,
        ),
    ]
    tris, mat_ids = [], []

    def add(ts, mid):
        tris.extend(ts)
        mat_ids.extend([mid] * len(ts))

    add(_box((0, 0, -5.5), (5, 5, 0.5)), 0)        # back wall
    add(_box((0, -5.5, 0), (5, 0.5, 5)), 0)        # floor
    add(_box((0, 5.5, 0), (5, 0.5, 5)), 0)         # ceiling
    add(_box((-5.5, 0, 0), (0.5, 5, 5)), 1)        # left (red)
    add(_box((5.5, 0, 0), (0.5, 5, 5)), 2)         # right (green)
    add(_box((0, 4.7, 0), (1.5, 0.1, 1.5)), 3)     # area light panel
    add(_box((1.8, -3.2, 1.2), (1.2, 1.8, 1.2), 0.5), 4)   # tall box
    add(_box((-2.0, -4.0, -1.5), (1.0, 1.0, 1.0), -0.3), 4)  # small box
    lights = [
        gltf_mod.GltfLight(
            np.array([0.0, 4.5, 0.0], np.float32),
            np.array([1.0, 1.0, 1.0], np.float32),
            100.0,
            0,
        )
    ]
    return scene_from_soup(tris, mat_ids, mats, lights)


def make_random_soup(n_tris: int, seed: int = 0, extent: float = 1.0) -> SceneArrays:
    """Random triangle soup for BVH correctness fuzzing."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-extent, extent, (n_tris, 1, 3))
    offsets = rng.normal(0, 0.08 * extent, (n_tris, 3, 3))
    tris = (centers + offsets).astype(np.float32)
    mats = [gltf_mod.GltfMaterial(np.array([0.8, 0.8, 0.8, 1], np.float32))]
    lights = [
        gltf_mod.GltfLight(np.zeros(3, np.float32), np.ones(3, np.float32), 10.0, 0)
    ]
    return scene_from_soup(list(tris), [0] * n_tris, mats, lights)


def make_city(grid: int = 16, seed: int = 7) -> SceneArrays:
    """Sponza-substitute: a grid of boxes ("buildings") + floor + lights.

    Gives the BVH a real workload (thousands to hundreds of thousands of
    triangles with uneven density) for the Sponza-class benchmark configs."""
    rng = np.random.default_rng(seed)
    mats = [
        gltf_mod.GltfMaterial(np.array([0.7, 0.7, 0.68, 1], np.float32),
                              metallic_factor=0.0, base_color_texture=0),  # checker
        gltf_mod.GltfMaterial(np.array([1.0, 1.0, 1.0, 1], np.float32),
                              metallic_factor=0.0, base_color_texture=1),  # brick
        gltf_mod.GltfMaterial(np.array([0.8, 0.8, 0.85, 1], np.float32),
                              roughness_factor=0.2),
        gltf_mod.GltfMaterial(np.array([1.0, 1.0, 1.0, 1], np.float32),
                              metallic_factor=0.3, roughness_factor=0.4,
                              base_color_texture=2),  # window grid
    ]

    # Parameter collection stays a Python loop (rng draw ORDER defines the
    # scene); geometry/UV generation is one vectorized pass (_boxes /
    # _boxes_uvs).
    centers, halves, rots, box_mats, tiles = [], [], [], [], []

    def add(center, half, mid, rot=0.0, tile=0.5):
        centers.append(center)
        halves.append(half)
        rots.append(rot)
        box_mats.append(mid)
        tiles.append(tile)

    span = grid * 2.0
    add((0, -0.25, 0), (span, 0.25, span), 0, tile=0.25)  # ground slab
    for i in range(grid):
        for j in range(grid):
            x = (i - grid / 2) * 4.0 + rng.uniform(-0.5, 0.5)
            z = (j - grid / 2) * 4.0 + rng.uniform(-0.5, 0.5)
            h = rng.uniform(1.0, 8.0)
            w = rng.uniform(0.6, 1.6)
            half = (w, h / 2, w)
            rot = rng.uniform(0, 3.14)  # drawn before the material pick
            add((x, h / 2, z), half, int(rng.integers(1, 4)), rot=rot)
            if rng.uniform() < 0.3:  # rooftop structure
                rh = (w * 0.4, 0.4, w * 0.4)
                add((x, h + 0.4, z), rh, 2)

    tris = _boxes(centers, halves, rots)
    uvs = _boxes_uvs(halves, tiles)
    mat_ids = np.repeat(np.asarray(box_mats, np.int32), 12).tolist()
    lights = [
        gltf_mod.GltfLight(
            np.array([rng.uniform(-span / 2, span / 2), rng.uniform(6, 14),
                      rng.uniform(-span / 2, span / 2)], np.float32),
            np.ones(3, np.float32),
            200.0,
            0,
        )
        for _ in range(4)
    ]
    return scene_from_soup(
        tris, mat_ids, mats, lights,
        images=_procedural_textures(), uvs=np.asarray(uvs, np.float32),
    )


def find_reference_cornell() -> Optional[str]:
    """The reference's cornell.gltf, if the checkout holds its media."""
    cand = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "media/scenes/cornell.gltf",
    )
    return cand if os.path.exists(cand) else None


def load_cornell() -> SceneArrays:
    """The default benchmark scene (config.json scene index 2): the
    reference's cornell.gltf when the checkout has it, else the procedural
    box. Says on stderr which one it loaded."""
    import sys

    path = find_reference_cornell()
    if path is not None:
        scene, name = load_scene(path), "cornell.gltf"
    else:
        scene, name = make_cornell_box(), "procedural cornell box"
    print(f"[scene] loaded {name}: {scene.num_tris} triangles",
          file=sys.stderr)
    return scene
