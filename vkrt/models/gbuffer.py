"""G-buffer pass: the raster pipeline replaced by primary-visibility rays.

The reference rasterizes the scene into an 8-MRT G-buffer with direct PBR
lighting from *all* lights (vert_shader.vert + frag_shader.frag:122-214).
Here the equivalent is a primary-ray pass through the same tracer
producing the identical buffer contract:

* color.rgb = emissive + sum_lights BRDF * Li * cosTheta (frag:188-214)
* albedo = (1-metal)*baseColor smuggled through the alpha channels of
  color/position/normal (frag:140-149)
* position/normal: world space; rough+metal pair (frag:141-144)
* NRD inputs: motion vector (0), oct-packed normal+roughness, viewZ,
  diffRadianceHitDist placeholder (frag:135-138)
* background: color = clear color (the attachment clear, main.cpp:483),
  position = normal = 0 — the hybrid kernel's background test
  (raytraceHybrid.rgen:67).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from vkrt.models.shading import surface_at_hit
from vkrt.ops import brdf as brdf_ops
from vkrt.ops.intersect import T_MAX, T_MIN
from vkrt.ops.nrd import pack_normal_and_roughness
from vkrt.utils.camera import generate_rays, pixel_coords
from vkrt.utils.smath import (
    cross,
    dot,
    length,
    normalize,
    transform_point,
)


class GBuffer(NamedTuple):
    color: jnp.ndarray        # (N,4) direct light rgb + albedo.r
    position: jnp.ndarray     # (N,4) world pos + albedo.g
    normal: jnp.ndarray       # (N,4) shading normal + albedo.b
    rough_metal: jnp.ndarray  # (N,2)
    view_z: jnp.ndarray       # (N,)
    norm_rough: jnp.ndarray   # (N,4) NRD packed
    motion: jnp.ndarray       # (N,4) zeros (static camera MV, frag:135)


def direct_lighting(scene, p, n, v, base_color, metallic, roughness):
    """All-lights direct PBR sum (frag_shader.frag:193-213).

    Directional lights use the reference's quirk: L = normalize(position)
    and no distance attenuation.
    """
    n_lights = scene.num_lights
    acc = jnp.zeros_like(p)
    for i in range(n_lights):  # static unroll; L is small
        lpos = scene.light_pos[i]
        lcol = scene.light_color[i]
        lint = scene.light_intensity[i]
        ltype = scene.light_type[i]
        ldir = lpos - p
        dist = length(ldir, keepdims=True)
        li_point = lcol * lint / jnp.maximum(dist * dist, 1e-20)
        l_point = ldir / jnp.maximum(dist, 1e-20)
        l_dir = jnp.broadcast_to(normalize(lpos), p.shape)
        is_point = ltype == 0
        l = jnp.where(is_point, l_point, l_dir)
        li = jnp.where(is_point, li_point, lcol * lint)
        h = normalize(l + v)
        cos_t = jnp.maximum(dot(l, n), 0.0)
        contrib = (
            brdf_ops.compute_pbr_brdf(n, v, l, h, base_color, metallic, roughness)
            * li
            * cos_t[:, None]
        )
        acc = acc + jnp.where((cos_t > 0.0)[:, None], contrib, 0.0)
    return acc


def gbuffer_pass(
    scene, tracer, cam, width: int, height: int, clear_color, pix=None
) -> GBuffer:
    """Primary rays at pixel centers -> G-buffer (replaces rasterizeGltf).

    ``pix``: optional per-shard pixel coordinates for SPMD tiling."""
    n = width * height if pix is None else pix.shape[0]
    dt = scene.tri_v0.dtype
    origin, direction = generate_rays(
        cam, width, height, jnp.full((n, 2), 0.5, dt), pix=pix
    )
    hi = tracer.closest(origin, direction, T_MIN, T_MAX)
    miss = ~hi.hit
    tri = jnp.maximum(hi.tri, 0)

    # screen-space UV derivatives by ray differentials: the per-pixel camera
    # direction derivative is transferred onto the hit plane (Igehy-style)
    # and pushed through the triangle's UV Jacobian — the analytic analog of
    # the raster pipeline's implicit dFdx/dFdy, feeding the 4x ANISOTROPIC
    # sampler the reference configures (hello_vulkan.cpp:452-454). Replaces
    # the round-2 isotropic per-triangle-density LOD, which ignored grazing
    # angles and footprint direction entirely.
    from vkrt.scene import scene_is_textured

    import os

    # VKRT_ANISO=0: fall back to the round-2 isotropic per-triangle-density
    # trilinear LOD (cheaper: 8 texel gathers/fetch vs aniso's 32) — a
    # measurement/perf knob; default stays the reference-faithful 4x aniso
    aniso = os.environ.get("VKRT_ANISO", "1") == "1"
    uv_grads = None
    lod = None
    if scene_is_textured(scene) and not aniso:
        pixel_angle = 2.0 * jnp.abs(cam.proj_inverse[1, 1]) / float(height)
        tex_w = scene.tex_level_size[:, 0, 0].max().astype(jnp.float32)
        density = jnp.take(scene.tri_uv_density, tri)
        footprint_texels = hi.t * pixel_angle * density * tex_w
        lod = jnp.log2(jnp.maximum(footprint_texels, 1e-9))
    if scene_is_textured(scene) and aniso:
        pixc = pix if pix is not None else pixel_coords(width, height)
        pi = cam.proj_inverse
        rot = cam.view_inverse[:3, :3]  # camera->world rotation
        # d(target)/d(pixel): projInverse column scaled by the NDC step,
        # rotated to world (generate_rays' target, rgen:47-50)
        # explicit multiply-adds, not a matmul: a float32 matmul may run in
        # TF32 on the GPU (same rule as generate_rays)
        def rot_mul(v):
            return rot[:, 0] * v[0] + rot[:, 1] * v[1] + rot[:, 2] * v[2]

        ax = rot_mul(pi[:3, 0] * (2.0 / float(width)))
        ay = rot_mul(pi[:3, 1] * (2.0 / float(height)))
        # |target| per pixel (direction was normalized in camera space)
        dndc = (pixc + 0.5) / jnp.asarray([width, height], jnp.float32) * 2.0 - 1.0
        t3 = jnp.stack(
            [
                pi[0, 0] * dndc[:, 0] + pi[0, 1] * dndc[:, 1] + pi[0, 2] + pi[0, 3],
                pi[1, 0] * dndc[:, 0] + pi[1, 1] * dndc[:, 1] + pi[1, 2] + pi[1, 3],
                pi[2, 0] * dndc[:, 0] + pi[2, 1] * dndc[:, 1] + pi[2, 2] + pi[2, 3],
            ],
            axis=-1,
        )
        inv_tlen = 1.0 / jnp.maximum(length(t3), 1e-20)

        e1 = jnp.take(scene.tri_e1, tri, axis=0)
        e2 = jnp.take(scene.tri_e2, tri, axis=0)
        cuv = jnp.take(scene.corner_uv, tri, axis=0)  # (N,3,2)
        ng = cross(e1, e2)
        denom = dot(ng, direction)
        safe_denom = jnp.where(jnp.abs(denom) < 1e-12, 1e-12, denom)
        # barycentric solve: world step -> (du_bary, dv_bary) via the edge
        # Gram matrix, then -> UV through the corner-UV deltas
        a = dot(e1, e1)
        b = dot(e1, e2)
        c = dot(e2, e2)
        inv_det = 1.0 / jnp.maximum(a * c - b * b, 1e-20)
        duv1 = cuv[:, 1] - cuv[:, 0]
        duv2 = cuv[:, 2] - cuv[:, 0]

        def uv_deriv(axis_vec):
            # normalized-direction derivative, then plane transfer at t
            dd = (axis_vec[None, :] - direction * dot(direction, axis_vec[None, :], keepdims=True)) * inv_tlen[:, None]
            dP = hi.t[:, None] * (dd - direction * (dot(ng, dd) / safe_denom)[:, None])
            p = dot(e1, dP)
            q = dot(e2, dP)
            du_b = (c * p - b * q) * inv_det
            dv_b = (a * q - b * p) * inv_det
            return duv1 * du_b[:, None] + duv2 * dv_b[:, None]

        uv_grads = (uv_deriv(ax), uv_deriv(ay))

    surf = surface_at_hit(scene, tri, hi.u, hi.v, direction, lod=lod,
                          uv_grads=uv_grads)

    v = normalize(-direction)
    # frag shader uses raw factors; same clamps as ray path are NOT applied
    direct = direct_lighting(
        scene, surf.world_pos, surf.shading_normal, v,
        surf.base_color, surf.metallic, surf.roughness,
    )
    color_rgb = surf.emissive + direct
    albedo = (1.0 - surf.metallic)[:, None] * surf.base_color  # frag:140

    clear3 = jnp.asarray(clear_color, dt)[:3]
    m = miss[:, None]
    color_rgb = jnp.where(m, clear3, color_rgb)
    world_pos = jnp.where(m, 0.0, surf.world_pos)
    nrm = jnp.where(m, 0.0, surf.shading_normal)
    albedo = jnp.where(m, 0.0, albedo)

    view_z = transform_point(cam.view, surf.world_pos)[:, 2]
    view_z = jnp.where(miss, 0.0, view_z)
    packed = pack_normal_and_roughness(
        surf.shading_normal, surf.roughness, surf.mat_id.astype(dt)
    )
    packed = jnp.where(m, 0.0, packed)

    return GBuffer(
        color=jnp.concatenate([color_rgb, albedo[:, 0:1]], axis=1),
        position=jnp.concatenate([world_pos, albedo[:, 1:2]], axis=1),
        normal=jnp.concatenate([nrm, albedo[:, 2:3]], axis=1),
        rough_metal=jnp.where(
            m, 0.0, jnp.stack([surf.roughness, surf.metallic], axis=-1)
        ),
        view_z=view_z,
        norm_rough=packed,
        motion=jnp.zeros((n, 4), dt),
    )
