"""Hit shading + BSDF sampling — the closest-hit stage as batched JAX.

This is the port of ``shaders/raytrace.rchit`` (shared by both RT
pipelines in the reference, hello_vulkan.cpp:1285): attribute interpolation,
TBN/normal mapping, material/texture evaluation, NEE direct light, and lobe
selection (diffuse with probability ``0.5*(1-metalness)``, else GGX
specular). Where GLSL branches per-thread, we evaluate both lobes for every
lane and select — including the *per-branch RNG streams*: each GLSL branch draws a
different number of LCG samples, so both candidate streams are advanced and
the surviving lane's state is selected, keeping per-lane sequences identical
to the reference's divergent execution.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from vkrt.ops import brdf as brdf_ops
from vkrt.ops.rng import rnd
from vkrt.ops.sampling import (
    M_INV_PI,
    create_coordinate_system,
    local_to_world,
    sampling_hemisphere,
    sampling_ndf_ggxtr,
)
from vkrt.ops.texture import sample_texture
from vkrt.utils.smath import cross, dot, length, normalize, reflect


def clamp_bounds(clamp_weights):
    """Normalize RenderSettings.clamp_weights into traced (2,) f32 [lo, hi]
    path-throughput clamp bounds.

    The clamp is always EMITTED (two elementwise min/max per weight
    component) with the bounds as traced data: [0, 50] when on,
    [-inf, +inf] when off — a bit-exact identity (max(x,-inf)=x,
    min(x,+inf)=x, NaN propagates unchanged). This makes the toggle a
    zero-recompile "push constant" like the reference's per-frame UI
    updates (main.cpp:67-105) instead of a static program branch.
    Accepts a Python bool (direct callers/tests) or an already-traced
    (2,) array (the engine's jitted step argument)."""
    if isinstance(clamp_weights, (bool, int)):
        if clamp_weights:
            return jnp.asarray([0.0, 50.0], jnp.float32)
        return jnp.asarray([-jnp.inf, jnp.inf], jnp.float32)
    return jnp.asarray(clamp_weights, jnp.float32)


class SurfaceSample(NamedTuple):
    """Everything the rchit stage writes back through the payload + what the
    G-buffer pass needs (raycommon.glsl:8-19, frag_shader.frag:122-149)."""

    world_pos: jnp.ndarray     # (N,3)
    shading_normal: jnp.ndarray  # (N,3) texNormal
    geo_normal: jnp.ndarray    # (N,3) interpolated worldNrm
    base_color: jnp.ndarray    # (N,3)
    metallic: jnp.ndarray      # (N,) raw (unclamped)
    roughness: jnp.ndarray     # (N,) raw (unclamped)
    emissive: jnp.ndarray      # (N,3) emissiveFactor * texture
    tangent: jnp.ndarray       # (N,3) final frame tangent
    binormal: jnp.ndarray      # (N,3)
    uv: jnp.ndarray            # (N,2)
    mat_id: jnp.ndarray        # (N,) int32


def surface_at_hit(scene, tri, u, v, ray_dir, lod=None,
                   uv_grads=None) -> SurfaceSample:
    """Interpolate attributes + evaluate material at hit (rchit:31-113).

    ``tri`` must be pre-clamped >= 0 (callers mask miss lanes).
    ``lod``: optional (N,) continuous mip level — the G-buffer pass samples
    trilinearly like the raster pipeline's LINEAR_MIPMAP_LINEAR sampler
    (hello_vulkan.cpp:489-499); the path tracer passes None (level 0, like
    the reference's RT pipeline which has no ray differentials).
    """
    w = 1.0 - u - v
    bary = jnp.stack([w, u, v], axis=-1)[..., None]  # (N,3,1)

    cn = jnp.take(scene.corner_normal, tri, axis=0)    # (N,3,3)
    ctg = jnp.take(scene.corner_tangent, tri, axis=0)  # (N,3,4)
    cuv = jnp.take(scene.corner_uv, tri, axis=0)       # (N,3,2)
    v0 = jnp.take(scene.tri_v0, tri, axis=0)
    e1 = jnp.take(scene.tri_e1, tri, axis=0)
    e2 = jnp.take(scene.tri_e2, tri, axis=0)

    world_pos = v0 + u[:, None] * e1 + v[:, None] * e2
    world_nrm = normalize(jnp.sum(cn * bary, axis=1))
    world_tag = normalize(jnp.sum(ctg[..., :3] * bary, axis=1))
    # Gram-Schmidt + handedness from corner 0's tangent.w (rchit:77-78)
    world_tag = normalize(world_tag - dot(world_tag, world_nrm, keepdims=True) * world_nrm)
    world_bin = ctg[:, 0, 3:4] * cross(world_nrm, world_tag)
    uv = jnp.sum(cuv * bary, axis=1)

    mat_id = jnp.take(scene.tri_mat, tri)
    del ray_dir  # ffnormal is computed but unused in the reference (rchit:98)
    return _material_surface(
        scene, mat_id, uv, world_pos, world_nrm, world_tag, world_bin, lod,
        uv_grads,
    )


def _material_surface(scene, mat_id, uv, world_pos, world_nrm, world_tag,
                      world_bin, lod, uv_grads=None) -> SurfaceSample:
    """Material/texture half of the rchit stage (rchit:80-113)."""
    base_factor = jnp.take(scene.mat_base_color, mat_id, axis=0)[:, :3]
    metal_f = jnp.take(scene.mat_metallic, mat_id)
    rough_f = jnp.take(scene.mat_roughness, mat_id)
    emis_f = jnp.take(scene.mat_emissive, mat_id, axis=0)

    from vkrt.scene import scene_is_textured

    if scene_is_textured(scene):
        from vkrt.ops.texture import sample_texture_lod

        base_tex = jnp.take(scene.mat_base_tex, mat_id)
        mr_tex = jnp.take(scene.mat_mr_tex, mat_id)
        normal_tex = jnp.take(scene.mat_normal_tex, mat_id)
        emis_tex = jnp.take(scene.mat_emissive_tex, mat_id)

        if uv_grads is not None:
            # raster-analog pass with screen-space UV derivatives: 4x
            # anisotropic trilinear (the reference's maxAnisotropy=4
            # sampler, hello_vulkan.cpp:452-454) for the visually dominant
            # color textures; the metallic-roughness and normal maps sample
            # trilinearly at the shared MINOR-axis LOD (the aniso tap fan
            # costs 32 texel gathers per fetch vs trilinear's 8, and
            # grazing-angle aliasing of mr/normal data is not visible
            # through the BRDF)
            from vkrt.ops.texture import aniso_minor_lod, sample_texture_aniso

            ddx_uv, ddy_uv = uv_grads

            def fetch(idx):
                return sample_texture_aniso(
                    scene.tex_mip_atlas, scene.tex_level_size,
                    scene.tex_level_off, scene.tex_n_levels, idx, uv,
                    ddx_uv, ddy_uv,
                )

            def fetch_data(idx):
                lod_m = aniso_minor_lod(
                    scene.tex_level_size, idx, ddx_uv, ddy_uv
                )
                return sample_texture_lod(
                    scene.tex_mip_atlas, scene.tex_level_size,
                    scene.tex_level_off, scene.tex_n_levels, idx, uv, lod_m,
                )
        elif lod is None:
            def fetch(idx):
                return sample_texture(scene.tex_rgba, scene.tex_size, idx, uv)
        else:
            def fetch(idx):
                return sample_texture_lod(
                    scene.tex_mip_atlas, scene.tex_level_size,
                    scene.tex_level_off, scene.tex_n_levels, idx, uv, lod,
                )

        if uv_grads is None:
            fetch_data = fetch
        # Per-SLOT static gating: a scene counts as textured when
        # ANY slot is used, but each slot's fetch is skipped independently
        # when NO material references it — a fetch over all-(-1) indices
        # returns white, so skipping is bit-identical, and the path-trace
        # fetch fan drops 4x on baseColor-only scenes (the city: 4 fetches
        # emitted, 1 meaningful).
        from vkrt.scene import _tex_slot_used

        base_color = base_factor
        if _tex_slot_used(scene.mat_base_tex):
            base_color = base_factor * fetch(base_tex)[:, :3]
        # roughness in G, metalness in B (gltf.glsl:40-44); no-texture => 1
        roughness, metallic = rough_f, metal_f
        if _tex_slot_used(scene.mat_mr_tex):
            mr = fetch_data(mr_tex)
            roughness = rough_f * mr[:, 1]
            metallic = metal_f * mr[:, 2]
        emissive = emis_f
        if _tex_slot_used(scene.mat_emissive_tex):
            emissive = emis_f * fetch(emis_tex)[:, :3]
        if _tex_slot_used(scene.mat_normal_tex):
            # Normal mapping (rchit:93-106): TBN = (worldTag, worldBin,
            # worldNrm); with a normal texture the frame is rebuilt around
            # texNormal.
            tex_n_rgb = fetch_data(normal_tex)[:, :3]
            mapped = normalize(tex_n_rgb * 2.0 - 1.0)
            mapped_world = normalize(
                local_to_world(mapped, world_tag, world_bin, world_nrm)
            )
            has_nmap = (normal_tex >= 0)[:, None]
            shading_normal = jnp.where(has_nmap, mapped_world, world_nrm)
            nt, nb = create_coordinate_system(shading_normal)
            tangent = jnp.where(has_nmap, nt, world_tag)
            binormal = jnp.where(has_nmap, nb, world_bin)
        else:
            shading_normal = world_nrm
            tangent = world_tag
            binormal = world_bin
    else:
        # untextured scene (checked statically at trace time): all texture
        # fetches are identity — skip the gather passes entirely
        base_color = base_factor
        roughness = rough_f
        metallic = metal_f
        emissive = emis_f
        shading_normal = world_nrm
        tangent = world_tag
        binormal = world_bin

    return SurfaceSample(
        world_pos=world_pos,
        shading_normal=shading_normal,
        geo_normal=world_nrm,
        base_color=base_color,
        metallic=metallic,
        roughness=roughness,
        emissive=emissive,
        tangent=tangent,
        binormal=binormal,
        uv=uv,
        mat_id=mat_id,
    )


class BsdfSample(NamedTuple):
    """Payload writes of the rchit stage (rchit:215-218) + NEE bookkeeping."""

    next_dir: jnp.ndarray      # (N,3)
    weight: jnp.ndarray        # (N,3) BRDF*cos/pdf
    emit_plus_nee: jnp.ndarray  # (N,3) prd.hitValue
    is_specular: jnp.ndarray   # (N,) bool
    shadow_dir: jnp.ndarray    # (N,3) L toward sampled light
    light_dist: jnp.ndarray    # (N,)
    seed: jnp.ndarray          # (N,) uint32


def sample_bsdf(scene, surf: SurfaceSample, ray_dir, seed, emit_gate,
                corr=None) -> BsdfSample:
    """Lobe selection + sampling (rchit:118-218). ``emit_gate`` (N,) bool is
    the ``prd.depth == 0 || prd.isSpecular`` emissive gate (rchit:83-88).

    ``corr``: optional (N, 6) per-block shared uniforms (ops.rng.corr_draws)
    replacing the six sampling draws — lobe pick, light pick, hemisphere
    r1/r2, GGX r1/r2 — for block-coherent bounce/shadow directions. Lane
    seeds advance exactly as without it (the substituted draws are still
    consumed), so the stream structure matches the reference estimator."""
    n_lights = scene.num_lights
    v = normalize(-ray_dir)
    nrm = surf.shading_normal

    emittance = jnp.where(emit_gate[:, None], surf.emissive, 0.0)

    # ratio uses *unclamped* metalness (rchit:127), clamps follow (128-129)
    ratio = 0.5 * (1.0 - surf.metallic)
    rough_c = jnp.clip(surf.roughness, 0.01, 0.99)
    metal_c = jnp.clip(surf.metallic, 0.01, 0.99)

    seed, r1 = rnd(seed)
    if corr is not None:
        r1 = corr[:, 0]
    is_diffuse = r1 < ratio

    # ---- diffuse branch (3 further draws: light pick + 2 hemisphere) ----
    seed_d, r_light = rnd(seed)
    if corr is not None:
        r_light = corr[:, 1]
    light_idx = jnp.clip(
        (r_light * float(n_lights)).astype(jnp.int32), 0, n_lights - 1
    )
    lpos = jnp.take(scene.light_pos, light_idx, axis=0)
    lcol = jnp.take(scene.light_color, light_idx, axis=0)
    lint = jnp.take(scene.light_intensity, light_idx)
    ltype = jnp.take(scene.light_type, light_idx)
    ldir = lpos - surf.world_pos
    light_dist = length(ldir)
    l_nee = ldir / jnp.maximum(light_dist[:, None], 1e-20)

    # directLight -> computePBR_BRDF re-fetches the *unclamped* material
    # values from the material/textures (gltf.glsl:111-115), so NEE sees raw
    # metallic/roughness while the sampled lobes below use the clamped ones.
    brdf_nee, li, cos_nee = brdf_ops.direct_light(
        lpos, lcol, lint, ltype,
        surf.world_pos, nrm, v, surf.base_color, surf.metallic, surf.roughness,
    )
    # "if dot(L, texNormal) <= 0: += 0" (rchit:166-174); lightsCount scaling
    nee = jnp.where(
        (dot(l_nee, nrm) > 0.0)[:, None],
        float(n_lights) * brdf_nee * li * cos_nee[:, None],
        0.0,
    )
    seed_d, hemi = sampling_hemisphere(
        seed_d, surf.tangent, surf.binormal, nrm,
        uniforms=None if corr is None else (corr[:, 2], corr[:, 3]),
    )
    dir_d = normalize(hemi)
    # weight = BRDF*cos/pdf with BRDF=(1-metal)*baseColor/pi and
    # pdf=ratio*cos/pi (rchit:176-183): the cosines cancel exactly.
    pdf_d = ratio * dot(dir_d, nrm) * M_INV_PI
    brdf_d = (1.0 - metal_c)[:, None] * surf.base_color * M_INV_PI
    weight_d = brdf_d * (dot(dir_d, nrm) / jnp.maximum(pdf_d, 1e-12))[:, None]

    # ---- specular branch (2 further draws: GGX) ----
    alpha = rough_c * rough_c
    seed_s, h_local = sampling_ndf_ggxtr(
        seed, alpha * alpha,
        uniforms=None if corr is None else (corr[:, 4], corr[:, 5]),
    )
    h = normalize(local_to_world(h_local, surf.tangent, surf.binormal, nrm))
    dir_s = normalize(reflect(-v, h))
    f0 = 0.04 * (1.0 - metal_c[:, None]) + surf.base_color * metal_c[:, None]
    brdf_over_pdf = brdf_ops.specular_brdf_over_pdf_cook_torrance(
        nrm, h, v, dir_s, f0, rough_c, ratio
    )
    weight_s = brdf_over_pdf * dot(dir_s, nrm)[:, None]  # cosTheta (rchit:207)

    sel = is_diffuse[:, None]
    return BsdfSample(
        next_dir=jnp.where(sel, dir_d, dir_s),
        weight=jnp.where(sel, weight_d, weight_s),
        emit_plus_nee=emittance + jnp.where(sel, nee, 0.0),
        is_specular=~is_diffuse,
        shadow_dir=l_nee,
        light_dist=light_dist,
        seed=jnp.where(is_diffuse, seed_d, seed_s),
    )
