"""Hybrid mode: G-buffer + ray-traced shadows / AO / 1-path GI.

Port of ``shaders/raytraceHybrid.rgen:50-303`` over the G-buffer produced by
:mod:`vkrt.models.gbuffer`. Per pixel:

* shadows: one randomly chosen light, binary visibility with a 0.01 floor,
  modulates alpha (hybrid rgen:81-131);
* AO: 4 cosine-hemisphere rays, radius 2.0, modulates alpha (rgen:133-169);
* GI: lobe pick by ``ratio = metalness*(1-roughness)`` vs 0.8 (rgen:184-202)
  then the same bounce chain as the path tracer starting at depth 1
  (rgen:211-266), weighted by albedo for the diffuse lobe;
* NRD REBLUR packing of radiance + normalized hit distance (rgen:273-281);
* accumulation into the RGBA accum image (rgen:36-48).
"""

from __future__ import annotations

import jax.numpy as jnp

from vkrt.models.gbuffer import GBuffer, gbuffer_pass
from vkrt.models.pathtracer import BounceCarry, accumulate, bounce_chain
from vkrt.ops import nrd
from vkrt.ops.rng import rnd, seed_pixels
from vkrt.ops.sampling import create_coordinate_system, sampling_hemisphere
from vkrt.utils.smath import dot, length, normalize, reflect

AO_SAMPLES = 4        # raytraceHybrid.rgen:31
RTAO_RADIUS = 2.0     # rgen:32
SHADOW_T_MIN = 0.1    # rgen:104


def hybrid_effects(
    scene,
    tracer,
    gbuf: GBuffer,
    cam,
    seed,
    frame,
    accum_rt,
    *,
    depth: int,
    use_shadows: bool,
    use_ao: bool,
    use_gi: bool,
    clamp_weights=False,
    corr: bool = False,
    corr_salt=None,
):
    """The raytraceHybrid.rgen main() body. Returns (color4, diff_rad_hitd,
    seed, rays).

    ``corr``: correlated per-block sampler (see RenderSettings.corr_sampler)
    — the shadow light pick, AO hemisphere draws, GI lobe direction and the
    GI bounce chain all share one draw per 1024-lane block per frame,
    for coherent visibility/bounce pools. ``corr_salt``: traced uint32
    decorrelating the tables across SPMD shards (0/None = unsharded
    stream)."""
    n = gbuf.color.shape[0]
    dt = gbuf.color.dtype
    n_lights = scene.num_lights

    corr_seed = None
    corr_tab = None
    if corr:
        from vkrt.ops.rng import corr_draws

        corr_seed = (
            jnp.asarray(frame).astype(jnp.uint32) * jnp.uint32(0x9E3779B9)
        )
        if corr_salt is not None:
            corr_seed = corr_seed + jnp.asarray(corr_salt, jnp.uint32)
        # depth keys >= 64 are reserved for the pre-chain hybrid draws (the
        # GI chain itself uses keys 1..depth-1 inside bounce_chain)
        corr_tab = lambda key: corr_draws(n, corr_seed, key).astype(dt)  # noqa: E731

    world_pos = gbuf.position[:, :3]
    world_nrm = gbuf.normal[:, :3]
    albedo = jnp.stack(
        [gbuf.color[:, 3], gbuf.position[:, 3], gbuf.normal[:, 3]], axis=-1
    )
    roughness = gbuf.rough_metal[:, 0]
    metalness = gbuf.rough_metal[:, 1]
    # background test (rgen:67): both pos and nrm exactly zero
    shaded = ~(
        jnp.all(world_pos == 0.0, axis=-1) & jnp.all(world_nrm == 0.0, axis=-1)
    )

    color_rgb = jnp.zeros((n, 3), dt)
    color_a = jnp.ones((n,), dt)
    rays = jnp.asarray(0.0, jnp.float32)

    # The shadow ray and the 4 AO rays are independent visibility queries
    # from the same G-buffer point: batch them into ONE trace call
    # (per-lane t limits; lanes that skip a query get dir=0/limit 0, which
    # the tracers treat as dead). RNG draw order is unchanged.
    vis_dirs, vis_lims = [], []
    if use_shadows:  # rgen:81-131
        seed, r = rnd(seed)
        if corr:
            r = corr_tab(64)[:, 1]
        light_idx = jnp.clip((r * float(n_lights)).astype(jnp.int32), 0, n_lights - 1)
        lpos = jnp.take(scene.light_pos, light_idx, axis=0)
        ldir = lpos - world_pos
        ldist = length(ldir)
        l = ldir / jnp.maximum(ldist[:, None], 1e-20)
        facing = dot(l, world_nrm) >= 0.0
        do_trace = shaded & facing
        vis_dirs.append(jnp.where(do_trace[:, None], l, 0.0))
        vis_lims.append(
            jnp.where(do_trace, jnp.maximum(ldist - SHADOW_T_MIN, SHADOW_T_MIN), 0.0)
        )
        rays = rays + jnp.sum(do_trace.astype(jnp.float32))

    if use_ao:  # rgen:133-169
        tangent, binormal = create_coordinate_system(world_nrm)
        for i_ao in range(AO_SAMPLES):
            u = None
            if corr:
                t = corr_tab(65 + i_ao)
                u = (t[:, 2], t[:, 3])
            seed, d = sampling_hemisphere(
                seed, tangent, binormal, world_nrm, uniforms=u
            )
            d = normalize(d)
            vis_dirs.append(jnp.where(shaded[:, None], d, 0.0))
            vis_lims.append(jnp.where(shaded, RTAO_RADIUS, 0.0))
        rays = rays + AO_SAMPLES * jnp.sum(shaded.astype(jnp.float32))

    if vis_dirs:
        k = len(vis_dirs)
        vis_tracer = tracer.with_seed(seed) if hasattr(tracer, "with_seed") else tracer
        hits = vis_tracer.any(
            jnp.concatenate([world_pos] * k),
            jnp.concatenate(vis_dirs),
            SHADOW_T_MIN,
            jnp.concatenate(vis_lims),
        )
        hits = hits.reshape(k, n)
        seg = 0
        if use_shadows:
            blocked = hits[0]
            seg = 1
            visibility = jnp.where(facing & ~(blocked & do_trace), 1.0, 0.0)
            visibility = jnp.maximum(visibility, 0.01)  # rgen:129
            color_a = jnp.where(shaded, color_a * visibility, color_a)
        if use_ao:
            ao = jnp.sum(
                jnp.where(hits[seg : seg + AO_SAMPLES] & shaded[None, :],
                          1.0 / AO_SAMPLES, 0.0),
                axis=0,
            ).astype(dt)
            color_a = jnp.where(shaded, color_a * (1.0 - ao), color_a)

    diff_rad_hitd = jnp.zeros((n, 4), dt)
    if use_gi:  # rgen:171-282
        ratio = metalness * (1.0 - roughness)  # rgen:184 (not the path formula)
        is_diffuse = ratio < 0.8
        tangent, binormal = create_coordinate_system(world_nrm)
        u = None
        if corr:
            t = corr_tab(72)
            u = (t[:, 2], t[:, 3])
        seed_d, hemi = sampling_hemisphere(
            seed, tangent, binormal, world_nrm, uniforms=u
        )
        dir_d = normalize(hemi)
        eye = cam.view_inverse[:3, 3]
        v = normalize(eye - world_pos)
        dir_s = normalize(reflect(-v, world_nrm))
        direction = jnp.where(is_diffuse[:, None], dir_d, dir_s)
        seed = jnp.where(is_diffuse, seed_d, seed)
        cur_weight = jnp.where(is_diffuse[:, None], albedo, jnp.ones((n, 3), dt))

        carry = BounceCarry(
            origin=world_pos,
            direction=direction,
            seed=seed,
            cur_weight=cur_weight,
            hit_value=jnp.zeros((n, 3), dt),
            active=shaded,
            is_specular=~is_diffuse,
            light_dist=jnp.zeros((n,), dt),
            hit_dists=jnp.zeros((n,), dt),
            rays_main=rays,
            rays_shadow=jnp.asarray(0.0, jnp.float32),
        )
        out = bounce_chain(
            scene,
            tracer,
            carry,
            depth=depth,
            start_depth=1,
            clear_color=jnp.zeros(4, dt),  # unused: d>0 misses get 0.01
            hitdist_weight=1.0,
            hitdist_accumulate=False,  # hybrid overwrites (rgen:257-263)
            clamp_weights=clamp_weights,
            corr_seed=corr_seed,
        )
        seed = out.seed
        rays = out.rays_main + out.rays_shadow
        gi = jnp.where(shaded[:, None], out.hit_value, 0.0)
        color_rgb = gi  # rgen:271: color.rgb = indirectColor.rgb

        nh = nrd.norm_hit_dist(out.hit_dists, gbuf.view_z, roughness)
        diff_rad_hitd = nrd.pack_radiance_and_norm_hit_dist(gi, nh)

    color = jnp.concatenate([color_rgb, color_a[:, None]], axis=-1)
    # background pixels accumulate (0,0,0,1) (rgen:67-71)
    color = jnp.where(shaded[:, None], color, jnp.asarray([0, 0, 0, 1], dt))
    new_accum = accumulate(accum_rt, color, frame)
    return new_accum, diff_rad_hitd, seed, rays


def hybrid_frame(
    scene,
    tracer,
    cam,
    frame,
    accum_rt,
    clear_color,
    *,
    width: int,
    height: int,
    depth: int,
    use_shadows: bool,
    use_ao: bool,
    use_gi: bool,
    use_denoiser: bool,
    clamp_weights=False,
    corr: bool = False,
    corr_salt=None,
    pix=None,
    seeds=None,
    perm=None,
    inv_perm=None,
    denoise_state=None,
    tile_axis=None,
):
    """Full hybrid frame: G-buffer pass + RT effects + accumulation
    (main.cpp:506-561). Returns (gbuffer, new_accum, rays, denoise_state').

    ``pix``/``seeds``: optional per-shard pixel coordinates and RNG states
    (SPMD tiling; the denoiser needs the full frame and is unavailable on
    sharded tiles — its à-trous window would cross tile boundaries).
    ``perm``/``inv_perm``: set when ``pix`` is the FULL frame in tile order
    (engine layout): the denoiser then un-permutes its image-space inputs
    and re-permutes the filtered radiance.
    ``denoise_state``: optional DenoiserState — selects the temporal
    (reprojecting) denoiser; None falls back to the spatial-only filter.
    ``tile_axis``: shard_map mesh axis name when ``pix`` is a row-band of
    a tile-sharded frame — the denoiser then runs in its mesh-parallel form
    (ppermute halos + all-gathered reprojection history,
    models/denoiser.denoise_temporal_tile) instead of being skipped."""
    gbuf = gbuffer_pass(scene, tracer, cam, width, height, clear_color, pix=pix)
    seed = seed_pixels(width, height, frame) if seeds is None else seeds
    n = width * height if pix is None else pix.shape[0]
    new_accum, diff_rad_hitd, _, rays = hybrid_effects(
        scene, tracer, gbuf, cam, seed, frame, accum_rt,
        depth=depth, use_shadows=use_shadows, use_ao=use_ao, use_gi=use_gi,
        clamp_weights=clamp_weights, corr=corr, corr_salt=corr_salt,
    )
    rays = rays + jnp.asarray(float(n), jnp.float32)  # primary G-buffer rays
    new_state = denoise_state
    if use_denoiser and use_gi and tile_axis is not None:
        from vkrt.models import denoiser as dn

        assert denoise_state is not None, "tile denoiser is temporal-only"
        filtered, new_state = dn.denoise_temporal_tile(
            denoise_state,
            diff_rad_hitd,
            gbuf.norm_rough,
            gbuf.view_z,
            gbuf.position[:, :3],
            cam.view_proj,
            width, height, tile_axis,
        )
        new_accum = jnp.concatenate([filtered, new_accum[:, 3:4]], axis=-1)
    elif use_denoiser and use_gi and (pix is None or inv_perm is not None):
        from vkrt.models import denoiser as dn
        from vkrt.utils.camera import retile as _retile, untile as _untile

        # perm/inv_perm are tile_perm's (documented contract): when the
        # width is tile-aligned the permutes run as reshape/swapaxes copies
        # instead of (N,)-row gathers
        structured = width % 32 == 0

        def unperm(a):
            if inv_perm is None:
                return a
            if structured:
                return _untile(a, width, height)
            return jnp.take(a, inv_perm, axis=0)

        if denoise_state is not None:
            filtered, new_state = dn.denoise_temporal(
                denoise_state,
                unperm(diff_rad_hitd),
                unperm(gbuf.norm_rough),
                unperm(gbuf.view_z),
                unperm(gbuf.position[:, :3]),
                cam.view_proj,
                width, height,
            )
        else:
            filtered = dn.denoise_gi(
                unperm(diff_rad_hitd), unperm(gbuf.norm_rough),
                unperm(gbuf.view_z), width, height,
            )
        if perm is not None:
            filtered = _retile(filtered, width, height) if structured \
                else jnp.take(filtered, perm, axis=0)
        new_accum = jnp.concatenate([filtered, new_accum[:, 3:4]], axis=-1)
    return gbuf, new_accum, rays, new_state
