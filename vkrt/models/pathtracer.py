"""Progressive Monte-Carlo path tracer — the ``raytrace.rgen`` port.

A frame is a pure function over ray batches: for every pixel, ``samples``
paths of up to ``depth`` bounces with NEE shadow rays, the reference's exact
estimator quirks preserved (SURVEY.md §7 item (e)):

* contribution per bounce ``min(prd.hitValue * curWeight, 10)`` — the 10.0
  firefly clamp (rgen:101) — *skipped entirely when the shadow ray is
  blocked* (rgen:99-102), emission included;
* miss radiance ``clearColor*0.8`` on primary, 0.01 ambient on secondary
  (raytrace.rmiss:15-18), and a miss ends the path (depth=100);
* shadow ray only for diffuse bounces, tMax ``lightDist - 0.1`` (rgen:79-97);
* frame-0 subpixel jitter forced to pixel center (rgen:44) — the two RNG
  draws still advance, like the GLSL;
* progressive accumulation ``mix(old, new, 1/(frame+1))`` (rgen:136-145).

The bounce loop is a ``lax.fori_loop`` with all lanes advancing in lockstep
under masks — the SIMD restructuring of the reference's per-thread loop. The
loop carries stale payload state (lightDist) across misses exactly like the
GLSL payload does, because the rgen's depth==1 hit-distance bookkeeping reads
it (rgen:103-114).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from vkrt.models.shading import clamp_bounds, sample_bsdf, surface_at_hit
from vkrt.ops.intersect import T_MAX, T_MIN
from vkrt.ops.rng import rnd, seed_pixels
from vkrt.utils.camera import generate_rays


class BounceCarry(NamedTuple):
    origin: jnp.ndarray       # (N,3) prd.rayOrigin
    direction: jnp.ndarray    # (N,3) prd.rayDirection
    seed: jnp.ndarray         # (N,) uint32
    cur_weight: jnp.ndarray   # (N,3) curWeight
    hit_value: jnp.ndarray    # (N,3) accumulated hitValue
    active: jnp.ndarray       # (N,) path still in the bounce loop
    is_specular: jnp.ndarray  # (N,) prd.isSpecular (persists across miss)
    light_dist: jnp.ndarray   # (N,) prd.lightDist (persists across miss)
    hit_dists: jnp.ndarray    # (N,) denoiser hit-distance bookkeeping
    rays_main: jnp.ndarray    # () f32 count of main rays traced
    rays_shadow: jnp.ndarray  # () f32 count of shadow rays traced


def bounce_chain(
    scene,
    tracer,
    carry: BounceCarry,
    *,
    depth: int,
    start_depth: int,
    clear_color,
    hitdist_weight: float,
    hitdist_accumulate: bool,
    clamp_weights=False,
    corr_seed=None,
) -> BounceCarry:
    """Run the shared bounce loop (rgen:62-116 / raytraceHybrid.rgen:211-266).

    ``hitdist_accumulate``: path mode does ``hitDists += w*...`` (rgen:107),
    hybrid GI overwrites ``hitDists = ...`` (hybrid rgen:257).
    ``clamp_weights``: opt-in extension bounding the path throughput — a
    Python bool or traced (2,) [lo, hi] bounds (see
    models.shading.clamp_bounds; the engine passes traced bounds so the
    toggle is zero-recompile).
    ``corr_seed``: traced uint32 scalar enabling the correlated per-block
    sampler (ops.rng.corr_draws) — None keeps independent per-lane draws.

    The loop is *software-pipelined* around the trace: after shading
    bounce d, the shadow rays of bounce d and the main rays of bounce d+1
    are batched into ONE unified trace call (per-lane t-limit; see
    ops.trace) — halving the per-bounce trace launches vs the GLSL's two
    ``traceRayEXT`` calls per iteration (rgen:64, 85).
    """
    if depth <= start_depth:
        return carry
    cl_lohi = clamp_bounds(clamp_weights)
    clear3 = jnp.asarray(clear_color, carry.origin.dtype)[:3]
    n = carry.origin.shape[0]
    dt = carry.origin.dtype

    def seeded(c: BounceCarry):
        # alpha-aware tracers draw punch-through RNG from the lane seeds
        return tracer.with_seed(c.seed) if hasattr(tracer, "with_seed") else tracer

    def closest(tr, orig, direction, t_lim):
        return tr.closest(orig, direction, T_MIN, T_MAX, t_lim=t_lim)

    def trace_start(c: BounceCarry):
        # dead lanes get a degenerate ray (dir=0, origin parked at infinity,
        # t-limit -1): contribution-neutral, and the traversal kernel
        # never lets them into its loop
        live_dir = jnp.where(c.active[:, None], c.direction, 0.0)
        live_origin = jnp.where(c.active[:, None], c.origin, 1e30)
        return closest(seeded(c), live_origin, live_dir,
                       jnp.where(c.active, T_MAX, -1.0))

    def body(d, c: BounceCarry, hi, trace_next: bool):
        """Shade bounce d from its hit info, launch the fused
        (next-main + shadow) trace, apply NEE. Returns (carry, next hit)."""
        miss = ~hi.hit & c.active | ~c.active
        tri = jnp.maximum(hi.tri, 0)

        surf = surface_at_hit(scene, tri, hi.u, hi.v, c.direction)
        emit_gate = (d == 0) | c.is_specular  # rchit:83
        corr = None
        if corr_seed is not None:
            from vkrt.ops.rng import corr_draws

            corr = corr_draws(n, corr_seed, d).astype(dt)
        bs = sample_bsdf(scene, surf, c.direction, c.seed, emit_gate,
                         corr=corr)

        # rmiss (raytrace.rmiss:11-19)
        miss_value = jnp.where(d == 0, clear3 * 0.8, jnp.full_like(clear3, 0.01))
        hit_value_this = jnp.where(miss[:, None], miss_value, bs.emit_plus_nee)
        is_spec_this = jnp.where(miss, c.is_specular, bs.is_specular)
        light_dist_this = jnp.where(miss, c.light_dist, bs.light_dist)

        # shadow ray (rgen:77-97): diffuse hits only. Lanes that don't need
        # one get dir=0 and t-limit 0, which the tracers treat as dead.
        do_shadow = c.active & ~miss & ~is_spec_this
        sh_dir = jnp.where(do_shadow[:, None], bs.shadow_dir, 0.0)
        sh_dist = jnp.maximum(light_dist_this - 0.1, T_MIN)
        sh_lim = jnp.where(do_shadow, sh_dist, 0.0)
        active_next = c.active & ~miss

        if trace_next:
            nx_o = jnp.where(active_next[:, None], surf.world_pos, 1e30)
            nx_d = jnp.where(active_next[:, None], bs.next_dir, 0.0)
            nx_lim = jnp.where(active_next, T_MAX, -1.0)
            res = closest(
                seeded(c),
                jnp.concatenate([nx_o, surf.world_pos]),
                jnp.concatenate([nx_d, sh_dir]),
                jnp.concatenate([nx_lim, sh_lim]),
            )
            hi_next = jax.tree.map(lambda x: x[:n], res)
            shadow_hit = res.hit[n:]
        else:
            shadow_hit = seeded(c).any(surf.world_pos, sh_dir, T_MIN, sh_lim)
            hi_next = hi
        shadow_hit = shadow_hit & do_shadow

        contrib = jnp.minimum(hit_value_this * c.cur_weight, 10.0)  # rgen:101
        add = (c.active & ~shadow_hit)[:, None]
        hit_value = c.hit_value + jnp.where(add, contrib, 0.0)

        # hit-distance bookkeeping at depth 1 for diffuse (rgen:103-114);
        # miss lanes are excluded: rmiss sets prd.depth=100 (rgen:103) so the
        # GLSL never runs this block for them (stale light_dist would leak)
        at_d1 = (d == 1) & ~is_spec_this & c.active & ~miss
        hd_new = jnp.where(shadow_hit, 0.5 * light_dist_this, light_dist_this)
        hd_new = hd_new * hitdist_weight
        if hitdist_accumulate:
            hit_dists = jnp.where(at_d1, c.hit_dists + hd_new, c.hit_dists)
        else:
            hit_dists = jnp.where(at_d1, hd_new, c.hit_dists)

        step_weight = bs.weight
        # traced clamp bounds ([-inf,+inf] = bit-exact identity when off;
        # see models.shading.clamp_bounds) — toggling never recompiles
        step_weight = jnp.minimum(
            jnp.maximum(step_weight, cl_lohi[0]), cl_lohi[1]
        )
        cur_weight = c.cur_weight * jnp.where(miss[:, None], 1.0, step_weight)
        # (curWeight *= prd.weight also runs on miss lanes in the GLSL, but
        # those lanes exit the loop and never contribute — skipping the stale
        # multiply is contribution-equivalent and avoids 0*inf NaNs.)

        new_c = BounceCarry(
            origin=jnp.where(miss[:, None], c.origin, surf.world_pos),
            direction=jnp.where(miss[:, None], c.direction, bs.next_dir),
            seed=jnp.where(miss, c.seed, bs.seed),
            cur_weight=cur_weight,
            hit_value=hit_value,
            active=active_next,
            is_specular=is_spec_this,
            light_dist=light_dist_this,
            hit_dists=hit_dists,
            rays_main=c.rays_main
            + (jnp.sum(active_next.astype(jnp.float32)) if trace_next else 0.0),
            rays_shadow=c.rays_shadow + jnp.sum(do_shadow.astype(jnp.float32)),
        )
        return new_c, hi_next

    hi0 = trace_start(carry)
    carry = carry._replace(
        rays_main=carry.rays_main + jnp.sum(carry.active.astype(jnp.float32))
    )

    # Static unroll for typical depths: lets shading fuse across bounces
    # and skips the last bounce's next-ray half.
    if depth - start_depth <= 8:
        hi = hi0
        for d in range(start_depth, depth):
            carry, hi = body(d, carry, hi, trace_next=(d < depth - 1))
        return carry
    # deep-bounce fallback: fori with the fused trace every iteration (the
    # final iteration's next-ray half is traced and discarded — bounded waste)

    def fbody(d, state):
        # the fused call already counted its next rays; the final iteration
        # over-counts the discarded half, corrected after the loop
        return body(d, *state, trace_next=True)

    carry, _ = jax.lax.fori_loop(start_depth, depth, fbody, (carry, hi0))
    # remove the dangling next-trace ray count from the last iteration
    return carry._replace(
        rays_main=carry.rays_main - jnp.sum(carry.active.astype(jnp.float32))
    )


class PathTraceResult(NamedTuple):
    radiance: jnp.ndarray   # (N,3) prd.hitValue (mean over spp)
    hit_dists: jnp.ndarray  # (N,) REBLUR hit-distance input
    rays: jnp.ndarray       # () f32 total rays traced (main + shadow)


def trace_pixels(
    scene,
    tracer,
    cam,
    width: int,
    height: int,
    frame,
    clear_color,
    *,
    samples: int,
    depth: int,
    clamp_weights=False,
    corr: bool = False,
    corr_salt=None,
    pix=None,
    seeds=None,
) -> PathTraceResult:
    """Full rgen main() over all pixels (rgen:24-121).

    ``pix``/``seeds``: optional per-shard pixel coordinates and RNG states —
    the SPMD entry used by vkrt.parallel to run this function on a tile
    of the frame per device. Defaults cover the whole frame.
    ``corr``: correlated per-block sampler (RenderSettings.corr_sampler).
    ``corr_salt``: traced uint32 decorrelating the shared-draw tables across
    SPMD shards / spp groups (same pixel sampled twice must not reuse one
    block draw). Salt 0 (or None) reproduces the unsharded stream exactly.
    """
    n = width * height if pix is None else pix.shape[0]
    dt = scene.tri_v0.dtype
    seed = seed_pixels(width, height, frame) if seeds is None else seeds

    def sample_body(s, acc):
        seed, hit_values, hit_dists, rays = acc
        corr_seed = None
        if corr:
            # fresh shared-draw table per (frame, sample): per-pixel draws
            # stay independent across frames/samples, correlated per block
            corr_seed = (
                jnp.asarray(frame).astype(jnp.uint32) * jnp.uint32(0x9E3779B9)
                + jnp.asarray(s).astype(jnp.uint32) * jnp.uint32(0x6A09E667)
            )
            if corr_salt is not None:
                corr_seed = corr_seed + jnp.asarray(corr_salt, jnp.uint32)
        seed, r1 = rnd(seed)
        seed, r2 = rnd(seed)
        jitter = jnp.where(
            jnp.asarray(frame) == 0,
            jnp.full((n, 2), 0.5, dt),
            jnp.stack([r1, r2], axis=-1),
        )
        origin, direction = generate_rays(cam, width, height, jitter, pix=pix)
        carry = BounceCarry(
            origin=origin,
            direction=direction,
            seed=seed,
            cur_weight=jnp.ones((n, 3), dt),
            hit_value=jnp.zeros((n, 3), dt),
            active=jnp.ones((n,), bool),
            is_specular=jnp.zeros((n,), bool),
            light_dist=jnp.zeros((n,), dt),
            hit_dists=hit_dists,
            rays_main=rays,
            rays_shadow=jnp.asarray(0.0, jnp.float32),
        )
        out = bounce_chain(
            scene,
            tracer,
            carry,
            depth=depth,
            start_depth=0,
            clear_color=clear_color,
            hitdist_weight=1.0 / samples,
            hitdist_accumulate=True,
            clamp_weights=clamp_weights,
            corr_seed=corr_seed,
        )
        return (
            out.seed,
            hit_values + out.hit_value,
            out.hit_dists,
            out.rays_main + out.rays_shadow,
        )

    init = (
        seed,
        jnp.zeros((n, 3), dt),
        jnp.zeros((n,), dt),
        jnp.asarray(0.0, jnp.float32),
    )
    if samples <= 4:  # static unroll (see bounce_chain note)
        acc = init
        for s in range(samples):
            acc = sample_body(s, acc)
        _, hit_values, hit_dists, rays = acc
    else:
        _, hit_values, hit_dists, rays = jax.lax.fori_loop(
            0, samples, sample_body, init
        )
    return PathTraceResult(
        radiance=hit_values / samples, hit_dists=hit_dists, rays=rays
    )


def accumulate(accum, new, frame):
    """Progressive accumulation mix(old, new, 1/(frame+1)) (rgen:136-145)."""
    a = 1.0 / (jnp.asarray(frame, new.dtype) + 1.0)
    blended = accum * (1.0 - a) + new * a
    return jnp.where(jnp.asarray(frame) > 0, blended, new)


def pathtrace_frame(
    scene,
    tracer,
    cam,
    frame,
    accum,
    clear_color,
    *,
    width: int,
    height: int,
    samples: int,
    depth: int,
    clamp_weights=False,
    corr: bool = False,
    pix=None,
    seeds=None,
):
    """One path-traced frame + accumulation (hello_vulkan.cpp:1423-1448).

    ``accum``: (H*W, 3) running image, in the same pixel order as ``pix``
    (the engine passes tile-ordered pixels for trace coherence).
    Returns (new_accum, rays).
    """
    res = trace_pixels(
        scene, tracer, cam, width, height, frame, clear_color,
        samples=samples, depth=depth, clamp_weights=clamp_weights,
        corr=corr, pix=pix, seeds=seeds,
    )
    return accumulate(accum, res.radiance, frame), res.rays
