"""Sharded frame rendering via shard_map over a (tile, spp) mesh.

One jitted SPMD program per frame: each device runs the identical bounce
chain (vkrt.models.pathtracer) on its pixel tile and sample group; the
only collective is a psum-mean over the spp axis. Scene and BVH are
replicated (read-only); the accumulation image lives sharded across frames
so no resharding happens frame to frame.

Seeding: sample groups get decorrelated streams via
``tea(pixel_index, frame * n_spp_groups + group)`` — with one spp group this
reduces exactly to the single-chip seeding (rng.seed_pixels), so a 1-device
mesh reproduces the unsharded image bit-for-bit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from vkrt.models.pathtracer import accumulate, trace_pixels
from vkrt.ops.rng import tea
from vkrt.utils.camera import pixel_coords, tile_perm


def make_sharded_pathtrace_step(
    scene, tracer, mesh: Mesh, *, width: int, height: int, samples: int,
    depth: int, corr: bool = False,
):
    """Build the jitted sharded step. Returns ``(step, inv_perm)``:
    ``step(cam, frame, accum, clear) -> (accum', rays)`` with ``accum``
    (H*W, 3) sharded P('tile'), and ``inv_perm`` (H*W,) i32 mapping the
    accumulator to scanline image order (``image = accum[inv_perm]``).

    The accumulator lives in SHARD-TILE order across frames: each band's
    rows are 32x32-tile-permuted for trace coherence and stay that way —
    un-permuting the radiance (an (H*W,)-row gather) is paid once at
    display time instead of every frame (the single-device engine does the
    same)."""
    n = width * height
    n_tile = mesh.shape["tile"]
    n_spp = mesh.shape["spp"]
    assert n % n_tile == 0, f"pixels {n} not divisible by tile axis {n_tile}"
    assert samples % n_spp == 0, f"spp {samples} not divisible by spp axis {n_spp}"
    local_samples = samples // n_spp

    pix_all = pixel_coords(width, height)
    pid_all = jnp.arange(n, dtype=jnp.uint32)

    # Per-shard 32x32 tile blocking: a shard's band arrives in scanline
    # order, but trace blocks and corr-sampler blocks want compact pixel
    # tiles, not 1024-wide stripes (the single-device engine permutes the
    # whole frame the same way). The pix/pid permutation is applied on the
    # HOST at build time (band-wise, so each shard's slice is already in
    # its band-tile order — two fewer (N,)-gathers per frame in the body).
    import numpy as _np

    local_tile = height % n_tile == 0  # whole row bands only
    if local_tile:
        band_perm, _ = tile_perm(width, height // n_tile)
        band_n = n // n_tile
        global_perm = _np.concatenate(
            [_np.asarray(band_perm) + b * band_n for b in range(n_tile)]
        )
        pix_all = jnp.take(pix_all, jnp.asarray(global_perm), axis=0)
        pid_all = pid_all[jnp.asarray(global_perm)]
        inv_perm = jnp.asarray(_np.argsort(global_perm).astype(_np.int32))
    else:
        inv_perm = jnp.arange(n, dtype=jnp.int32)

    def shard_body(cam, frame, accum_shard, clear_color, pix, pid):
        group = jax.lax.axis_index("spp").astype(jnp.uint32)
        seeds = tea(pid, jnp.uint32(frame) * jnp.uint32(n_spp) + group)
        # corr: the shared-draw tables must differ per shard AND per spp
        # group (a pixel sampled by two groups must not reuse one block
        # draw), so salt the corr seed with both axis indices. A (1,1)
        # mesh salts to 0 and reproduces the unsharded corr stream
        # bit-for-bit; multi-shard corr is a different (equally unbiased)
        # correlated estimator — block membership follows the local pool.
        corr_salt = None
        if corr:
            tile_i = jax.lax.axis_index("tile").astype(jnp.uint32)
            corr_salt = (
                tile_i * jnp.uint32(0xC2B2AE35)
                + group * jnp.uint32(0x27D4EB2F)
            )
        res = trace_pixels(
            scene,  # replicated via closure capture
            tracer,
            cam,
            width,
            height,
            frame,
            clear_color,
            samples=local_samples,
            depth=depth,
            corr=corr,
            corr_salt=corr_salt,
            pix=pix,
            seeds=seeds,
        )
        radiance = jax.lax.pmean(res.radiance, "spp")
        rays = jax.lax.psum(res.rays, ("tile", "spp"))
        return accumulate(accum_shard, radiance, frame), rays

    mapped = shard_map(
        shard_body,
        mesh=mesh,
        in_specs=(P(), P(), P("tile"), P(), P("tile"), P("tile")),
        out_specs=(P("tile"), P()),
        # the bounce chain's scan carries mix device-varying and replicated
        # values (e.g. zero-initialized accumulators); skip the vma check
        check_vma=False,
    )

    @jax.jit
    def step(cam, frame, accum, clear_color):
        return mapped(cam, frame, accum, clear_color, pix_all, pid_all)

    return step, inv_perm


def make_sharded_hybrid_step(
    scene, tracer, mesh: Mesh, *,
    width: int, height: int, depth: int,
    use_shadows: bool = True, use_ao: bool = True, use_gi: bool = False,
    use_denoiser: bool = False, corr: bool = False,
):
    """Sharded hybrid frame: pixel tiles over the 'tile' axis (the hybrid
    pass has one sample stream, so the spp axis must be 1).

    With ``use_denoiser`` (requires ``use_gi``), the temporal denoiser runs
    INSIDE the mesh in its tile form (models/denoiser.denoise_temporal_tile:
    ppermute row halos for the à-trous/clamp stencils, all-gathered history
    for reprojection) — per-pixel equal to the full-frame filter. The step
    then takes and returns a band-sharded DenoiserState. Requires
    height % n_tile == 0 (whole row bands) and band height >= the filter's
    2^iterations tap reach."""
    from vkrt.models.denoiser import DenoiserState
    from vkrt.models.hybrid import hybrid_frame

    n = width * height
    n_tile = mesh.shape["tile"]
    assert mesh.shape["spp"] == 1, "hybrid mode shards pixels only"
    assert n % n_tile == 0, f"pixels {n} not divisible by tile axis {n_tile}"
    if use_denoiser:
        assert use_gi, "denoiser filters the GI channel"
        assert height % n_tile == 0, \
            f"denoised mesh needs whole row bands: {height} % {n_tile} != 0"

    pix_all = pixel_coords(width, height)
    pid_all = jnp.arange(n, dtype=jnp.uint32)

    def shard_body(cam, frame, accum_shard, clear_color, dstate, pix, pid):
        seeds = tea(pid, jnp.uint32(frame))
        corr_salt = None
        if corr:  # see make_sharded_pathtrace_step (spp axis is 1 here)
            corr_salt = (
                jax.lax.axis_index("tile").astype(jnp.uint32)
                * jnp.uint32(0xC2B2AE35)
            )
        gbuf, new_accum, rays, new_state = hybrid_frame(
            scene, tracer, cam, frame, accum_shard, clear_color,
            width=width, height=height, depth=depth,
            use_shadows=use_shadows, use_ao=use_ao, use_gi=use_gi,
            use_denoiser=use_denoiser, corr=corr, corr_salt=corr_salt,
            pix=pix, seeds=seeds,
            denoise_state=dstate,
            tile_axis="tile" if use_denoiser else None,
        )
        return gbuf, new_accum, jax.lax.psum(rays, ("tile", "spp")), new_state

    state_spec = DenoiserState(
        hist_rad=P("tile"), hist_m1=P("tile"), hist_m2=P("tile"),
        hist_len=P("tile"), prev_view_proj=P(),
        prev_view_z=P("tile"), prev_normal=P("tile"),
    )
    mapped = shard_map(
        shard_body,
        mesh=mesh,
        in_specs=(P(), P(), P("tile"), P(),
                  state_spec if use_denoiser else P(),
                  P("tile"), P("tile")),
        out_specs=(P("tile"), P("tile"), P(),
                   state_spec if use_denoiser else P()),
        check_vma=False,
    )

    if use_denoiser:
        @jax.jit
        def step(cam, frame, accum_rt, clear_color, denoise_state):
            return mapped(cam, frame, accum_rt, clear_color, denoise_state,
                          pix_all, pid_all)

        return step

    @jax.jit
    def step(cam, frame, accum_rt, clear_color):
        gbuf, new_accum, rays, _ = mapped(
            cam, frame, accum_rt, clear_color, jnp.zeros((), jnp.float32),
            pix_all, pid_all,
        )
        return gbuf, new_accum, rays

    return step


def device_put_accum(mesh: Mesh, width: int, height: int):
    """Fresh accumulation image, sharded over the tile axis."""
    return jax.device_put(
        jnp.zeros((width * height, 3), jnp.float32), NamedSharding(mesh, P("tile"))
    )


def render_sharded(
    scene, tracer, cam, mesh, *, width, height, samples, depth, frames,
    clear_color, corr=False,
):
    """Render ``frames`` progressive frames under the mesh; returns the
    accumulator in SCANLINE order (N,3)."""
    step, inv_perm = make_sharded_pathtrace_step(
        scene, tracer, mesh, width=width, height=height, samples=samples,
        depth=depth, corr=corr,
    )
    accum = device_put_accum(mesh, width, height)
    rays_per_frame = []
    for f in range(frames):
        accum, rays = step(cam, f, accum, jnp.asarray(clear_color, jnp.float32))
        # keep the counter on device: float(rays) here would sync the
        # pipeline every frame
        rays_per_frame.append(rays)
    total_rays = float(sum(jax.device_get(r) for r in rays_per_frame))
    return jnp.take(accum, inv_perm, axis=0), total_rays
