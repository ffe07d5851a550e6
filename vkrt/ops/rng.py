"""Counter/state-based RNG matching the reference's TEA + LCG generators.

The reference seeds a per-pixel LCG with a 16-round TEA hash
(``shaders/random.glsl:6-33``) of the pixel id and ``clockARB()``
(``shaders/raytrace.rgen:27``). ``clockARB`` is non-deterministic, which makes
the reference's images unreproducible run-to-run; we keep the identical TEA/LCG
algorithm but seed with ``tea(pixel_index, frame)`` so every render is
bit-deterministic (the replacement for a wall-clock seed — there is no
``clockARB`` under XLA, and determinism is what makes golden-image tests
possible). Note the reference hashes ``y*x + x`` which collides heavily across
pixels and only decorrelates through the clock; with a deterministic seed we
hash the linear pixel index ``y*width + x`` instead.

All functions are stateless and batched: the LCG state is an explicit uint32
array threaded through the sampler, which is exactly how a functional/XLA
renderer wants its RNG (no hidden state, trivially shardable across devices).
"""

from __future__ import annotations

import jax.numpy as jnp

_LCG_A = jnp.uint32(1664525)
_LCG_C = jnp.uint32(1013904223)
_INV_2_24 = jnp.float32(1.0 / float(0x01000000))


def tea(val0, val1, rounds: int = 16):
    """TEA hash (shaders/random.glsl:6-20). Inputs broadcast; returns uint32."""
    v0 = jnp.asarray(val0).astype(jnp.uint32)
    v1 = jnp.asarray(val1).astype(jnp.uint32)
    v0, v1 = jnp.broadcast_arrays(v0, v1)
    s0 = jnp.uint32(0)
    for _ in range(rounds):
        s0 = s0 + jnp.uint32(0x9E3779B9)
        v0 = v0 + (
            ((v1 << 4) + jnp.uint32(0xA341316C))
            ^ (v1 + s0)
            ^ ((v1 >> 5) + jnp.uint32(0xC8013EA4))
        )
        v1 = v1 + (
            ((v0 << 4) + jnp.uint32(0xAD90777D))
            ^ (v0 + s0)
            ^ ((v0 >> 5) + jnp.uint32(0x7E95761E))
        )
    return v0


def lcg(state):
    """One LCG step (shaders/random.glsl:22-28). Returns (new_state, bits24)."""
    state = _LCG_A * state + _LCG_C
    return state, state & jnp.uint32(0x00FFFFFF)


def rnd(state):
    """Uniform float in [0, 1) (shaders/random.glsl:30-33).

    Returns ``(new_state, u)`` — the functional form of GLSL's
    ``float rnd(inout uint prev)``.
    """
    state, bits = lcg(state)
    return state, bits.astype(jnp.float32) * _INV_2_24


def seed_pixels(width: int, height: int, frame):
    """Per-pixel seeds, flat row-major (N = height*width,) uint32."""
    idx = jnp.arange(width * height, dtype=jnp.uint32)
    return tea(idx, jnp.uint32(frame))


# --- correlated per-block sampling (opt-in, see RenderSettings) -------------
#
# The incoherent-pool trace is visit-count-bound: a block of rays costs the
# union of its rays' traversal footprints, and independently-sampled bounce
# directions spread a cosine lobe over >= 4 octants. Sharing the SAMPLING
# DECISIONS across a block — one lobe pick, one light
# pick, one hemisphere point, one GGX half-vector point per (block, bounce,
# frame) — makes a block's bounce directions cohere (identical local sample
# vector rotated into each lane's own TBN frame) and its NEE shadow rays
# converge on one light. Each pixel's draw is still marginally uniform and
# independent ACROSS frames (the table is re-hashed per frame), so the
# estimator stays unbiased with unchanged per-pixel variance; the trade is
# correlated noise WITHIN a block per frame (structured, block-shaped noise
# in unconverged frames) which temporal accumulation averages out at the
# same 1/N rate. Matches the bounce loop of raytrace.rgen:62-116 in
# distribution, not draw-for-draw.

CORR_DRAWS = 6  # lobe, light, hemi r1/r2, ggx r1/r2

# Lanes per shared-draw block: 1024 consecutive lanes of a pool (one 32x32
# pixel tile of the engine's tile-ordered layout) share one draw row.
CORR_BLOCK = 1024


def block_uniform_table(n_blocks: int, corr_seed, depth: int):
    """(G, CORR_DRAWS) f32 of per-block shared uniforms in [0,1) for one
    bounce.

    ``corr_seed``: traced uint32 scalar (frame/sample mix). ``depth`` is
    static."""
    i = jnp.arange(n_blocks, dtype=jnp.uint32)
    dkey = jnp.asarray(depth).astype(jnp.uint32) * jnp.uint32(0x85EBCA6B)
    st = tea(i, jnp.asarray(corr_seed, jnp.uint32) ^ dkey, rounds=8)
    us = []
    for _ in range(CORR_DRAWS):
        st, u = rnd(st)
        us.append(u)
    return jnp.stack(us, axis=1)


def corr_draws(n: int, corr_seed, depth: int, block: int = CORR_BLOCK):
    """Per-lane view of the block table: (N, CORR_DRAWS) f32, each run of
    ``block`` consecutive lanes sharing one row. Pool order is tile order
    (the engine feeds tile-ordered pools and never re-sorts)."""
    g = -(-n // block)
    tab = block_uniform_table(g, corr_seed, depth)
    return jnp.repeat(tab, block, axis=0)[:n]
