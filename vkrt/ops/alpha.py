"""Alpha-tested any-hit: stochastic transparency as masked re-tracing.

The reference ships (unwired) any-hit shaders that stochastically ignore
intersections on transparent materials (raytrace_rahit_todo.glsl:32-38:
``illum==4`` materials punch through with probability ``1 - dissolve``, and
``dissolve==0`` always punches). Hardware any-hit shaders interrupt traversal
per intersection; the equivalent here is a bounded *re-trace loop*
outside the kernel: trace closest, evaluate the hit's opacity host-of-kernel
(material factors + baseColor texture alpha at the hit UV — the glTF
generalization of dissolve), draw an RNG, and re-launch only the punched
lanes from just past the hit. Punched lanes re-enter the trace with their
origins advanced; settled lanes are parked at infinity so the kernel's root
vote culls their blocks — each extra round costs roughly one near-empty
kernel launch.

Opacity semantics (glTF 2.0 alphaMode x reference rahit):
* OPAQUE (0): opacity 1 — never punches (rahit: ``illum != 4`` returns).
* MASK (1): opacity is 1 where alpha >= cutoff else 0 — deterministic
  cutout (the classic alpha-tested foliage case).
* BLEND (2): opacity = alpha — stochastic transparency, the direct
  ``rnd(prd.seed) > mat.dissolve`` analog.

The punch RNG derives from a TEA hash of the lane seed and the round index
instead of advancing the caller's sampling stream: the reference *would*
advance prd.seed in the any-hit, but its rahit was never wired into a
pipeline, so there is no stream to match — keeping the main estimator's
draws untouched preserves all existing goldens for opaque scenes.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from vkrt.ops.rng import tea, rnd

# Max transparent surfaces a single ray segment can punch through per trace.
# Beyond this the last hit is accepted (bounded bias, matches the spirit of
# hardware traversal budgets).
DEFAULT_ROUNDS = 4


def scene_has_alpha(scene) -> bool:
    """Host-side static gate: True iff any material can punch through."""
    from vkrt.utils.hostmirror import asnumpy

    return bool((asnumpy(scene.mat_alpha_mode) != 0).any())


def opacity_at_hit(scene, tri, u, v):
    """Effective opacity of a hit: baseColor.a (factor x texture) through the
    material's alphaMode. ``tri`` pre-clamped >= 0."""
    mat_id = jnp.take(scene.tri_mat, tri)
    mode = jnp.take(scene.mat_alpha_mode, mat_id)
    alpha = jnp.take(scene.mat_base_color, mat_id, axis=0)[:, 3]
    cutoff = jnp.take(scene.mat_alpha_cutoff, mat_id)

    from vkrt.scene import scene_is_textured

    if scene_is_textured(scene):
        from vkrt.ops.texture import sample_texture

        w = 1.0 - u - v
        cuv = jnp.take(scene.corner_uv, tri, axis=0)  # (N,3,2)
        bary = jnp.stack([w, u, v], axis=-1)[..., None]
        uv = jnp.sum(cuv * bary, axis=1)
        base_tex = jnp.take(scene.mat_base_tex, mat_id)
        alpha = alpha * sample_texture(scene.tex_rgba, scene.tex_size,
                                       base_tex, uv)[:, 3]

    masked = (alpha >= cutoff).astype(alpha.dtype)
    return jnp.where(mode == 0, 1.0, jnp.where(mode == 1, masked, alpha))


def alpha_closest(scene, tracer, orig, direction, t_min, t_max, t_lim, seed,
                  rounds: int = DEFAULT_ROUNDS):
    """``tracer.closest`` with stochastic alpha punch-through.

    ``t_lim`` is per-lane (same contract as Tracer.closest); the
    returned HitInfo's ``t`` is measured from the ORIGINAL origin, so callers
    see the same geometry contract as an opaque trace. ``seed`` is consumed
    read-only (see module docstring).
    """
    hi = tracer.closest(orig, direction, t_min, t_max, t_lim=t_lim)
    if rounds <= 0:
        return hi

    n = orig.shape[0]
    # a lane is "unsettled" only while its newest hit still awaits its punch
    # decision: once a lane accepts a hit (or misses) it is settled for good —
    # re-drawing settled lanes each round would compound the punch probability
    unsettled = jnp.ones((n,), bool)

    def punch_round(r, hi, unsettled):
        a = opacity_at_hit(scene, jnp.maximum(hi.tri, 0), hi.u, hi.v)
        # decorrelated per-(lane, round) uniform draw
        bits = tea(seed ^ jnp.uint32(0x61706861), jnp.uint32(r + 1), rounds=8)
        u01 = (bits & jnp.uint32(0x00FFFFFF)).astype(jnp.float32) * (1.0 / 16777216.0)
        punch = unsettled & hi.hit & (u01 >= a)  # rahit: rnd > dissolve -> ignore

        # advance punched lanes just past their hit; park everyone else.
        # hi.t is ALWAYS measured from the original origin (the merge below
        # shifts re-trace results back by +adv), so the advance is computed
        # directly from it — adding the previous round's advance again would
        # double-count and overshoot past real geometry on stacked
        # transparent surfaces.
        adv = hi.t * (1.0 + 1e-4) + 1e-3
        new_o = orig + direction * adv[:, None]
        to = jnp.where(punch[:, None], new_o, 1e30)
        td = jnp.where(punch[:, None], direction, 0.0)
        tl = jnp.where(punch, t_lim - adv, -1.0)
        hi2 = tracer.closest(to, td, t_min, t_max, t_lim=tl)

        # merge: punched lanes adopt the re-trace result (t shifted back to
        # the original origin's frame); settled lanes keep theirs
        hi = type(hi)(
            hit=jnp.where(punch, hi2.hit, hi.hit),
            t=jnp.where(punch, hi2.t + adv, hi.t),
            tri=jnp.where(punch, hi2.tri, hi.tri),
            u=jnp.where(punch, hi2.u, hi.u),
            v=jnp.where(punch, hi2.v, hi.v),
        )
        return hi, punch  # only re-traced lanes have an undecided hit

    hi, unsettled = punch_round(0, hi, unsettled)
    for r in range(1, rounds):
        # rounds after the first are usually no-ops (most pools punch zero
        # or one layer); lax.cond skips the re-trace launch + opacity
        # gathers entirely once every lane has settled
        hi, unsettled = jax.lax.cond(
            jnp.any(unsettled),
            lambda h, s, r=r: punch_round(r, h, s),
            lambda h, s: (h, jnp.zeros_like(s)),
            hi, unsettled,
        )
    return hi


def make_alpha_tracer(scene, inner, rounds: int = DEFAULT_ROUNDS):
    """Wrap ``inner`` with punch-through when the scene needs it (else return
    ``inner`` unchanged — zero cost for opaque scenes)."""
    if not scene_has_alpha(scene):
        return inner
    return AlphaTracer(scene=scene, inner=inner, rounds=rounds)


class AlphaTracer:
    """Tracer adapter: same closest/any surface, alpha-aware.

    Carries a per-call seed via ``with_seed`` (functional; returns a new
    adapter) so estimator code can hand its lane seeds down without changing
    the tracer call signature used across the renderer.
    """

    def __init__(self, scene, inner, rounds: int = DEFAULT_ROUNDS, seed=None):
        self.scene = scene
        self.inner = inner
        self.rounds = rounds
        self.seed = seed

    def with_seed(self, seed):
        return AlphaTracer(self.scene, self.inner, self.rounds, seed)

    def _seed_for(self, n):
        if self.seed is not None:
            return self.seed
        return jnp.arange(n, dtype=jnp.uint32)  # deterministic fallback

    def closest(self, orig, direction, t_min, t_max, t_lim=None):
        if t_lim is None:
            t_lim = jnp.broadcast_to(jnp.asarray(t_max, orig.dtype),
                                     orig.shape[:1])
        seed = self._seed_for(orig.shape[0])
        if seed.shape[0] != orig.shape[0]:
            # fused shadow+bounce batches trace 2N rays with N seeds: tile,
            # decorrelating each repeat so a lane's bounce and shadow rays
            # draw independent punch decisions
            reps = -(-orig.shape[0] // seed.shape[0])
            seed = jnp.concatenate(
                [seed ^ jnp.uint32(r * 0x9E3779B9) for r in range(reps)]
            )[: orig.shape[0]]
        return alpha_closest(self.scene, self.inner, orig, direction, t_min,
                             t_max, t_lim, seed, self.rounds)

    def any(self, orig, direction, t_min, t_max):
        t_lim = jnp.broadcast_to(jnp.asarray(t_max, orig.dtype),
                                 orig.shape[:1]) if jnp.ndim(t_max) == 0 else t_max
        hi = self.closest(orig, direction, t_min, jnp.max(t_lim), t_lim=t_lim)
        return hi.hit
