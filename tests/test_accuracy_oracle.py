"""Absolute-accuracy bound (BASELINE.md's <=1e-3 RMSE target, in spirit).

No Vulkan ground truth can exist on this machine, so the strongest
available absolute anchor is exact-arithmetic evaluation of the IDENTICAL
estimator: the f32 pipeline the GPU runs (the per-ray traversal kernel, in
interpret mode here, + the XLA shading stage) against a float64
brute-force oracle, equal seeds, equal spp, equal bounce schedule. The RNG emits
identical f32 draws on both paths (ops/rng.py keeps uint32 state and a
fixed 2^-24 quantization), so the two renders follow the SAME random walk
and the residual is purely accumulated floating-point drift + traversal
tie-breaks — the quantity the <=1e-3 budget is meant to bound.
"""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

W, H = 64, 48
FRAMES = 3
DEPTH = 3


def _render(scene, tracer, dtype):
    from vkrt.models.pathtracer import pathtrace_frame
    from vkrt.utils.camera import Camera

    cam = Camera().matrices(W, H)
    cam = jax.tree.map(lambda a: jnp.asarray(a, dtype), cam)
    clear = jnp.asarray([1.0, 1.0, 1.0, 1.0], dtype)
    step = jax.jit(
        partial(pathtrace_frame, scene, tracer,
                width=W, height=H, samples=1, depth=DEPTH)
    )
    accum = jnp.zeros((W * H, 3), dtype)
    for f in range(FRAMES):
        accum, _ = step(cam, f, accum, clear)
    return np.asarray(accum, np.float64)


def test_f32_pallas_vs_f64_bruteforce_oracle():
    from vkrt.ops.trace import build_tracer, make_tracer
    from vkrt.scene import make_cornell_box

    scene = make_cornell_box()

    # the GPU path in f32: the traversal kernel (interpret) + XLA shading
    kernel = build_tracer(scene.tri_v0, scene.tri_e1, scene.tri_e2,
                          "kernel", interpret=True)
    img32 = _render(scene, kernel, jnp.float32)

    with jax.enable_x64():
        scene64 = jax.tree.map(
            lambda a: jnp.asarray(a, jnp.float64)
            if a.dtype == jnp.float32 else jnp.asarray(a),
            scene,
        )
        img64 = _render(scene64, make_tracer(scene64, "bruteforce"),
                        jnp.float64)

    # Compare DISPLAYED images (gamma + [0,1] clip, post.frag:58): the raw
    # accumulation buffer legitimately contains unbounded negative outliers
    # — the reference's specular weight BRDF*cos/pdf is sign-unclamped
    # (raytrace.rchit:205-218) and the firefly clamp only bounds above
    # (rgen:101) — which the display transform clips, exactly as the
    # reference's post pass does. RMSE on [0,1] display values is the
    # BASELINE.md metric's actual domain.
    from vkrt.models.post import tonemap

    disp32 = np.clip(np.asarray(tonemap(jnp.asarray(img32)), np.float64), 0, 1)
    disp64 = np.clip(np.asarray(tonemap(jnp.asarray(img64)), np.float64), 0, 1)

    # Two error populations exist by construction. (1) float drift: tiny,
    # everywhere. (2) chaotic divergence: an f32 rounding that flips a
    # DISCRETE sampling decision (lobe select r1<ratio, light pick, a
    # coplanar-hit tie-break) sends that pixel's entire random walk down a
    # different path — the error there is O(1) no matter how accurate the
    # arithmetic, so it measures decision-boundary density, not numerical
    # quality. Bound both populations separately.
    err = np.abs(disp32 - disp64).max(-1)
    assert np.percentile(err, 99) <= 1e-3, np.percentile(err, 99)
    diverged = err > 1e-2
    assert diverged.mean() < 0.01, diverged.mean()
    rmse = float(np.sqrt(np.mean((disp32 - disp64)[~diverged] ** 2)))
    assert rmse <= 1e-3, rmse

    # and the f64 render is itself sane (finite, lit)
    assert np.isfinite(img64).all()
    assert disp64.mean() > 0.05
