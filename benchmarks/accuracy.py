"""Device accuracy anchor: the default device against the float64 oracle.

Renders a small Cornell on the default device through the tracer ``auto``
picks there (the traversal kernel on a GPU), and bounds it against the
float64 brute-force oracle of the identical estimator on the CPU — the
BASELINE.md <=1e-3 RMSE target, with the methodology of
tests/test_accuracy_oracle.py (two error populations: float drift bounded
by RMSE/p99, chaotic discrete-decision divergence bounded by count).

Run standalone (``python -m benchmarks.accuracy``; exits 5 when out of
budget) or through bench.py / chip_smoke.py, where a miss is fatal.
"""

from __future__ import annotations

import json
import sys
from functools import partial

W, H = 64, 48
FRAMES = 3
DEPTH = 3

BUDGET_RMSE = 1e-3
BUDGET_P99 = 1e-3
BUDGET_DIVERGED = 0.01


def _render(scene, tracer, dtype, device=None):
    import numpy as np
    import jax
    import jax.numpy as jnp

    from vkrt.models.pathtracer import pathtrace_frame
    from vkrt.utils.camera import Camera

    cam = Camera().matrices(W, H)
    cam = jax.tree.map(lambda a: jnp.asarray(a, dtype), cam)
    clear = jnp.asarray([1.0, 1.0, 1.0, 1.0], dtype)
    step = jax.jit(
        partial(pathtrace_frame, scene, tracer,
                width=W, height=H, samples=1, depth=DEPTH),
        device=device,
    )
    accum = jnp.zeros((W * H, 3), dtype)
    if device is not None:
        accum = jax.device_put(accum, device)
    for f in range(FRAMES):
        accum, _ = step(cam, f, accum, clear)
    return np.asarray(jax.device_get(accum), np.float64)


def run() -> dict:
    """Render device-f32 vs CPU-f64; print and return the accuracy
    record."""
    import numpy as np
    import jax
    import jax.numpy as jnp

    from vkrt.models.post import tonemap
    from vkrt.ops.trace import make_tracer
    from vkrt.scene import make_cornell_box

    dev = jax.devices()[0]
    scene = make_cornell_box()
    tracer = make_tracer(scene, "auto")
    with jax.default_matmul_precision("highest"):
        img32 = _render(scene, tracer, jnp.float32)

    cpu = jax.devices("cpu")[0]
    with jax.enable_x64():
        with jax.default_device(cpu):
            scene64 = jax.tree.map(
                lambda a: jnp.asarray(a, jnp.float64)
                if a.dtype == jnp.float32 else jnp.asarray(a),
                scene,
            )
            img64 = _render(scene64, make_tracer(scene64, "bruteforce"),
                            jnp.float64, device=cpu)

    disp32 = np.clip(np.asarray(tonemap(jnp.asarray(img32, jnp.float32)),
                                np.float64), 0, 1)
    disp64 = np.clip(np.asarray(tonemap(jnp.asarray(img64, jnp.float32)),
                                np.float64), 0, 1)
    err = np.abs(disp32 - disp64).max(-1)
    diverged = err > 1e-2
    rmse = float(np.sqrt(np.mean((disp32 - disp64)[~diverged] ** 2)))
    p99 = float(np.percentile(err, 99))
    rec = {
        "workload": f"cornell_{W}x{H}_spp1_depth{DEPTH}_frames{FRAMES}",
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "tracer": _tracer_name(tracer),
        "rmse_display": rmse,
        "p99_abs_err": p99,
        "diverged_frac": float(diverged.mean()),
        "budget": {"rmse": BUDGET_RMSE, "p99": BUDGET_P99,
                   "diverged": BUDGET_DIVERGED},
        "ok": bool(rmse <= BUDGET_RMSE and p99 <= BUDGET_P99
                   and diverged.mean() < BUDGET_DIVERGED),
    }
    print(f"[accuracy] {json.dumps(rec)}", file=sys.stderr, flush=True)
    return rec


def _tracer_name(tracer) -> str:
    if getattr(tracer, "tables", None) is not None:
        return "kernel"
    return "bvh" if getattr(tracer, "bvh", None) is not None else "bruteforce"


def main():
    from vkrt.utils.jaxcache import enable

    enable()
    rec = run()
    if not rec["ok"]:
        sys.exit(5)


if __name__ == "__main__":
    main()
