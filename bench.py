"""Benchmark harness: the reference's default workload on one GPU.

Workload = the reference's default config (config.json:8-11 + initRayTracing
defaults, hello_vulkan.cpp:911-918): Cornell at 1280x720, path-traced at
spp=1, depth=3, progressive accumulation across frames, through ``Engine``
(display pass included). Reports steady-state throughput in Mrays/s (rays =
every traceRayEXT-equivalent: primary, bounce and shadow rays actually
alive, counted on device) and ms/frame.

vs_baseline is against the 100 Mrays/s/device north star from BASELINE.json.

Needs a GPU: on any other platform it exits 3 without a result. The device
accuracy anchor (benchmarks/accuracy.py) runs after the timing; a miss
exits 5. Prints exactly one JSON line on stdout; diagnostics go to stderr.
"""

import json
import statistics
import sys
import time

FRAMES_PER_BATCH = 8
BATCHES = 3


def main():
    from vkrt.utils.jaxcache import enable as enable_cache

    enable_cache()

    import jax
    import numpy as np

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"[bench] FATAL: no GPU (platform {dev.platform!r}); "
              "refusing to report a device metric", file=sys.stderr)
        sys.exit(3)

    from vkrt.config import RenderSettings, load_config
    from vkrt.engine import Engine
    from vkrt.scene import load_cornell

    try:
        cfg = load_config("config.json")
        width, height = cfg.width, cfg.height
    except FileNotFoundError:
        width, height = 1280, 720

    scene = load_cornell()
    settings = RenderSettings(rt_mode=1, samples=1, depth=3)
    eng = Engine(scene, width, height, settings)
    print(f"[bench] device: {dev.device_kind} x{jax.device_count()}",
          file=sys.stderr)

    # compile + frame 0 (centered jitter)
    t0 = time.perf_counter()
    eng.render_frame().block_until_ready()
    print(f"[bench] compile+frame0: {time.perf_counter()-t0:.3f}s",
          file=sys.stderr)

    batch_ms, batch_mrays = [], []
    out = None
    for _ in range(BATCHES):
        rays0 = eng.total_rays
        t0 = time.perf_counter()
        for _ in range(FRAMES_PER_BATCH):
            out = eng.render_frame()
        out.block_until_ready()
        dt = time.perf_counter() - t0
        rays = eng.total_rays - rays0
        batch_ms.append(dt / FRAMES_PER_BATCH * 1e3)
        batch_mrays.append(rays / dt / 1e6)
        print(f"[bench] batch: {batch_ms[-1]} ms/frame, {batch_mrays[-1]} "
              "Mrays/s", file=sys.stderr)

    # validate the IMAGE before posting a number: a NaN/Inf or black
    # pipeline must fail the bench, not publish a meaningless Mrays/s
    final = np.asarray(eng.accum)
    if not np.isfinite(final).all() or float(final.max()) <= 0.0:
        print("[bench] FATAL: non-finite or black accumulation image",
              file=sys.stderr, flush=True)
        sys.exit(4)

    from benchmarks.accuracy import run as accuracy_run

    rec = accuracy_run()
    if not rec["ok"]:
        print(f"[bench] FATAL: device accuracy out of budget: {rec}",
              file=sys.stderr, flush=True)
        sys.exit(5)

    mrays = statistics.median(batch_mrays)
    print(
        json.dumps(
            {
                "metric": "pathtrace_cornell_1280x720_spp1_depth3",
                "value": mrays,
                "unit": "Mrays/s",
                "vs_baseline": mrays / 100.0,
                "ms_per_frame": statistics.median(batch_ms),
                "batches_ms_per_frame": batch_ms,
                "scene_tris": int(scene.num_tris),
                "width": width,
                "height": height,
                "platform": dev.platform,
                "device_kind": dev.device_kind,
                "device_count": jax.device_count(),
                "accuracy_rmse": rec["rmse_display"],
            }
        )
    )


if __name__ == "__main__":
    main()
