"""Trace-layer benchmark: the traversal kernel against XLA's plain versions.

For each scene it times, on the GPU at 1280x720:

* the trace calls of one path-traced frame (depth 3) on the pools that frame
  really traces — primary, the fused next+shadow pools, the last shadow
  pool — for every backend (``kernel``, ``bvh``, and ``bruteforce`` where it
  is affordable);
* the frame end to end through ``Engine`` (display included) for each
  backend, interleaved A, B, A, B in one process, and the share of the frame
  the trace calls take (the rest is ray generation, shading, accumulation
  and display);
* the hybrid city frame (shadows, AO, GI, temporal denoiser) end to end;
* a triangle-count sweep (procedural city grids) of kernel against brute
  force end to end: the crossover that sets ``BRUTEFORCE_MAX_TRIS``.

Every record is one JSON line on stdout (and in ``--out``), with the
device's platform, kind and count; times are medians of ``--repeats`` runs,
each ending in ``block_until_ready``. Needs a GPU.

    python -m benchmarks.trace_layers [--out trace_layers.jsonl] [--blocks 32,64,128]
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

W, H = 1280, 720
DEPTH = 3


class _Recorder:
    """Tracer wrapper that records every pool it is asked to trace (as
    traced values, so a jitted frame can return them)."""

    def __init__(self, inner):
        self.inner = inner
        self.pools = []

    def closest(self, orig, direction, t_min, t_max, t_lim=None):
        import jax.numpy as jnp

        lim = t_lim if t_lim is not None else jnp.broadcast_to(
            jnp.asarray(t_max, orig.dtype), orig.shape[:1])
        self.pools.append(("closest", orig, direction, lim))
        return self.inner.closest(orig, direction, t_min, t_max, t_lim=t_lim)

    def any(self, orig, direction, t_min, t_max):
        import jax.numpy as jnp

        lim = jnp.broadcast_to(jnp.asarray(t_max, orig.dtype), orig.shape[:1])
        self.pools.append(("any", orig, direction, lim))
        return self.inner.any(orig, direction, t_min, t_max)


def _median_ms(fn, repeats):
    fn()  # warm (compile)
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts), ts


def frame_pools(scene, tracer, cam):
    """The (kind, orig, dir, t_lim) pools of one depth-3 path-traced frame
    at frame index 1 (jittered), in the engine's tile order."""
    import jax
    import jax.numpy as jnp

    from vkrt.models.pathtracer import pathtrace_frame
    from vkrt.ops.rng import tea
    from vkrt.utils.camera import pixel_coords, tile_perm

    perm, _ = tile_perm(W, H)
    pix = jnp.take(pixel_coords(W, H), jnp.asarray(perm), axis=0)
    pid = jnp.asarray(perm).astype(jnp.uint32)
    rec = _Recorder(tracer)
    kinds = []

    def f(cam):
        rec.pools.clear()
        pathtrace_frame(scene, rec, cam, 1, jnp.zeros((W * H, 3)),
                        jnp.ones(4), width=W, height=H, samples=1,
                        depth=DEPTH, corr=True, pix=pix,
                        seeds=tea(pid, jnp.uint32(1)))
        kinds[:] = [p[0] for p in rec.pools]
        return [p[1:] for p in rec.pools]

    pools = jax.jit(f)(cam)
    return list(zip(kinds, pools))


def time_pools(label, tracers, pools, repeats, emit):
    """Per-pool and per-frame trace time of each backend on ``pools``."""
    import jax

    from vkrt.ops.intersect import T_MAX, T_MIN

    totals = {}
    for name, tr in tracers.items():
        total = 0.0
        for i, (kind, (o, d, lim)) in enumerate(pools):
            if kind == "closest":
                fn = jax.jit(lambda o, d, lim, tr=tr: tr.closest(
                    o, d, T_MIN, T_MAX, t_lim=lim))
            else:
                fn = jax.jit(lambda o, d, lim, tr=tr: tr.any(
                    o, d, T_MIN, lim))
            ms, ts = _median_ms(
                lambda: jax.block_until_ready(fn(o, d, lim)), repeats)
            live = int((lim > 0).sum())
            emit({"kind": "trace_call", "scene": label, "backend": name,
                  "pool": i, "query": kind, "lanes": int(o.shape[0]),
                  "live_lanes": live, "ms": ms, "runs_ms": ts})
            total += ms
        totals[name] = total
        emit({"kind": "trace_frame", "scene": label, "backend": name,
              "ms": total, "pools": len(pools)})
    return totals


def time_kernel_blocks(label, tracer, pools, blocks, repeats, emit):
    """Per-frame kernel trace time at each block size (rays per program;
    one warp per 32 rays) on the same pools."""
    import jax

    from vkrt.ops.bvh_kernel import traverse
    from vkrt.ops.intersect import T_MIN

    for block in blocks:
        total = 0.0
        for kind, (o, d, lim) in pools:
            fn = jax.jit(lambda o, d, lim, any_hit=(kind == "any"), b=block:
                         traverse(tracer.tables, o, d, T_MIN, lim,
                                  any_hit=any_hit, block=b))
            ms, _ = _median_ms(
                lambda: jax.block_until_ready(fn(o, d, lim)), repeats)
            total += ms
        emit({"kind": "kernel_block", "scene": label, "block": block,
              "trace_frame_ms": total})


def time_engines(label, scene, settings, backends, camera, repeats, frames,
                 emit, trace_ms=None):
    """End-to-end ms/frame per backend, interleaved A, B, A, B."""
    from vkrt.engine import Engine

    engines = {b: Engine(scene, W, H, settings.replace(backend=b), camera)
               for b in backends}
    for eng in engines.values():  # compile + warm
        eng.render_frame().block_until_ready()
    runs = {b: [] for b in backends}
    for _ in range(repeats):
        for b, eng in engines.items():
            r0 = eng.total_rays
            t0 = time.perf_counter()
            out = None
            for _ in range(frames):
                out = eng.render_frame()
            out.block_until_ready()
            dt = time.perf_counter() - t0
            runs[b].append((dt / frames * 1e3,
                            (eng.total_rays - r0) / dt / 1e6))
    for b in backends:
        ms = statistics.median(r[0] for r in runs[b])
        rec = {"kind": "e2e", "scene": label, "backend": b,
               "mode": "path" if settings.rt_mode == 1 else "hybrid",
               "ms_per_frame": ms,
               "mrays_per_s": statistics.median(r[1] for r in runs[b]),
               "runs_ms_per_frame": [r[0] for r in runs[b]],
               "tris": int(scene.num_tris)}
        if trace_ms is not None and b in trace_ms:
            rec["trace_ms"] = trace_ms[b]
            rec["trace_share"] = trace_ms[b] / ms
        emit(rec)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=None)
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--frames", type=int, default=4)
    p.add_argument("--sweep", default="4,8,16,32",
                   help="city grids for the kernel/brute-force crossover")
    p.add_argument("--blocks", default="",
                   help="kernel block sizes to time on the frame pools, "
                        "e.g. 32,64,128")
    args = p.parse_args(argv)

    from vkrt.utils.jaxcache import enable

    enable()
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"trace_layers: no GPU (platform {dev.platform!r})",
              file=sys.stderr)
        return 3
    tag = {"platform": dev.platform, "device_kind": dev.device_kind,
           "device_count": jax.device_count()}
    sink = open(args.out, "w") if args.out else None

    def emit(rec):
        line = json.dumps({**rec, **tag})
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    from vkrt.config import RenderSettings
    from vkrt.ops.trace import build_tracer
    from vkrt.scene import make_city, make_cornell_box
    from vkrt.utils.camera import Camera, orbit_camera

    def city_cam(g):
        return orbit_camera(0.12, radius=3.125 * g, height=max(8.0, 0.5 * g))

    cases = [
        ("cornell", make_cornell_box(), Camera(),
         ("kernel", "bvh", "bruteforce")),
        ("city96", make_city(grid=96), city_cam(96), ("kernel", "bvh")),
    ]
    path = RenderSettings(rt_mode=1, samples=1, depth=DEPTH)
    for label, scene, cam, backends in cases:
        emit({"kind": "scene", "scene": label, "tris": int(scene.num_tris)})
        tris = (scene.tri_v0, scene.tri_e1, scene.tri_e2)
        tracers = {b: build_tracer(*tris, b) for b in backends}
        pools = frame_pools(scene, tracers["bvh"], cam.matrices(W, H))
        trace_ms = time_pools(label, tracers, pools, args.repeats, emit)
        if args.blocks:
            time_kernel_blocks(
                label, tracers["kernel"], pools,
                [int(b) for b in args.blocks.split(",")], args.repeats, emit)
        time_engines(label, scene, path, backends, cam, args.repeats,
                     args.frames, emit, trace_ms)
        if label == "city96":
            hyb = RenderSettings(rt_mode=0, use_shadows=True, use_ao=True,
                                 use_gi=True, use_denoiser=True)
            time_engines(label, scene, hyb, backends, cam, args.repeats,
                         args.frames, emit)
    for g in (int(x) for x in args.sweep.split(",") if x):
        scene = make_city(grid=g)
        time_engines(f"city{g}", scene, path, ("kernel", "bruteforce"),
                     city_cam(g), args.repeats, args.frames, emit)
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
