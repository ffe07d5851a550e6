"""Full benchmark suite: the five BASELINE.json configs.

The headline driver metric stays in /bench.py (one JSON line); this suite
measures every config the baseline asks for:

1. Cornell path trace, 1 spp / 1 bounce, diffuse NEE (reference image)
2. Cornell multi-bounce GI with progressive accumulation
3. Sponza-class full path trace — the Sponza asset is not shipped
   (config.json references it but the reference repo only carries Cornell),
   so the procedural city scene stands in at a comparable triangle count
4. Hybrid: G-buffer pass + RT shadows / AO / GI
5. Fly-through with per-frame camera motion + denoiser (fireplace/suntemple
   stand-in), i.e. accumulation resets every frame

Usage: python -m benchmarks.suite [--width W --height H --frames N]
Prints one JSON line per config.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _assert_finite_image(name, arr):
    """A NaN/Inf or all-black render must FAIL the suite config, not post a
    timing row: perf numbers from an unvalidated image are not numbers."""
    import numpy as np

    a = np.asarray(arr)
    if not np.isfinite(a).all():
        raise AssertionError(
            f"[suite:{name}] {(~np.isfinite(a)).sum()} non-finite output "
            "elements — refusing to report a timing for a broken image"
        )
    if float(np.abs(a).max()) <= 0.0:
        raise AssertionError(f"[suite:{name}] all-zero output image")


def device_record() -> dict:
    """The device every result ran on (platform, kind, count)."""
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "device_kind": d.device_kind,
            "device_count": jax.device_count()}


def run_engine_bench(name, scene, settings, width, height, frames,
                     camera_fn=None, png_out=None, extra_metrics_fn=None):
    import jax

    from vkrt.engine import Engine
    from vkrt.utils.camera import Camera

    eng = Engine(scene, width, height, settings,
                 camera=camera_fn(0.0) if camera_fn else Camera())
    # compile + warm
    out = eng.render_frame()
    out.block_until_ready()
    eng.reset_frame()
    eng.total_rays = 0.0

    t0 = time.time()
    for f in range(frames):
        if camera_fn is not None:
            eng.camera = camera_fn(f / max(frames, 1))
        out = eng.render_frame()
    out.block_until_ready()
    dt = time.time() - t0
    final = jax.device_get(out)
    _assert_finite_image(name, final)
    if png_out:
        from vkrt.models.post import to_u8_image
        from vkrt.utils.png import write_png

        write_png(png_out, to_u8_image(out, width, height))
        print(f"[suite] wrote {png_out}", file=sys.stderr)
    rec = {
        "config": name,
        **device_record(),
        "ms_per_frame": round(dt / frames * 1e3, 2),
        "fps": round(frames / dt, 2),
        "mrays_per_s": round(eng.total_rays / dt / 1e6, 2),
        "frames": frames,
        "resolution": f"{width}x{height}",
    }
    if extra_metrics_fn is not None:
        rec.update(extra_metrics_fn(final, eng))
    print(json.dumps(rec), flush=True)
    return rec


def run_sharded_bench(name, scene, width, height, frames, depth):
    """Sharded config: the default tracer under shard_map over a (tile, spp)
    device mesh — on one device this is the mesh(1,1) validation of the
    SPMD path; on N devices it scales the tile axis."""
    import jax
    import jax.numpy as jnp

    from vkrt.ops.trace import make_tracer
    from vkrt.parallel.mesh import factor_mesh, make_render_mesh
    from vkrt.parallel.render import (
        device_put_accum,
        make_sharded_pathtrace_step,
    )
    from vkrt.utils.camera import Camera

    n_tile, n_spp = factor_mesh(jax.device_count())
    mesh = make_render_mesh(n_tile=n_tile, n_spp=n_spp)
    tracer = make_tracer(scene, "auto")
    from vkrt.config import RenderSettings

    step, _inv = make_sharded_pathtrace_step(
        scene, tracer, mesh, width=width, height=height,
        samples=n_spp, depth=depth, corr=RenderSettings().corr_sampler,
    )
    cam = Camera().matrices(width, height)
    clear = jnp.asarray([1.0, 1.0, 1.0, 1.0], jnp.float32)
    accum = device_put_accum(mesh, width, height)
    accum, rays = step(cam, 0, accum, clear)  # compile + warm
    accum.block_until_ready()

    accum = device_put_accum(mesh, width, height)
    total_rays = 0.0
    t0 = time.time()
    for f in range(frames):
        accum, rays = step(cam, f, accum, clear)
    accum.block_until_ready()
    dt = time.time() - t0
    _assert_finite_image(name, jax.device_get(accum))
    total_rays = float(rays) * frames  # rays/frame is constant per config
    rec = {
        "config": name,
        **device_record(),
        "mesh": f"tile={n_tile},spp={n_spp}",
        "ms_per_frame": round(dt / frames * 1e3, 2),
        "fps": round(frames / dt, 2),
        "mrays_per_s": round(total_rays / dt / 1e6, 2),
        "frames": frames,
        "resolution": f"{width}x{height}",
    }
    print(json.dumps(rec), flush=True)
    return rec


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--configs", type=str, default="1,2,3,4,5,6,7,8")
    args = p.parse_args(argv)

    from vkrt.utils.jaxcache import enable

    enable()

    from vkrt.config import RenderSettings
    from vkrt.scene import load_cornell, make_city
    from vkrt.utils.camera import orbit_camera

    w, h, n = args.width, args.height, args.frames
    wanted = set(args.configs.split(","))
    results = []

    if "1" in wanted or "2" in wanted:
        cornell = load_cornell()
        if "1" in wanted:
            results.append(run_engine_bench(
                "cornell_1spp_1bounce", cornell,
                RenderSettings(rt_mode=1, samples=1, depth=1), w, h, n,
            ))
        if "2" in wanted:
            results.append(run_engine_bench(
                "cornell_multibounce_accum", cornell,
                RenderSettings(rt_mode=1, samples=1, depth=5), w, h, n,
            ))
    if "3" in wanted or "4" in wanted or "5" in wanted:
        city = make_city(grid=96)  # ~143k tris Sponza-class substitute
        print(f"[suite] city scene: {city.num_tris} tris", file=sys.stderr)
        if "3" in wanted:
            results.append(run_engine_bench(
                "city_full_pathtrace", city,
                RenderSettings(rt_mode=1, samples=1, depth=4), w, h, n,
                camera_fn=lambda t: orbit_camera(0.12, radius=300, height=48),
            ))
        if "4" in wanted:
            results.append(run_engine_bench(
                "hybrid_shadows_ao_gi", city,
                RenderSettings(rt_mode=0, use_shadows=True, use_ao=True, use_gi=True),
                w, h, n,
                camera_fn=lambda t: orbit_camera(0.12, radius=300, height=48),
            ))
        if "5" in wanted:
            den_settings = RenderSettings(rt_mode=0, use_shadows=True,
                                          use_ao=True, use_gi=True,
                                          use_denoiser=True)
            cam5 = lambda t: orbit_camera(t, radius=300, height=48)  # noqa: E731

            def _rmse_vs_converged(final_out, _eng, frames=n):
                """Accuracy column for the denoised row: the last fly-through frame vs a converged static
                accumulation at the SAME pose with the denoiser off
                (methodology of tests/test_denoiser.py); also the raw
                1-frame noisy RMSE so the denoiser's gain is visible."""
                import jax as _jax
                import numpy as _np

                from vkrt.engine import Engine as _Engine

                t_last = (frames - 1) / max(frames, 1)
                base = den_settings.replace(use_denoiser=False)
                ref_eng = _Engine(city, w, h, base, camera=cam5(t_last))
                ref = None
                for _ in range(64):
                    ref = ref_eng.render_frame()
                ref = _np.asarray(_jax.device_get(ref))
                noisy_eng = _Engine(city, w, h, base, camera=cam5(t_last))
                noisy = _np.asarray(_jax.device_get(noisy_eng.render_frame()))
                a = _np.asarray(final_out)

                def rm(x):
                    return float(_np.sqrt(_np.mean((x - ref) ** 2)))

                return {"rmse_vs_converged": round(rm(a), 5),
                        "rmse_noisy_1frame": round(rm(noisy), 5)}

            results.append(run_engine_bench(
                "city_flythrough_denoised", city, den_settings,
                w, h, n, camera_fn=cam5,
                extra_metrics_fn=_rmse_vs_converged,
            ))
    if "6" in wanted:
        cornell = load_cornell()
        results.append(run_sharded_bench(
            "cornell_sharded_mesh", cornell, w, h, n, depth=3,
        ))
    if "8" in wanted:
        # Real ON-DISK asset layout: the generated sponzoid hall in
        # Sponza's file layout — .gltf + external .bin + external PNG
        # baseColor / normal-map URIs, 4 textured
        # materials, TANGENTs, KHR point lights, ~162k tris — rendered
        # through parse_gltf -> build_scene -> Engine and saved to PNG.
        import os as _os

        import numpy as _np

        from vkrt.utils.camera import Camera as _Cam
        from vkrt.utils.sponzoid import load_sponzoid

        adir = _os.path.join(_os.path.dirname(__file__), "assets", "sponzoid")
        t0 = time.time()
        sponz = load_sponzoid(adir, tess=4)
        print(f"[suite] sponzoid: {sponz.num_tris} tris, "
              f"{sponz.tex_rgba.shape[0] if hasattr(sponz, 'tex_rgba') else 0}"
              f" textures ({time.time()-t0:.1f}s load)", file=sys.stderr)
        cam8 = _Cam(eye=_np.array([0.0, 6.0, 26.0]),
                    center=_np.array([0.0, 5.0, 0.0]),
                    up=_np.array([0.0, 1.0, 0.0]))
        results.append(run_engine_bench(
            "sponzoid_disk_pathtrace", sponz,
            RenderSettings(rt_mode=1, samples=1, depth=3), w, h, n,
            camera_fn=lambda t: cam8,
            png_out=_os.path.join(adir, "sponzoid_render.png"),
        ))
    if "7" in wanted:
        # Sponza-SCALE stress — ~2.8x the config-3 triangle count, same
        # estimator: how trace cost scales with triangle count.
        big = make_city(grid=160)
        print(f"[suite] big city scene: {big.num_tris} tris", file=sys.stderr)
        results.append(run_engine_bench(
            "bigcity_full_pathtrace", big,
            RenderSettings(rt_mode=1, samples=1, depth=4), w, h, n,
            camera_fn=lambda t: orbit_camera(0.12, radius=500, height=64),
        ))
    return results


if __name__ == "__main__":
    main()
