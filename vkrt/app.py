"""Headless CLI app — the ``main()`` + ImGui panel replacement.

Exposes the same parameter surface the reference's UI does (main.cpp:67-105):
render mode, bounces, spp, shadows/AO/GI toggles, view-accumulated, max
frames, clear color — plus frame count and PNG output since we render
headless. Reads the reference's exact ``config.json`` schema.

Usage:
    python -m vkrt.app --config config.json --frames 16 --out out.png
    python -m vkrt.app --scene path/to.gltf --mode path --spp 2 --depth 5
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from vkrt.config import (
    DEFAULT_CLEAR_COLOR,
    EngineConfig,
    RenderSettings,
    load_config,
    resolve_scene_path,
)
from vkrt.ops.trace import BACKENDS
from vkrt.utils.png import write_png


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", default=None, help="config.json path")
    p.add_argument("--scene", default=None, help="override scene file (.gltf/.glb)")
    p.add_argument("--scene-index", type=int, default=None, help="index into config scenes[]")
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--mode", choices=["hybrid", "path"], default="hybrid",
                   help="render mode (main.cpp:457; default hybrid like the reference)")
    p.add_argument("--spp", type=int, default=1, help="samples/pixel 1-100")
    p.add_argument("--depth", type=int, default=3, help="bounces 1-30")
    p.add_argument("--frames", type=int, default=1, help="progressive frames to accumulate")
    p.add_argument("--max-frames", type=int, default=None,
                   help="enable the max-frames limiter at this count")
    p.add_argument("--no-shadows", action="store_true")
    p.add_argument("--no-ao", action="store_true")
    p.add_argument("--gi", action="store_true", help="enable hybrid GI")
    p.add_argument("--denoiser", action="store_true", help="enable SVGF denoiser (GI)")
    p.add_argument("--alpha-test", action="store_true",
                   help="enable alpha-tested transparency (the reference's "
                        "unwired any-hit shaders, finished; see ops/alpha.py)")
    p.add_argument("--corr-sampler",
                   action=argparse.BooleanOptionalAction,
                   default=os.environ.get("VKRT_CORR", "1") == "1",
                   help="correlated per-block sampler: share the lobe/"
                        "light/hemisphere draws across each 1024-lane "
                        "block (one 32x32 pixel tile) per frame (unbiased; "
                        "coherent bounce/shadow pools). Default ON; "
                        "--no-corr-sampler / VKRT_CORR=0 restores "
                        "independent per-lane draws")
    p.add_argument("--view-accumulated", action="store_true")
    p.add_argument("--clear-color", type=float, nargs=3, default=None)
    p.add_argument(
        "--backend",
        choices=list(BACKENDS),
        default="auto",
        help="trace backend: auto picks per platform and scene size "
             "(ops/trace.py choose_backend); kernel needs a GPU",
    )
    p.add_argument("--eye", type=float, nargs=3, default=None)
    p.add_argument("--lookat", type=float, nargs=3, default=None)
    p.add_argument("--fov", type=float, default=60.0)
    p.add_argument("--orbit", action="store_true",
                   help="fly-through: orbit the camera over the frames and "
                        "write a PNG per frame (out name gets _NNNN suffix)")
    p.add_argument("--orbit-radius", type=float, default=18.0)
    p.add_argument("--orbit-height", type=float, default=6.0)
    p.add_argument("--mesh", default=None, metavar="TILE,SPP",
                   help="render over a (tile, spp) device mesh via shard_map "
                        "(e.g. --mesh 4,2 needs 8 devices; on CPU set "
                        "XLA_FLAGS=--xla_force_host_platform_device_count=8)")
    p.add_argument("--cpu", action="store_true",
                   help="force the CPU backend (same as JAX_PLATFORMS=cpu)")
    p.add_argument("--out", default="out.png")
    p.add_argument("--procedural", choices=["cornell", "city"], default=None,
                   help="use a procedural scene instead of a file")
    p.add_argument("--city-grid", type=int, default=None, metavar="N",
                   help="procedural city size (benchmark suite uses 96 = "
                        "143k tris, 160 = 399k Sponza-scale; default small)")
    p.add_argument("--save-state", default=None,
                   help="checkpoint accumulation state to this .npz on exit")
    p.add_argument("--load-state", default=None,
                   help="resume accumulation state from this .npz")
    p.add_argument("--stats", action="store_true",
                   help="print per-run frame stats JSON to stderr")
    p.add_argument("--trace-dir", default=None,
                   help="write a jax.profiler device trace here")
    p.add_argument("--interactive", action="store_true",
                   help="live parameter loop on stdin — the headless ImGui "
                        "panel (main.cpp:67-105): render/set/clear/camera/"
                        "save commands between frames; traced knobs "
                        "(view_accumulated, clamp_weights, clear color, "
                        "max_frames, camera) apply with ZERO recompile, "
                        "static ones (spp/depth/toggles) swap to a cached "
                        "compiled step per combination")
    return p


def main(argv=None) -> int:
    parser = build_argparser()
    args = parser.parse_args(argv)
    if args.frames < 1:
        parser.error(f"--frames must be >= 1 (got {args.frames})")

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    from vkrt.utils.jaxcache import enable as enable_cache

    enable_cache()

    cfg = EngineConfig()
    if args.config:
        cfg = load_config(args.config)
    elif os.path.exists("config.json"):
        cfg = load_config("config.json")
    if args.scene_index is not None:
        cfg = EngineConfig(cfg.scenes, args.scene_index, cfg.vsync, cfg.width, cfg.height)
    width = args.width or cfg.width
    height = args.height or cfg.height

    from vkrt import scene as scene_mod
    from vkrt.engine import Engine
    from vkrt.utils.camera import Camera

    t0 = time.time()
    if args.procedural == "cornell":
        scene = scene_mod.make_cornell_box()
    elif args.procedural == "city":
        scene = (scene_mod.make_city(grid=args.city_grid)
                 if args.city_grid else scene_mod.make_city())
    elif args.scene:
        scene = scene_mod.load_scene(args.scene)
    else:
        path = resolve_scene_path(cfg)
        if not os.path.exists(path):
            print(f"scene {path} not found; using procedural cornell", file=sys.stderr)
            scene = scene_mod.make_cornell_box()
        else:
            scene = scene_mod.load_scene(path)
    print(f"scene loaded: {scene.num_tris} tris, {scene.num_lights} lights "
          f"({time.time()-t0:.2f}s)")

    settings = RenderSettings(
        samples=args.spp,
        depth=args.depth,
        use_shadows=not args.no_shadows,
        use_ao=not args.no_ao,
        use_gi=args.gi,
        rt_mode=1 if args.mode == "path" else 0,
        view_accumulated=args.view_accumulated,
        max_frames=args.max_frames or 1,
        stop_at_max_frames=args.max_frames is not None,
        use_denoiser=args.denoiser,
        backend=args.backend,
        alpha_test=args.alpha_test,
        corr_sampler=args.corr_sampler,
    )
    cam = Camera(
        eye=tuple(args.eye) if args.eye else (0.0, 0.0, 15.0),
        center=tuple(args.lookat) if args.lookat else (0.0, 0.0, 0.0),
        fov_deg=args.fov,
    )
    clear = tuple(args.clear_color) + (1.0,) if args.clear_color else DEFAULT_CLEAR_COLOR

    if args.mesh:
        return run_sharded(args, scene, settings, cam, clear, width, height)

    engine = Engine(scene, width, height, settings, cam, clear)

    from vkrt.utils import checkpoint
    from vkrt.utils.profiling import FrameStats, device_trace, timed_frame
    from vkrt.models.post import to_u8_image

    if args.load_state:
        ok = checkpoint.restore(engine, args.load_state)
        print(f"resume from {args.load_state}: {'ok, frame ' + str(engine.frame) if ok else 'rejected'}")

    from vkrt.utils.camera import orbit_camera

    if args.interactive:
        return run_interactive(engine, args, width, height)

    stats = FrameStats()
    t0 = time.time()
    out = None
    with device_trace(args.trace_dir):
        for f in range(args.frames):
            if args.orbit:
                engine.camera = orbit_camera(
                    f / max(args.frames, 1),
                    center=tuple(args.lookat) if args.lookat else (0, 0, 0),
                    radius=args.orbit_radius,
                    height=args.orbit_height,
                    fov_deg=args.fov,
                )
            with timed_frame(stats, block=None):
                out = engine.render_frame()
                out.block_until_ready()
            if args.orbit:
                base, ext = os.path.splitext(args.out)
                write_png(f"{base}_{f:04d}{ext}", to_u8_image(out, width, height))
    dt = time.time() - t0
    img = to_u8_image(out, width, height)
    # single device->host sync for the ray counter (the engine accumulates it
    # on device; a per-frame float() read would bubble the pipeline)
    total_rays = engine.total_rays
    if stats.times_s:
        stats.rays = [total_rays / len(stats.times_s)] * len(stats.times_s)
    mrays = total_rays / dt / 1e6 if dt > 0 else 0.0
    print(
        f"{args.frames} frames at {width}x{height} in {dt:.3f}s "
        f"({dt / args.frames * 1000:.1f} ms/frame, {mrays:.1f} Mrays/s incl. compile)"
    )
    if args.stats:
        stats.log()
    if args.save_state:
        checkpoint.save(engine, args.save_state)
        print(f"saved state to {args.save_state}")
    write_png(args.out, img)
    print(f"wrote {args.out}")
    return 0


def run_interactive(engine, args, width, height) -> int:
    """Live parameter loop — the headless equivalent of the reference's
    ImGui panel (main.cpp:67-105): change any render setting between
    frames from stdin. Any change resets accumulation like the reference
    (main.cpp:103-104). Traced knobs (view_accumulated, clamp_weights,
    clear color, max_frames, camera) reuse the compiled step; static ones
    (spp/depth/use_* toggles) recompile once and are cached per
    combination (persistent across processes, utils/jaxcache.py).

    Commands (one per line; '#' comments and blank lines ignored):
      render [N]           render N progressive frames (default 1)
      set KEY VALUE        any RenderSettings field, e.g. set depth 5,
                           set use_gi 1, set clamp_weights 1, set samples 2
      clear R G B          clear color
      eye X Y Z | lookat X Y Z | fov DEG      camera (resets accumulation)
      save [PATH]          write the current composite PNG (default --out)
      stats                frame counter + last render timing
      quit                 exit (writes --out first)
    """
    import dataclasses
    import jax

    import jax.numpy as jnp

    from vkrt.models.post import to_u8_image

    out = None
    last_ms = None

    def render_n(k: int):
        nonlocal out, last_ms
        t0 = time.time()
        for _ in range(k):
            out = engine.render_frame()
        out.block_until_ready()
        last_ms = (time.time() - t0) / max(k, 1) * 1e3
        print(f"rendered {k} frame(s), {last_ms:.1f} ms/frame "
              f"(frame counter {engine.frame})")

    fields = {f.name: f.type for f in dataclasses.fields(engine.settings)}
    print("interactive: 'render N', 'set KEY VALUE', 'clear R G B', "
          "'eye/lookat X Y Z', 'fov D', 'save [PATH]', 'stats', 'quit'",
          flush=True)
    for line in sys.stdin:
        toks = line.split("#", 1)[0].split()
        if not toks:
            continue
        cmd, rest = toks[0].lower(), toks[1:]
        try:
            if cmd == "quit":
                break
            elif cmd == "render":
                render_n(int(rest[0]) if rest else 1)
            elif cmd == "set":
                key, val = rest[0], rest[1]
                if key not in fields:
                    print(f"unknown setting {key!r}; one of "
                          f"{sorted(fields)}")
                    continue
                cur = getattr(engine.settings, key)
                new = (val not in ("0", "false", "False")
                       if isinstance(cur, bool) else type(cur)(val))
                step0 = engine._step
                engine.update_settings(engine.settings.replace(**{key: new}))
                print(f"{key} = {new} "
                      f"({'recompiled step' if engine._step is not step0 else 'no recompile'})")
            elif cmd == "clear":
                engine.clear_color = jnp.asarray(
                    [float(x) for x in rest[:3]] + [1.0], jnp.float32)
                engine.reset_frame()  # radiance changes: restart accumulation
                print("clear color set (no recompile)")
            elif cmd in ("eye", "lookat"):
                kw = {"eye" if cmd == "eye" else "center":
                      tuple(float(x) for x in rest[:3])}
                engine.camera = dataclasses.replace(engine.camera, **kw)
                print(f"{cmd} set (accumulation resets on next frame)")
            elif cmd == "fov":
                engine.camera = dataclasses.replace(
                    engine.camera, fov_deg=float(rest[0]))
                print("fov set")
            elif cmd == "save":
                path = rest[0] if rest else args.out
                if out is None:
                    render_n(1)
                write_png(path, to_u8_image(out, width, height))
                print(f"wrote {path}")
            elif cmd == "stats":
                print(f"frame {engine.frame}, last {last_ms and f'{last_ms:.1f}'} "
                      f"ms/frame, total rays {engine.total_rays:.3g}")
            else:
                print(f"unknown command {cmd!r}")
        except (ValueError, IndexError) as e:
            print(f"bad command {line.strip()!r}: {e}")
        sys.stdout.flush()
    if out is not None:
        write_png(args.out, to_u8_image(out, width, height))
        print(f"wrote {args.out}")
    return 0


def run_sharded(args, scene, settings, cam_obj, clear, width, height) -> int:
    """Multi-device rendering via vkrt.parallel (SURVEY §2d mesh story):
    pixel tiles over the 'tile' axis, sample groups over 'spp' (one psum)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from vkrt.models import post
    from vkrt.ops.trace import make_tracer
    from vkrt.parallel.mesh import make_render_mesh
    from vkrt.parallel.render import (
        device_put_accum,
        make_sharded_hybrid_step,
        render_sharded,
    )

    n_tile, n_spp = (int(x) for x in args.mesh.split(","))
    if n_tile * n_spp > jax.device_count():
        print(f"--mesh {args.mesh} needs {n_tile*n_spp} devices, have "
              f"{jax.device_count()}", file=sys.stderr)
        return 2
    if settings.rt_mode == 1 and settings.samples % n_spp != 0:
        print(f"--spp {settings.samples} must be divisible by the spp mesh "
              f"axis ({n_spp})", file=sys.stderr)
        return 2
    mesh = make_render_mesh(n_tile=n_tile, n_spp=n_spp)
    tracer = make_tracer(scene, args.backend, alpha=args.alpha_test)
    cam = cam_obj.matrices(width, height)
    t0 = time.time()
    if settings.rt_mode == 1:
        accum, rays = render_sharded(
            scene, tracer, cam, mesh, width=width, height=height,
            samples=settings.samples, depth=settings.depth,
            frames=args.frames, clear_color=clear,
            corr=settings.corr_sampler,
        )
        out = post.composite(
            None,
            jnp.concatenate([accum, jnp.ones_like(accum[:, :1])], axis=1),
            rt_mode=1, view_accumulated=settings.view_accumulated,
            use_gi=settings.use_gi,
        )
    else:
        if n_spp != 1:
            print("hybrid mode shards pixels only; use --mesh N,1", file=sys.stderr)
            return 2
        use_dn = settings.use_denoiser and settings.use_gi
        if use_dn and height % n_tile != 0:
            print(f"--denoiser under a mesh needs whole row bands: height "
                  f"{height} not divisible by tile axis {n_tile}",
                  file=sys.stderr)
            return 2
        step = make_sharded_hybrid_step(
            scene, tracer, mesh, width=width, height=height,
            depth=settings.depth, use_shadows=settings.use_shadows,
            use_ao=settings.use_ao, use_gi=settings.use_gi,
            use_denoiser=use_dn, corr=settings.corr_sampler,
        )
        accum = jax.device_put(
            jnp.zeros((width * height, 4), jnp.float32),
            NamedSharding(mesh, P("tile")),
        )
        dstate = None
        if use_dn:
            from vkrt.models.denoiser import DenoiserState, init_state

            spec = DenoiserState(
                hist_rad=P("tile"), hist_m1=P("tile"), hist_m2=P("tile"),
                hist_len=P("tile"), prev_view_proj=P(),
                prev_view_z=P("tile"), prev_normal=P("tile"),
            )
            dstate = jax.tree.map(
                lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
                init_state(width, height), spec,
            )
        clear4 = jnp.asarray(clear, jnp.float32)
        # device-side ray counter: a float(r) each frame would sync the
        # host into the frame loop (same rule as the engine's counter)
        rays_dev = jnp.zeros((), jnp.float32)
        gbuf = None
        for f in range(args.frames):
            if use_dn:
                gbuf, accum, r, dstate = step(cam, f, accum, clear4, dstate)
            else:
                gbuf, accum, r = step(cam, f, accum, clear4)
            rays_dev = rays_dev + r
        rays = float(rays_dev)
        out = post.composite(
            gbuf.color[:, :3], accum, rt_mode=0,
            view_accumulated=settings.view_accumulated, use_gi=settings.use_gi,
        )
    img = post.to_u8_image(out, width, height)
    dt = time.time() - t0
    mrays = rays / dt / 1e6 if dt > 0 else 0.0
    print(
        f"sharded mesh(tile={n_tile}, spp={n_spp}): {args.frames} frames at "
        f"{width}x{height} in {dt:.3f}s ({mrays:.1f} Mrays/s incl. compile)"
    )
    write_png(args.out, img)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
