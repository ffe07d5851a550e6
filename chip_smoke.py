#!/usr/bin/env python3
"""Smoke test of the renderer on one GPU: the quickest proof that the main
path starts, compiles and renders correctly on the card.

    python3 chip_smoke.py               # one card, every phase below
    python3 chip_smoke.py --four-cards  # four cards: the mesh phase only

Phases (one card), each fatal on failure:

1. device check: JAX's default device must be a GPU (no CPU fallback);
2. trace-kernel parity: the per-ray traversal kernel against the plain
   references (brute force on Cornell, the LBVH walk on the 143k-triangle
   city) on 1280x720 primary and secondary pools, closest and any-hit;
3. path tracer: ``Engine`` at 1280x720, spp 1, depth 3 on Cornell;
4. hybrid: ``Engine`` with shadows, AO, GI and the temporal denoiser on
   ``make_city(grid=96)`` at 1280x720 over orbit frames;
5. accuracy anchor: benchmarks/accuracy.py against the CPU float64 oracle.

``--four-cards`` runs only the mesh phase: the sharded path step on a
(tile=2, spp=2) mesh and the sharded hybrid+denoiser step on (4,1), each
compared with the single-card ``Engine`` image.

The card's name and power limit (nvidia-smi) are printed before the last
line; the last line is one JSON object, printed only when every phase
passed. ``--rehearse`` runs the same phases on the CPU at the given size
(kernel through the Pallas interpreter) and prints no result line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback

FAILED = []


def card_line() -> str:
    """``name, power.limit`` of the first card as nvidia-smi reports it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        lines = out.stdout.strip().splitlines()
        return lines[0].strip() if lines else "nvidia-smi: no output"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"


def run_phase(name, fn, *a, **kw):
    print(f"== {name}", flush=True)
    t0 = time.perf_counter()
    try:
        fn(*a, **kw)
    except Exception:  # a phase failure is reported and makes the run fail
        traceback.print_exc()
        FAILED.append(name)
        print(f"== {name}: FAILED after {time.perf_counter() - t0:.1f}s",
              flush=True)
        return
    print(f"== {name}: ok ({time.perf_counter() - t0:.1f}s incl. compile)",
          flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def check_image(name, img):
    import numpy as np

    a = np.asarray(img)
    check(np.isfinite(a).all(),
          f"{name}: {(~np.isfinite(a)).sum()} non-finite values")
    check(float(a.max()) > 0.0, f"{name}: image is black")


# ---------------------------------------------------------------------------
# one-card phases
# ---------------------------------------------------------------------------


def _pools(scene, cam, width, height, seed):
    """Primary rays at pixel centres, and a secondary pool from their hits:
    random directions, per-lane limits, and 10% dead lanes (dir 0,
    limit -1) as the fused bounce pools carry them."""
    import jax
    import jax.numpy as jnp

    from vkrt.ops.trace import make_tracer
    from vkrt.utils.camera import generate_rays

    n = width * height
    o, d = generate_rays(cam, width, height, jnp.full((n, 2), 0.5))
    hit = make_tracer(scene, "bvh").closest(o, d, 1e-3, 1e4)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    d2 = jax.random.normal(k1, (n, 3))
    d2 = d2 / jnp.linalg.norm(d2, axis=1, keepdims=True)
    o2 = o + d * hit.t[:, None]
    lim = jax.random.uniform(k2, (n,), minval=0.3, maxval=8.0)
    dead = jax.random.uniform(k3, (n,)) < 0.1
    d2 = jnp.where(dead[:, None], 0.0, d2)
    lim = jnp.where(dead, -1.0, lim)
    return (o, d, jnp.full((n,), 1e4)), (o2, d2, lim)


def compare_tracers(label, got, ref, pools):
    """Closest: t within 1e-4 relative where both hit the same triangle,
    the same triangle (or miss) on >= 99.9% of lanes; any-hit: the same
    verdict on >= 99.99% of lanes."""
    import numpy as np

    for pname, (o, d, lim) in zip(("primary", "secondary"), pools):
        a = got.closest(o, d, 1e-3, 1e4, t_lim=lim)
        b = ref.closest(o, d, 1e-3, 1e4, t_lim=lim)
        tri_a, tri_b = np.asarray(a.tri), np.asarray(b.tri)
        hit_a, hit_b = np.asarray(a.hit), np.asarray(b.hit)
        tri_a = np.where(hit_a, tri_a, -1)
        tri_b = np.where(hit_b, tri_b, -1)
        same = tri_a == tri_b
        both = hit_a & hit_b & same
        ta, tb = np.asarray(a.t)[both], np.asarray(b.t)[both]
        rel = float(np.max(np.abs(ta - tb) / np.maximum(np.abs(tb), 1e-6))) \
            if both.any() else 0.0
        any_a = np.asarray(got.any(o, d, 1e-3, lim))
        any_b = np.asarray(ref.any(o, d, 1e-3, lim))
        any_same = float((any_a == any_b).mean())
        print(f"   {label} {pname}: {len(tri_a)} lanes, hit "
              f"{hit_b.mean():.4f}, same tri {same.mean():.6f}, max rel t "
              f"{rel:.3e}, any-hit agree {any_same:.6f}", flush=True)
        check(same.mean() >= 0.999, f"{label} {pname}: same tri {same.mean()}")
        check(rel <= 1e-4, f"{label} {pname}: max rel t error {rel}")
        check(any_same >= 0.9999, f"{label} {pname}: any-hit agree {any_same}")


def phase_kernel_parity(width, height, city_grid, interpret):
    import jax

    from vkrt.ops.trace import build_tracer
    from vkrt.scene import make_city, make_cornell_box
    from vkrt.utils.camera import Camera, orbit_camera

    with jax.default_matmul_precision("highest"):
        for label, scene, cam, ref_backend in (
            ("cornell", make_cornell_box(), Camera(), "bruteforce"),
            ("city", make_city(grid=city_grid),
             orbit_camera(0.12, radius=300, height=48), "bvh"),
        ):
            tris = (scene.tri_v0, scene.tri_e1, scene.tri_e2)
            kernel = build_tracer(*tris, "kernel", interpret=interpret)
            ref = build_tracer(*tris, ref_backend)
            pools = _pools(scene, cam.matrices(width, height), width, height,
                           seed=1)
            print(f"   {label}: {scene.num_tris} triangles, kernel vs "
                  f"{ref_backend}", flush=True)
            compare_tracers(label, kernel, ref, pools)


def _timed_engine(eng, frames, camera_fn=None):
    """Warm one frame (compile), then time ``frames`` frames ending in
    block_until_ready. Returns (ms/frame, Mrays/s, last output)."""
    if camera_fn is not None:
        eng.camera = camera_fn(0)
    eng.render_frame().block_until_ready()
    rays0 = eng.total_rays
    t0 = time.perf_counter()
    out = None
    for f in range(frames):
        if camera_fn is not None:
            eng.camera = camera_fn(f + 1)
        out = eng.render_frame()
    out.block_until_ready()
    dt = time.perf_counter() - t0
    return dt / frames * 1e3, (eng.total_rays - rays0) / dt / 1e6, out


def phase_path(width, height, frames, card, tracer_fn):
    from vkrt.config import RenderSettings
    from vkrt.engine import Engine
    from vkrt.scene import load_cornell

    scene = load_cornell()
    eng = Engine(scene, width, height, RenderSettings(rt_mode=1, depth=3),
                 tracer=tracer_fn(scene))
    ms, mrays, out = _timed_engine(eng, frames)
    check_image("path", out)
    check_image("path accum", eng.accum)
    print(f"   path tracer, cornell ({scene.num_tris} triangles), "
          f"{width}x{height} spp 1 depth 3: {ms} ms/frame, {mrays} Mrays/s "
          f"over {frames} frames [{card}]", flush=True)


def phase_hybrid(width, height, frames, city_grid, card, tracer_fn):
    from vkrt.config import RenderSettings
    from vkrt.engine import Engine
    from vkrt.scene import make_city
    from vkrt.utils.camera import orbit_camera

    scene = make_city(grid=city_grid)
    settings = RenderSettings(rt_mode=0, use_shadows=True, use_ao=True,
                              use_gi=True, use_denoiser=True)
    eng = Engine(scene, width, height, settings, tracer=tracer_fn(scene))
    orbit = lambda f: orbit_camera(0.12 + 0.01 * f, radius=300, height=48)  # noqa: E731
    ms, mrays, out = _timed_engine(eng, frames, camera_fn=orbit)
    check_image("hybrid", out)
    print(f"   hybrid + shadows/AO/GI + temporal denoiser, city grid "
          f"{city_grid} ({scene.num_tris} triangles), {width}x{height}: "
          f"{ms} ms/frame, {mrays} Mrays/s over {frames} orbit frames "
          f"[{card}]", flush=True)


def phase_accuracy():
    from benchmarks.accuracy import run

    rec = run()
    print(f"   accuracy: rmse {rec['rmse_display']:.3e}, p99 "
          f"{rec['p99_abs_err']:.3e}, diverged {rec['diverged_frac']:.4f} "
          f"(tracer {rec['tracer']})", flush=True)
    check(rec["ok"], f"accuracy out of budget: {rec}")


# ---------------------------------------------------------------------------
# four-card phase
# ---------------------------------------------------------------------------


def _display(img):
    import numpy as np

    from vkrt.models.post import tonemap

    return np.clip(np.asarray(tonemap(img), np.float64), 0.0, 1.0)


def phase_four_cards(width, height, frames, tracer_fn):
    """Sharded path (tile=2, spp=2) and hybrid+denoiser (4,1) at full size
    against the one-card Engine. Tile-only sharding reproduces the Engine's
    random walk, so the hybrid image must match it per pixel: p99 of the
    linear |diff| <= 1e-3, and < 1% of pixels whose display value is off by
    more than 1e-2 (the accuracy anchor's two error populations: float
    drift, and walks sent elsewhere by a flipped discrete decision). The spp axis draws other
    samples, so the path image is compared statistically: 16x16 block means
    of the display image within 0.05 and the global mean within 0.01."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from vkrt.config import RenderSettings
    from vkrt.engine import Engine
    from vkrt.models.denoiser import DenoiserState, init_state
    from vkrt.parallel.mesh import make_render_mesh
    from vkrt.parallel.render import make_sharded_hybrid_step, render_sharded
    from vkrt.scene import make_cornell_box
    from vkrt.utils.camera import Camera

    check(jax.device_count() >= 4, f"needs 4 devices, has {jax.device_count()}")
    scene = make_cornell_box()
    tracer = tracer_fn(scene)
    cam = Camera()
    camm = cam.matrices(width, height)
    clear = (1.0, 1.0, 1.0, 1.0)

    # --- path tracer over (tile=2, spp=2) ---------------------------------
    mesh = make_render_mesh(n_tile=2, n_spp=2)
    t0 = time.perf_counter()
    accum, rays = render_sharded(
        scene, tracer, camm, mesh, width=width, height=height, samples=2,
        depth=3, frames=frames, clear_color=clear)
    print(f"   sharded path (tile=2, spp=2), {frames} frames: "
          f"{time.perf_counter() - t0:.3f}s incl. compile, rays {rays}",
          flush=True)
    check_image("sharded path", accum)
    eng = Engine(scene, width, height,
                 RenderSettings(rt_mode=1, samples=2, depth=3,
                                corr_sampler=False), cam, tracer=tracer)
    for _ in range(frames):
        eng.render_frame()
    ref = jnp.take(eng.accum, eng._inv_perm, axis=0)
    a = _display(accum).reshape(height, width, 3)
    b = _display(ref).reshape(height, width, 3)
    bh, bw = height // 16, width // 16
    blk = lambda x: x[:bh * 16, :bw * 16].reshape(16, bh, 16, bw, 3).mean((1, 3))  # noqa: E731
    blk_diff = float(np.abs(blk(a) - blk(b)).max())
    mean_diff = float(abs(a.mean() - b.mean()))
    print(f"   path vs one-card Engine: max 16x16 block-mean diff "
          f"{blk_diff:.4f}, global mean diff {mean_diff:.5f}", flush=True)
    check(blk_diff <= 0.05, f"sharded path block means differ by {blk_diff}")
    check(mean_diff <= 0.01, f"sharded path means differ by {mean_diff}")

    # --- hybrid + temporal denoiser over (4,1) ----------------------------
    mesh_h = make_render_mesh(n_tile=4, n_spp=1)
    step = make_sharded_hybrid_step(
        scene, tracer, mesh_h, width=width, height=height, depth=3,
        use_shadows=True, use_ao=True, use_gi=True, use_denoiser=True,
        corr=False)
    spec = DenoiserState(
        hist_rad=P("tile"), hist_m1=P("tile"), hist_m2=P("tile"),
        hist_len=P("tile"), prev_view_proj=P(),
        prev_view_z=P("tile"), prev_normal=P("tile"),
    )
    dstate = jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh_h, s)),
        init_state(width, height), spec)
    accum_rt = jax.device_put(jnp.zeros((width * height, 4), jnp.float32),
                              NamedSharding(mesh_h, P("tile")))
    clear4 = jnp.asarray(clear, jnp.float32)
    t0 = time.perf_counter()
    for f in range(frames):
        _, accum_rt, _, dstate = step(camm, f, accum_rt, clear4, dstate)
    accum_rt.block_until_ready()
    print(f"   sharded hybrid+denoiser (4,1), {frames} frames: "
          f"{time.perf_counter() - t0:.3f}s incl. compile", flush=True)
    check_image("sharded hybrid", accum_rt)
    eng = Engine(scene, width, height,
                 RenderSettings(rt_mode=0, use_gi=True, use_denoiser=True,
                                corr_sampler=False), cam, tracer=tracer)
    for _ in range(frames):
        eng.render_frame()
    ref = jnp.take(eng.accum_rt, eng._inv_perm, axis=0)
    lin = np.abs(np.asarray(accum_rt[:, :3]) - np.asarray(ref[:, :3])).max(-1)
    err = np.abs(_display(accum_rt[:, :3]) - _display(ref[:, :3])).max(-1)
    p99, off = float(np.percentile(lin, 99)), float((err > 1e-2).mean())
    print(f"   hybrid vs one-card Engine: p99 |diff| {p99:.3e}, pixels off "
          f"by >1e-2: {off:.5f}", flush=True)
    check(p99 <= 1e-3, f"sharded hybrid p99 diff {p99}")
    check(off < 0.01, f"sharded hybrid: {off} of pixels differ")


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the four-card mesh phase")
    p.add_argument("--rehearse", action="store_true",
                   help="run on the CPU at --width/--height; no result line")
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--city-grid", type=int, default=96)
    p.add_argument("--frames", type=int, default=8)
    args = p.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu" and not args.rehearse:
        print(f"chip_smoke: no GPU (JAX platform {dev.platform!r}); "
              "nothing to test", file=sys.stderr)
        return 2

    from vkrt.ops.trace import build_tracer, make_tracer
    from vkrt.utils.jaxcache import enable

    enable()
    interpret = dev.platform != "gpu"
    card = card_line() if not interpret else "no card (rehearsal)"
    print(f"device: {dev.platform} {dev.device_kind} x{jax.device_count()}; "
          f"card: {card}", flush=True)

    def tracer_fn(scene):
        if interpret:  # rehearsal: the GPU path's kernel, interpreted
            return build_tracer(scene.tri_v0, scene.tri_e1, scene.tri_e2,
                                "kernel", interpret=True)
        return make_tracer(scene, "auto")

    w, h = args.width, args.height
    if args.four_cards:
        run_phase("four-card mesh", phase_four_cards, w, h,
                  min(args.frames, 4), tracer_fn)

    else:
        run_phase("trace-kernel parity", phase_kernel_parity, w, h,
                  args.city_grid, interpret)
        run_phase("path tracer", phase_path, w, h, args.frames, card,
                  tracer_fn)
        run_phase("hybrid", phase_hybrid, w, h, args.frames, args.city_grid,
                  card, tracer_fn)
        run_phase("accuracy anchor", phase_accuracy)


    if FAILED:
        print(f"chip_smoke: FAILED phases: {', '.join(FAILED)}",
              file=sys.stderr, flush=True)
        return 1
    print(f"card: {card}", flush=True)
    if args.rehearse:
        print("chip_smoke: rehearsal passed", flush=True)
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
