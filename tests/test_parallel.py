"""Multi-device sharded rendering on the 8-virtual-CPU-device mesh
('multi-node without a cluster', SURVEY.md §4)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from vkrt.config import RenderSettings
from vkrt.engine import Engine
from vkrt.ops.trace import make_tracer
from vkrt.parallel.mesh import factor_mesh, make_render_mesh
from vkrt.parallel.render import (
    device_put_accum,
    make_sharded_pathtrace_step,
    render_sharded,
)
from vkrt.scene import make_cornell_box
from vkrt.utils.camera import Camera

W, H = 64, 32

needs_8dev = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs 8 virtual devices"
)


@pytest.fixture(scope="module")
def box():
    return make_cornell_box()


@needs_8dev
def test_tile_sharding_matches_single_device(box):
    tracer = make_tracer(box, "bruteforce")
    cam = Camera().matrices(W, H)
    mesh = make_render_mesh(n_tile=8, n_spp=1)
    accum, rays = render_sharded(
        box, tracer, cam, mesh,
        width=W, height=H, samples=1, depth=3, frames=2,
        clear_color=(1, 1, 1, 1),
    )
    # single-device reference (identical seeding when n_spp == 1)
    # corr_sampler pinned off: these tests assert SHARDING equivalence
    # under identical sampling; sharded corr regroups blocks (own tests below)
    e = Engine(box, W, H, RenderSettings(rt_mode=1, backend="bruteforce",
                                         corr_sampler=False))
    e.render_frame()
    e.render_frame()
    # engine buffers live in tile order; un-permute for comparison
    np.testing.assert_allclose(
        np.asarray(accum),
        np.asarray(jnp.take(e.accum, e._inv_perm, axis=0)),
        rtol=1e-5, atol=1e-6,
    )
    assert rays > 0


@needs_8dev
def test_tile_and_spp_axes(box):
    tracer = make_tracer(box, "bruteforce")
    cam = Camera().matrices(W, H)
    mesh = make_render_mesh(n_tile=4, n_spp=2)
    accum, rays = render_sharded(
        box, tracer, cam, mesh,
        width=W, height=H, samples=2, depth=2, frames=1,
        clear_color=(1, 1, 1, 1),
    )
    a = np.asarray(accum)
    assert np.isfinite(a).all()
    assert a.max() > 0
    # compare against unsharded 2-spp render: different RNG streams, same
    # estimator -> images agree in the mean
    e = Engine(box, W, H, RenderSettings(rt_mode=1, samples=2, depth=2,
                                         backend="bruteforce",
                                         corr_sampler=False))
    e.render_frame()
    b = np.asarray(jnp.take(e.accum, e._inv_perm, axis=0))
    finite = np.isfinite(a) & np.isfinite(b) & (np.abs(b) < 50) & (np.abs(a) < 50)
    assert abs(a[finite].mean() - b[finite].mean()) < 0.3


@needs_8dev
def test_output_sharding_is_tile_partitioned(box):
    tracer = make_tracer(box, "bruteforce")
    cam = Camera().matrices(W, H)
    mesh = make_render_mesh(n_tile=8, n_spp=1)
    step, _inv = make_sharded_pathtrace_step(
        box, tracer, mesh, width=W, height=H, samples=1, depth=2
    )
    accum = device_put_accum(mesh, W, H)
    out, _ = step(cam, 0, accum, jnp.ones(4, jnp.float32))
    # output stays sharded: no implicit gather in the frame loop
    assert len(out.sharding.device_set) == 8


def test_factor_mesh():
    assert factor_mesh(8) == (4, 2)
    assert factor_mesh(2) == (2, 1)
    assert factor_mesh(1) == (1, 1)
    assert factor_mesh(6) == (3, 2)


@needs_8dev
def test_sharded_hybrid_matches_single_device(box):
    from vkrt.parallel.render import make_sharded_hybrid_step

    tracer = make_tracer(box, "bruteforce")
    cam = Camera().matrices(W, H)
    mesh = make_render_mesh(n_tile=8, n_spp=1)
    step = make_sharded_hybrid_step(
        box, tracer, mesh, width=W, height=H, depth=3,
        use_shadows=True, use_ao=True, use_gi=True,
    )
    accum = jax.device_put(
        jnp.zeros((W * H, 4), jnp.float32),
        jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("tile")),
    )
    gbuf, accum, rays = step(cam, 0, accum, jnp.ones(4, jnp.float32))

    e = Engine(box, W, H, RenderSettings(rt_mode=0, use_gi=True,
                                         corr_sampler=False))
    e.render_frame()
    inv = e._inv_perm
    np.testing.assert_allclose(
        np.asarray(accum), np.asarray(jnp.take(e.accum_rt, inv, axis=0)),
        rtol=1e-5, atol=1e-6,
    )
    np.testing.assert_allclose(
        np.asarray(gbuf.color),
        np.asarray(jnp.take(e.gbuffer.color, inv, axis=0)),
        rtol=1e-5, atol=1e-6,
    )
    assert float(rays) == e.total_rays


@needs_8dev
def test_app_mesh_cli(tmp_path):
    """The --mesh CLI path end to end: argument plumbing + sharded render +
    PNG output."""
    from vkrt.app import main

    out = str(tmp_path / "mesh.png")
    # spp must be divisible by the spp mesh axis: friendly error, not a trace
    assert main([
        "--procedural", "cornell", "--mode", "path", "--mesh", "4,2",
        "--spp", "1", "--width", "64", "--height", "48", "--out", out,
    ]) == 2
    rc = main([
        "--procedural", "cornell", "--mode", "path", "--mesh", "4,2",
        "--spp", "2", "--width", "64", "--height", "48", "--frames", "2",
        "--backend", "bruteforce", "--out", out,
    ])
    assert rc == 0
    import numpy as np
    from vkrt.utils.png import decode_png

    img = decode_png(open(out, "rb").read())
    assert img.shape[:2] == (48, 64)
    assert img[..., :3].std() > 5.0  # an actual image, not a constant


@needs_8dev
def test_sharded_pathtrace_with_kernel_tracer(box):
    """The GPU path's tracer (the Pallas traversal kernel, interpret mode on
    CPU) under shard_map — catches shard_map x pallas_call interaction bugs
    the bruteforce-backed tests cannot."""
    from vkrt.ops.trace import build_tracer

    w, h = 32, 16  # tiny: interpret mode is slow
    tracer = build_tracer(box.tri_v0, box.tri_e1, box.tri_e2, "kernel",
                          interpret=True)
    cam = Camera().matrices(w, h)
    mesh = make_render_mesh(n_tile=4, n_spp=2)
    step, inv = make_sharded_pathtrace_step(
        box, tracer, mesh, width=w, height=h, samples=2, depth=2
    )
    accum = device_put_accum(mesh, w, h)
    accum, rays = step(cam, 0, accum, jnp.ones(4, jnp.float32))
    a = np.asarray(jnp.take(accum, inv, axis=0))
    assert np.isfinite(a).all() and a.max() > 0 and float(rays) > 0

    # equivalence against the same tracer unsharded (n_spp=1 exact seeding)
    mesh1 = make_render_mesh(n_tile=4, n_spp=1)
    step1, inv1 = make_sharded_pathtrace_step(
        box, tracer, mesh1, width=w, height=h, samples=1, depth=2
    )
    accum1, _ = step1(cam, 0, device_put_accum(mesh1, w, h),
                      jnp.ones(4, jnp.float32))
    accum1 = jnp.take(accum1, inv1, axis=0)
    from vkrt.models.pathtracer import pathtrace_frame

    ref, _ = pathtrace_frame(
        box, tracer, cam, 0, jnp.zeros((w * h, 3), jnp.float32),
        jnp.ones(4, jnp.float32), width=w, height=h, samples=1, depth=2,
    )
    # each lane walks the same tree in the same order whatever block it
    # lands in; allow isolated seam pixels (float reassociation between the
    # two compiled programs), everything else must match exactly.
    a, b = np.asarray(accum1), np.asarray(ref)
    mismatched = np.any(np.abs(a - b) > 1e-5 + 1e-5 * np.abs(b), axis=-1)
    assert mismatched.mean() < 0.01, (
        f"{mismatched.sum()}/{mismatched.size} pixels differ"
    )


@needs_8dev
def test_denoise_tile_equals_full():
    """The tile-sharded temporal denoiser (ppermute halos + all-gathered
    reprojection history) is per-pixel equal to the full-frame filter
   , on history that reprojects ACROSS
    band boundaries."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from jax import shard_map

    from vkrt.models import denoiser as dn
    from vkrt.ops import nrd

    w, h = 32, 32  # 4 bands of 8 rows = exactly the 2^3 tap reach
    n = w * h
    rng = np.random.default_rng(7)
    f32 = lambda *s: jnp.asarray(rng.random(s, np.float32))  # noqa: E731

    rad = f32(n, 3)
    hdn = f32(n)
    normal = np.asarray(rng.normal(size=(n, 3)), np.float32)
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    normal = jnp.asarray(normal)
    rough = f32(n)
    mid = jnp.zeros((n,), jnp.float32)
    packed_rad = nrd.pack_radiance_and_norm_hit_dist(rad, hdn)
    packed_nrm = nrd.pack_normal_and_roughness(normal, rough, mid)

    # two frames of a camera strafe large enough that history crosses bands
    cam0 = Camera(eye=(0.0, 0.0, 9.0)).matrices(w, h)
    cam1 = Camera(eye=(0.0, 0.8, 9.0)).matrices(w, h)
    # world positions on a plane in front of both cameras
    xs = (jnp.arange(n) % w).astype(jnp.float32) / w * 4.0 - 2.0
    ys = (jnp.arange(n) // w).astype(jnp.float32) / h * 4.0 - 2.0
    world_pos = jnp.stack([xs, ys, jnp.zeros_like(xs)], axis=-1)
    view_z = jnp.full((n,), 9.0, jnp.float32)

    # frame-0 state from the full-frame path (shared starting point)
    state0 = dn.init_state(w, h)
    _, state1 = dn.denoise_temporal(
        state0, packed_rad, packed_nrm, view_z, world_pos,
        cam0.view_proj, w, h,
    )

    ref, ref_state = dn.denoise_temporal(
        state1, packed_rad, packed_nrm, view_z, world_pos,
        cam1.view_proj, w, h,
    )

    mesh = make_render_mesh(n_tile=4, n_spp=1)
    spec = dn.DenoiserState(
        hist_rad=P("tile"), hist_m1=P("tile"), hist_m2=P("tile"),
        hist_len=P("tile"), prev_view_proj=P(),
        prev_view_z=P("tile"), prev_normal=P("tile"),
    )

    def body(state, prad, pnrm, vz, wp):
        return dn.denoise_temporal_tile(
            state, prad, pnrm, vz, wp, cam1.view_proj, w, h, "tile"
        )

    tiled = shard_map(
        body, mesh=mesh,
        in_specs=(spec, P("tile"), P("tile"), P("tile"), P("tile")),
        out_specs=(P("tile"), spec),
        check_vma=False,
    )
    state1_sh = jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), state1, spec
    )
    got, got_state = jax.jit(tiled)(
        state1_sh, packed_rad, packed_nrm, view_z, world_pos
    )

    # history must actually cross band boundaries for this to test halos
    prev_px, in_prev = dn.motion_vectors(world_pos, cam0.view_proj, w, h)
    rows_moved = np.abs(
        np.asarray(prev_px[:, 1]) - np.asarray(jnp.arange(n) // w)
    )
    assert rows_moved[np.asarray(in_prev)].max() > 1.0

    np.testing.assert_allclose(
        np.asarray(got), np.asarray(ref), rtol=1e-5, atol=1e-6
    )
    for a, b in zip(jax.tree.leaves(got_state), jax.tree.leaves(ref_state)):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-6
        )


@needs_8dev
def test_sharded_hybrid_denoised_matches_single_device(box):
    """Benchmark config 5's stack (hybrid + GI + temporal denoiser) under a
    mesh: per-pixel equal to the single-device engine across frames."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from vkrt.models.denoiser import DenoiserState, init_state
    from vkrt.parallel.render import make_sharded_hybrid_step

    tracer = make_tracer(box, "bruteforce")
    cam = Camera().matrices(W, H)
    mesh = make_render_mesh(n_tile=4, n_spp=1)
    step = make_sharded_hybrid_step(
        box, tracer, mesh, width=W, height=H, depth=3,
        use_shadows=True, use_ao=True, use_gi=True, use_denoiser=True,
    )
    spec = DenoiserState(
        hist_rad=P("tile"), hist_m1=P("tile"), hist_m2=P("tile"),
        hist_len=P("tile"), prev_view_proj=P(),
        prev_view_z=P("tile"), prev_normal=P("tile"),
    )
    dstate = jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
        init_state(W, H), spec,
    )
    accum = jax.device_put(
        jnp.zeros((W * H, 4), jnp.float32), NamedSharding(mesh, P("tile"))
    )
    for f in range(2):
        gbuf, accum, rays, dstate = step(
            cam, f, accum, jnp.ones(4, jnp.float32), dstate
        )

    e = Engine(box, W, H, RenderSettings(
        rt_mode=0, use_gi=True, use_denoiser=True, temporal_denoiser=True,
        corr_sampler=False,
    ))
    e.render_frame()
    e.render_frame()
    inv = e._inv_perm
    np.testing.assert_allclose(
        np.asarray(accum), np.asarray(jnp.take(e.accum_rt, inv, axis=0)),
        rtol=1e-4, atol=1e-5,
    )


@needs_8dev
def test_sharded_corr_mesh11_matches_engine(box):
    """Correlated sampler under a (1,1) mesh: the corr salt mixes to zero
    (tile 0, spp group 0) so the sharded corr stream reproduces the
    single-device engine's corr render exactly — the same bit-exactness
    contract the independent sampler has."""
    tracer = make_tracer(box, "bruteforce")
    cam = Camera().matrices(W, H)
    mesh = make_render_mesh(n_tile=1, n_spp=1)
    accum, rays = render_sharded(
        box, tracer, cam, mesh,
        width=W, height=H, samples=1, depth=3, frames=2,
        clear_color=(1, 1, 1, 1), corr=True,
    )
    e = Engine(box, W, H, RenderSettings(rt_mode=1, backend="bruteforce",
                                         corr_sampler=True))
    e.render_frame()
    e.render_frame()
    np.testing.assert_allclose(
        np.asarray(accum),
        np.asarray(jnp.take(e.accum, e._inv_perm, axis=0)),
        rtol=1e-5, atol=1e-6,
    )


@needs_8dev
def test_sharded_corr_multishard_statistics(box):
    """Correlated sampler over (4,2): block membership follows the local
    pools, so the image is a DIFFERENT (equally unbiased) correlated
    estimator than unsharded corr — assert validity + mean agreement, and
    that the two spp groups were actually decorrelated (the salted tables
    must not duplicate one group's draws into the other)."""
    tracer = make_tracer(box, "bruteforce")
    cam = Camera().matrices(W, H)
    mesh = make_render_mesh(n_tile=4, n_spp=2)
    accum, rays = render_sharded(
        box, tracer, cam, mesh,
        width=W, height=H, samples=2, depth=2, frames=2,
        clear_color=(1, 1, 1, 1), corr=True,
    )
    a = np.asarray(accum)
    assert np.isfinite(a).all() and a.max() > 0 and rays > 0
    e = Engine(box, W, H, RenderSettings(rt_mode=1, samples=2, depth=2,
                                         backend="bruteforce",
                                         corr_sampler=True))
    e.render_frame()
    e.render_frame()
    b = np.asarray(jnp.take(e.accum, e._inv_perm, axis=0))
    finite = np.isfinite(a) & np.isfinite(b) & (np.abs(b) < 50) & (np.abs(a) < 50)
    assert abs(a[finite].mean() - b[finite].mean()) < 0.3

    # spp-group decorrelation: a 1-spp sharded render at group salt 0 vs the
    # same frame re-rendered as group 1 of a 2-group mesh must differ (the
    # group salt feeds the corr tables)
    mesh1 = make_render_mesh(n_tile=4, n_spp=1)
    acc1, _ = render_sharded(
        box, tracer, cam, mesh1,
        width=W, height=H, samples=1, depth=2, frames=1,
        clear_color=(1, 1, 1, 1), corr=True,
    )
    assert not np.allclose(np.asarray(acc1), a, atol=1e-4)


@needs_8dev
def test_sharded_corr_hybrid_smoke(box):
    """Hybrid + GI with corr under a (4,1) mesh: valid finite output in the
    same exposure range as the corr-less sharded hybrid."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from vkrt.parallel.render import make_sharded_hybrid_step

    tracer = make_tracer(box, "bruteforce")
    cam = Camera().matrices(W, H)
    mesh = make_render_mesh(n_tile=4, n_spp=1)
    outs = {}
    for corr in (False, True):
        step = make_sharded_hybrid_step(
            box, tracer, mesh, width=W, height=H, depth=2,
            use_shadows=True, use_ao=True, use_gi=True, corr=corr,
        )
        accum = jax.device_put(
            jnp.zeros((W * H, 4), jnp.float32),
            NamedSharding(mesh, P("tile")),
        )
        _, accum, rays = step(cam, 0, accum, jnp.ones(4, jnp.float32))
        outs[corr] = np.asarray(accum)
        assert np.isfinite(outs[corr]).all() and float(rays) > 0
    assert not np.allclose(outs[False], outs[True])
    assert abs(outs[False].mean() - outs[True].mean()) < 0.1
