"""Correlated per-block sampler (RenderSettings.corr_sampler).

The sampler shares the six sampling draws — lobe pick, light pick,
hemisphere r1/r2, GGX r1/r2 — across each 1024-ray kernel block per
(frame, sample, bounce) so a block's bounce/shadow directions cohere (the
incoherent-pool trace is the measured Sponza-class frame bound, STATUS r3).
Correctness requirements tested here:

* block structure: one shared row per 1024 lanes, re-drawn per frame/depth;
* coherence: equal-normal lanes in one block sample IDENTICAL directions;
* marginals: each pixel's draw stays uniform across frames (unbiasedness);
* equal-budget convergence: accumulated images converge to the same mean
  at the same rate as independent per-lane draws (matches the estimator of
  raytrace.rgen:62-116 in distribution).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from vkrt.ops.rng import block_uniform_table, corr_draws
from vkrt.scene import make_cornell_box

W, H = 48, 36


@pytest.fixture(scope="module")
def box():
    return make_cornell_box()


def test_corr_draws_block_structure():
    n = 3000  # 3 blocks (2 full + ragged tail)
    a = np.asarray(corr_draws(n, jnp.uint32(7), 2))
    assert a.shape == (n, 6)
    # constant within each 1024-lane block
    for b in range(3):
        blk = a[b * 1024 : min((b + 1) * 1024, n)]
        assert (blk == blk[0]).all()
    # distinct across blocks, depths, seeds
    assert not (a[0] == a[1024]).all()
    b_d = np.asarray(corr_draws(n, jnp.uint32(7), 3))
    assert not (a[0] == b_d[0]).all()
    b_s = np.asarray(corr_draws(n, jnp.uint32(8), 2))
    assert not (a[0] == b_s[0]).all()
    assert (a >= 0).all() and (a < 1).all()


def test_corr_marginals_uniform():
    """A fixed lane's shared draw across frames is marginally uniform —
    the unbiasedness requirement (each pixel integrates the hemisphere
    across frames exactly like independent draws would)."""
    us = np.stack(
        [np.asarray(block_uniform_table(4, jnp.uint32(s), 1))[:, :6]
         for s in range(512)]
    )  # (512 frames, 4 blocks, 6 draws)
    flat = us.reshape(512, -1)
    mean = flat.mean(axis=0)
    var = flat.var(axis=0)
    np.testing.assert_allclose(mean, 0.5, atol=0.05)
    np.testing.assert_allclose(var, 1.0 / 12.0, atol=0.02)
    # crude equidistribution: each octile gets its share
    hist = np.histogram(flat, bins=8, range=(0, 1))[0]
    assert hist.min() > 0.8 * flat.size / 8


def test_corr_sample_bsdf_block_coherent(box):
    """Lanes with identical surfaces in one block must sample the SAME
    bounce direction and light under corr (the whole point), and diverse
    directions without it."""
    from vkrt.models.shading import SurfaceSample, sample_bsdf
    from vkrt.ops.rng import seed_pixels

    n = 2048  # two blocks
    one = jnp.ones((n,), jnp.float32)
    zero = jnp.zeros((n,), jnp.float32)
    up = jnp.stack([zero, one, zero], axis=-1)
    tx = jnp.stack([one, zero, zero], axis=-1)
    bz = jnp.stack([zero, zero, one], axis=-1)
    surf = SurfaceSample(
        world_pos=jnp.zeros((n, 3), jnp.float32),
        shading_normal=up, geo_normal=up,
        base_color=jnp.full((n, 3), 0.7, jnp.float32),
        metallic=zero, roughness=0.5 * one,
        emissive=jnp.zeros((n, 3), jnp.float32),
        tangent=tx, binormal=bz,
        uv=jnp.zeros((n, 2), jnp.float32),
        mat_id=jnp.zeros((n,), jnp.int32),
    )
    ray_dir = jnp.broadcast_to(
        jnp.asarray([0.0, -1.0, 0.0], jnp.float32), (n, 3)
    )
    seed = seed_pixels(n, 1, 5)
    emit = jnp.zeros((n,), bool)

    corr = corr_draws(n, jnp.uint32(11), 0)
    bs_c = sample_bsdf(box, surf, ray_dir, seed, emit, corr=corr)
    d = np.asarray(bs_c.next_dir)
    # identical within each block (equal frames + shared draws)
    assert (d[:1024] == d[0]).all()
    assert (d[1024:] == d[1024]).all()
    # blocks differ from each other
    assert not np.allclose(d[0], d[1024])
    # shadow target: one light per block
    sd = np.asarray(bs_c.shadow_dir)
    np.testing.assert_allclose(
        sd[:1024], np.broadcast_to(sd[0], (1024, 3)), atol=1e-6
    )

    # independent draws: directions spread inside the block
    bs_i = sample_bsdf(box, surf, ray_dir, seed, emit)
    di = np.asarray(bs_i.next_dir)
    assert np.unique(np.round(di[:1024], 4), axis=0).shape[0] > 900
    # lane streams advance identically within each branch: every corr seed
    # equals one of the two branch seeds of the independent run (the lobe
    # pick differs, so which branch's stream survives may flip)
    from vkrt.ops.rng import rnd

    s1, _ = rnd(seed)          # after lobe draw
    sd_seed, _ = rnd(s1)       # diffuse branch: light draw
    for _ in range(2):
        sd_seed, _ = rnd(sd_seed)  # hemisphere draws
    ss_seed = s1
    for _ in range(2):
        ss_seed, _ = rnd(ss_seed)  # GGX draws
    got = np.asarray(bs_c.seed)
    ok = (got == np.asarray(sd_seed)) | (got == np.asarray(ss_seed))
    assert ok.all()


def _mean_image(box, frames, corr, depth=2, start=0):
    import jax
    from functools import partial

    from vkrt.models.pathtracer import trace_pixels
    from vkrt.ops.trace import make_tracer
    from vkrt.utils.camera import Camera

    tracer = make_tracer(box, "bruteforce")
    cam = Camera().matrices(W, H)
    step = jax.jit(
        partial(
            trace_pixels, box, tracer, cam, W, H,
            clear_color=jnp.ones(4),
            samples=1, depth=depth, clamp_weights=True, corr=corr,
        )
    )
    acc = np.zeros((W * H, 3), np.float64)
    for f in range(start, start + frames):
        acc += np.asarray(step(f).radiance, np.float64)
    return acc / frames


def test_corr_equal_budget_convergence(box):
    """Equal-budget accumulated images: the correlated sampler must land as
    close to the converged reference as independent draws do."""
    from vkrt.utils.metrics import rmse

    ref = _mean_image(box, 160, corr=False, start=1000)
    img_def = _mean_image(box, 40, corr=False)
    img_cor = _mean_image(box, 40, corr=True)
    e_def = rmse(img_def, ref)
    e_cor = rmse(img_cor, ref)
    # same convergence rate: correlated error within 20% of independent
    # (per-pixel variance is identical; only cross-pixel correlation
    # changes, which equal-budget RMSE is insensitive to)
    assert e_cor <= 1.2 * e_def, (e_cor, e_def)
    # and both actually converged somewhat
    assert e_cor < 0.5 * rmse(_mean_image(box, 4, corr=True), ref)


def test_corr_engine_pallas_paths(box):
    """corr_sampler through the Engine on the GPU path's tracer (the Pallas
    traversal kernel, interpret mode on CPU): valid finite images in both
    modes, and the correlated image is block-coherent but in the same
    exposure range."""
    from vkrt.config import RenderSettings
    from vkrt.engine import Engine
    from vkrt.ops.trace import build_tracer
    from vkrt.utils.camera import Camera

    kernel = build_tracer(box.tri_v0, box.tri_e1, box.tri_e2, "kernel",
                          interpret=True)
    outs = {}
    for corr in (False, True):
        s = RenderSettings(rt_mode=1, depth=2, corr_sampler=corr)
        e = Engine(box, 64, 48, s, Camera(), tracer=kernel)
        for _ in range(3):
            img = e.render_frame()
        outs[corr] = np.asarray(img, np.float64)
        assert np.isfinite(outs[corr]).all()
        assert outs[corr].max() > 0.05
    # different draws -> different noise, same scene -> same exposure
    assert not np.allclose(outs[False], outs[True])
    assert abs(outs[False].mean() - outs[True].mean()) < 0.1


def test_corr_hybrid_smoke(box):
    from vkrt.config import RenderSettings
    from vkrt.engine import Engine
    from vkrt.utils.camera import Camera

    s = RenderSettings(rt_mode=0, use_gi=True, depth=2, corr_sampler=True)
    e = Engine(box, 48, 36, s, Camera())
    img = np.asarray(e.render_frame())
    assert np.isfinite(img).all()
    assert img.max() > 0.05
