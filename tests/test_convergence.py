"""Convergence / accuracy tests (SURVEY.md §4 golden+convergence tiers).

Monte-Carlo correctness shows up as statistics: accumulation must converge
at the 1/sqrt(N) rate toward a stable mean, independent sample sets must
agree in expectation, and the backends must agree with each other under the
full estimator.
"""

import numpy as np
import pytest

from vkrt.config import RenderSettings
from vkrt.engine import Engine
from vkrt.scene import make_cornell_box
from vkrt.utils.metrics import psnr, rmse

W, H = 48, 36


@pytest.fixture(scope="module")
def box():
    return make_cornell_box()


def _frame_radiances(box, frames, depth=3, start_frame=0, clamp=True):
    """Per-frame radiance images for frame indices [start, start+frames).

    ``clamp=True`` is the clamped extension (see RenderSettings.
    clamp_weights); ``clamp=False`` is the reference-faithful estimator with
    its unbounded negative tails."""
    import jax
    import jax.numpy as jnp
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
            samples=1, depth=depth, clamp_weights=clamp,
        )
    )
    return np.stack(
        [np.asarray(step(f).radiance, np.float64)
         for f in range(start_frame, start_frame + frames)]
    )


def _accum_after(box, frames, depth=3, start_frame=0):
    """Mean radiance over frame indices [start, start+frames) — a plain
    average (the engine's progressive mix assumes starting at frame 0, so
    for disjoint-seed windows we average per-frame radiance directly).

    clamp_weights on: the reference-faithful estimator has unbounded
    negative tails (see RenderSettings.clamp_weights) that destroy
    convergence statistics; the clamped extension is what converges."""
    return _frame_radiances(box, frames, depth, start_frame).mean(0).astype(
        np.float32
    )


def test_accumulation_converges(box):
    """RMSE to a disjoint long-run reference drops with more frames —
    roughly 1/sqrt(N), degraded by the estimator's heavy tails (the
    one-sided firefly clamp admits negative outliers, see test_renderer)."""
    ref = np.clip(_accum_after(box, 64, start_frame=100), 0, 10)
    r4 = rmse(np.clip(_accum_after(box, 4, start_frame=1), 0, 10), ref)
    r16 = rmse(np.clip(_accum_after(box, 16, start_frame=1), 0, 10), ref)
    assert r16 < r4 * 0.75, (r4, r16)  # ideal would be 0.5


def test_independent_estimates_agree_in_mean(box):
    """Two disjoint frame ranges estimate the same image."""
    a = _accum_after(box, 24, start_frame=1)   # frames 1..24
    b = _accum_after(box, 24, start_frame=25)  # frames 25..48
    a, b = np.clip(a, 0, 10), np.clip(b, 0, 10)
    assert psnr(a, b, peak=max(a.max(), 1.0)) > 20.0


def test_faithful_estimator_statistics(box):
    """Quantify the FAITHFUL estimator (clamp_weights=False) instead of
    routing every statistic through the clamped extension. Three documented facts:

    1. its heavy tails are RARE — the fraction of per-frame pixel values
       outside [-10, 50] is far below 1e-2 (they are outliers, not bulk);
    2. a tail-robust location estimate (median-of-means over 6 disjoint
       6-frame groups) agrees with the clamped long-run reference — i.e.
       the clamp is a variance fix, not a brightness change;
    3. median-of-means beats the plain mean under the same budget — the
       concrete variance-reduction recipe a faithful-estimator user should
       apply.
    """
    raw = _frame_radiances(box, 36, start_frame=1, clamp=False)
    ref = np.clip(_accum_after(box, 64, start_frame=100), 0, 10)

    tail_frac = np.mean((raw < -10.0) | (raw > 50.0))
    assert tail_frac < 1e-2, tail_frac

    groups = raw.reshape(6, 6, *raw.shape[1:]).mean(axis=1)  # 6 group means
    mom = np.median(groups, axis=0).astype(np.float32)
    plain = raw.mean(axis=0).astype(np.float32)

    r_mom = rmse(np.clip(mom, 0, 10), ref)
    r_plain = rmse(np.clip(plain, 0, 10), ref)
    assert r_mom < r_plain, (r_mom, r_plain)
    # agreement with the clamped reference at the same order as the clamped
    # estimator's own 36-frame noise floor
    r_clamped = rmse(np.clip(_accum_after(box, 36, start_frame=1), 0, 10), ref)
    assert r_mom < 3.0 * r_clamped, (r_mom, r_clamped)


def test_backends_agree_in_expectation(box):
    """bruteforce vs bvh backends: same estimator, same seeds -> (nearly)
    identical accumulated images after several frames."""
    imgs = {}
    for backend in ("bruteforce", "bvh"):
        e = Engine(
            box, W, H,
            RenderSettings(rt_mode=1, backend=backend, clamp_weights=True),
        )
        for _ in range(4):
            e.render_frame()
        imgs[backend] = np.clip(np.asarray(e.accum), 0, 10)
    assert rmse(imgs["bruteforce"], imgs["bvh"]) < 0.02


def test_depth_increases_energy(box):
    """More bounces can only add (non-negative NEE) indirect energy in the
    box interior, modulo noise."""
    d1 = np.clip(_accum_after(box, 16, depth=1), 0, 10)
    d4 = np.clip(_accum_after(box, 16, depth=4), 0, 10)
    assert d4.mean() > d1.mean()


def test_hybrid_gi_correlates_with_path_trace(box):
    """Hybrid-mode GI (direct raster + 1-path GI estimate) must correlate
    with the converged path trace — same scene, same lighting — even though
    the estimators differ (SURVEY §4: RMSE between hybrid GI and converged
    path trace)."""
    ref = np.clip(_accum_after(box, 48, depth=3), 0, 4)
    e = Engine(box, W, H, RenderSettings(rt_mode=0, use_gi=True, clamp_weights=True))
    out = None
    for _ in range(48):
        out = e.render_frame()
    hyb = np.clip(np.asarray(out), 0, 4)
    # normalized cross-correlation over pixels
    a = ref.reshape(-1) - ref.mean()
    b = hyb.reshape(-1) - hyb.mean()
    ncc = float((a @ b) / np.sqrt((a @ a) * (b @ b) + 1e-12))
    assert ncc > 0.7, ncc
