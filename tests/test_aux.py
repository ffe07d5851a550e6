"""Auxiliary subsystems: NRD packing round-trips, denoiser, checkpoint/resume,
profiling stats."""

import numpy as np
import jax.numpy as jnp

from vkrt.ops import nrd


def test_oct_encode_roundtrip(rng):
    n = rng.normal(size=(500, 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    e = nrd.encode_unit_vector(jnp.asarray(n, jnp.float32))
    d = np.asarray(nrd.decode_unit_vector(e))
    dots = np.sum(d * n, axis=1)
    assert dots.min() > 0.999


def test_ycocg_roundtrip(rng):
    c = np.abs(rng.normal(size=(200, 3))).astype(np.float32)
    out = np.asarray(nrd.ycocg_to_linear(nrd.linear_to_ycocg(jnp.asarray(c))))
    np.testing.assert_allclose(out, c, rtol=1e-5, atol=1e-6)


def test_pack_radiance_sanitizes():
    rad = jnp.asarray([[np.nan, 1.0, 2.0], [1.0, 2.0, 3.0], [np.inf, 0.0, 0.0]])
    nh = jnp.asarray([0.5, np.nan, 0.25])
    packed = np.asarray(nrd.pack_radiance_and_norm_hit_dist(rad, nh))
    assert np.isfinite(packed).all()
    # NaN radiance row zeroed
    np.testing.assert_allclose(packed[0, :3], 0.0)
    # NaN hitdist zeroed
    assert packed[1, 3] == 0.0


def test_norm_hit_dist_range():
    hd = jnp.asarray([0.0, 1.0, 100.0, 1e6])
    out = np.asarray(nrd.norm_hit_dist(hd, jnp.asarray([5.0] * 4), jnp.asarray([0.5] * 4)))
    assert (out >= 0).all() and (out <= 1).all()
    assert out[0] == 0.0 and out[3] == 1.0


def test_pack_normal_roughness_fields(rng):
    n = rng.normal(size=(10, 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    p = nrd.pack_normal_and_roughness(
        jnp.asarray(n, jnp.float32), jnp.full(10, 0.3), jnp.arange(10.0)
    )
    nn, rough, mid = nrd.unpack_normal_and_roughness(p)
    np.testing.assert_allclose(np.asarray(rough), 0.3, atol=1e-6)
    assert (np.sum(np.asarray(nn) * n, axis=1) > 0.999).all()


def test_atrous_preserves_constant_image():
    from vkrt.models.denoiser import atrous_filter

    w, h = 16, 12
    img = jnp.full((w * h, 3), 2.5)
    nrm = jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]]), (w * h, 1))
    z = jnp.full((w * h,), 3.0)
    out = np.asarray(atrous_filter(img, nrm, z, w, h))
    np.testing.assert_allclose(out, 2.5, rtol=1e-5)


def test_atrous_respects_normal_edges():
    """Blur must not leak across a hard normal discontinuity."""
    from vkrt.models.denoiser import atrous_filter

    w, h = 32, 8
    img = np.zeros((h, w, 3), np.float32)
    img[:, : w // 2] = 1.0
    nrm = np.zeros((h, w, 3), np.float32)
    nrm[:, : w // 2, 2] = 1.0
    nrm[:, w // 2 :, 0] = 1.0
    z = np.full((h, w), 2.0, np.float32)
    out = np.asarray(
        atrous_filter(
            jnp.asarray(img.reshape(-1, 3)),
            jnp.asarray(nrm.reshape(-1, 3)),
            jnp.asarray(z.reshape(-1)),
            w, h,
        )
    ).reshape(h, w, 3)
    # left side stays ~1, right stays ~0 (orthogonal normals kill weights)
    assert out[:, : w // 2 - 4].min() > 0.98
    assert out[:, w // 2 + 4 :].max() < 0.02


def test_checkpoint_roundtrip(tmp_path, procedural_cornell):
    from vkrt.config import RenderSettings
    from vkrt.engine import Engine
    from vkrt.utils import checkpoint

    path = str(tmp_path / "state.npz")
    e = Engine(procedural_cornell, 32, 24, RenderSettings(rt_mode=1))
    e.render_frame()
    e.render_frame()
    checkpoint.save(e, path)

    e2 = Engine(procedural_cornell, 32, 24, RenderSettings(rt_mode=1))
    assert checkpoint.restore(e2, path)
    assert e2.frame == e.frame
    np.testing.assert_array_equal(np.asarray(e2.accum), np.asarray(e.accum))
    # resumed render continues identically to an uninterrupted one
    e.render_frame()
    e2.render_frame()
    np.testing.assert_array_equal(np.asarray(e2.accum), np.asarray(e.accum))


def test_checkpoint_roundtrips_denoiser_state(tmp_path, procedural_cornell):
    """A resumed denoised fly-through must keep its temporal history: the
    reprojection buffers + moments ARE convergence state (dropping them
    restarts the filter from hist_len 0). The resumed engine must continue
    bit-identically to the uninterrupted one."""
    from vkrt.config import RenderSettings
    from vkrt.engine import Engine
    from vkrt.utils import checkpoint

    settings = RenderSettings(rt_mode=0, use_shadows=True, use_ao=True,
                              use_gi=True, use_denoiser=True)
    path = str(tmp_path / "state.npz")
    e = Engine(procedural_cornell, 32, 24, settings)
    assert e.denoise_state is not None
    e.render_frame()
    e.render_frame()
    checkpoint.save(e, path)

    e2 = Engine(procedural_cornell, 32, 24, settings)
    assert checkpoint.restore(e2, path)
    for a, b in zip(e2.denoise_state, e.denoise_state):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    out1 = e.render_frame()
    out2 = e2.render_frame()
    np.testing.assert_array_equal(np.asarray(out2), np.asarray(out1))


def test_checkpoint_rejects_mismatched_fingerprint(tmp_path, procedural_cornell):
    from vkrt.config import RenderSettings
    from vkrt.engine import Engine
    from vkrt.utils import checkpoint

    path = str(tmp_path / "state.npz")
    e = Engine(procedural_cornell, 32, 24, RenderSettings(rt_mode=1))
    e.render_frame()
    checkpoint.save(e, path)
    other = Engine(procedural_cornell, 32, 24, RenderSettings(rt_mode=1, depth=5))
    assert not checkpoint.restore(other, path)


def test_frame_stats():
    from vkrt.utils.profiling import FrameStats

    s = FrameStats()
    s.record(0.01, 1e6)
    s.record(0.03, 3e6)
    assert abs(s.ms_per_frame - 20.0) < 1e-9
    assert abs(s.fps - 50.0) < 1e-9
    assert abs(s.mrays_per_s - 100.0) < 1e-6
    assert s.summary()["frames"] == 2
