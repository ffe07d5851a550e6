"""Camera matrix + ray generation tests against the reference conventions."""

import numpy as np
import jax.numpy as jnp

from vkrt.utils.camera import Camera, generate_rays, look_at, perspective_vk


def test_lookat_maps_eye_to_origin():
    v = look_at((0, 0, 15), (0, 0, 0), (0, 1, 0))
    p = v @ np.array([0, 0, 15, 1.0])
    np.testing.assert_allclose(p[:3], 0, atol=1e-12)
    # center maps onto -z axis at distance 15
    c = v @ np.array([0, 0, 0, 1.0])
    np.testing.assert_allclose(c[:3], [0, 0, -15], atol=1e-12)


def test_perspective_vk_depth_range():
    p = perspective_vk(60, 16 / 9, 0.1, 1000.0)
    near = p @ np.array([0, 0, -0.1, 1.0])
    far = p @ np.array([0, 0, -1000.0, 1.0])
    np.testing.assert_allclose(near[2] / near[3], 0.0, atol=1e-9)
    np.testing.assert_allclose(far[2] / far[3], 1.0, atol=1e-9)
    # Vulkan Y flip: a point above center projects to negative y
    up = p @ np.array([0, 1, -10, 1.0])
    assert up[1] / up[3] < 0


def test_center_ray_points_at_lookat_center():
    w, h = 64, 64
    cam = Camera().matrices(w, h)
    jitter = jnp.full((w * h, 2), 0.5)
    o, d = generate_rays(cam, w, h, jitter)
    o, d = np.asarray(o), np.asarray(d)
    np.testing.assert_allclose(o[0], [0, 0, 15], atol=1e-5)
    center = d.reshape(h, w, 3)[h // 2, w // 2]
    # the exact center pixel is offset half a pixel; direction ~ -z
    assert center[2] < -0.999
    np.testing.assert_allclose(np.linalg.norm(d, axis=1), 1.0, atol=1e-5)


def test_ray_directions_match_projection_inverse():
    """Top-left pixel ray must pass through NDC (-1,-1) on the near plane,
    i.e. up and left of center in world space for the default camera."""
    w, h = 8, 8
    cam = Camera().matrices(w, h)
    jitter = jnp.zeros((w * h, 2))
    _, d = generate_rays(cam, w, h, jitter)
    d = np.asarray(d).reshape(h, w, 3)
    # default camera at +z looking at origin, up +y, right +x:
    topleft = d[0, 0]
    assert topleft[1] > 0  # up
    assert topleft[0] < 0  # left
    bottomright = d[-1, -1]
    assert bottomright[1] < 0 and bottomright[0] > 0


def test_fov_controls_spread():
    w, h = 32, 32
    wide = Camera(fov_deg=90.0).matrices(w, h)
    narrow = Camera(fov_deg=30.0).matrices(w, h)
    jitter = jnp.zeros((w * h, 2))
    _, dw = generate_rays(wide, w, h, jitter)
    _, dn = generate_rays(narrow, w, h, jitter)
    spread_w = float(np.asarray(dw)[0] @ np.asarray(dw)[-1])
    spread_n = float(np.asarray(dn)[0] @ np.asarray(dn)[-1])
    assert spread_w < spread_n  # wider fov -> corner rays farther apart


def test_untile_matches_inverse_perm():
    """untile (reshape/transpose display un-permute) must be exactly
    out[inv_perm] for every frame geometry, including ragged bottom
    tiles (720 = 22*32 + 16)."""
    import numpy as np
    import jax.numpy as jnp

    from vkrt.utils.camera import tile_perm, untile

    rng = np.random.default_rng(0)
    for w, h in ((1280, 720), (96, 72), (64, 32), (1280, 16), (160, 120)):
        _, inv = tile_perm(w, h)
        x = jnp.asarray(rng.normal(size=(w * h, 3)).astype(np.float32))
        np.testing.assert_array_equal(
            np.asarray(untile(x, w, h)), np.asarray(x)[inv], err_msg=f"{w}x{h}"
        )


def test_retile_matches_perm():
    """retile must be exactly img[perm] (inverse of untile)."""
    import numpy as np
    import jax.numpy as jnp

    from vkrt.utils.camera import retile, tile_perm, untile

    rng = np.random.default_rng(1)
    for w, h in ((1280, 720), (96, 72), (64, 32), (160, 120)):
        perm, _ = tile_perm(w, h)
        x = jnp.asarray(rng.normal(size=(w * h, 4)).astype(np.float32))
        np.testing.assert_array_equal(
            np.asarray(retile(x, w, h)), np.asarray(x)[perm], err_msg=f"{w}x{h}"
        )
        np.testing.assert_array_equal(
            np.asarray(untile(retile(x, w, h), w, h)), np.asarray(x)
        )
