"""Camera: lookat/perspective matrices and primary-ray generation.

Replicates the reference's camera stack — ``nvh::CameraManipulator`` lookat +
``nvmath::perspectiveVK`` (hello_vulkan.cpp:61-72: fov from CameraManip,
near 0.1, far 1000) — as pure functions producing the same
viewProj/viewInverse/projInverse the UBO carries (shaders/host_device.h:68-73).

Defaults mirror main.cpp:158-160: eye (0,0,15), center (0,0,0), up (0,1,0),
fov 60 deg (nvh::CameraManipulator default).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import jax.numpy as jnp

NEAR_PLANE = 0.1
FAR_PLANE = 1000.0


@dataclasses.dataclass(frozen=True)
class Camera:
    """CameraManip-equivalent state (main.cpp:158-160)."""

    eye: tuple = (0.0, 0.0, 15.0)
    center: tuple = (0.0, 0.0, 0.0)
    up: tuple = (0.0, 1.0, 0.0)
    fov_deg: float = 60.0

    def matrices(self, width: int, height: int) -> "CameraMatrices":
        aspect = width / float(height)
        view = look_at(self.eye, self.center, self.up)
        proj = perspective_vk(self.fov_deg, aspect, NEAR_PLANE, FAR_PLANE)
        return CameraMatrices(
            view_proj=jnp.asarray(proj @ view, jnp.float32),
            view=jnp.asarray(view, jnp.float32),
            view_inverse=jnp.asarray(np.linalg.inv(view), jnp.float32),
            proj_inverse=jnp.asarray(np.linalg.inv(proj), jnp.float32),
        )


class CameraMatrices(NamedTuple):
    """GlobalUniforms equivalent (host_device.h:68-73) + raw view for viewZ.

    A NamedTuple so it is a pytree and flows through jit as four arrays.
    """

    view_proj: jnp.ndarray
    view: jnp.ndarray
    view_inverse: jnp.ndarray
    proj_inverse: jnp.ndarray


def orbit_camera(t: float, center=(0.0, 0.0, 0.0), radius: float = 18.0,
                 height: float = 6.0, fov_deg: float = 60.0) -> Camera:
    """Fly-through camera path: orbit around ``center`` at parameter t in
    [0, 1) — the headless stand-in for CameraManip mouse navigation, used by
    the fly-through benchmark configs (BASELINE.json config 5)."""
    ang = 2.0 * math.pi * t
    eye = (
        center[0] + radius * math.sin(ang),
        center[1] + height,
        center[2] + radius * math.cos(ang),
    )
    return Camera(eye=eye, center=tuple(center), fov_deg=fov_deg)


def look_at(eye, center, up) -> np.ndarray:
    """Right-handed GL-style view matrix (camera looks down -Z)."""
    eye = np.asarray(eye, np.float64)
    center = np.asarray(center, np.float64)
    up = np.asarray(up, np.float64)
    z = eye - center
    z = z / np.linalg.norm(z)
    x = np.cross(up, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    m = np.eye(4)
    m[0, :3] = x
    m[1, :3] = y
    m[2, :3] = z
    m[:3, 3] = -m[:3, :3] @ eye
    return m


def perspective_vk(fov_deg: float, aspect: float, near: float, far: float) -> np.ndarray:
    """nvmath::perspectiveVK — Vulkan clip space: Y flipped, depth [0, 1]."""
    f = 1.0 / math.tan(math.radians(fov_deg) * 0.5)
    m = np.zeros((4, 4))
    m[0, 0] = f / aspect
    m[1, 1] = -f
    m[2, 2] = far / (near - far)
    m[2, 3] = (near * far) / (near - far)
    m[3, 2] = -1.0
    return m


def pixel_coords(width: int, height: int):
    """Flat row-major pixel (x, y) coordinates, (H*W, 2) float32 —
    pixel (0,0) top-left (Vulkan image convention). Shardable on dim 0."""
    xs = jnp.arange(width, dtype=jnp.float32)
    ys = jnp.arange(height, dtype=jnp.float32)
    px, py = jnp.meshgrid(xs, ys)  # (H, W)
    return jnp.stack([px.reshape(-1), py.reshape(-1)], axis=-1)


def tile_perm(width: int, height: int, tile: int = 32):
    """Pixel permutation tiling the frame into ``tile`` x ``tile`` blocks.

    Neighbouring lanes are traced together (a warp of the traversal kernel)
    and, under the correlated sampler, share draws per 1024-lane block; in
    scanline order such a block is a 1024x1 pixel stripe whose frustum
    sweeps much of the scene. In tile order one 1024-lane block is one
    32x32 pixel tile — a compact frustum. Within a tile pixels stay
    row-major.

    Returns (perm, inv_perm) int32 numpy arrays with
    ``pixels_tiled = pixels[perm]`` and ``image = out[inv_perm]``.
    """
    ys, xs = np.mgrid[0:height, 0:width]
    key = (
        ((ys // tile) * ((width + tile - 1) // tile) + (xs // tile)).astype(np.int64)
        * (tile * tile)
        + (ys % tile) * tile
        + (xs % tile)
    ).reshape(-1)
    perm = np.argsort(key, kind="stable").astype(np.int32)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size, dtype=np.int32)
    return perm, inv


def untile(out, width: int, height: int, tile: int = 32):
    """Tile order -> scanline order as reshape/transpose ops.

    Exactly ``out[inv_perm]`` for ``tile_perm``'s inverse, but expressed
    as structured copies instead of an (H*W,)-row GATHER: XLA runs the
    transposes at copy speed. Requires
    ``width % tile == 0`` (ragged right-edge tiles break the regular
    structure — callers fall back to the take).
    """
    assert width % tile == 0, width
    n_tx = width // tile
    n_ty = height // tile
    feats = out.shape[1:]
    parts = []
    full = n_ty * tile * width
    if n_ty:
        seg = out[:full].reshape(n_ty, n_tx, tile, tile, *feats)
        # (ty, tx, y_in, x_in) -> (ty, y_in, tx, x_in)
        seg = jnp.swapaxes(seg, 1, 2).reshape(full, *feats)
        parts.append(seg)
    rem = height - n_ty * tile
    if rem:
        seg = out[full:].reshape(n_tx, rem, tile, *feats)
        seg = jnp.swapaxes(seg, 0, 1).reshape(rem * width, *feats)
        parts.append(seg)
    return parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=0)


def retile(img, width: int, height: int, tile: int = 32):
    """Scanline order -> tile order (inverse of ``untile``), as
    reshape/swapaxes copies. Exactly ``img[perm]`` for ``tile_perm``'s
    permutation. Requires ``width % tile == 0``."""
    assert width % tile == 0, width
    n_tx = width // tile
    n_ty = height // tile
    feats = img.shape[1:]
    parts = []
    full = n_ty * tile * width
    if n_ty:
        seg = img[:full].reshape(n_ty, tile, n_tx, tile, *feats)
        # (ty, y_in, tx, x_in) -> (ty, tx, y_in, x_in)
        seg = jnp.swapaxes(seg, 1, 2).reshape(full, *feats)
        parts.append(seg)
    rem = height - n_ty * tile
    if rem:
        seg = img[full:].reshape(rem, n_tx, tile, *feats)
        seg = jnp.swapaxes(seg, 0, 1).reshape(rem * width, *feats)
        parts.append(seg)
    return parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=0)


def generate_rays(cam: CameraMatrices, width: int, height: int, jitter, pix=None):
    """Primary rays exactly as raytrace.rgen:44-55.

    ``jitter``: (N, 2) in [0,1) or a scalar pair broadcast. ``pix``: optional
    (N, 2) pixel coordinates (defaults to the full frame) — passing an
    explicit shard makes the whole ray-gen SPMD over a device mesh.
    Returns (origin (N,3), direction (N,3)) — direction normalized in camera
    space then rotated to world (the reference normalizes target.xyz before
    the view transform; view is a rigid transform so order is equivalent).
    """
    if pix is None:
        pix = pixel_coords(width, height)
    pixel_center = pix + jitter
    in_uv = pixel_center / jnp.asarray([width, height], jnp.float32)
    d = in_uv * 2.0 - 1.0
    # target = projInverse @ (d.x, d.y, 1, 1); only .xyz used after normalize.
    # Written as explicit multiply-adds rather than a matmul: a float32
    # matmul may run in TF32 on the GPU — camera rays need full fp32.
    pi = cam.proj_inverse
    tdir = jnp.stack(
        [
            pi[0, 0] * d[:, 0] + pi[0, 1] * d[:, 1] + pi[0, 2] + pi[0, 3],
            pi[1, 0] * d[:, 0] + pi[1, 1] * d[:, 1] + pi[1, 2] + pi[1, 3],
            pi[2, 0] * d[:, 0] + pi[2, 1] * d[:, 1] + pi[2, 2] + pi[2, 3],
        ],
        axis=-1,
    )
    tdir = tdir / jnp.linalg.norm(tdir, axis=-1, keepdims=True)
    vi = cam.view_inverse
    world_dir = jnp.stack(
        [
            vi[0, 0] * tdir[:, 0] + vi[0, 1] * tdir[:, 1] + vi[0, 2] * tdir[:, 2],
            vi[1, 0] * tdir[:, 0] + vi[1, 1] * tdir[:, 1] + vi[1, 2] * tdir[:, 2],
            vi[2, 0] * tdir[:, 0] + vi[2, 1] * tdir[:, 1] + vi[2, 2] * tdir[:, 2],
        ],
        axis=-1,
    )
    origin = jnp.broadcast_to(vi[:3, 3], world_dir.shape)
    return origin, world_dir
