"""Texture sampling as batched gather ops.

Replaces the reference's descriptor-array ``textureSamplers`` fetches
(raytrace.rchit:87,102; gltf.glsl:26-53): bilinear filtering with REPEAT
addressing on the stacked/padded atlas in :class:`SceneArrays`. Mip selection
(the reference generates full mip chains, hello_vulkan.cpp:499) is provided by
:func:`build_mip_pyramid` + trilinear lookup for the hybrid G-buffer path;
the path tracer samples level 0 like the ray pipeline effectively does for
secondary rays (no ray differentials in the reference either).
"""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np

# Anisotropic tap count, read + validated ONCE at import (it is baked into
# each Engine's jitted step at trace time, so later env changes would be
# silently ignored — pin it here to make that explicit). 4 matches the
# reference sampler's maxAnisotropy (hello_vulkan.cpp:452-454); 2 halves
# the tap fan (16 texel gathers per fetch instead of 32) at a quality cost
# only visible at footprint ratios near the 4x clamp.
ANISO_TAPS = int(os.environ.get("VKRT_ANISO_TAPS", "4"))
if ANISO_TAPS not in (2, 4):
    raise ValueError(
        f"VKRT_ANISO_TAPS must be 2 or 4, got {ANISO_TAPS!r}"
    )


def _gather_texel(tex_flat, k, y, x, th, tw):
    lin = (k * th + y) * tw + x
    out = jnp.take(tex_flat, lin, axis=0)
    # bf16 atlas support (VKRT_TEX_BF16): the cast sits AFTER the gather so
    # the random-gather bytes halve; all filtering math stays f32.
    return out.astype(jnp.float32) if out.dtype != jnp.float32 else out


def sample_texture(tex_rgba, tex_size, tex_idx, uv):
    """Bilinear REPEAT sample. tex_idx (N,) int32 (-1 => white), uv (N,2).

    Returns (N,4) RGBA. Texel centers at half-integer coordinates
    (GL_LINEAR convention).
    """
    k_all, th, tw, _ = tex_rgba.shape
    tex_flat = tex_rgba.reshape(k_all * th * tw, 4)
    k = jnp.maximum(tex_idx, 0)
    size = jnp.take(tex_size, k, axis=0)  # (N,2) w,h
    w = size[:, 0].astype(jnp.float32)
    h = size[:, 1].astype(jnp.float32)

    u = uv[:, 0] - jnp.floor(uv[:, 0])  # REPEAT wrap
    v = uv[:, 1] - jnp.floor(uv[:, 1])
    fx = u * w - 0.5
    fy = v * h - 0.5
    x0 = jnp.floor(fx)
    y0 = jnp.floor(fy)
    ax = (fx - x0)[:, None]
    ay = (fy - y0)[:, None]

    wi = size[:, 0]
    hi = size[:, 1]
    x0i = jnp.mod(x0.astype(jnp.int32), wi)
    x1i = jnp.mod(x0.astype(jnp.int32) + 1, wi)
    y0i = jnp.mod(y0.astype(jnp.int32), hi)
    y1i = jnp.mod(y0.astype(jnp.int32) + 1, hi)

    c00 = _gather_texel(tex_flat, k, y0i, x0i, th, tw)
    c10 = _gather_texel(tex_flat, k, y0i, x1i, th, tw)
    c01 = _gather_texel(tex_flat, k, y1i, x0i, th, tw)
    c11 = _gather_texel(tex_flat, k, y1i, x1i, th, tw)
    c = (
        c00 * (1 - ax) * (1 - ay)
        + c10 * ax * (1 - ay)
        + c01 * (1 - ax) * ay
        + c11 * ax * ay
    )
    return jnp.where((tex_idx >= 0)[:, None], c, 1.0)


def pack_mip_atlas(images, srgb_flags=None):
    """Pack per-image mip pyramids into one atlas.

    Levels sit side by side horizontally (level l of a WxH texture at
    x-offset W*(2 - 2^(1-l)) in a 2W-wide strip), so one (K, TH, 2*TW, 4)
    array carries every level of every texture and lookups stay single-array
    gathers. Returns (atlas (K,TH,2TW,4) f32 linear, level_size (K,L,2) i32
    (w,h), level_off (K,L) i32 x-offsets, n_levels (K,) i32).
    """
    from vkrt.scene import srgb_to_linear

    k = len(images)
    th = max(im.shape[0] for im in images)
    tw = max(im.shape[1] for im in images)
    lmax = max(1, int(np.ceil(np.log2(max(th, tw)))) + 1)
    atlas = np.zeros((k, th, 2 * tw, 4), np.float32)
    level_size = np.zeros((k, lmax, 2), np.int32)
    level_off = np.zeros((k, lmax), np.int32)
    n_levels = np.zeros(k, np.int32)
    for i, im in enumerate(images):
        f = im.astype(np.float32) / 255.0
        if srgb_flags is not None and srgb_flags[i]:
            f = np.concatenate([srgb_to_linear(f[..., :3]), f[..., 3:]], axis=-1)
        levels = build_mip_pyramid(f)
        n_levels[i] = len(levels)
        x = 0
        for l, lev in enumerate(levels[:lmax]):
            h, w = lev.shape[:2]
            atlas[i, :h, x : x + w] = lev
            level_size[i, l] = (w, h)
            level_off[i, l] = x
            x += w
        # clamp the tail so out-of-range lods sample the last level
        for l in range(len(levels), lmax):
            level_size[i, l] = level_size[i, len(levels) - 1]
            level_off[i, l] = level_off[i, len(levels) - 1]
    return atlas, level_size, level_off, n_levels


def _bilinear_at_level(tex_flat, k, th, tw2, uv, w, h, xoff):
    u = uv[:, 0] - jnp.floor(uv[:, 0])
    v = uv[:, 1] - jnp.floor(uv[:, 1])
    wf = w.astype(jnp.float32)
    hf = h.astype(jnp.float32)
    fx = u * wf - 0.5
    fy = v * hf - 0.5
    x0 = jnp.floor(fx)
    y0 = jnp.floor(fy)
    ax = (fx - x0)[:, None]
    ay = (fy - y0)[:, None]
    x0i = jnp.mod(x0.astype(jnp.int32), w) + xoff
    x1i = jnp.mod(x0.astype(jnp.int32) + 1, w) + xoff
    y0i = jnp.mod(y0.astype(jnp.int32), h)
    y1i = jnp.mod(y0.astype(jnp.int32) + 1, h)
    c00 = _gather_texel(tex_flat, k, y0i, x0i, th, tw2)
    c10 = _gather_texel(tex_flat, k, y0i, x1i, th, tw2)
    c01 = _gather_texel(tex_flat, k, y1i, x0i, th, tw2)
    c11 = _gather_texel(tex_flat, k, y1i, x1i, th, tw2)
    return (
        c00 * (1 - ax) * (1 - ay)
        + c10 * ax * (1 - ay)
        + c01 * (1 - ax) * ay
        + c11 * ax * ay
    )


def sample_texture_lod(atlas, level_size, level_off, n_levels, tex_idx, uv, lod):
    """Trilinear mip sample (the GL_LINEAR_MIPMAP_LINEAR the reference's
    sampler requests, hello_vulkan.cpp:489-499). tex_idx (N,) (-1 => white),
    uv (N,2), lod (N,) continuous level-of-detail. Returns (N,4)."""
    k_all, th, tw2, _ = atlas.shape
    tex_flat = atlas.reshape(k_all * th * tw2, 4)
    k = jnp.maximum(tex_idx, 0)
    max_l = (jnp.take(n_levels, k) - 1).astype(jnp.float32)
    lod_c = jnp.clip(lod, 0.0, max_l)
    l0 = jnp.floor(lod_c).astype(jnp.int32)
    l1 = jnp.minimum(l0 + 1, max_l.astype(jnp.int32))
    frac = (lod_c - l0.astype(jnp.float32))[:, None]

    def level(li):
        sz = level_size[k, li]
        off = level_off[k, li]
        return _bilinear_at_level(tex_flat, k, th, tw2, uv, sz[:, 0], sz[:, 1], off)

    c = level(l0) * (1 - frac) + level(l1) * frac
    return jnp.where((tex_idx >= 0)[:, None], c, 1.0)


MAX_ANISO = 4.0  # the reference sampler's maxAnisotropy (hello_vulkan.cpp:452-454)


def aniso_minor_lod(level_size, tex_idx, ddx_uv, ddy_uv):
    """The MINOR-footprint-axis mip level (clamped so major/minor never
    exceeds MAX_ANISO) — the LOD the aniso taps sample at. Useful alone
    for data textures that skip the tap fan."""
    k = jnp.maximum(tex_idx, 0)
    sz0 = level_size[k, 0].astype(jnp.float32)  # (N,2) level-0 (w,h)
    px = jnp.sqrt(jnp.sum((ddx_uv * sz0) ** 2, axis=-1))
    py = jnp.sqrt(jnp.sum((ddy_uv * sz0) ** 2, axis=-1))
    pmax = jnp.maximum(px, py)
    pmin = jnp.minimum(px, py)
    pmin_eff = jnp.maximum(jnp.maximum(pmin, pmax / MAX_ANISO), 1e-9)
    return jnp.log2(pmin_eff)


def sample_texture_aniso(
    atlas, level_size, level_off, n_levels, tex_idx, uv, ddx_uv, ddy_uv,
    taps=None,
):
    """4x anisotropic trilinear sample from screen-space UV derivatives.

    The analog of the reference's anisotropyEnable/maxAnisotropy=4 sampler
    (hello_vulkan.cpp:452-454), GL-style: the LOD comes from the MINOR
    footprint axis (clamped so the ratio never exceeds MAX_ANISO) and four
    taps march along the MAJOR axis to cover the rest of the footprint.
    ``ddx_uv``/``ddy_uv``: (N,2) UV change per pixel step. At isotropic
    footprints the taps collapse inside one texel and this degrades to
    plain trilinear.
    """
    k = jnp.maximum(tex_idx, 0)
    sz0 = level_size[k, 0].astype(jnp.float32)  # (N,2) level-0 (w,h)
    px = jnp.sqrt(jnp.sum((ddx_uv * sz0) ** 2, axis=-1))
    py = jnp.sqrt(jnp.sum((ddy_uv * sz0) ** 2, axis=-1))
    pmax = jnp.maximum(px, py)
    pmin = jnp.minimum(px, py)
    pmin_eff = jnp.maximum(jnp.maximum(pmin, pmax / MAX_ANISO), 1e-9)
    lod = jnp.log2(pmin_eff)
    major = jnp.where((px >= py)[:, None], ddx_uv, ddy_uv)
    if taps is None:
        taps = ANISO_TAPS
    offsets = {2: (-0.25, 0.25), 4: (-0.375, -0.125, 0.125, 0.375)}[taps]
    acc = 0.0
    for s in offsets:
        acc = acc + sample_texture_lod(
            atlas, level_size, level_off, n_levels, tex_idx,
            uv + major * s, lod,
        )
    return acc / len(offsets)


def build_mip_pyramid(image: np.ndarray):
    """Full mip chain by 2x2 box filter (cmdGenerateMipmaps equivalent,
    hello_vulkan.cpp:499). Host-side numpy; returns list level0..levelN."""
    levels = [np.asarray(image, np.float32)]
    cur = levels[0]
    while max(cur.shape[0], cur.shape[1]) > 1:
        nxt = cur
        if nxt.shape[0] > 1:
            h = nxt.shape[0] // 2
            nxt = 0.5 * (nxt[0 : 2 * h : 2] + nxt[1 : 2 * h : 2])
        if nxt.shape[1] > 1:
            w = nxt.shape[1] // 2
            nxt = 0.5 * (nxt[:, 0 : 2 * w : 2] + nxt[:, 1 : 2 * w : 2])
        levels.append(nxt.astype(np.float32))
        cur = nxt
    return levels
