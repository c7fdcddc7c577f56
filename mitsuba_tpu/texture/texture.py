"""Texture system: bitmap textures with mip pyramids in a flat texel pool.

Counterpart of the reference's Texture2D + TMIPMap (ref: include/mitsuba/
render/texture.h:119, mipmap.h:60-296, src/textures/bitmap.cpp): host-side
compilation builds a box-filtered mip pyramid per texture and packs every
level of every texture into one [TEXELS, 3] pool; a per-(texture, level)
meta table holds (offset, width, height). Device lookups are bilinear at an
explicit LOD (trilinear = two levels + lerp); wrap modes repeat/clamp.

Procedural textures (checkerboard/grid — ref: src/textures/{checkerboard,
gridtexture}.cpp) are rasterized into bitmaps at compile time: on an accelerator a
texel fetch and closed-form evaluation cost the same, and one code path
keeps the wavefront branchless.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

MAX_MIPS = 16
WRAP_REPEAT = 0
WRAP_CLAMP = 1

# tex_meta rows are [NTEX * MAX_MIPS, 4]: offset, width, height, wrap


def build_pyramid(img: np.ndarray) -> list[np.ndarray]:
    """Box-filter mip chain (ref: mipmap.h pyramid construction)."""
    levels = [np.asarray(img, np.float32)]
    while levels[-1].shape[0] > 1 or levels[-1].shape[1] > 1:
        prev = levels[-1]
        h, w = prev.shape[:2]
        nh, nw = max(1, h // 2), max(1, w // 2)
        ph = prev[: nh * 2, : nw * 2]
        down = 0.25 * (ph[0::2, 0::2] + ph[1::2, 0::2]
                       + ph[0::2, 1::2] + ph[1::2, 1::2])
        levels.append(down.astype(np.float32))
    return levels


def pack_textures(images: list[np.ndarray],
                  wraps: list[int] | None = None):
    """→ (tex_data [TEXELS, 3] f32, tex_meta [NTEX*MAX_MIPS, 4] i32)."""
    if not images:
        return (np.zeros((1, 3), np.float32),
                np.zeros((1, 4), np.int32))
    wraps = wraps or [WRAP_REPEAT] * len(images)
    pool, meta = [], np.zeros((len(images) * MAX_MIPS, 4), np.int32)
    offset = 0
    for ti, img in enumerate(images):
        img = np.asarray(img, np.float32)
        if img.ndim == 2:
            img = np.repeat(img[:, :, None], 3, axis=2)
        for li, lvl in enumerate(build_pyramid(img)[:MAX_MIPS]):
            h, w = lvl.shape[:2]
            meta[ti * MAX_MIPS + li] = (offset, w, h, wraps[ti])
            pool.append(lvl.reshape(-1, 3))
            offset += h * w
        # pad missing levels with the last one's meta (clamped lod)
        n_lv = min(len(build_pyramid(img)), MAX_MIPS)
        for li in range(n_lv, MAX_MIPS):
            meta[ti * MAX_MIPS + li] = meta[ti * MAX_MIPS + n_lv - 1]
    return np.concatenate(pool).astype(np.float32), meta


def _wrap(x, n, mode):
    xr = jnp.mod(x, n)
    xc = jnp.clip(x, 0, n - 1)
    return jnp.where(mode == WRAP_REPEAT, xr, xc)


def eval_texture_lod(scene, tex_id, uv, level):
    """Bilinear lookup at integer mip `level` (mipmap.h:296 bilinear path).
    tex_id, level, uv broadcast over the wavefront. v=0 is the bottom of
    the image (OpenGL-style, matching the reference's uv convention)."""
    meta = scene.tex_meta[tex_id * MAX_MIPS + level]      # [N, 4]
    off, w, h, wrap = meta[..., 0], meta[..., 1], meta[..., 2], meta[..., 3]
    fx = uv[..., 0] * w.astype(jnp.float32) - 0.5
    fy = (1.0 - uv[..., 1]) * h.astype(jnp.float32) - 0.5
    x0 = jnp.floor(fx).astype(jnp.int32)
    y0 = jnp.floor(fy).astype(jnp.int32)
    tx = fx - x0
    ty = fy - y0

    def texel(xi, yi):
        xi = _wrap(xi, w, wrap)
        yi = _wrap(yi, h, wrap)
        return scene.tex_data[off + yi * w + xi]

    c00 = texel(x0, y0)
    c10 = texel(x0 + 1, y0)
    c01 = texel(x0, y0 + 1)
    c11 = texel(x0 + 1, y0 + 1)
    top = c00 * (1 - tx)[..., None] + c10 * tx[..., None]
    bot = c01 * (1 - tx)[..., None] + c11 * tx[..., None]
    return top * (1 - ty)[..., None] + bot * ty[..., None]


def eval_texture(scene, tex_id, uv, lod=None):
    """Texture lookup; lod None/0 → finest level, fractional lod →
    trilinear blend of adjacent mips (mipmap.h:60 trilinear)."""
    if lod is None:
        return eval_texture_lod(scene, tex_id, uv, jnp.zeros_like(tex_id))
    l0 = jnp.floor(lod).astype(jnp.int32)
    l0 = jnp.clip(l0, 0, MAX_MIPS - 2)
    frac = jnp.clip(lod - l0.astype(jnp.float32), 0.0, 1.0)
    a = eval_texture_lod(scene, tex_id, uv, l0)
    b = eval_texture_lod(scene, tex_id, uv, l0 + 1)
    return a * (1 - frac)[..., None] + b * frac[..., None]


def checkerboard(color0=(0.4, 0.4, 0.4), color1=(0.2, 0.2, 0.2), res=512,
                 tiles=8) -> np.ndarray:
    """Rasterized checkerboard (ref: src/textures/checkerboard.cpp)."""
    yy, xx = np.meshgrid(np.arange(res), np.arange(res), indexing="ij")
    cell = ((xx * tiles // res) + (yy * tiles // res)) % 2
    img = np.where(cell[..., None] == 0,
                   np.asarray(color0, np.float32),
                   np.asarray(color1, np.float32))
    return img.astype(np.float32)


def grid_texture(color0=(0.2, 0.2, 0.2), color1=(0.4, 0.4, 0.4),
                 res=512, tiles=8, line_width=0.01) -> np.ndarray:
    """Rasterized grid lines (ref: src/textures/gridtexture.cpp)."""
    t = (np.arange(res) + 0.5) / res * tiles
    f = np.abs(t - np.round(t))
    on_x = f < line_width * tiles
    on = on_x[None, :] | on_x[:, None]
    img = np.where(on[..., None], np.asarray(color0, np.float32),
                   np.asarray(color1, np.float32))
    return img.astype(np.float32)


def eval_texture_aniso(scene, tex_id, uv, duv0, duv1, max_aniso=8.0,
                       probes=5):
    """Anisotropic lookup from a screen-space uv footprint — the
    counterpart of TMIPMap's EWA path (ref: mipmap.h:91,296 `evalEWA`).

    duv0/duv1: the footprint's uv derivatives (∂uv/∂x, ∂uv/∂y), [..., 2].

    Wavefront approximation: instead of iterating the texels inside the
    ellipse (a data-dependent loop), the ellipse is integrated with a
    FIXED number of Gaussian-weighted trilinear probes along its major
    axis (footprint assembly, McCormack et al. "Feline", 1999 — the same
    scheme GPU texture units implement). Each probe is an isotropic
    lookup at the LOD of the minor axis; anisotropy is clamped to
    `max_aniso` exactly like the reference's `maxAnisotropy` property.
    """
    meta = scene.tex_meta[tex_id * MAX_MIPS]
    size = jnp.maximum(meta[..., 1], meta[..., 2]).astype(jnp.float32)

    l0 = jnp.sum(duv0 * duv0, axis=-1)
    l1 = jnp.sum(duv1 * duv1, axis=-1)
    major_is_0 = l0 >= l1
    maj2 = jnp.where(major_is_0, l0, l1)
    min2 = jnp.where(major_is_0, l1, l0)
    major = jnp.sqrt(jnp.maximum(maj2, 1e-20))
    minor = jnp.sqrt(jnp.maximum(min2, 1e-20))
    # clamp anisotropy (mipmap.h maxAnisotropy): widen the minor axis
    ratio = major / jnp.maximum(minor, 1e-10)
    minor = jnp.where(ratio > max_aniso, major / max_aniso, minor)

    lod = jnp.log2(jnp.maximum(minor * size, 1e-6))
    lod = jnp.clip(lod, 0.0, MAX_MIPS - 1.0)

    dir_maj = jnp.where(major_is_0[..., None], duv0, duv1)
    dir_maj = dir_maj / jnp.maximum(major, 1e-10)[..., None]

    # Gaussian-weighted probes spanning [-(1 - minor/major), +...]
    span = jnp.maximum(major - minor, 0.0)
    ts = jnp.linspace(-1.0, 1.0, probes)
    ws = jnp.exp(-2.0 * ts ** 2)
    ws = ws / ws.sum()
    out = 0.0
    for i in range(probes):
        uv_i = uv + dir_maj * (0.5 * span * ts[i])[..., None]
        out = out + ws[i] * eval_texture(scene, tex_id, uv_i, lod)
    return out
