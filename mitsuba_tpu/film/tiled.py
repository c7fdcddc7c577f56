"""Tiled out-of-core film: render + develop in bounded-memory tiles.

Counterpart of the reference's `tiledhdrfilm` (ref: src/films/
tiledhdrfilm.cpp — a tiled OpenEXR written incrementally so huge films
never materialise in RAM). Wavefront redesign: tiles are crop-window
wavefronts (the camera's pixel_xy interface makes a crop a simple index
range); each tile renders to completion and is flushed straight into a
memory-mapped float32 output, so host memory stays O(tile²) regardless
of film size. The memmap is written as a .npy (loadable with
np.load(mmap_mode=...)) or converted to EXR at the end when it fits.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..core import rng
from ..integrator.common import DIM_PIXEL
from .film import Film


def render_tiled(scene, camera, integrator, spp: int, out_path: str,
                 width: int | None = None, height: int | None = None,
                 tile: int = 256, seed: int = 0, progress=None):
    """Render in `tile`×`tile` crops, streaming each finished tile into a
    memory-mapped npy at out_path. Returns the memmap (flushed).

    camera must expose .width/.height/.sample_ray (all sensors here do);
    `integrator.li` is used directly, one wavefront per tile per sample
    pass — identical RNG streams to the monolithic renderer, so the
    tiled image is bit-identical to Film-based rendering with a box
    filter.
    """
    w = width or camera.width
    h = height or camera.height
    out = np.lib.format.open_memmap(out_path, mode="w+",
                                    dtype=np.float32, shape=(h, w, 3))
    n_tx = -(-w // tile)
    n_ty = -(-h // tile)
    for ty in range(n_ty):
        for tx in range(n_tx):
            x0, y0 = tx * tile, ty * tile
            tw = min(tile, w - x0)
            th = min(tile, h - y0)
            xs = jnp.arange(tw, dtype=jnp.uint32)
            ys = jnp.arange(th, dtype=jnp.uint32)
            gx, gy = jnp.meshgrid(xs, ys, indexing="xy")
            pix = ((gy + y0) * w + (gx + x0)).reshape(-1)
            acc = jnp.zeros((th * tw, 3))
            for s in range(spp):
                su = jnp.uint32(s)
                jitter = rng.sample_2d(seed, pix, DIM_PIXEL, su)
                pos = jnp.stack(
                    [(pix % w).astype(jnp.float32) + jitter[..., 0],
                     (pix // w).astype(jnp.float32) + jitter[..., 1]],
                    axis=-1)
                o, d = camera.sample_ray(pos)
                acc = acc + integrator.li(scene, o, d, jnp.uint32(seed),
                                          pix, su)
            out[y0:y0 + th, x0:x0 + tw] = np.asarray(
                acc / spp).reshape(th, tw, 3)
            if progress is not None:
                progress(ty * n_tx + tx + 1, n_tx * n_ty)
    out.flush()
    return out
