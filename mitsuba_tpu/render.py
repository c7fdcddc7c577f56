"""Render orchestration: the sampling loop over pixels × spp.

Analog of the reference's RenderJob/BlockedRenderProcess pipeline (ref:
src/librender/renderjob.cpp:25-120, renderproc.cpp:25-160) redesigned as a
wavefront: instead of Hilbert-ordered 32×32 blocks pulled by worker
threads, the whole film is one wavefront of H·W rays; spp is a
`lax.fori_loop` that accumulates filtered splats into the film.
Multi-device sharding wraps this in shard_map (parallel/dist.py) — the
film is tile-sharded, rays follow it.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .core import rng
from .film.film import Film
from .integrator.common import DIM_APERTURE, DIM_PIXEL
from .scene.scene import SceneData


def render_fn(scene: SceneData, camera, film: Film, integrator, spp: int,
              seed: int = 0, stats: bool = False):
    """Render and return the developed [H, W, 3] image.

    Jit-friendly: all shapes static given (camera, film, spp). The sample
    index keys the RNG so any (pixel, sample) pair is reproducible in
    isolation — the foundation of both the CPU-oracle allclose tests and
    path-replay backprop.

    stats=True also returns the integrator's exact `li_stats` ray count
    of every pass: (image, counts [spp] uint32).
    """
    h, w = film.height, film.width
    n = h * w
    px = jnp.arange(n, dtype=jnp.uint32)
    pix_x = (px % w).astype(jnp.float32)
    pix_y = (px // w).astype(jnp.float32)

    def sample_pass(s, carry):
        accum, counts = carry
        s = jnp.uint32(s)
        jitter = integrator._d2(seed, px, s, DIM_PIXEL)
        pos = jnp.stack([pix_x + jitter[..., 0],
                         pix_y + jitter[..., 1]], axis=-1)
        ap = rng.sample_2d(seed, px, DIM_APERTURE, s)
        o, d = camera.sample_ray(pos, ap)
        if stats:
            radiance, n_rays = integrator.li_stats(
                scene, o, d, jnp.uint32(seed), px, s)
            counts = counts.at[s].set(n_rays.astype(jnp.uint32))
        else:
            radiance = integrator.li(scene, o, d, jnp.uint32(seed), px, s)
        return film.splat(accum, pos, radiance), counts

    accum, counts = jax.lax.fori_loop(
        0, spp, sample_pass,
        (film.new_accumulator(), jnp.zeros((spp,), jnp.uint32)))
    if stats:
        return film.develop(accum), counts
    return film.develop(accum)


@partial(jax.jit, static_argnames=("camera", "film", "integrator", "spp",
                                   "stats"))
def _render_jit(scene, camera, film, integrator, spp, seed, stats):
    return render_fn(scene, camera, film, integrator, spp, seed, stats)


def render(scene: SceneData, camera, film: Film, integrator, spp: int,
           seed: int = 0, stats: bool = False):
    """Jitted render_fn. With stats=True returns (image, n_rays) with
    n_rays an exact Python int."""
    out = _render_jit(scene, camera, film, integrator, spp, seed, stats)
    if stats:
        img, counts = out
        return img, int(np.asarray(counts, np.uint64).sum())
    return out
