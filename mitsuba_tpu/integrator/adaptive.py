"""Adaptive sampling: per-pixel t-test driven sample allocation.

Counterpart of the reference `adaptive` meta-integrator (ref:
src/integrators/misc/adaptive.cpp): it keeps drawing sample batches per
pixel until the Student-t confidence interval of the pixel mean shrinks
below maxError·mean (quality/pValue properties), delegating actual
radiance estimation to a nested integrator.

Wavefront redesign: per-pixel *dynamic* sample counts are hostile to
fixed-shape compilation, so each outer pass keeps a CONSTANT wavefront of
H·W lanes and re-aims them: converged pixels give up their lanes, which
are redistributed round-robin over the unconverged set (an argsort by
converged-flag + modular assignment — the wavefront analog of the
reference's per-pixel while loop). Per-pixel Welford statistics (count,
mean, M2 of luminance) live in accumulators; every (pixel, k-th repeat)
lane derives a unique RNG sample index from the running per-pixel count,
so the sample stream stays replayable.

The stopping rule matches adaptive.cpp: stddev·t / sqrt(n) < maxError ·
mean, with the normal-quantile approximation for the t value (the
reference tabulates it; batches are ≥ 16 samples so the normal quantile
is within a few % of Student-t).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core import rng
from ..film.film import Film
from ..integrator.common import DIM_PIXEL
from ..scene.scene import SceneData

# two-sided normal quantiles for common p-values (adaptive.cpp defaults
# quality=0.05 ⇒ 95% confidence)
_QUANTILES = {0.2: 1.2816, 0.1: 1.6449, 0.05: 1.9600, 0.01: 2.5758}


@dataclass(frozen=True)
class AdaptiveSampler:
    """maxError / pValue / maxSampleFactor per adaptive.cpp properties.
    `child` is the nested radiance estimator (the reference wraps any
    SamplingIntegrator the same way)."""
    max_error: float = 0.05
    p_value: float = 0.05
    batch_spp: int = 16
    max_passes: int = 8         # ⇒ max spp = batch_spp · max_passes
    child: object = None        # nested integrator (default: PathTracer)

    def render(self, scene: SceneData, camera, film: Film, integrator,
               seed: int = 0):
        return _render_adaptive(scene, camera, film, integrator, self,
                                seed)

    def render_full(self, scene: SceneData, camera, film: Film,
                    spp: int, seed: int = 0):
        """Uniform-API entry (CLI): spp = max samples per pixel."""
        import dataclasses

        from .path import PathTracer
        child = self.child if self.child is not None else PathTracer()
        if hasattr(child, "specialized_for"):
            child = child.specialized_for(scene)
        cfg = dataclasses.replace(
            self, max_passes=max(1, spp // self.batch_spp), child=None)
        return _render_adaptive(scene, camera, film, child, cfg, seed)

    def render_with_counts(self, scene, camera, film, integrator,
                           seed: int = 0):
        """Also returns the per-pixel sample-count map (diagnostics — the
        analog of the reference's per-block sample statistics)."""
        return _render_adaptive_impl(scene, camera, film, integrator,
                                     self, seed)


@partial(jax.jit, static_argnames=("camera", "film", "integrator", "cfg"))
def _render_adaptive(scene, camera, film, integrator, cfg, seed):
    return _render_adaptive_impl(scene, camera, film, integrator, cfg,
                                 seed)[0]


def _render_adaptive_impl(scene, camera, film, integrator,
                          cfg: AdaptiveSampler, seed):
    h, w = film.height, film.width
    n = h * w
    lane = jnp.arange(n, dtype=jnp.uint32)
    quantile = _QUANTILES.get(cfg.p_value, 1.96)
    seed = jnp.asarray(seed, jnp.uint32)

    # per-pixel accumulators: rgb sum, luminance count/mean/M2 (Welford)
    state0 = (jnp.zeros((n, 3)),            # rgb sum
              jnp.zeros((n,)),              # count
              jnp.zeros((n,)),              # lum mean
              jnp.zeros((n,)))              # lum M2

    def converged(count, mean, m2):
        var = m2 / jnp.maximum(count - 1.0, 1.0)
        stderr = jnp.sqrt(var / jnp.maximum(count, 1.0)) * quantile
        ok = stderr <= cfg.max_error * jnp.maximum(mean, 1e-4)
        return ok & (count >= 2 * cfg.batch_spp)   # ≥2 batches like ref

    def one_pass(p, state):
        rgb, count, mean, m2 = state
        conv = converged(count, mean, m2)
        n_unconv = jnp.maximum(jnp.sum((~conv).astype(jnp.int32)), 1)
        # unconverged pixels first; lanes round-robin over them
        order = jnp.argsort(conv.astype(jnp.int32), stable=True)
        pix = order[(lane % n_unconv.astype(jnp.uint32)).astype(jnp.int32)]
        pix = pix.astype(jnp.uint32)
        repeat = (lane // n_unconv.astype(jnp.uint32)).astype(jnp.uint32)
        samp = count[pix].astype(jnp.uint32) + repeat

        def body(k, carry):
            rgb, count, mean, m2 = carry
            s = samp * jnp.uint32(cfg.batch_spp) + jnp.uint32(k)
            jitter = rng.sample_2d(seed, pix, DIM_PIXEL, s)
            px_x = (pix % w).astype(jnp.float32) + jitter[..., 0]
            px_y = (pix // w).astype(jnp.float32) + jitter[..., 1]
            pos = jnp.stack([px_x, px_y], axis=-1)
            o, d = camera.sample_ray(pos)
            L = integrator.li(scene, o, d, seed, pix, s)
            lum = (0.212671 * L[..., 0] + 0.715160 * L[..., 1]
                   + 0.072169 * L[..., 2])
            rgb = rgb.at[pix].add(L)
            count = count.at[pix].add(1.0)
            # batched Welford via scatter: do it with the standard
            # sum/sumsq identity instead (order-independent)
            mean_ = mean.at[pix].add(lum)      # temporarily holds Σlum
            m2_ = m2.at[pix].add(lum * lum)    # temporarily holds Σlum²
            return rgb, count, mean_, m2_

        # accumulate Σ, Σ² then convert back to (mean, M2) representation
        sum_l = mean * count + 0.0
        sum_l2 = m2 + count * mean * mean
        rgb, count2, sum_l, sum_l2 = jax.lax.fori_loop(
            0, cfg.batch_spp, body, (rgb, count, sum_l, sum_l2))
        mean2 = sum_l / jnp.maximum(count2, 1.0)
        m2n = jnp.maximum(sum_l2 - count2 * mean2 * mean2, 0.0)
        return rgb, count2, mean2, m2n

    state = jax.lax.fori_loop(0, cfg.max_passes, one_pass, state0)
    rgb, count, mean, m2 = state
    img = (rgb / jnp.maximum(count, 1.0)[..., None]).reshape(h, w, 3)
    return img, count.reshape(h, w)
