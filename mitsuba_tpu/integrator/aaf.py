"""Axis-aligned filtering for soft shadows (winmad research integrator).

Counterpart of the fork's `aaf` plugin (ref: src/integrators/aaf/aaf.cpp
— Mehta et al. 2012 "Axis-Aligned Filtering for Interactive Sampled Soft
Shadows"): render direct illumination at low spp while recording, per
pixel, the min/max ratio d2/d1 of occluder distance (d2) to light
distance (d1); frequency analysis turns those into per-pixel screen-space
Gaussian filter widths (β ∝ s2/(1+s2) of the occlusion spectrum) and an
adaptive spp estimate; a cross-pixel blur with the derived widths removes
the residual shadow noise without blurring shadow edges.

Wavefront shape: the sampling pass is the ordinary direct-illumination
wavefront with two extra per-lane reductions (min/max occluder ratios
via masked scatter-min/max); the reconstruction pass is a separable
variable-width Gaussian evaluated as a fixed K-tap window (shape-static;
the reference's CUDA prototype does the same with a clamped radius).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core import rng
from ..core.math import SHADOW_EPSILON, Frame, dot
from ..emitter.emitter import sample_direct
from ..film.film import Film
from ..scene.scene import SceneData
from .common import (DIM_NEE_POS, DIM_NEE_SEL, DIM_PIXEL,
                     offset_ray_origin, ray_mint)
from .path import PathTracer


@dataclass(frozen=True)
class AAFIntegrator(PathTracer):
    """Properties mirror aaf.cpp: light_sigma (light size surrogate),
    max_filter_px, taps of the reconstruction window."""
    light_sigma: float = 0.1
    max_filter_px: int = 8

    def render(self, scene: SceneData, camera, film: Film, spp: int = 4,
               seed: int = 0):
        return _render_aaf(scene, camera, film, self, spp, seed)


@partial(jax.jit, static_argnames=("camera", "film", "integ", "spp"))
def _render_aaf(scene, camera, film, integ: AAFIntegrator, spp, seed):
    from ..bsdf.bsdf import eval_bsdf_ex, resolve_material
    from ..emitter.emitter import eval_area, eval_env

    h, w = film.height, film.width
    n = h * w
    px = jnp.arange(n, dtype=jnp.uint32)
    pix_x = (px % w).astype(jnp.float32)
    pix_y = (px // w).astype(jnp.float32)

    def one_pass(s, carry):
        unocc, shad, d2d1_min, d2d1_max, nsh = carry
        s = jnp.uint32(s)
        jitter = rng.sample_2d(seed, px, DIM_PIXEL, s)
        pos = jnp.stack([pix_x + jitter[..., 0],
                         pix_y + jitter[..., 1]], axis=-1)
        o, d = camera.sample_ray(pos)
        its = integ._intersect(scene, o, d, ray_mint(o))
        hit = its.valid
        cos_surf = -dot(d, its.ng)
        le = eval_area(scene, its.em_id, cos_surf)
        base = jnp.where(hit[..., None], le, eval_env(scene, d))

        mat = resolve_material(scene, its.mat_id, its.uv, integ.families)
        frame = Frame.from_normal(its.ns)
        wi_local = Frame.to_local(frame, -d)
        u_sel = rng.sample_1d(seed, px, DIM_NEE_SEL + 4, s)
        u_pos = rng.sample_2d(seed, px, DIM_NEE_POS + 4, s)
        ds = sample_direct(scene, its.p, u_sel, u_pos)
        f = eval_bsdf_ex(mat, wi_local, Frame.to_local(frame, ds.d),
                         integ.families)
        so = offset_ray_origin(its.p, its.ng, ds.d)
        # occluder DISTANCE, not just a bool — the AAF frequency bound
        its_sh = integ._intersect(scene, so, ds.d, ray_mint(so))
        occ = its_sh.valid & (its_sh.t < ds.dist * (1.0 - SHADOW_EPSILON))
        d1 = jnp.maximum(ds.dist, 1e-6)
        ratio = jnp.clip(d1 / jnp.maximum(its_sh.t, 1e-6), 1.0, 20.0)
        ok = hit & (ds.pdf > 0)
        # ds.value already folds the 1/pdf (emitter.sample_direct)
        contrib = jnp.where(ok[..., None], f * ds.value, 0.0)
        # unoccluded shading (no visibility), shadow factor separately —
        # aaf.cpp filters the VISIBILITY channel only
        unocc = unocc + base + contrib
        vis = jnp.where(ok & ~occ, 1.0, jnp.where(ok, 0.0, 1.0))
        shad = shad + vis
        rec = ok & occ
        d2d1_min = jnp.minimum(d2d1_min, jnp.where(rec, ratio, 1e9))
        d2d1_max = jnp.maximum(d2d1_max, jnp.where(rec, ratio, 0.0))
        nsh = nsh + rec.astype(jnp.float32)
        return unocc, shad, d2d1_min, d2d1_max, nsh

    init = (jnp.zeros((n, 3)), jnp.zeros((n,)),
            jnp.full((n,), 1e9), jnp.zeros((n,)), jnp.zeros((n,)))
    unocc, shad, r_min, r_max, nsh = jax.lax.fori_loop(0, spp, one_pass,
                                                       init)
    unocc = (unocc / spp).reshape(h, w, 3)
    vis = (shad / spp).reshape(h, w)

    # ---- per-pixel filter width (Mehta et al. eq. 13-ish) --------------
    # s2 = d2/d1 spread: fully unoccluded pixels get no blur; penumbrae
    # get β ∝ light_sigma · (s2_max/(s2_max − 1)) clamped to max_filter_px
    has_occ = (nsh > 0).reshape(h, w)
    s2 = jnp.where(nsh > 0, r_max, 1.0).reshape(h, w)
    beta = integ.light_sigma * s2 / jnp.maximum(s2 - 1.0, 1e-2)
    beta_px = jnp.clip(beta * w * 0.05, 0.5, float(integ.max_filter_px))
    beta_px = jnp.where(has_occ, beta_px, 0.5)

    # ---- separable variable-width Gaussian over the visibility channel
    k = integ.max_filter_px

    def blur_axis(img2d, widths, axis):
        acc = jnp.zeros_like(img2d)
        wsum = jnp.zeros_like(img2d)
        for o_ in range(-k, k + 1):
            shifted = jnp.roll(img2d, o_, axis=axis)
            w_ = jnp.exp(-0.5 * (o_ / jnp.maximum(widths, 1e-3)) ** 2)
            acc = acc + shifted * w_
            wsum = wsum + w_
        return acc / jnp.maximum(wsum, 1e-9)

    vis_f = blur_axis(vis, beta_px, 0)
    vis_f = blur_axis(vis_f, beta_px, 1)
    img = unocc * vis_f[..., None]
    return img, vis, vis_f, beta_px
