"""Irradiance caching (Ward/Křivánek-style) for diffuse indirect light.

Counterpart of the reference `irrcache` meta-integrator (ref:
src/integrators/misc/irrcache_proc.cpp + librender irrcache.cpp:388,
irrcache.h:44-148): hemispherical indirect irradiance is computed at a
sparse set of surface records and interpolated elsewhere with Ward's
weight w_i = 1/(‖x−x_i‖/R_i + √(1−n·n_i)), where R_i is the harmonic
mean hit distance of record i's hemisphere rays.

Wavefront redesign: the reference fills an octree lazily per pixel
(data-dependent insertion — hostile to fixed-shape compilation); here the
records are placed up front by area-weighted surface sampling (the same
trade the dipole preprocess makes vs irrproc.cpp) and the interpolation
is a dense [N_pixels, K_records] weight matrix — a matmul contraction, no
pointer tree. Hemisphere sampling per record mirrors irrcache.h's
HemisphereSampler (cosine-weighted, one bounce of path radiance).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import rng
from ..core.math import Frame, dot, matmul
from ..core.warp import square_to_cosine_hemisphere
from ..scene.scene import SceneData
from .common import DIM_PIXEL, offset_ray_origin, ray_mint
from .path import PathTracer

_DIM_IC = 1 << 26


class IrrCache(NamedTuple):
    p: jax.Array        # [K, 3] record positions
    n: jax.Array        # [K, 3] normals
    e: jax.Array        # [K, 3] indirect irradiance
    r: jax.Array        # [K] harmonic-mean distance (validity radius)
    valid: jax.Array    # [K]


@dataclass(frozen=True)
class IrrCacheIntegrator(PathTracer):
    """quality/resolution knobs per irrcache.cpp properties; `records`
    plays the role the octree's adaptive density plays there."""
    records: int = 512
    hemi_samples: int = 64        # rays per record (ref: resolution²·π/2)
    indirect_depth: int = 3       # bounces gathered into the cache

    # ------------------------------------------------------------------

    def build_cache(self, scene: SceneData, seed: int = 0) -> IrrCache:
        k = self.records
        kid = jnp.arange(k, dtype=jnp.uint32)
        seed = jnp.asarray(seed, jnp.uint32)

        # place records on diffuse geometry (area-weighted)
        area = jnp.where(scene.tri_area > 0, scene.tri_area, 0.0)
        cdf = jnp.cumsum(area)
        total = jnp.maximum(cdf[-1], 1e-12)
        u = rng.sample_1d(seed, kid, _DIM_IC)
        tri = jnp.clip(jnp.searchsorted(cdf, u * total, "right"),
                       0, scene.p0.shape[0] - 1)
        u2 = rng.sample_2d(seed, kid, _DIM_IC + 1)
        sq = jnp.sqrt(jnp.maximum(1.0 - u2[..., 0], 0.0))
        p = (scene.p0[tri] + (1.0 - sq)[..., None] * scene.e1[tri]
             + (u2[..., 1] * sq)[..., None] * scene.e2[tri])
        n = scene.ng[tri]
        frame = Frame.from_normal(n)

        # hemisphere gather: cosine-weighted rays, one PT estimate each;
        # E = π · mean(L) (cosine pdf folds the cosine);
        # harmonic mean distance from the first-hit t's (irrcache.h:148)
        inner = PathTracer(max_depth=self.indirect_depth,
                           rr_depth=10 ** 6,
                           cluster_size=self.cluster_size,
                           families=self.families,
                           hide_emitters=False)

        def one(s, carry):
            e, inv_d = carry
            ud = rng.sample_2d(seed, kid, _DIM_IC + 2, s)
            d = Frame.to_world(frame, square_to_cosine_hemisphere(ud))
            o = offset_ray_origin(p, n, d)
            its = self._intersect(scene, o, d, ray_mint(o))
            # indirect only: radiance re-entering from the first hit
            li = inner.li(scene, o, d, seed + jnp.uint32(77), kid,
                          s + jnp.uint32(1) * 0)
            # subtract nothing — record stores FULL hemispherical
            # radiance minus the directly-visible-emitter term, which
            # the render-time direct lighting already covers:
            from ..emitter.emitter import eval_area, eval_env
            le_hit = jnp.where(
                its.valid[..., None],
                eval_area(scene, its.em_id, -dot(d, its.ng)),
                eval_env(scene, d))
            e = e + jnp.maximum(li - le_hit, 0.0)
            t_safe = jnp.where(its.valid, its.t, 1e30)
            return e, inv_d + 1.0 / jnp.maximum(t_safe, 1e-6)

        e, inv_d = jax.lax.fori_loop(
            0, self.hemi_samples, one,
            (jnp.zeros((k, 3)), jnp.zeros((k,))))
        e = e * (np.pi / self.hemi_samples)
        r = self.hemi_samples / jnp.maximum(inv_d, 1e-6)
        # clamp validity radii like the reference (irrcache.cpp:200)
        scene_scale = jnp.max(jnp.where((scene.tri_area > 0)[:, None],
                                        jnp.abs(scene.p0), 0.0))
        r = jnp.clip(r, 1e-3 * scene_scale, 0.5 * scene_scale)
        return IrrCache(p, n, e, r, area[tri] > 0)

    # ------------------------------------------------------------------

    def interpolate(self, cache: IrrCache, x, n):
        """Ward-weighted irradiance estimate at (x, n): [N, 3]."""
        d2 = (jnp.sum(x * x, -1, keepdims=True)
              + jnp.sum(cache.p * cache.p, -1)[None, :]
              - 2.0 * matmul(x, cache.p.T))
        dist = jnp.sqrt(jnp.maximum(d2, 0.0))
        ndot = jnp.clip(matmul(n, cache.n.T), -1.0, 1.0)
        w = 1.0 / (dist / cache.r[None, :]
                   + jnp.sqrt(jnp.maximum(1.0 - ndot, 0.0)) + 1e-4)
        # records only count within their validity domain (w > 1/κ with
        # κ=0.5 quality, and same-side normals) — irrcache.h:110
        ok = (w > 2.0) & (ndot > 0.1) & cache.valid[None, :]
        w = jnp.where(ok, w, 0.0)
        wsum = jnp.sum(w, axis=-1, keepdims=True)
        est = matmul(w, cache.e) / jnp.maximum(wsum, 1e-9)
        have = wsum[..., 0] > 0
        return est, have

    def li_with_cache(self, scene, cache, o, d, seed, pixel_id,
                      sample_idx=0):
        from ..bsdf.bsdf import resolve_material
        from .direct import DirectIntegrator
        di = DirectIntegrator(cluster_size=self.cluster_size,
                              families=self.families)
        L = di.li(scene, o, d, seed, pixel_id, sample_idx)
        its = self._intersect(scene, o, d, ray_mint(o))
        mat = resolve_material(scene, its.mat_id, its.uv, self.families)
        from ..scene.scene import MAT_DIFFUSE, MAT_ROUGH_DIFFUSE
        diffuse_like = ((its.mat_id >= 0)
                        & ((scene.mat_type[jnp.maximum(its.mat_id, 0)]
                            == MAT_DIFFUSE)
                           | (scene.mat_type[jnp.maximum(its.mat_id, 0)]
                              == MAT_ROUGH_DIFFUSE)))
        est, have = self.interpolate(cache, its.p, its.ns)
        albedo = mat.params[..., 0:3]
        indirect = albedo * est / np.pi    # Lo = (ρ/π)·E
        sel = its.valid & diffuse_like & have
        return L + jnp.where(sel[..., None], indirect, 0.0)

    def li(self, scene, o, d, seed, pixel_id, sample_idx=0):
        cache = self.build_cache(scene, seed)
        return self.li_with_cache(scene, cache, o, d, seed, pixel_id,
                                  sample_idx)

    def render(self, scene: SceneData, camera, film, spp: int = 4,
               seed: int = 0):
        return _render_irrcache(scene, camera, film, self, spp, seed)


@partial(jax.jit, static_argnames=("camera", "film", "integ", "spp"))
def _render_irrcache(scene, camera, film, integ, spp, seed):
    cache = integ.build_cache(scene, seed)
    h, w = film.height, film.width
    npix = h * w
    px = jnp.arange(npix, dtype=jnp.uint32)
    pix_x = (px % w).astype(jnp.float32)
    pix_y = (px // w).astype(jnp.float32)

    def sample_pass(s, accum):
        s = jnp.uint32(s)
        jitter = rng.sample_2d(seed, px, DIM_PIXEL, s)
        pos = jnp.stack([pix_x + jitter[..., 0],
                         pix_y + jitter[..., 1]], axis=-1)
        o, d = camera.sample_ray(pos)
        radiance = integ.li_with_cache(scene, cache, o, d,
                                       jnp.uint32(seed), px, s)
        return film.splat(accum, pos, radiance)

    accum = jax.lax.fori_loop(0, spp, sample_pass,
                              film.new_accumulator())
    return film.develop(accum)
