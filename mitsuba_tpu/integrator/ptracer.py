"""Adjoint particle tracer: light paths splatted through the sensor.

Counterpart of the reference `ptracer` plugin (ref: src/integrators/
ptracer/{ptracer.cpp,ptracer_proc.cpp} over the ParticleTracer infra,
render/particleproc.h:128): particles start on emitters carrying power
throughput, random-walk through the scene, and every vertex connects to the
camera through a visibility ray; contributions splat to the projected
pixel. Wavefront shape: one wavefront of N particles, `lax.scan` over bounces,
camera connections as batched projections (sensor.project) + shadow traces,
film accumulation via scatter-add.

Radiometry: with W = 1/(A·cos³θ) (sensor.project), a vertex with power
throughput α and incoming direction wi splats α·f(wi→ω_cam)·W/d² — and the
image is the splat sum × n_pixels / N_particles, which reproduces the same
radiance estimate as the eye-path tracer (validated statistically in
tests/test_ptracer.py).
"""
from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

from ..bsdf.bsdf import (eval_bsdf_ex, perturb_shading_frame,
                         resolve_material, sample_bsdf_ex)
from ..core import rng
from ..core.math import SHADOW_EPSILON, Frame, dot, normalize
from ..core.warp import square_to_cosine_hemisphere
from ..emitter.emitter import sample_direct  # noqa: F401 (api surface)
from ..scene.scene import EM_AREA, SceneData
from .common import (DIM_BSDF_U1, DIM_BSDF_U2, DIM_NEE_POS, DIM_NEE_SEL,
                     DIM_RR, bounce_dim, offset_ray_origin, ray_mint)
from .path import PathTracer


@dataclass(frozen=True)
class ParticleTracer(PathTracer):
    """Light tracer config (maxDepth/rrDepth semantics as the reference)."""

    def render(self, scene: SceneData, camera, n_particles: int,
               seed: int = 0):
        """Returns the [H, W, 3] light-traced image."""
        n = n_particles
        pid = jnp.arange(n, dtype=jnp.uint32)
        seed = jnp.uint32(seed)
        h, w = camera.height, camera.width
        n_pix = h * w
        cam_pos = camera.position

        accum0 = jnp.zeros((h, w, 3))

        def splat(accum, p, value, enabled):
            raster, visible, imp = camera.project(p)
            to_cam = cam_pos - p
            d2 = jnp.maximum(jnp.sum(to_cam * to_cam, axis=-1), 1e-12)
            dc = to_cam * jax.lax.rsqrt(d2)[..., None]
            # camera visibility ray
            so = p + dc * 1e-4 * (
                1.0 + jnp.max(jnp.abs(p), axis=-1))[..., None]
            dist = jnp.sqrt(d2)
            occ = self._occluded(scene, so, dc, ray_mint(so),
                                 dist * (1.0 - SHADOW_EPSILON))
            ok = enabled & visible & ~occ
            contrib = value * (imp / d2)[..., None]
            contrib = jnp.where(ok[..., None], contrib, 0.0)
            ix = jnp.clip(raster[..., 0].astype(jnp.int32), 0, w - 1)
            iy = jnp.clip(raster[..., 1].astype(jnp.int32), 0, h - 1)
            return accum.at[iy, ix].add(contrib), dc

        # ---- emitter start vertex (area emitters) ----------------------
        u_sel = rng.sample_1d(seed, pid, bounce_dim(0, DIM_NEE_SEL))
        u_pos = rng.sample_2d(seed, pid, bounce_dim(0, DIM_NEE_POS))
        em_id, u_re, em_pmf = scene.em_pmf.sample_reuse(u_sel)
        is_area = scene.em_type[em_id] == EM_AREA
        # triangle pick (globalized cdf, as emitter.sample_direct)
        key = em_id.astype(jnp.float32) + jnp.clip(u_re, 0.0, 1.0 - 1e-7)
        hi = jnp.clip(jnp.searchsorted(scene.em_tri_cdfg, key, "right"),
                      0, max(scene.em_tris.shape[0] - 1, 0))
        row = scene.em_tri_data[hi]
        sq = jnp.sqrt(jnp.maximum(1.0 - u_pos[..., 0], 0.0))
        b0 = 1.0 - sq
        b1 = u_pos[..., 1] * sq
        p0 = (row[..., 0:3] + b0[..., None] * row[..., 3:6]
              + b1[..., None] * row[..., 6:9])
        n_l = row[..., 9:12]
        le = scene.em_radiance[em_id]
        area = scene.em_area[em_id]
        alpha_pos = le * (area / jnp.maximum(em_pmf, 1e-12))[..., None]
        alpha_pos = jnp.where(is_area[..., None], alpha_pos, 0.0)

        # emitter vertex → camera (directly visible light): with the
        # position density pmf/A, E[α_pos·cosθ_l·W/d²]·n_pix = Le exactly
        # for pixels covering the emitter (one-sided)
        cos_l0 = jnp.maximum(dot(normalize(cam_pos - p0), n_l), 0.0)
        accum, _ = splat(accum0, p0, alpha_pos * cos_l0[..., None],
                         is_area)

        # ---- emission direction (cosine-weighted, area.cpp sampleRay) --
        u_dir = rng.sample_2d(seed, pid, bounce_dim(0, DIM_BSDF_U2))
        frame_l = Frame.from_normal(n_l)
        d0 = Frame.to_world(frame_l, square_to_cosine_hemisphere(u_dir))
        alpha = alpha_pos * jnp.pi     # Le·π·A/pmf
        o0 = offset_ray_origin(p0, n_l, d0)
        active0 = is_area

        def bounce_body(carry, bounce):
            o, d, alpha, active, accum = carry
            its = self._intersect(scene, o, d, ray_mint(o))
            hit = active & its.valid

            mat = resolve_material(scene, its.mat_id, its.uv,
                                   self.families)
            frame = Frame.from_normal(its.ns)
            frame = perturb_shading_frame(scene, mat, frame, its.uv)
            wi_local = Frame.to_local(frame, -d)

            # connect to camera
            to_cam = normalize(cam_pos - its.p)
            wc_local = Frame.to_local(frame, to_cam)
            f_cam = eval_bsdf_ex(mat, wi_local, wc_local, self.families)
            accum, _ = splat(accum, its.p, alpha * f_cam, hit)

            # continue the walk
            u2 = rng.sample_2d(seed, pid, bounce_dim(bounce + 1,
                                                     DIM_BSDF_U2))
            u1 = rng.sample_1d(seed, pid, bounce_dim(bounce + 1,
                                                     DIM_BSDF_U1))
            bs = sample_bsdf_ex(mat, wi_local, u2, u1, self.families)
            d_next = Frame.to_world(frame, bs.wo)
            o_next = offset_ray_origin(its.p, its.ng, d_next)
            alpha_next = alpha * bs.weight
            alive = hit & (bs.pdf > 0) & jnp.any(alpha_next > 0, axis=-1)
            depth = bounce + 2
            if self.max_depth > 0:
                alive = alive & (depth <= self.max_depth)
            u_rr = rng.sample_1d(seed, pid, bounce_dim(bounce + 1, DIM_RR))
            q = jnp.minimum(jnp.max(alpha_next, axis=-1)
                            / jnp.maximum(jnp.max(alpha, axis=-1), 1e-12),
                            0.95)
            do_rr = depth >= self.rr_depth
            rr_cont = ~do_rr | (u_rr < q)
            alpha_next = jnp.where((do_rr & rr_cont)[..., None],
                                   alpha_next
                                   / jnp.maximum(q, 1e-6)[..., None],
                                   alpha_next)
            alive = alive & rr_cont
            return ((o_next, jnp.where(alive[..., None], d_next, d),
                     jnp.where(alive[..., None], alpha_next, 0.0),
                     alive, accum), None)

        n_bounces = (self.max_depth - 1) if self.max_depth > 0 else 16
        (o_, d_, a_, act_, accum), _ = jax.lax.scan(
            bounce_body, (o0, d0, alpha, active0, accum),
            jnp.arange(max(n_bounces, 1)))
        return accum * (n_pix / n)
