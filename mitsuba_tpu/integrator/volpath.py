"""Volumetric path tracer: surfaces + a global homogeneous medium.

Wavefront counterpart of the reference's `volpath` integrator (ref: src/
integrators/path/volpath.cpp:104-181; SURVEY Appendix A.7): per bounce the
wavefront first samples a medium interaction against the surface hit
distance (media/homogeneous.py balance strategy), then each lane takes the
medium branch (phase-function NEE + phase sampling, HG) or the surface
branch (standard path.py shading) — both masked, no divergence. NEE shadow
rays are attenuated by the medium transmittance on top of surface occlusion
(ref: Scene::evalTransmittance / sampleAttenuatedEmitterDirect,
scene.h:558).

With scene.has_medium == False this integrator reproduces PathTracer
exactly (the medium branch is compiled in but fully masked; prefer
PathTracer when no media exist — it's cheaper).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import jax
import jax.numpy as jnp

from ..bsdf.bsdf import (eval_bsdf_ex, pdf_bsdf_ex, perturb_shading_frame,
                         resolve_material, sample_bsdf_ex)
from ..core import rng
from ..core.math import SHADOW_EPSILON, Frame, dot
from ..emitter.emitter import (eval_area, eval_env, pdf_direct_area,
                               pdf_direct_env, sample_direct)
from ..media.homogeneous import sample_distance, transmittance
from ..phase.phase import hg_eval, hg_sample
from ..scene.scene import SceneData
from .common import (DIM_BSDF_U1, DIM_BSDF_U2, DIM_MEDIUM, DIM_NEE_POS,
                     DIM_NEE_SEL, DIM_PHASE, DIM_RR, bounce_dim, mis_power,
                     offset_ray_origin, ray_mint)
from .path import PathTracer


@dataclass(frozen=True)
class VolPathTracer(PathTracer):
    """volpath config; inherits MonteCarloIntegrator-style fields."""

    def li(self, scene: SceneData, o, d, seed, pixel_id, sample_idx=0):
        return self.li_stats(scene, o, d, seed, pixel_id, sample_idx)[0]

    def li_stats(self, scene: SceneData, o, d, seed, pixel_id,
                 sample_idx=0):
        n = o.shape[0]
        sigma_t = scene.med_sigma_t[0]
        med_albedo = scene.med_albedo[0]
        g = scene.med_g[0]
        med_bound = scene.med_bound[0]
        has_med = scene.has_medium

        def bounce_body(carry, bounce):
            (o, d, throughput, L, active, eta_scale, prev_pdf,
             prev_delta, n_rays) = carry

            its = self._intersect(scene, o, d, ray_mint(o))
            t_surf = jnp.where(its.valid, its.t, 1e30)

            # ---- medium distance sampling -----------------------------
            u_med = self._d2(seed, pixel_id, sample_idx,
                             bounce_dim(bounce, DIM_MEDIUM))
            ms = sample_distance(sigma_t, med_albedo, u_med[..., 0],
                                 u_med[..., 1], t_surf, med_bound)
            in_medium = active & has_med & ms.sampled
            on_surface = active & its.valid & ~(has_med & ms.sampled)
            escaped = active & ~its.valid & ~(has_med & ms.sampled)

            seg_w = jnp.where(has_med,
                              jnp.where(in_medium[..., None], ms.w_medium,
                                        ms.w_surface),
                              jnp.ones((n, 3)))
            throughput = throughput * seg_w

            # ---- escaped: environment ---------------------------------
            env_rad = eval_env(scene, d)
            env_pdf = pdf_direct_env(scene, d)
            w_env = jnp.where(prev_delta, 1.0, mis_power(prev_pdf, env_pdf))
            first = bounce == 0
            w_env = jnp.where(first & self.hide_emitters, 0.0, w_env)
            L = L + jnp.where(escaped[..., None],
                              throughput * env_rad * w_env[..., None], 0.0)

            # ---- surface emitter hit ----------------------------------
            cos_surf = -dot(d, its.ng)
            le = eval_area(scene, its.em_id, cos_surf)
            nee_pdf_hit = pdf_direct_area(scene, its.em_id, d, its.t,
                                          cos_surf)
            w_hit = jnp.where(prev_delta, 1.0,
                              mis_power(prev_pdf, nee_pdf_hit))
            w_hit = jnp.where(first & self.hide_emitters, 0.0, w_hit)
            L = L + jnp.where(on_surface[..., None],
                              throughput * le * w_hit[..., None], 0.0)

            depth = bounce + 2

            # ---- NEE (shared emitter sample; per-branch weighting) ----
            p_med = o + ms.t[..., None] * d
            p_event = jnp.where(in_medium[..., None], p_med, its.p)
            u_sel = self._d1(seed, pixel_id, sample_idx,
                             bounce_dim(bounce, DIM_NEE_SEL))
            u_pos = self._d2(seed, pixel_id, sample_idx,
                             bounce_dim(bounce, DIM_NEE_POS))
            ds = sample_direct(scene, p_event, u_sel, u_pos)
            nee_ok = (ds.pdf > 0) & (depth + 1 <= self.max_depth + 1
                                     if self.max_depth > 0 else True)

            # surface branch: BSDF eval + shadow from offset surface point
            mat = resolve_material(scene, its.mat_id, its.uv,
                                   self.families)
            frame = Frame.from_normal(its.ns)
            frame = perturb_shading_frame(scene, mat, frame, its.uv)
            wi_local = Frame.to_local(frame, -d)
            wo_nee = Frame.to_local(frame, ds.d)
            f_surf = eval_bsdf_ex(mat, wi_local, wo_nee, self.families)
            pdf_surf_nee = pdf_bsdf_ex(mat, wi_local, wo_nee,
                                       self.families)
            # medium branch: phase eval (wi = -d)
            f_phase = hg_eval(g, dot(-d, ds.d))
            pdf_phase_nee = f_phase

            f_nee = jnp.where(in_medium[..., None],
                              jnp.broadcast_to(f_phase[..., None],
                                               f_surf.shape), f_surf)
            counter_pdf = jnp.where(in_medium, pdf_phase_nee, pdf_surf_nee)

            so = jnp.where(in_medium[..., None], p_event,
                           offset_ray_origin(its.p, its.ng, ds.d))
            smax = ds.dist * (1.0 - SHADOW_EPSILON)
            occ = self._occluded(scene, so, ds.d, ray_mint(so), smax)
            tr_shadow = jnp.where(
                has_med,
                transmittance(sigma_t, ds.dist, med_bound),
                jnp.ones((n, 3)))

            contributes = (in_medium | on_surface) & nee_ok & ~occ \
                & jnp.any(f_nee > 0, axis=-1)
            w_nee = jnp.where(ds.is_delta, 1.0,
                              mis_power(ds.pdf, counter_pdf))
            L = L + jnp.where(contributes[..., None],
                              throughput * ds.value * f_nee * tr_shadow
                              * w_nee[..., None], 0.0)

            # ---- continuation sampling --------------------------------
            u2 = self._d2(seed, pixel_id, sample_idx,
                          bounce_dim(bounce, DIM_BSDF_U2))
            u1 = self._d1(seed, pixel_id, sample_idx,
                          bounce_dim(bounce, DIM_BSDF_U1))
            bs = sample_bsdf_ex(mat, wi_local, u2, u1, self.families)
            d_bsdf = Frame.to_world(frame, bs.wo)

            u_ph = self._d2(seed, pixel_id, sample_idx,
                            bounce_dim(bounce, DIM_PHASE))
            d_phase, pdf_phase = hg_sample(g, -d, u_ph)

            d_next = jnp.where(in_medium[..., None], d_phase, d_bsdf)
            o_next = jnp.where(in_medium[..., None], p_event,
                               offset_ray_origin(its.p, its.ng, d_bsdf))
            # phase weight = eval/pdf = 1 (exact importance sampling)
            w_cont = jnp.where(in_medium[..., None], jnp.ones((n, 3)),
                               bs.weight)
            pdf_cont = jnp.where(in_medium, pdf_phase, bs.pdf)
            delta_cont = jnp.where(in_medium, False, bs.is_delta)

            throughput_next = throughput * w_cont
            alive = (in_medium | on_surface) & (pdf_cont > 0) \
                & jnp.any(throughput_next > 0, axis=-1)
            if self.max_depth > 0:
                alive = alive & (depth <= self.max_depth)

            eta_scale_next = eta_scale * jnp.where(in_medium, 1.0, bs.eta)
            q = jnp.minimum(
                jnp.max(throughput_next, axis=-1) * eta_scale_next ** 2,
                0.95)
            u_rr = self._d1(seed, pixel_id, sample_idx,
                            bounce_dim(bounce, DIM_RR))
            do_rr = depth >= self.rr_depth
            rr_continue = ~do_rr | (u_rr < q)
            throughput_next = jnp.where(
                (do_rr & rr_continue)[..., None],
                throughput_next / jnp.maximum(q, 1e-6)[..., None],
                throughput_next)
            alive = alive & rr_continue

            n_rays = (n_rays + jnp.sum(active.astype(jnp.uint32))
                      + jnp.sum(contributes.astype(jnp.uint32)))

            return ((o_next, jnp.where(alive[..., None], d_next, d),
                     jnp.where(alive[..., None], throughput_next, 0.0),
                     L, alive, eta_scale_next,
                     jnp.where(delta_cont, 1.0, pdf_cont),
                     delta_cont, n_rays), None)

        n_bounces = self.max_depth if self.max_depth > 0 else 32
        zf = o[..., 0] * 0.0
        zero3 = jnp.zeros_like(o)
        init = (o, d, zero3 + 1.0, zero3, zf < 1.0,
                zf + 1.0, zf + 1.0, zf < 1.0,
                (zf.sum() * 0.0).astype(jnp.uint32))
        (o_, d_, tp, L, _a, _e, _p, _pd, n_rays), _ = jax.lax.scan(
            bounce_body, init, jnp.arange(n_bounces))
        return L, n_rays
