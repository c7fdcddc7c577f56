"""Heterogeneous volumetric path tracer (Woodcock delta tracking).

Counterpart of the reference's volpath over a `heterogeneous` medium (ref:
src/medium/heterogeneous.cpp delta tracking + src/integrators/path/
volpath.cpp): free paths sampled by null-collision flights against the
max-density majorant (media/heterogeneous.py), NEE transmittance by ratio
tracking, HG phase scattering. Extinction is treated as monochrome
(mean of sigma_t — the common configuration of the reference's
heterogeneous medium: scalar density grid × spectrum) with RGB albedo.
"""
from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

from ..bsdf.bsdf import (eval_bsdf_ex, pdf_bsdf_ex, perturb_shading_frame,
                         resolve_material, sample_bsdf_ex)
from ..core import rng
from ..core.math import SHADOW_EPSILON, Frame, dot
from ..emitter.emitter import (eval_area, eval_env, pdf_direct_area,
                               pdf_direct_env, sample_direct)
from ..media.heterogeneous import (sample_distance_woodcock,
                                   transmittance_ratio)
from ..phase.phase import hg_eval, hg_sample
from ..scene.scene import SceneData
from .common import (DIM_BSDF_U1, DIM_BSDF_U2, DIM_MEDIUM, DIM_NEE_POS,
                     DIM_NEE_SEL, DIM_PHASE, DIM_RR, bounce_dim, mis_power,
                     offset_ray_origin, ray_mint)
from .path import PathTracer


@dataclass(frozen=True)
class HeteroVolPathTracer(PathTracer):
    """Volumetric PT over the scene's density grid.

    sggx=True enables the winmad anisotropic-microflake medium (ref:
    src/medium/heterogeneous{2,3}.cpp + src/phase/SGGX.cpp): extinction
    becomes directionally varying, σ_t(x, d) = density(x)·σ_scale·σ_S(d)
    with σ_S(d) = √(dᵀ S d) from scene.med_sggx (the phase.h:204-231
    sigmaDir interface), and scattering uses the specular SGGX microflake
    phase with perfect VNDF importance sampling. σ_S is constant along a
    ray for the (global-S) single-lobe medium, so delta tracking just
    scales each lane's σ and the majorant by the S-matrix bounds.
    """
    sggx: bool = False
    # Gaussian-fiber microflake medium (ref: src/phase/microflake.cpp):
    # directional σ via 2·σT(cosθ to the fiber axis), specular flake
    # mirroring for scattering. Orientation from scene.med_fiber.
    fiber: bool = False
    fiber_stddev: float = 0.3

    def li(self, scene: SceneData, o, d, seed, pixel_id, sample_idx=0):
        return self.li_stats(scene, o, d, seed, pixel_id, sample_idx)[0]

    def li_stats(self, scene: SceneData, o, d, seed, pixel_id,
                 sample_idx=0):
        n = o.shape[0]
        sigma_scale = jnp.mean(scene.med_sigma_t[0])
        med_albedo = scene.med_albedo[0]
        g = scene.med_g[0]
        grid = scene.med_grid
        bb_min = scene.med_grid_min
        bb_ext = scene.med_grid_extent
        majorant = scene.med_majorant
        if self.sggx:
            from ..phase.phase import (_s_mat, sggx_mix_sigma,
                                       sggx_mix_specular_eval,
                                       sggx_mix_specular_sample,
                                       sggx_sigma, sggx_specular_eval,
                                       sggx_specular_sample)
            s6 = scene.med_sggx
            if s6.ndim == 2:
                # multi-lobe mixture [K, 7] = (w, S6) per lobe
                # (ref: heterogeneous{2,3}.cpp multi-lobe SGGX media)
                smat = jnp.abs(_s_mat(s6[:, 1:]))
                lam_ub = jnp.max(jnp.sum(smat, axis=-1), axis=-1)
                sig_max = jnp.sum(
                    s6[:, 0] * jnp.sqrt(jnp.maximum(lam_ub, 1e-12)))
                sggx_sig = lambda dd: sggx_mix_sigma(s6, dd)
                sggx_eval = lambda a, b: sggx_mix_specular_eval(s6, a, b)
                sggx_smp = lambda a, u: sggx_mix_specular_sample(s6, a, u)
            else:
                # majorant σ bound: λ_max(S) ≤ max Gershgorin row sum
                # (cheap and branch-free; no eigendecomposition per
                # lane)
                smat = jnp.abs(_s_mat(s6))
                lam_ub = jnp.max(jnp.sum(smat, axis=-1))
                sig_max = jnp.sqrt(jnp.maximum(lam_ub, 1e-12))
                sggx_sig = lambda dd: sggx_sigma(s6, dd)
                sggx_eval = lambda a, b: sggx_specular_eval(s6, a, b)
                sggx_smp = lambda a, u: sggx_specular_sample(s6, a, u)
            majorant = majorant * sig_max
        if self.fiber:
            import numpy as _np
            from ..phase.phase import (fiber_sigma_t_table,
                                       microflake_eval,
                                       microflake_sample,
                                       microflake_sigma_dir)
            ftab_np = fiber_sigma_t_table(self.fiber_stddev)
            ftab = jnp.asarray(ftab_np)
            fdir = scene.med_fiber
            majorant = majorant * (2.0 * float(_np.max(ftab_np)))

        def bounce_body(carry, bounce):
            (o, d, throughput, L, active, eta_scale, prev_pdf,
             prev_delta, n_rays) = carry

            its = self._intersect(scene, o, d, ray_mint(o))
            t_surf = jnp.where(its.valid, its.t, 1e30)

            # ---- delta tracking ---------------------------------------
            bits = rng.hash_u32(seed, pixel_id,
                                bounce_dim(bounce, DIM_MEDIUM),
                                sample_idx)[..., 0]
            if self.sggx:
                sig_dir = sggx_sig(d)
            elif self.fiber:
                sig_dir = microflake_sigma_dir(ftab, fdir, d)
            else:
                sig_dir = jnp.ones_like(t_surf)
            sampled, t_med, sig_ev = sample_distance_woodcock(
                grid, bb_min, bb_ext, sigma_scale * sig_dir, majorant,
                o, d, t_surf, bits)
            in_medium = active & sampled
            on_surface = active & its.valid & ~sampled
            escaped = active & ~its.valid & ~sampled
            # delta tracking weights are 1; scattering applies albedo
            throughput = jnp.where(in_medium[..., None],
                                   throughput * med_albedo, throughput)

            # ---- escaped / emitter hit --------------------------------
            first = bounce == 0
            env_rad = eval_env(scene, d)
            env_pdf = pdf_direct_env(scene, d)
            w_env = jnp.where(prev_delta, 1.0, mis_power(prev_pdf, env_pdf))
            w_env = jnp.where(first & self.hide_emitters, 0.0, w_env)
            L = L + jnp.where(escaped[..., None],
                              throughput * env_rad * w_env[..., None], 0.0)
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

            # ---- NEE ---------------------------------------------------
            p_med = o + t_med[..., None] * d
            p_event = jnp.where(in_medium[..., None], p_med, its.p)
            u_sel = self._d1(seed, pixel_id, sample_idx,
                             bounce_dim(bounce, DIM_NEE_SEL))
            u_pos = self._d2(seed, pixel_id, sample_idx,
                             bounce_dim(bounce, DIM_NEE_POS))
            ds = sample_direct(scene, p_event, u_sel, u_pos)
            nee_ok = (ds.pdf > 0) & (depth + 1 <= self.max_depth + 1
                                     if self.max_depth > 0 else True)

            mat = resolve_material(scene, its.mat_id, its.uv,
                                   self.families)
            frame = Frame.from_normal(its.ns)
            frame = perturb_shading_frame(scene, mat, frame, its.uv)
            wi_local = Frame.to_local(frame, -d)
            wo_nee = Frame.to_local(frame, ds.d)
            f_surf = eval_bsdf_ex(mat, wi_local, wo_nee, self.families)
            pdf_surf_nee = pdf_bsdf_ex(mat, wi_local, wo_nee,
                                       self.families)
            if self.sggx:
                f_phase = sggx_eval(-d, ds.d)
            elif self.fiber:
                f_phase = microflake_eval(self.fiber_stddev, ftab,
                                          fdir, -d, ds.d)
            else:
                f_phase = hg_eval(g, dot(-d, ds.d))
            f_nee = jnp.where(in_medium[..., None],
                              jnp.broadcast_to(f_phase[..., None],
                                               f_surf.shape), f_surf)
            counter_pdf = jnp.where(in_medium, f_phase, pdf_surf_nee)

            so = jnp.where(in_medium[..., None], p_event,
                           offset_ray_origin(its.p, its.ng, ds.d))
            smax = ds.dist * (1.0 - SHADOW_EPSILON)
            occ = self._occluded(scene, so, ds.d, ray_mint(so), smax)
            sh_bits = rng.hash_u32(seed, pixel_id,
                                   bounce_dim(bounce, DIM_PHASE) + 1,
                                   sample_idx)[..., 1]
            if self.sggx:
                sig_sh = sggx_sig(ds.d)
            elif self.fiber:
                sig_sh = microflake_sigma_dir(ftab, fdir, ds.d)
            else:
                sig_sh = jnp.ones_like(t_surf)
            tr_sh = transmittance_ratio(
                grid, bb_min, bb_ext, sigma_scale * sig_sh, majorant,
                so, ds.d, jnp.minimum(ds.dist, 1e4),
                sh_bits)[..., None]

            contributes = (in_medium | on_surface) & nee_ok & ~occ \
                & jnp.any(f_nee > 0, axis=-1)
            w_nee = jnp.where(ds.is_delta, 1.0,
                              mis_power(ds.pdf, counter_pdf))
            L = L + jnp.where(contributes[..., None],
                              throughput * ds.value * f_nee * tr_sh
                              * w_nee[..., None], 0.0)

            # ---- continuation -----------------------------------------
            u2 = self._d2(seed, pixel_id, sample_idx,
                          bounce_dim(bounce, DIM_BSDF_U2))
            u1 = self._d1(seed, pixel_id, sample_idx,
                          bounce_dim(bounce, DIM_BSDF_U1))
            bs = sample_bsdf_ex(mat, wi_local, u2, u1, self.families)
            d_bsdf = Frame.to_world(frame, bs.wo)
            u_ph = self._d2(seed, pixel_id, sample_idx,
                            bounce_dim(bounce, DIM_PHASE))
            if self.sggx:
                d_phase, pdf_phase = sggx_smp(-d, u_ph)
            elif self.fiber:
                d_phase, pdf_phase = microflake_sample(
                    self.fiber_stddev, ftab,
                    jnp.broadcast_to(fdir, d.shape), -d, u_ph, u1)
            else:
                d_phase, pdf_phase = hg_sample(g, -d, u_ph)
            d_next = jnp.where(in_medium[..., None], d_phase, d_bsdf)
            o_next = jnp.where(in_medium[..., None], p_event,
                               offset_ray_origin(its.p, its.ng, d_bsdf))
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
