"""Single scattering in participating media (Holzschuch 2015, fast flavor).

Counterpart of the reference `singlescatter` subsurface plugin (ref:
src/subsurface/singlescatter.cpp — fast single scatter, the default
`fastSingleScatter=true` path at singlescatter.cpp:1416-1470):

At a hit on the translucent object, the camera ray refracts through the
smooth dielectric boundary; along the internal refracted segment,
`fss_samples` points V are drawn with exponential importance sampling
(mean free path `radius = min_c 1/sigma_t[c]`, singlescatter.cpp:1655-1660);
each V connects to a sampled emitter through the object boundary: the exit
point is found by intersecting V→L, light refracts in at the exit with
Fresnel (1-F) and the Walter et al. geometry term
D = (dV + eta·dL)(|cosL/cosV|·dV + |cosV/cosL|·eta·dL)
(singlescatter.cpp:1455-1460), the in-medium segment attenuates by
exp(-sigma_t·(dist+dV)) and scatters once with HG.

Also reproduced from `Lo` (singlescatter.cpp:1581-1640 + LoSingle
1322-1420): the specular reflection term F·Li(reflected), the
through-transmittance term (exit refraction at the far boundary,
attenuated by exp(-sigma_t·thickness)), and `ss_depth` internal
(total/Fresnel) reflection bounces, each adding another single-scatter
light connection.

Wavefront design: no recursion — the internal-reflection chain is an
unrolled masked wavefront loop (depth is ≤ a few), and the two surface
Li() continuations are evaluated as full secondary wavefronts through the
base path tracer. All lanes march in lock-step with validity masks.
"""
from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from ..core.fresnel import fresnel_dielectric
from ..core.math import SHADOW_EPSILON, Frame, dot, normalize, refract_local
from ..emitter.emitter import sample_direct
from ..phase.phase import hg_eval
from ..scene.scene import SceneData
from .common import offset_ray_origin, ray_mint
from .path import PathTracer

_DIM_SS = 1 << 24      # private RNG dimension block (cf. dipole's 1<<25)


@dataclass(frozen=True)
class SingleScatterIntegrator(PathTracer):
    """Path tracer + single-scatter term on surfaces with material
    `target_mat` (attach a dielectric/null-like material there; the
    boundary Fresnel is computed from `eta` here, as the reference reads
    it from the child BSDF — singlescatter.cpp:1647)."""
    target_mat: int = -1
    sigma_s: tuple = (2.6, 3.2, 3.9)
    sigma_a: tuple = (0.0021, 0.0041, 0.0071)
    g: float = 0.0
    eta: float = 1.33
    fss_samples: int = 2           # fssSamples (singlescatter.cpp:125)
    ss_depth: int = 2              # singleScatterDepth (default 4 in ref)
    transmittance: bool = True     # singleScatterTransmittance
    reflection: bool = True        # the Lo specular-reflection term

    def _consts(self):
        sig_s = jnp.asarray(self.sigma_s, jnp.float32)
        sig_t = sig_s + jnp.asarray(self.sigma_a, jnp.float32)
        radius = float(np.min(1.0 / np.maximum(
            np.asarray(self.sigma_s, np.float64)
            + np.asarray(self.sigma_a, np.float64), 1e-12)))
        return sig_s, sig_t, radius

    def _refract_world(self, d_in, ns):
        """Refract incident world direction d_in (pointing at the surface)
        through normal ns with ratio eta. Returns (d_t, F, total_internal)."""
        wi = -d_in
        frame = Frame.from_normal(ns)
        wi_l = Frame.to_local(frame, wi)
        f, cos_t, _, _ = fresnel_dielectric(wi_l[..., 2], self.eta)
        wo_l = refract_local(wi_l, jnp.asarray(self.eta), cos_t)
        return Frame.to_world(frame, normalize(wo_l)), f, f >= 1.0

    def _connect(self, scene, entry_p, d_int, thickness, valid, att,
                 seed, pixel_id, sample_idx, depth):
        """One LoSingle light connection (fast loop,
        singlescatter.cpp:1416-1470). Returns [N, 3]."""
        sig_s, sig_t, radius = self._consts()
        n = entry_p.shape[0]
        base = _DIM_SS + depth * 16

        # Emitter sample from the *entry* point (ref samples dRec at its.p)
        us = self._d1(seed, pixel_id, sample_idx, base + 0)
        up = self._d2(seed, pixel_id, sample_idx, base + 1)
        ds = sample_direct(scene, entry_p, us, up)
        light_p = entry_p + ds.d * ds.dist[..., None]
        # eta² for the light entering the denser medium
        # (singlescatter.cpp:1409); D replaces the 1/dist² falloff so the
        # sampled value is un-divided by dist² (weight0's dRec.dist² term).
        value = ds.value * (self.eta ** 2) * (ds.dist ** 2)[..., None]
        ok_light = valid & (ds.pdf > 0)

        s_max = 1.0 - jnp.exp(-thickness / radius)
        d_samples = s_max / self.fss_samples
        weight0 = (d_samples * radius)[..., None] * sig_s

        acc = jnp.zeros((n, 3))
        for s in range(self.fss_samples):
            u = self._d1(seed, pixel_id, sample_idx, base + 2 + s)
            dist = -jnp.log(jnp.maximum(1.0 - u * s_max, 1e-20)) * radius
            v = entry_p + dist[..., None] * d_int
            inside = dist <= thickness
            weight = weight0 * jnp.exp(dist / radius)[..., None]

            # Exit point: first surface from V toward the light
            vl = light_p - v
            d_vl = jnp.linalg.norm(vl, axis=-1)
            vl_dir = vl / jnp.maximum(d_vl, 1e-12)[..., None]
            exit_its = self._intersect(scene, v, vl_dir,
                                       jnp.full((n,), 1e-5))
            p_world = exit_its.p
            hit_boundary = exit_its.valid

            # Shadow ray from the exit point to the light
            omega_l = light_p - p_world
            d_l = jnp.linalg.norm(omega_l, axis=-1)
            omega_l = omega_l / jnp.maximum(d_l, 1e-12)[..., None]
            so = offset_ray_origin(p_world, exit_its.ng, omega_l)
            occ = self._occluded(scene, so, omega_l, ray_mint(so),
                                 d_l * (1.0 - SHADOW_EPSILON))

            omega_v = v - p_world
            d_v = jnp.linalg.norm(omega_v, axis=-1)
            omega_v = omega_v / jnp.maximum(d_v, 1e-12)[..., None]

            cos_l = dot(omega_l, exit_its.ns)
            cos_v = dot(omega_v, exit_its.ns)
            nonzero = (jnp.abs(cos_l) > 1e-6) & (jnp.abs(cos_v) > 1e-6)

            f_exit, _, _, _ = fresnel_dielectric(cos_l, self.eta)
            abs_l = jnp.maximum(jnp.abs(cos_l), 1e-6)
            abs_v = jnp.maximum(jnp.abs(cos_v), 1e-6)
            big_d = ((d_v + self.eta * d_l)
                     * (abs_l / abs_v * d_v
                        + abs_v / abs_l * self.eta * d_l))

            phase = (hg_eval(jnp.asarray(self.g), dot(omega_v, d_int))
                     [..., None]
                     * jnp.exp(-sig_t * (dist + d_v)[..., None]))

            term = (((1.0 - f_exit) / jnp.maximum(big_d, 1e-12))[..., None]
                    * phase * value * weight * att)
            keep = (ok_light & inside & hit_boundary & ~occ
                    & nonzero)[..., None]
            acc = acc + jnp.where(keep, term, 0.0)
        return acc

    def li(self, scene: SceneData, o, d, seed, pixel_id, sample_idx=0):
        base_l = super().li(scene, o, d, seed, pixel_id, sample_idx)
        its = self._intersect(scene, o, d, ray_mint(o))
        sel = its.valid & (its.mat_id == self.target_mat)
        sig_s, sig_t, radius = self._consts()
        n = o.shape[0]

        # --- entry refraction (Lo, singlescatter.cpp:1625-1639) ---------
        d_int, f_entry, tir = self._refract_world(d, its.ns)
        # delta-transmission radiance weight: (1-F)·(1/eta)² entering
        att = ((1.0 - f_entry) / self.eta ** 2)[..., None]
        att = jnp.where((sel & ~tir)[..., None], att, 0.0)

        lo = jnp.zeros((n, 3))

        # --- specular reflection continuation (Lo:1604-1623) ------------
        if self.reflection:
            frame = Frame.from_normal(its.ns)
            wi_l = Frame.to_local(frame, -d)
            d_refl = Frame.to_world(
                frame, jnp.stack([-wi_l[..., 0], -wi_l[..., 1],
                                  wi_l[..., 2]], axis=-1))
            ro = offset_ray_origin(its.p, its.ng, d_refl)
            l_refl = super().li(scene, ro, d_refl, seed, pixel_id,
                                sample_idx + (1 << 20))
            lo = lo + jnp.where(sel[..., None],
                                f_entry[..., None] * l_refl, 0.0)

        # --- internal chain: march + connect, ss_depth bounces ----------
        entry_p = its.p
        cur_d = d_int
        valid = sel & ~tir
        for depth in range(self.ss_depth):
            if depth == 0:
                eo = offset_ray_origin(entry_p, -its.ng, cur_d)
            else:
                eo = entry_p + 1e-4 * cur_d
            fwd = self._intersect(scene, eo, cur_d, jnp.full((n,), 1e-5))
            thickness = jnp.where(fwd.valid, fwd.t, 0.0)
            valid = valid & fwd.valid

            lo = lo + self._connect(scene, entry_p, cur_d, thickness,
                                    valid, att, seed, pixel_id,
                                    sample_idx, depth)

            # transmittance continuation at the far boundary
            # (LoSingle:1343-1370) — only from the first interface chain
            if self.transmittance and depth == 0:
                # signed-cosine Fresnel handles the inside→outside case
                d_out, f2, tir2 = self._refract_world(cur_d, fwd.ns)
                ok = valid & ~tir2
                t_att = (att * ((1.0 - f2) * self.eta ** 2)[..., None]
                         * jnp.exp(-sig_t * thickness[..., None]))
                to = offset_ray_origin(fwd.p, fwd.ng, d_out)
                l_out = super().li(scene, to, d_out, seed, pixel_id,
                                   sample_idx + (2 << 20))
                lo = lo + jnp.where(ok[..., None], t_att * l_out, 0.0)

            if depth + 1 < self.ss_depth:
                # Fresnel (possibly total) internal reflection
                # (LoSingle:1376-1399)
                frame = Frame.from_normal(fwd.ns)
                wl = Frame.to_local(frame, -cur_d)
                # wl.z < 0 (arriving from inside): fresnel_dielectric's
                # signed-cosine convention picks eta_it = 1/eta itself
                f_int, _, _, _ = fresnel_dielectric(wl[..., 2], self.eta)
                cur_d = Frame.to_world(
                    frame, jnp.stack([-wl[..., 0], -wl[..., 1],
                                      wl[..., 2]], axis=-1))
                att = att * (f_int[..., None]
                             * jnp.exp(-sig_t * thickness[..., None]))
                entry_p = fwd.p

        return base_l + lo
