"""VPL renderer (instant radiosity).

Counterpart of the reference `vpl` plugin + generateVPLs infra (ref:
src/integrators/vpl/vpl.cpp, src/librender/vpl.cpp:25-241): random-walk
particles from the emitters deposit virtual point lights; the image is lit
by summing every VPL's contribution with a clamped geometry term.

Wavefront shape: VPL generation is one particle wavefront (`lax.scan`
over bounces, every vertex stored — the fixed-size analog of the
reference's std::deque of VPLs); rendering is one camera-hit wavefront
followed by a `lax.scan` over VPLs, each step shading ALL pixels against
one VPL with a batched shadow-ray test. No per-VPL image passes like the
reference's GPU preview — the whole sum is one fused loop.

Radiometry: a VPL stores radiant flux Φ [W]. Emitter VPLs radiate
diffusely (I(ω) = Φ cosθ/π, the area-light equivalence vpl.cpp uses);
surface VPLs re-emit through their BSDF with the stored incoming
direction. Contribution to shading point x:
    L += f_x(wi_cam, ω) · f_y(wi_y, -ω) · cosθ_y · cosθ_x / d² · Φ
with d² clamped below by (clamping · scene_radius)² — the bias knob the
reference exposes as `clamping` (vpl.cpp:44-48).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..bsdf.bsdf import (eval_bsdf_ex, perturb_shading_frame,
                         resolve_material, sample_bsdf_ex)
from ..core import rng
from ..core.math import SHADOW_EPSILON, Frame, dot, normalize
from ..core.warp import square_to_cosine_hemisphere
from ..scene.scene import EM_AREA, SceneData
from .common import (DIM_BSDF_U1, DIM_BSDF_U2, DIM_NEE_POS, DIM_NEE_SEL,
                     DIM_PIXEL, bounce_dim, offset_ray_origin, ray_mint)
from .path import PathTracer

_VPL_DIM_BASE = 1 << 18     # RNG dims for the generation walk


class VPLs(NamedTuple):
    """Flat VPL table: [NV] records (NV = n_paths · (max walk depth))."""
    p: jax.Array            # [NV, 3] position
    n: jax.Array            # [NV, 3] shading normal
    wi: jax.Array           # [NV, 3] incoming direction (toward source)
    flux: jax.Array         # [NV, 3] radiant flux Φ (already / n_paths)
    mat_id: jax.Array       # [NV] surface material (-1 ⇒ emitter VPL)
    uv: jax.Array           # [NV, 2]
    valid: jax.Array        # [NV] bool


@dataclass(frozen=True)
class VPLIntegrator(PathTracer):
    """Config mirroring the reference plugin (vpl.cpp properties):
    shadowMapResolution → n/a (true shadow rays, not shadow maps);
    clamping — relative geometry-term distance clamp."""
    n_paths: int = 256
    clamping: float = 0.1

    # ------------------------------------------------------------------
    # phase 1: VPL generation (ref: librender/vpl.cpp generateVPLs)
    # ------------------------------------------------------------------

    def generate_vpls(self, scene: SceneData, seed: int = 0) -> VPLs:
        n = self.n_paths
        pid = jnp.arange(n, dtype=jnp.uint32)
        seed = jnp.uint32(seed)
        dim = _VPL_DIM_BASE

        # emitter start vertex (area emitters; point/directional luminaire
        # VPLs — vpl.cpp:70-110 — not yet generated here)
        u_sel = rng.sample_1d(seed, pid, dim + bounce_dim(0, DIM_NEE_SEL))
        u_pos = rng.sample_2d(seed, pid, dim + bounce_dim(0, DIM_NEE_POS))
        em_id, u_re, em_pmf = scene.em_pmf.sample_reuse(u_sel)
        is_area = scene.em_type[em_id] == EM_AREA
        key = em_id.astype(jnp.float32) + jnp.clip(u_re, 0.0, 1.0 - 1e-7)
        hi = jnp.clip(jnp.searchsorted(scene.em_tri_cdfg, key, "right"),
                      0, max(scene.em_tris.shape[0] - 1, 0))
        row = scene.em_tri_data[hi]
        sq = jnp.sqrt(jnp.maximum(1.0 - u_pos[..., 0], 0.0))
        b0 = 1.0 - sq
        b1 = u_pos[..., 1] * sq
        p0 = (row[..., 0:3] + b0[..., None] * row[..., 3:6]
              + b1[..., None] * row[..., 6:9])
        n0 = row[..., 9:12]
        le = scene.em_radiance[em_id]
        area = scene.em_area[em_id]
        # path power Φ = Le·π·A/pmf, amortised over n_paths
        flux0 = le * (np.pi * area / jnp.maximum(em_pmf, 1e-12)
                      )[..., None] / n
        flux0 = jnp.where(is_area[..., None], flux0, 0.0)

        em_vpl = (p0, n0, n0, flux0,
                  jnp.full((n,), -1, jnp.int32),
                  jnp.zeros((n, 2)), is_area)

        # cosine emission direction; power throughput stays Φ
        u_dir = rng.sample_2d(seed, pid, dim + bounce_dim(0, DIM_BSDF_U2))
        fr = Frame.from_normal(n0)
        d0 = Frame.to_world(fr, square_to_cosine_hemisphere(u_dir))
        o0 = offset_ray_origin(p0, n0, d0)

        def body(carry, bounce):
            o, d, alpha, active = carry
            its = self._intersect(scene, o, d, ray_mint(o))
            hit = active & its.valid
            mat = resolve_material(scene, its.mat_id, its.uv,
                                   self.families)
            frame = Frame.from_normal(its.ns)
            frame = perturb_shading_frame(scene, mat, frame, its.uv)
            wi_local = Frame.to_local(frame, -d)
            out = (its.p, its.ns, -d, jnp.where(hit[..., None], alpha, 0.0),
                   jnp.where(hit, its.mat_id, -1), its.uv, hit)

            u2 = rng.sample_2d(seed, pid,
                               dim + bounce_dim(bounce + 1, DIM_BSDF_U2))
            u1 = rng.sample_1d(seed, pid,
                               dim + bounce_dim(bounce + 1, DIM_BSDF_U1))
            bs = sample_bsdf_ex(mat, wi_local, u2, u1, self.families)
            d_next = Frame.to_world(frame, bs.wo)
            o_next = offset_ray_origin(its.p, its.ng, d_next)
            alpha_next = alpha * bs.weight
            alive = hit & (bs.pdf > 0) & jnp.any(alpha_next > 0, axis=-1)
            return ((o_next, jnp.where(alive[..., None], d_next, d),
                     jnp.where(alive[..., None], alpha_next, 0.0),
                     alive), out)

        # depth accounting (max_depth counts path EDGES, as PathTracer):
        # an emitter VPL lights camera→x→light (2 edges); a surface VPL
        # after k light segments lights paths of 2+k edges ⇒ walk length
        # = max_depth - 2
        n_surf = max((self.max_depth - 2) if self.max_depth > 0 else 6, 0)
        fields = [em_vpl]
        if n_surf > 0:
            _, outs = jax.lax.scan(body, (o0, d0, flux0, is_area),
                                   jnp.arange(n_surf))
            fields.append(tuple(
                jnp.reshape(x, (-1,) + x.shape[2:]) for x in outs))
        cat = [jnp.concatenate([f[i] for f in fields], axis=0)
               for i in range(7)]
        return VPLs(*cat)

    # ------------------------------------------------------------------
    # phase 2: shading (ref: vpl.cpp render loop)
    # ------------------------------------------------------------------

    def li_with_vpls(self, scene: SceneData, vpls: VPLs, o, d, seed,
                     pixel_id, sample_idx=0):
        its = self._intersect(scene, o, d, ray_mint(o))
        hit = its.valid

        # directly visible emitters (the VPL sum models indirect+direct
        # FROM the shading point on; emitter seen by the camera is exact)
        cos_surf = -dot(d, its.ng)
        from ..emitter.emitter import eval_area, eval_env
        le = eval_area(scene, its.em_id, cos_surf)
        L = jnp.where(hit[..., None], le, eval_env(scene, d))

        mat = resolve_material(scene, its.mat_id, its.uv, self.families)
        frame = Frame.from_normal(its.ns)
        frame = perturb_shading_frame(scene, mat, frame, its.uv)
        wi_local = Frame.to_local(frame, -d)

        # geometry clamp distance relative to the scene extent (the padded
        # far-away triangles have zero area and are excluded)
        valid_t = scene.tri_area > 0
        radius = jnp.max(jnp.where(valid_t[:, None], jnp.abs(scene.p0),
                                   0.0))
        min_d2 = (self.clamping * radius) ** 2

        def shade_one(carry, j):
            L = carry
            yp = vpls.p[j]
            yn = vpls.n[j]
            ywi = vpls.wi[j]
            yflux = vpls.flux[j]
            ymat = vpls.mat_id[j]
            yuv = vpls.uv[j]
            yvalid = vpls.valid[j]

            v = yp[None, :] - its.p
            d2 = jnp.sum(v * v, axis=-1)
            dist = jnp.sqrt(jnp.maximum(d2, 1e-20))
            w = v / dist[..., None]
            cos_x = dot(w, its.ns)
            cos_y = -dot(w, yn[None, :])
            d2c = jnp.maximum(d2, min_d2)
            g = jnp.maximum(cos_y, 0.0) / d2c

            # VPL-side BSDF (emitter VPL ⇒ diffuse 1/π kernel)
            is_em_vpl = ymat < 0
            yfr = Frame.from_normal(yn[None, :])
            ymat_r = resolve_material(
                scene, jnp.maximum(ymat, 0)[None], yuv[None, :],
                self.families)
            f_y_b = eval_bsdf_ex(
                ymat_r, Frame.to_local(yfr, ywi[None, :]),
                Frame.to_local(yfr, -w), self.families)
            # eval_bsdf includes the cosine at y; the emitter kernel needs
            # cos_y/π explicitly — both fold the cosθ_y so g drops it
            f_y = jnp.where(is_em_vpl, 1.0 / np.pi, f_y_b
                            / jnp.maximum(cos_y, 1e-6)[..., None])

            f_x = eval_bsdf_ex(mat, wi_local, Frame.to_local(frame, w),
                               self.families)

            contrib = f_x * f_y * (g[..., None] * yflux[None, :])
            ok = hit & yvalid & (cos_x > 0) & (cos_y > 1e-6) & jnp.any(
                contrib > 0, axis=-1)

            so = offset_ray_origin(its.p, its.ng, w)
            occ = self._occluded(scene, so, w, ray_mint(so),
                                 dist * (1.0 - SHADOW_EPSILON))
            ok = ok & ~occ
            return L + jnp.where(ok[..., None], contrib, 0.0), None

        nv = vpls.p.shape[0]
        L, _ = jax.lax.scan(shade_one, L, jnp.arange(nv))
        return L

    def li(self, scene: SceneData, o, d, seed, pixel_id, sample_idx=0):
        vpls = self.generate_vpls(scene, seed)
        return self.li_with_vpls(scene, vpls, o, d, seed, pixel_id,
                                 sample_idx)

    def render(self, scene: SceneData, camera, film, spp: int = 1,
               seed: int = 0):
        """Full VPL render: one VPL set, spp camera samples."""
        return _render_vpl(scene, camera, film, self, spp, seed)


@partial(jax.jit, static_argnames=("camera", "film", "integ", "spp"))
def _render_vpl(scene, camera, film, integ: VPLIntegrator, spp, seed):
    vpls = integ.generate_vpls(scene, seed)
    h, w = film.height, film.width
    n = h * w
    px = jnp.arange(n, dtype=jnp.uint32)
    pix_x = (px % w).astype(jnp.float32)
    pix_y = (px // w).astype(jnp.float32)

    def sample_pass(s, accum):
        s = jnp.uint32(s)
        jitter = rng.sample_2d(seed, px, DIM_PIXEL, s)
        pos = jnp.stack([pix_x + jitter[..., 0],
                         pix_y + jitter[..., 1]], axis=-1)
        o, d = camera.sample_ray(pos)
        radiance = integ.li_with_vpls(scene, vpls, o, d,
                                      jnp.uint32(seed), px, s)
        return film.splat(accum, pos, radiance)

    accum = jax.lax.fori_loop(0, spp, sample_pass, film.new_accumulator())
    return film.develop(accum)
