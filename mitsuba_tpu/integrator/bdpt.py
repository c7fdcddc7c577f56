"""Bidirectional path tracer (wavefront, MIS over all strategies).

Counterpart of the reference `bdpt` plugin over libbidir (ref:
src/integrators/bdpt/bdpt.cpp, src/libbidir/{path,vertex,edge}.cpp,
pathsampler.cpp; SURVEY.md §2.3). Wavefront redesign: instead of
per-path `Path`/`PathVertex` object chains (vertex.h:48), both subpaths
are generated as fixed-depth *vertex arrays* via `lax.scan` — position,
normal, material id, throughput, solid-angle forward/reverse pdfs plus
segment geometry (area conversions happen at MIS time), delta flags, all
[K, N]-shaped — and every (eye length e, light length l) strategy pair
is an unrolled branchless connection over the whole wavefront with one
shadow ray.

MIS follows Veach's pdf-ratio recursion in the remap-delta-to-one form
(the algorithm behind the reference's Path::miWeight, libbidir/path.cpp):
e and l are static per unrolled pair, so the ratio products are plain
Python loops over [N] arrays.

Strategy set: l ∈ {0 (eye path hits the emitter), 1 (emitter-sample
connection = NEE), ≥2 (subpath connections)} with eye surface vertices
e ≥ 1. The t=1 light-tracing strategy (the reference's light image,
bdpt_wr.cpp) is not in the sum — ParticleTracer covers that regime — and
the MIS weights form a partition of unity over the included set, so the
estimator stays unbiased: every path is sampled by some included
strategy (pure delta eye chains by l = 0).

Light subpaths start on area emitters with cosine emission (matching
emitter/area.cpp sampleRay); environment/point/delta emitters are
handled by the eye-path strategies only.
"""
from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..bsdf.bsdf import (eval_bsdf_ex, pdf_bsdf_ex, resolve_material,
                         sample_bsdf_ex)
from ..core.math import SHADOW_EPSILON, Frame, dot
from ..core.warp import square_to_cosine_hemisphere
from ..emitter.emitter import eval_env
from ..scene.scene import SceneData
from .common import (DIM_BSDF_U1, DIM_BSDF_U2, bounce_dim,
                     offset_ray_origin, ray_mint)
from .path import PathTracer

_LIGHT_DIM_BASE = 8192   # RNG dim offset: light-subpath stream
_CONN_DIM_BASE = 16384   # RNG dim offset: connection samples
INV_PI = float(1.0 / np.pi)


def _remap0(x):
    """Veach delta remap: treat zero/delta pdfs as 1 in ratio products."""
    return jnp.where(x > 0, x, 1.0)


@dataclass(frozen=True)
class BDPT(PathTracer):
    """max_depth = maximum path edges (reference bdpt.cpp maxDepth).
    No Russian roulette inside subpaths (fixed truncation keeps the pdf
    bookkeeping exact, like the reference with rrDepth > maxDepth)."""

    def li(self, scene: SceneData, o, d, seed, pixel_id, sample_idx=0):
        return self.li_stats(scene, o, d, seed, pixel_id, sample_idx)[0]

    # ------------------------------------------------------------------
    # subpath generation
    # ------------------------------------------------------------------

    def _walk(self, scene, o0, d0, beta_in0, pdf_omega0, active0, seed,
              pixel_id, sample_idx, n_steps, dim_base):
        """Random walk storing one record per vertex (stacked [K, N, …]):

          p, ns, ng       hit geometry
          mat_id, uv      material handle (re-resolved at connection)
          wi              unit world direction from this vertex toward
                          its predecessor
          beta            path throughput INTO the vertex
          d2              squared distance to the predecessor
          pdf_fwd_w       solid-angle pdf with which the segment into
                          this vertex was sampled at the predecessor
          pdf_back_w      solid-angle pdf of re-sampling the reverse
                          segment (toward the predecessor) from this
                          vertex's continuation lobe
          delta           continuation lobe was Dirac
          valid, em_id
        """

        def body(carry, k):
            o, d, beta, pdf_omega, active = carry
            its = self._intersect(scene, o, d, ray_mint(o))
            hit = active & its.valid

            mat = resolve_material(scene, its.mat_id, its.uv,
                                   self.families)
            frame = Frame.from_normal(its.ns)
            wi_local = Frame.to_local(frame, -d)
            u2 = self._d2(seed, pixel_id, sample_idx,
                          dim_base + bounce_dim(k, DIM_BSDF_U2))
            u1 = self._d1(seed, pixel_id, sample_idx,
                          dim_base + bounce_dim(k, DIM_BSDF_U1))
            bs = sample_bsdf_ex(mat, wi_local, u2, u1, self.families)
            pdf_back_w = pdf_bsdf_ex(mat, bs.wo, wi_local, self.families)

            d2 = jnp.maximum(its.t * its.t, 1e-12)
            out = (its.p, its.ns, its.ng, its.mat_id, its.uv, -d, beta,
                   d2, pdf_omega, pdf_back_w, bs.is_delta, hit, its.em_id)

            d_next = Frame.to_world(frame, bs.wo)
            o_next = offset_ray_origin(its.p, its.ng, d_next)
            beta_next = beta * bs.weight
            alive = hit & (bs.pdf > 0) & jnp.any(beta_next > 0, axis=-1)
            return ((o_next, jnp.where(alive[..., None], d_next, d),
                     jnp.where(alive[..., None], beta_next, 0.0),
                     jnp.where(bs.is_delta, 0.0, bs.pdf), alive), out)

        init = (o0, d0, beta_in0, pdf_omega0, active0)
        _, outs = jax.lax.scan(body, init, jnp.arange(n_steps))
        keys = ("p", "ns", "ng", "mat_id", "uv", "wi", "beta", "d2",
                "pdf_fwd_w", "pdf_back_w", "delta", "valid", "em_id")
        return dict(zip(keys, outs))

    # ------------------------------------------------------------------

    def li_stats(self, scene: SceneData, o, d, seed, pixel_id,
                 sample_idx=0):
        from ..core import rng as _rng
        n = o.shape[0]
        max_edges = self.max_depth if self.max_depth > 0 else 6
        n_eye = max_edges                  # eye surface vertices x1..xE
        n_light = max(max_edges - 1, 0)    # light surface verts y1..yL

        families = self.families
        zf = o[..., 0] * 0.0

        # ---- eye subpath -------------------------------------------------
        eye = self._walk(scene, o, d, jnp.zeros_like(o) + 1.0,
                         zf + 1e8,   # camera "pdf" sentinel (cancels: the
                         # camera edge is shared by every included
                         # strategy, so its ratio never enters the MIS sum)
                         zf < 1.0, seed, pixel_id, sample_idx, n_eye, 0)

        # ---- light subpath start (area emitter, cosine emission) --------
        u_sel = self._d1(seed, pixel_id, sample_idx, _LIGHT_DIM_BASE - 4)
        u_pos = self._d2(seed, pixel_id, sample_idx, _LIGHT_DIM_BASE - 3)
        u_dir = self._d2(seed, pixel_id, sample_idx, _LIGHT_DIM_BASE - 2)
        em_id, u_re, em_pmf = scene.em_pmf.sample_reuse(u_sel)
        from ..scene.scene import EM_AREA
        is_area = scene.em_type[em_id] == EM_AREA
        key = em_id.astype(jnp.float32) + jnp.clip(u_re, 0.0, 1.0 - 1e-7)
        hi = jnp.clip(jnp.searchsorted(scene.em_tri_cdfg, key, "right"),
                      0, max(scene.em_tris.shape[0] - 1, 0))
        row = scene.em_tri_data[hi]
        sq = jnp.sqrt(jnp.maximum(1.0 - u_pos[..., 0], 0.0))
        b0 = 1.0 - sq
        b1 = u_pos[..., 1] * sq
        y0_p = (row[..., 0:3] + b0[..., None] * row[..., 3:6]
                + b1[..., None] * row[..., 6:9])
        y0_n = row[..., 9:12]
        le = scene.em_radiance[em_id]
        area_total = scene.em_area[em_id]
        pdf_y0_area = em_pmf / jnp.maximum(area_total, 1e-12)   # pmf/A
        fr0 = Frame.from_normal(y0_n)
        d0l = Frame.to_world(fr0, square_to_cosine_hemisphere(u_dir))
        cos0 = jnp.maximum(dot(d0l, y0_n), 0.0)
        pdf_dir0 = cos0 * INV_PI
        # β into y1 = Le·cos/(pdf_pos·pdf_dir) = Le·π·A/pmf (cosine cancel)
        beta_y1 = le * (cos0 / jnp.maximum(pdf_y0_area * pdf_dir0, 1e-12)
                        )[..., None]
        beta_y1 = jnp.where(is_area[..., None], beta_y1, 0.0)
        o0l = offset_ray_origin(y0_p, y0_n, d0l)
        light = self._walk(scene, o0l, d0l, beta_y1, pdf_dir0,
                           (zf < 1.0) & is_area, seed, pixel_id,
                           sample_idx, n_light, _LIGHT_DIM_BASE) \
            if n_light > 0 else None

        # ---------- helpers over static vertex indices --------------------
        def E(name, k):                     # eye vertex k (1-based x_k)
            return eye[name][k - 1]

        def Yv(name, k):                    # light surface vertex y_k (1-based)
            return light[name][k - 1]

        def mat_at(mat_id, uv):
            return resolve_material(scene, mat_id, uv, families)

        def frame_at(ns):
            return Frame.from_normal(ns)

        def bsdf_eval(mat_id, uv, ns, wi_w, wo_w):
            mat = mat_at(mat_id, uv)
            fr = frame_at(ns)
            return eval_bsdf_ex(mat, Frame.to_local(fr, wi_w),
                                Frame.to_local(fr, wo_w), families)

        def bsdf_pdf(mat_id, uv, ns, wi_w, wo_w):
            mat = mat_at(mat_id, uv)
            fr = frame_at(ns)
            return pdf_bsdf_ex(mat, Frame.to_local(fr, wi_w),
                               Frame.to_local(fr, wo_w), families)

        def to_area(pdf_w, d2, cos_tgt):
            return pdf_w * jnp.abs(cos_tgt) / jnp.maximum(d2, 1e-12)

        def seg(p_from, p_to):
            v = p_to - p_from
            d2 = jnp.maximum(jnp.sum(v * v, axis=-1), 1e-12)
            return v * jax.lax.rsqrt(d2)[..., None], d2

        # stored-array area pdfs along each subpath ------------------------
        def eye_fwd_area(k):      # pdf of x_k from x_{k-1} (camera side)
            if k == 1:
                return zf + 1.0   # shared camera edge — cancels (see above)
            return to_area(eye["pdf_fwd_w"][k - 1], eye["d2"][k - 1],
                           dot(eye["wi"][k - 1], eye["ns"][k - 1]))

        def eye_rev_area_stored(k):   # pdf of x_k from x_{k+1} (bsdf back)
            # stored at vertex k+1: pdf_back_w, segment (k+1 → k)
            return to_area(eye["pdf_back_w"][k], eye["d2"][k],
                           dot(eye["wi"][k], eye["ns"][k - 1]))

        def light_fwd_area(k):    # pdf of y_k from y_{k-1} (light side)
            if k == 0:
                return pdf_y0_area
            if k == 1:
                return to_area(pdf_dir0, light["d2"][0],
                               dot(light["wi"][0], light["ns"][0]))
            return to_area(light["pdf_fwd_w"][k - 1], light["d2"][k - 1],
                           dot(light["wi"][k - 1], light["ns"][k - 1]))

        def light_rev_area_stored(k):   # pdf of y_k from y_{k+1}
            ns_k = y0_n if k == 0 else light["ns"][k - 1]
            return to_area(light["pdf_back_w"][k], light["d2"][k],
                           dot(light["wi"][k], ns_k))

        def eye_delta(k):
            return eye["delta"][k - 1]

        def light_delta(k):      # y0 = area emitter: never delta
            if k == 0:
                return zf > 1.0
            return light["delta"][k - 1]

        # ---------- MIS weight for strategy (e, l) ------------------------
        def mis_weight(e, l, rev_e, rev_em1, rev_yl, rev_ylm1):
            """rev_*: connection-specific area pdfs —
            rev_e    pdf of x_e from the light side,
            rev_em1  pdf of x_{e-1} from x_e (light-side incoming),
            rev_yl   pdf of y_{l-1} from the eye side (l ≥ 1),
            rev_ylm1 pdf of y_{l-2} from y_{l-1} (l ≥ 2)."""
            sum_ri = zf
            # eye side: alternatives with shorter eye prefixes (down to
            # eye = {camera, x1}; t=1 excluded)
            ri = zf + 1.0
            for i in range(e, 1, -1):
                if i == e:
                    rev = rev_e
                elif i == e - 1:
                    rev = rev_em1
                else:
                    rev = eye_rev_area_stored(i)
                ri = ri * _remap0(rev) / _remap0(eye_fwd_area(i))
                d_i = eye_delta(i)
                d_im1 = eye_delta(i - 1) if i - 1 >= 1 else (zf > 1.0)
                ok = ~(d_i | d_im1)
                sum_ri = sum_ri + jnp.where(ok, ri, 0.0)
            # light side: alternatives with shorter light prefixes
            ri = zf + 1.0
            for i in range(l - 1, -1, -1):
                if i == l - 1:
                    rev = rev_yl
                elif i == l - 2:
                    rev = rev_ylm1
                else:
                    rev = light_rev_area_stored(i)
                ri = ri * _remap0(rev) / _remap0(light_fwd_area(i))
                d_i = light_delta(i)
                d_im1 = light_delta(i - 1) if i - 1 >= 0 else (zf > 1.0)
                ok = ~(d_i | d_im1)
                sum_ri = sum_ri + jnp.where(ok, ri, 0.0)
            return 1.0 / (1.0 + sum_ri)

        # ---------- strategies ---------------------------------------------
        L = jnp.zeros((n, 3))
        n_rays = (zf.sum() * 0.0).astype(jnp.uint32)

        # env escape on the FIRST eye segment (no emitter-side sampling
        # of env maps here: weight 1, matches hide_emitters semantics)
        first_valid = eye["valid"][0]
        esc = ~first_valid
        L = L + jnp.where(esc[..., None], eval_env(scene, d), 0.0)

        for e in range(1, n_eye + 1):
            xe_valid = eye["valid"][e - 1]
            xe_beta = eye["beta"][e - 1]
            xe_p, xe_ns, xe_ng = (eye["p"][e - 1], eye["ns"][e - 1],
                                  eye["ng"][e - 1])
            xe_wi = eye["wi"][e - 1]
            xe_mat, xe_uv = eye["mat_id"][e - 1], eye["uv"][e - 1]
            prev_p = o if e == 1 else eye["p"][e - 2]
            prev_ns = None if e == 1 else eye["ns"][e - 2]

            # ---- l = 0: eye path hit an emitter ------------------------
            em_here = eye["em_id"][e - 1]
            cos_hit = dot(xe_wi, xe_ng)          # toward the camera side
            is_em = xe_valid & (em_here >= 0) & (cos_hit > 0)
            le_hit = scene.em_radiance[jnp.maximum(em_here, 0)]
            if e == 1:
                w0 = zf + 1.0                    # directly visible light
            else:
                pmf_hit = scene.em_pmf.pmf[jnp.maximum(em_here, 0)]
                # reverse pdfs for the hit strategy: x_e sampled as an
                # emitter position; x_{e-1} from cosine emission
                rev_e0 = pmf_hit / jnp.maximum(
                    scene.em_area[jnp.maximum(em_here, 0)], 1e-12)
                dir_back, d2_back = seg(xe_p, prev_p)
                rev_em1_0 = to_area(
                    jnp.maximum(dot(dir_back, xe_ns), 0.0) * INV_PI,
                    d2_back, dot(dir_back, prev_ns))
                w0 = mis_weight(e, 0, rev_e0, rev_em1_0, None, None)
            L = L + jnp.where(is_em[..., None],
                              xe_beta * le_hit * w0[..., None], 0.0)

            max_l = max_edges - e
            for l in range(1, min(n_light + 1, max_l + 1) + 0):
                if l > n_light + 1:
                    break
                # junction endpoints
                if l == 1:
                    yj_p, yj_ns = y0_p, y0_n
                    yj_valid = is_area
                else:
                    if l - 1 > n_light:
                        break
                    yj_p = light["p"][l - 2]
                    yj_ns = light["ns"][l - 2]
                    yj_valid = light["valid"][l - 2]
                dir_ey, d2_ey = seg(xe_p, yj_p)      # x_e → y junction
                cos_e = dot(dir_ey, xe_ns)
                cos_y = -dot(dir_ey, yj_ns)

                f_e = bsdf_eval(xe_mat, xe_uv, xe_ns, xe_wi, dir_ey)
                pdf_e_fwd_w = bsdf_pdf(xe_mat, xe_uv, xe_ns, xe_wi,
                                       dir_ey)

                if l == 1:
                    # emitter sample contribution: Le·cosY/(d²·pdf_area)
                    radiometric = le * jnp.maximum(cos_y, 0.0)[..., None] \
                        / jnp.maximum(d2_ey * pdf_y0_area, 1e-12)[..., None]
                    contrib = xe_beta * f_e * radiometric
                    ok = xe_valid & yj_valid & (cos_y > 1e-6)
                else:
                    yj_wi = light["wi"][l - 2]
                    yj_mat = light["mat_id"][l - 2]
                    yj_uv = light["uv"][l - 2]
                    yj_beta = light["beta"][l - 2]
                    f_y = bsdf_eval(yj_mat, yj_uv, yj_ns, yj_wi, -dir_ey)
                    contrib = (xe_beta * f_e * f_y * yj_beta
                               / jnp.maximum(d2_ey, 1e-12)[..., None])
                    ok = xe_valid & yj_valid
                ok = ok & jnp.any(contrib > 0, axis=-1)

                # visibility
                so = offset_ray_origin(xe_p, xe_ng, dir_ey)
                dist = jnp.sqrt(d2_ey)
                occ = self._occluded(scene, so, dir_ey, ray_mint(so),
                                     dist * (1.0 - SHADOW_EPSILON))
                ok = ok & ~occ
                n_rays = n_rays + jnp.sum(ok.astype(jnp.uint32))

                # ---- connection-specific reverse pdfs ------------------
                # pdf of x_e from light side:
                if l == 1:
                    pdf_y_to_e_w = jnp.maximum(-cos_y * 0.0
                                               + jnp.maximum(cos_y, 0.0),
                                               0.0) * INV_PI
                    rev_e = to_area(pdf_y_to_e_w, d2_ey, cos_e)
                else:
                    pdf_y_bsdf = bsdf_pdf(yj_mat, yj_uv, yj_ns, yj_wi,
                                          -dir_ey)
                    rev_e = to_area(pdf_y_bsdf, d2_ey, cos_e)
                # pdf of x_{e-1} from x_e when lit from the junction:
                if e == 1:
                    rev_em1 = None   # never used (loop floor is i = 2)
                else:
                    dir_back, d2_back = seg(xe_p, prev_p)
                    pdf_back_w = bsdf_pdf(xe_mat, xe_uv, xe_ns, dir_ey,
                                          dir_back)
                    rev_em1 = to_area(pdf_back_w, d2_back,
                                      dot(dir_back, prev_ns))
                # pdf of y_{l-1} from the eye side:
                rev_yl = to_area(pdf_e_fwd_w, d2_ey, cos_y)
                # pdf of y_{l-2} from y_{l-1} with eye-side incoming:
                if l >= 2:
                    yprev_p = y0_p if l == 2 else light["p"][l - 3]
                    yprev_ns = y0_n if l == 2 else light["ns"][l - 3]
                    dir_yback, d2_yback = seg(yj_p, yprev_p)
                    pdf_yback_w = bsdf_pdf(yj_mat, yj_uv, yj_ns, -dir_ey,
                                           dir_yback)
                    rev_ylm1 = to_area(pdf_yback_w, d2_yback,
                                       dot(dir_yback, yprev_ns))
                else:
                    rev_ylm1 = None

                w = mis_weight(e, l, rev_e, rev_em1, rev_yl, rev_ylm1)
                L = L + jnp.where(ok[..., None],
                                  contrib * w[..., None], 0.0)

        return L, n_rays
