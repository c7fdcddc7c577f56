"""BSDF families with branchless wavefront dispatch.

The reference dispatches `bsdf->sample/eval/pdf` through a virtual call per
ray (ref: include/mitsuba/render/bsdf.h:224,378-449). On an accelerator a wavefront
holds rays touching different materials, so dispatch-by-branching would
serialize; instead every family's closed-form sample/eval/pdf runs on the
whole wavefront (cheap elementwise math) and per-lane results are selected by the
material type code — the reference's lobe-type flag system (bsdf.h:233-296)
becomes data. Conventions match the reference exactly:

  * directions are in the local shading frame, wi = toward viewer;
  * `eval` returns f(wi, wo)·|cosθo| in the solid-angle measure — zero for
    delta lobes (queried with EDiscrete in the reference);
  * `sample` returns (wo, weight = f·cos/pdf, pdf, is_delta);
  * pdfs of smooth lobes are solid-angle densities.

Parameter-table layout: scene.scene.py docstring.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import microfacet as mf
from ..core.fresnel import (fresnel_conductor_exact, fresnel_dielectric,
                            fresnel_diffuse_reflectance)
from ..core.math import Frame, dot, normalize, reflect, refract_local
from ..core.warp import (INV_PI, square_to_cosine_hemisphere,
                         square_to_cosine_hemisphere_pdf)
from ..scene import scene as S


class BSDFSample(NamedTuple):
    wo: jnp.ndarray        # [N, 3] sampled direction (local frame)
    weight: jnp.ndarray    # [N, 3] f·cos/pdf (spectral throughput weight)
    pdf: jnp.ndarray       # [N] solid-angle pdf (delta: discrete prob)
    is_delta: jnp.ndarray  # [N] bool — sampled a Dirac lobe
    eta: jnp.ndarray       # [N] relative ior of the sampled event (RR weight)


def _cos_theta(v):
    return v[..., 2]


# ---------------------------------------------------------------------------
# diffuse (ref: src/bsdfs/diffuse.cpp — Appendix A.3 of SURVEY.md)
# ---------------------------------------------------------------------------

def diffuse_eval(p, wi, wo):
    albedo = p[..., 0:3]
    f = albedo * INV_PI * jnp.maximum(_cos_theta(wo), 0.0)[..., None]
    valid = (_cos_theta(wi) > 0) & (_cos_theta(wo) > 0)
    return jnp.where(valid[..., None], f, 0.0)


def diffuse_pdf(p, wi, wo):
    valid = (_cos_theta(wi) > 0) & (_cos_theta(wo) > 0)
    return jnp.where(valid, square_to_cosine_hemisphere_pdf(wo), 0.0)


def diffuse_sample(p, wi, u2, u1):
    wo = square_to_cosine_hemisphere(u2)
    pdf = square_to_cosine_hemisphere_pdf(wo)
    albedo = p[..., 0:3]
    valid = _cos_theta(wi) > 0
    weight = jnp.where(valid[..., None], albedo, 0.0)
    return wo, weight, jnp.where(valid, pdf, 0.0), jnp.zeros(
        wi.shape[:-1], bool), jnp.ones(wi.shape[:-1])


# ---------------------------------------------------------------------------
# rough diffuse / Oren-Nayar (ref: src/bsdfs/roughdiffuse.cpp, fast approx)
# ---------------------------------------------------------------------------

def roughdiffuse_eval(p, wi, wo):
    albedo = p[..., 0:3]
    # conversion: sigma = alpha/sqrt(2) (roughdiffuse.cpp:129)
    sigma = p[..., 9] * 0.70711
    sigma2 = sigma * sigma
    a = 1.0 - sigma2 / (2.0 * (sigma2 + 0.33))
    b = 0.45 * sigma2 / (sigma2 + 0.09)
    ct_i, ct_o = _cos_theta(wi), _cos_theta(wo)
    st_i = jnp.sqrt(jnp.maximum(1 - ct_i * ct_i, 0.0))
    st_o = jnp.sqrt(jnp.maximum(1 - ct_o * ct_o, 0.0))
    # cos(phi_i - phi_o)
    denom = jnp.maximum(st_i * st_o, 1e-7)
    cos_dphi = jnp.clip(
        (wi[..., 0] * wo[..., 0] + wi[..., 1] * wo[..., 1]) / denom, -1.0, 1.0)
    sin_alpha = jnp.maximum(st_i, st_o)
    tan_beta = jnp.minimum(st_i / jnp.maximum(ct_i, 1e-7),
                           st_o / jnp.maximum(ct_o, 1e-7))
    f = (albedo * INV_PI
         * (a + b * jnp.maximum(cos_dphi, 0.0) * sin_alpha * tan_beta
            )[..., None] * jnp.maximum(ct_o, 0.0)[..., None])
    valid = (ct_i > 0) & (ct_o > 0)
    return jnp.where(valid[..., None], f, 0.0)


def roughdiffuse_pdf(p, wi, wo):
    return diffuse_pdf(p, wi, wo)


def roughdiffuse_sample(p, wi, u2, u1):
    wo = square_to_cosine_hemisphere(u2)
    pdf = diffuse_pdf(p, wi, wo)
    f = roughdiffuse_eval(p, wi, wo)
    w = jnp.where(pdf[..., None] > 0, f / jnp.maximum(pdf, 1e-6)[..., None],
                  0.0)
    return wo, w, pdf, jnp.zeros(wi.shape[:-1], bool), jnp.ones(wi.shape[:-1])


# ---------------------------------------------------------------------------
# LEADR anisotropic rough diffuse (ref: src/bsdfs/aniso_roughdiffuse.cpp)
# ---------------------------------------------------------------------------
# Diffuse microsurface whose slopes follow an anisotropic Gaussian given by
# its first/second moments (μx, μy, E[x²], E[y²], E[xy]) — winmad's LEADR-
# mapping appearance-prefiltering BSDF. The reference evaluates the slope
# expectation with ONE random sample per eval (aniso_roughdiffuse.cpp:144,
# a per-thread sampler pool); here the Gaussian expectation is evaluated
# with a DETERMINISTIC 4-point unscented quadrature (sigma points μ±√2·L·eᵢ
# of the Cholesky factor L): exact for quadratic integrands, no extra RNG
# dims in the replayable counter stream, and zero estimator variance. The
# Smith height-correlated masking term uses the same approxLambda
# rational fit (aniso_roughdiffuse.cpp:85-107).

def _leadr_lambda(w, mux, muy, sx2, sy2, cxy):
    ct = _cos_theta(w)
    st = jnp.sqrt(jnp.maximum(1.0 - ct * ct, 0.0))
    st_s = jnp.maximum(st, 1e-7)
    cphi, sphi = w[..., 0] / st_s, w[..., 1] / st_s
    cot = ct / st_s
    mu_phi = cphi * mux + sphi * muy
    s2_phi = jnp.maximum(cphi * cphi * sx2 + sphi * sphi * sy2
                         + 2.0 * cphi * sphi * cxy, 1e-12)
    v = (cot - mu_phi) / jnp.sqrt(2.0 * s2_phi)
    lam = jnp.where(
        v < 0.0, 1e8,
        jnp.where(v < 1.6,
                  (1.0 - 1.259 * v + 0.396 * v * v)
                  / jnp.maximum(3.535 * v + 2.181 * v * v, 1e-12),
                  0.0))
    return jnp.where(st < 1e-6, 0.0, lam)


def anisoroughdiffuse_eval(p, wi, wo):
    albedo = p[..., 0:3]
    mux, muy = p[..., 3], p[..., 4]
    sx2 = jnp.maximum(p[..., 5] - mux * mux, 1e-8)
    sy2 = jnp.maximum(p[..., 6] - muy * muy, 1e-8)
    cxy = p[..., 7] - mux * muy
    use_vis = p[..., 11] > 0.5

    # mesoscale normal from the mean slope
    ml = jax.lax.rsqrt(mux * mux + muy * muy + 1.0)
    mnx, mny, mnz = -mux * ml, -muy * ml, ml
    wi_dot_n = wi[..., 0] * mnx + wi[..., 1] * mny + wi[..., 2] * mnz

    # height-correlated Smith G2 from the moments (slope-independent)
    lam_i = _leadr_lambda(wi, mux, muy, sx2, sy2, cxy)
    lam_o = _leadr_lambda(wo, mux, muy, sx2, sy2, cxy)
    g2 = 1.0 / (1.0 + lam_i + lam_o)

    # Cholesky of the slope covariance (decorrelated sampling basis, as
    # the reference's conditional Gaussian draw)
    l11 = jnp.sqrt(sx2)
    l21 = cxy / l11
    l22 = jnp.sqrt(jnp.maximum(sy2 - l21 * l21, 1e-12))

    r = 0.0
    s2 = jnp.sqrt(2.0)
    for (z0, z1) in ((s2, 0.0), (-s2, 0.0), (0.0, s2), (0.0, -s2)):
        sx = mux + l11 * z0
        sy = muy + l21 * z0 + l22 * z1
        il = jax.lax.rsqrt(sx * sx + sy * sy + 1.0)
        wmx, wmy, wmz = -sx * il, -sy * il, il
        di = jnp.maximum(wmx * wi[..., 0] + wmy * wi[..., 1]
                         + wmz * wi[..., 2], 0.0)
        do = jnp.maximum(wmx * wo[..., 0] + wmy * wo[..., 1]
                         + wmz * wo[..., 2], 0.0)
        term = di * do / wmz
        term = jnp.where(use_vis & (di > 1e-7) & (do > 1e-7),
                         term * g2,
                         jnp.where(use_vis, 0.0, term))
        r = r + 0.25 * term

    scale = INV_PI * mnz / jnp.maximum(wi_dot_n, 1e-7) * r
    valid = (_cos_theta(wi) > 0) & (_cos_theta(wo) > 0) & (wi_dot_n > 0)
    return jnp.where(valid[..., None], albedo * scale[..., None], 0.0)


def anisoroughdiffuse_pdf(p, wi, wo):
    return diffuse_pdf(p, wi, wo)


def anisoroughdiffuse_sample(p, wi, u2, u1):
    wo = square_to_cosine_hemisphere(u2)
    pdf = diffuse_pdf(p, wi, wo)
    f = anisoroughdiffuse_eval(p, wi, wo)
    w = jnp.where(pdf[..., None] > 0,
                  f / jnp.maximum(pdf, 1e-6)[..., None], 0.0)
    return wo, w, pdf, jnp.zeros(wi.shape[:-1], bool), jnp.ones(
        wi.shape[:-1])


# ---------------------------------------------------------------------------
# conductor — delta mirror (ref: src/bsdfs/conductor.cpp:254-268)
# ---------------------------------------------------------------------------

def conductor_sample(p, wi, u2, u1):
    eta, k, spec = p[..., 0:3], p[..., 3:6], p[..., 6:9]
    wo = reflect(wi)
    valid = _cos_theta(wi) > 0
    f = fresnel_conductor_exact(_cos_theta(wi), eta, k) * spec
    weight = jnp.where(valid[..., None], f, 0.0)
    pdf = jnp.where(valid, 1.0, 0.0)
    return wo, weight, pdf, jnp.ones(wi.shape[:-1], bool), jnp.ones(
        wi.shape[:-1])


def conductor_eval(p, wi, wo):
    return jnp.zeros(wi.shape[:-1] + (3,))


def conductor_pdf(p, wi, wo):
    return jnp.zeros(wi.shape[:-1])


# ---------------------------------------------------------------------------
# rough conductor — GGX/Beckmann microfacet reflection
# (ref: src/bsdfs/roughconductor.cpp:298-418, SURVEY Appendix A.3)
# ---------------------------------------------------------------------------

def _rc_params(p):
    return (p[..., 0:3], p[..., 3:6], p[..., 6:9], p[..., 9], p[..., 10],
            p[..., 11].astype(jnp.int32))


def roughconductor_eval(p, wi, wo):
    eta, k, spec, au, av, dist = _rc_params(p)
    ct_i, ct_o = _cos_theta(wi), _cos_theta(wo)
    h = normalize(wi + wo)
    d = mf.eval_d(h, au, av, dist)
    g = mf.smith_g(wi, wo, h, au, av, dist)
    fr = fresnel_conductor_exact(dot(wi, h), eta, k)
    # f·cosθo = F D G / (4 cosθi)
    val = fr * spec * (d * g / jnp.maximum(4.0 * ct_i, 1e-7))[..., None]
    valid = (ct_i > 1e-7) & (ct_o > 1e-7)
    return jnp.where(valid[..., None], val, 0.0)


def roughconductor_pdf(p, wi, wo):
    """Half-vector pdf with the 1/(4 wo·h) Jacobian
    (roughconductor.cpp:298-323). GGX samples the visible-normal
    distribution (microfacet.h:67 sampleVisible default); Beckmann uses the
    classic D·cosθ strategy (the sampleVisible=false path) so sampling and
    pdf stay an exact pair."""
    _, _, _, au, av, dist = _rc_params(p)
    h = normalize(wi + wo)
    is_ggx = jnp.asarray(dist) == mf.GGX
    pdf_h = jnp.where(is_ggx,
                      mf.pdf_visible(wi, h, au, av, dist),
                      mf.pdf_all(h, au, av, dist))
    pdf = pdf_h / jnp.maximum(4.0 * jnp.abs(dot(wo, h)), 1e-7)
    valid = (_cos_theta(wi) > 1e-7) & (_cos_theta(wo) > 1e-7)
    return jnp.where(valid, pdf, 0.0)


def roughconductor_sample(p, wi, u2, u1):
    eta, k, spec, au, av, dist = _rc_params(p)
    is_ggx = (jnp.asarray(dist) == mf.GGX)[..., None]
    m = jnp.where(is_ggx,
                  mf.sample_visible(wi, u2, au, av, dist),
                  mf.sample_all(u2, au, av, dist))
    wo = 2.0 * dot(wi, m)[..., None] * m - wi
    ct_o = _cos_theta(wo)
    pdf = roughconductor_pdf(p, wi, wo)
    # weight = f·cosθo / pdf (for GGX this reduces to the reference's
    # F·spec·G1(wo), roughconductor.cpp:405-408)
    f = roughconductor_eval(p, wi, wo)
    weight = f / jnp.maximum(pdf, 1e-12)[..., None]
    valid = (_cos_theta(wi) > 1e-7) & (ct_o > 1e-7) & (pdf > 1e-12)
    return (wo, jnp.where(valid[..., None], weight, 0.0),
            jnp.where(valid, pdf, 0.0), jnp.zeros(wi.shape[:-1], bool),
            jnp.ones(wi.shape[:-1]))


# ---------------------------------------------------------------------------
# rough dielectric — microfacet refraction (ref: src/bsdfs/roughdielectric.cpp,
# Walter et al. 2007 formulas)
# ---------------------------------------------------------------------------

def _rd_params(p):
    return (jnp.maximum(p[..., 0], 1e-3), p[..., 1:4], p[..., 4:7],
            p[..., 9], p[..., 10], p[..., 11].astype(jnp.int32))


def _rd_halfvec(wi, wo, eta, reflect_side):
    """Upper-hemisphere micronormal for a (wi, wo) pair: reflection
    m ∝ wi + wo; transmission m ∝ -(wi + η_it·wo) (Walter 2007 eq. 16)."""
    ci = _cos_theta(wi)
    eta_it = jnp.where(ci > 0, eta, 1.0 / eta)
    m_r = normalize(wi + wo)
    m_t = normalize(wi + eta_it[..., None] * wo)
    m = jnp.where(reflect_side[..., None], m_r, m_t)
    return m * jnp.sign(m[..., 2:3])         # orient to +z


def roughdielectric_eval(p, wi, wo):
    """f·|cosθo| for reflection and transmission lobes (Walter eqs. 20/21,
    with the radiance 1/η² transport factor as in roughdielectric.cpp)."""
    eta, spec_r, spec_t, au, av, dist = _rd_params(p)
    ci, co = _cos_theta(wi), _cos_theta(wo)
    reflect_side = ci * co > 0
    m = _rd_halfvec(wi, wo, eta, reflect_side)
    f, _, eta_itm, eta_tim = fresnel_dielectric(dot(wi, m), eta)
    d_ndf = mf.eval_d(m, au, av, dist)
    g = mf.smith_g(wi, wo, m, au, av, dist)

    val_r = spec_r * (f * d_ndf * g
                      / jnp.maximum(4.0 * jnp.abs(ci), 1e-7))[..., None]
    wim = dot(wi, m)
    wom = dot(wo, m)
    denom_t = (wim + eta_itm * wom) ** 2
    # Walter's η_o² factor and the radiance solid-angle compression
    # (1/η_it)² cancel exactly (roughdielectric.cpp eval's factor²·eta²)
    val_t_scalar = ((1.0 - f) * d_ndf * g * jnp.abs(wim * wom)
                    / jnp.maximum(jnp.abs(ci) * denom_t, 1e-7))
    val_t = spec_t * val_t_scalar[..., None]
    val = jnp.where(reflect_side[..., None], val_r, val_t)
    # side condition (Walter 2007): wi and wo must lie on the same side of
    # m for reflection, opposite sides for transmission — directions whose
    # recovered m violates this are outside the lobe's image (pdf/f = 0)
    chirality_ok = jnp.where(reflect_side, wim * wom > 0, wim * wom < 0)
    valid = (jnp.abs(ci) > 1e-7) & chirality_ok
    return jnp.where(valid[..., None], val, 0.0)


def roughdielectric_pdf(p, wi, wo):
    eta, _, _, au, av, dist = _rd_params(p)
    ci, co = _cos_theta(wi), _cos_theta(wo)
    reflect_side = ci * co > 0
    m = _rd_halfvec(wi, wo, eta, reflect_side)
    # m is already oriented to +z (the hemisphere sample_* draws from);
    # only wi needs flipping into that hemisphere
    side = jnp.sign(ci)[..., None]
    is_ggx = jnp.asarray(dist) == mf.GGX
    pdf_m = jnp.where(is_ggx,
                      mf.pdf_visible(wi * side, m, au, av, dist),
                      mf.pdf_all(m, au, av, dist))
    f, _, eta_itm, _ = fresnel_dielectric(dot(wi, m), eta)
    wim, wom = dot(wi, m), dot(wo, m)
    jac_r = 1.0 / jnp.maximum(4.0 * jnp.abs(wom), 1e-7)
    jac_t = (jnp.abs(wom) * eta_itm ** 2
             / jnp.maximum((wim + eta_itm * wom) ** 2, 1e-7))
    pdf = pdf_m * jnp.where(reflect_side, f * jac_r, (1.0 - f) * jac_t)
    chirality_ok = jnp.where(reflect_side, wim * wom > 0, wim * wom < 0)
    return jnp.where((jnp.abs(ci) > 1e-7) & chirality_ok, pdf, 0.0)


def roughdielectric_sample(p, wi, u2, u1):
    eta, spec_r, spec_t, au, av, dist = _rd_params(p)
    ci = _cos_theta(wi)
    side = jnp.sign(ci)[..., None]
    wi_up = wi * side
    is_ggx = (jnp.asarray(dist) == mf.GGX)[..., None]
    m_up = jnp.where(is_ggx, mf.sample_visible(wi_up, u2, au, av, dist),
                     mf.sample_all(u2, au, av, dist))
    # m_up is in the geometric upper hemisphere (matches _rd_halfvec)
    cos_im = dot(wi, m_up)                   # signed
    f, cos_t, eta_itm, eta_tim = fresnel_dielectric(cos_im, eta)
    pick_reflect = u1 < f
    wo_r = 2.0 * cos_im[..., None] * m_up - wi
    # refraction about m_up (generalized refract_local; cos_t carries the
    # transmitted-side sign)
    wo_t = (-eta_tim[..., None] * wi
            + (eta_tim * cos_im + cos_t)[..., None] * m_up)
    wo = jnp.where(pick_reflect[..., None], wo_r, normalize(wo_t))
    pdf = roughdielectric_pdf(p, wi, wo)
    fval = roughdielectric_eval(p, wi, wo)
    weight = fval / jnp.maximum(pdf, 1e-12)[..., None]
    # reject lobe/hemisphere mismatches (roughdielectric.cpp sample():
    # reflection must stay on wi's side, transmission must cross)
    co = _cos_theta(wo)
    side_ok = jnp.where(pick_reflect, ci * co > 1e-10, ci * co < -1e-10)
    valid = (jnp.abs(ci) > 1e-7) & (pdf > 1e-12) & side_ok
    eta_event = jnp.where(pick_reflect, 1.0, eta_itm)
    return (wo, jnp.where(valid[..., None], weight, 0.0),
            jnp.where(valid, pdf, 0.0), jnp.zeros(wi.shape[:-1], bool),
            eta_event)


# ---------------------------------------------------------------------------
# ward — anisotropic glossy (ref: src/bsdfs/ward.cpp, balanced variant)
# ---------------------------------------------------------------------------

def ward_eval(p, wi, wo):
    kd, ks = p[..., 0:3], p[..., 3:6]
    au = jnp.maximum(p[..., 9], 1e-3)
    av = jnp.maximum(p[..., 10], 1e-3)
    ci, co = _cos_theta(wi), _cos_theta(wo)
    h = wi + wo
    ex = -((h[..., 0] / au) ** 2 + (h[..., 1] / av) ** 2) \
        / jnp.maximum(h[..., 2] ** 2, 1e-12)
    spec = (jnp.exp(ex) / (4.0 * jnp.pi * au * av
                           * jnp.maximum(jnp.sqrt(ci * co), 1e-6)))
    f = kd * (INV_PI * co)[..., None] + ks * (spec * co)[..., None]
    valid = (ci > 0) & (co > 0)
    return jnp.where(valid[..., None], f, 0.0)


def _ward_spec_prob(p):
    sd = jnp.max(p[..., 0:3], axis=-1)
    ss = jnp.max(p[..., 3:6], axis=-1)
    return ss / jnp.maximum(sd + ss, 1e-7)


def ward_pdf(p, wi, wo):
    au = jnp.maximum(p[..., 9], 1e-3)
    av = jnp.maximum(p[..., 10], 1e-3)
    prob_s = _ward_spec_prob(p)
    h = normalize(wi + wo)
    ex = -((h[..., 0] / au) ** 2 + (h[..., 1] / av) ** 2) \
        / jnp.maximum(h[..., 2] ** 2, 1e-12)
    pdf_h = jnp.exp(ex) / (jnp.pi * au * av
                           * jnp.maximum(h[..., 2] ** 3, 1e-6))
    pdf_s = pdf_h / jnp.maximum(4.0 * jnp.abs(dot(wo, h)), 1e-6)
    pdf_d = square_to_cosine_hemisphere_pdf(wo)
    valid = (_cos_theta(wi) > 0) & (_cos_theta(wo) > 0)
    return jnp.where(valid, prob_s * pdf_s + (1 - prob_s) * pdf_d, 0.0)


def ward_sample(p, wi, u2, u1):
    au = jnp.maximum(p[..., 9], 1e-3)
    av = jnp.maximum(p[..., 10], 1e-3)
    prob_s = _ward_spec_prob(p)
    pick_s = u1 < prob_s
    # sample half-vector (ward.cpp): φh from anisotropic warp, θh from exp
    phi = jnp.arctan2(av * jnp.sin(2 * jnp.pi * u2[..., 1]),
                      au * jnp.cos(2 * jnp.pi * u2[..., 1]))
    cp, sp = jnp.cos(phi), jnp.sin(phi)
    t2 = -jnp.log(jnp.maximum(u2[..., 0], 1e-7)) \
        / ((cp / au) ** 2 + (sp / av) ** 2)
    ct = 1.0 / jnp.sqrt(1.0 + t2)
    st = jnp.sqrt(jnp.maximum(1 - ct * ct, 0.0))
    h = jnp.stack([st * cp, st * sp, ct], axis=-1)
    wo_s = 2.0 * dot(wi, h)[..., None] * h - wi
    wo_d = square_to_cosine_hemisphere(u2)
    wo = jnp.where(pick_s[..., None], wo_s, wo_d)
    pdf = ward_pdf(p, wi, wo)
    f = ward_eval(p, wi, wo)
    w = jnp.where(pdf[..., None] > 1e-6,
                  f / jnp.maximum(pdf, 1e-6)[..., None], 0.0)
    return wo, w, pdf, jnp.zeros(wi.shape[:-1], bool), jnp.ones(
        wi.shape[:-1])


# ---------------------------------------------------------------------------
# null — pass-through (ref: src/bsdfs/null.cpp)
# ---------------------------------------------------------------------------

def null_sample(p, wi, u2, u1):
    wo = -wi
    ones = jnp.ones(wi.shape[:-1])
    return (wo, jnp.ones(wi.shape[:-1] + (3,)), ones,
            jnp.ones(wi.shape[:-1], bool), ones)


# ---------------------------------------------------------------------------
# smooth dielectric — delta reflect/refract (ref: src/bsdfs/dielectric.cpp)
# ---------------------------------------------------------------------------

def dielectric_sample(p, wi, u2, u1):
    eta_ratio = jnp.maximum(p[..., 0], 1e-3)  # grad-safe on masked lanes
    spec_r, spec_t = p[..., 1:4], p[..., 4:7]
    ct_i = _cos_theta(wi)
    f, cos_t, eta_it, eta_ti = fresnel_dielectric(ct_i, eta_ratio)
    pick_reflect = u1 < f
    wo_r = reflect(wi)
    wo_t = refract_local(wi, eta_ratio, cos_t)
    wo = jnp.where(pick_reflect[..., None], wo_r, wo_t)
    # radiance transport: factor eta_ti² on refraction (dielectric.cpp:232)
    w_r = spec_r
    w_t = spec_t * (eta_ti * eta_ti)[..., None]
    weight = jnp.where(pick_reflect[..., None], w_r, w_t)
    pdf = jnp.where(pick_reflect, f, 1.0 - f)
    eta_event = jnp.where(pick_reflect, 1.0, eta_it)
    return (wo, weight, pdf, jnp.ones(wi.shape[:-1], bool), eta_event)


def dielectric_eval(p, wi, wo):
    return jnp.zeros(wi.shape[:-1] + (3,))


def dielectric_pdf(p, wi, wo):
    return jnp.zeros(wi.shape[:-1])


# ---------------------------------------------------------------------------
# thin dielectric (ref: src/bsdfs/thindielectric.cpp)
# ---------------------------------------------------------------------------

def thindielectric_sample(p, wi, u2, u1):
    eta_ratio = jnp.maximum(p[..., 0], 1e-3)
    spec_r, spec_t = p[..., 1:4], p[..., 4:7]
    ct_i = _cos_theta(wi)
    f, _, _, _ = fresnel_dielectric(jnp.abs(ct_i), eta_ratio)
    # account for internal bounces: R' = R + TRT + ... = R(1 + T²/(1-R²)-ish)
    f = jnp.where(f < 1.0, f + (1.0 - f) * (1.0 - f) * f
                  / jnp.maximum(1.0 - f * f, 1e-7), f)
    pick_reflect = u1 < f
    wo = jnp.where(pick_reflect[..., None], reflect(wi), -wi)
    weight = jnp.where(pick_reflect[..., None], spec_r, spec_t)
    pdf = jnp.where(pick_reflect, f, 1.0 - f)
    return (wo, weight, pdf, jnp.ones(wi.shape[:-1], bool),
            jnp.ones(wi.shape[:-1]))


# ---------------------------------------------------------------------------
# plastic — delta coat over diffuse (ref: src/bsdfs/plastic.cpp)
# ---------------------------------------------------------------------------

def _plastic_parts(p):
    eta = jnp.maximum(p[..., 0], 1e-3)  # grad-safe on masked lanes
    kd = p[..., 1:4]
    ks = p[..., 4:7]
    nonlinear = p[..., 7]
    return eta, kd, ks, nonlinear


def _plastic_diffuse_weight(eta, kd, nonlinear):
    """Internal-scattering-compensated diffuse term (plastic.cpp:~300)."""
    fdr_int = fresnel_diffuse_reflectance(1.0 / eta)
    inv_eta2 = 1.0 / (eta * eta)
    denom = jnp.where(nonlinear[..., None] > 0.5,
                      1.0 - kd * fdr_int[..., None],
                      (1.0 - fdr_int)[..., None])
    return kd * inv_eta2[..., None] / jnp.maximum(denom, 1e-4)


def plastic_eval(p, wi, wo):
    eta, kd, ks, nonlinear = _plastic_parts(p)
    ct_i, ct_o = _cos_theta(wi), _cos_theta(wo)
    fi, _, _, _ = fresnel_dielectric(ct_i, eta)
    fo, _, _, _ = fresnel_dielectric(ct_o, eta)
    diff = _plastic_diffuse_weight(eta, kd, nonlinear)
    f = diff * (INV_PI * (1.0 - fi) * (1.0 - fo)
                * jnp.maximum(ct_o, 0.0))[..., None]
    valid = (ct_i > 0) & (ct_o > 0)
    return jnp.where(valid[..., None], f, 0.0)


def plastic_pdf(p, wi, wo):
    eta, kd, ks, _ = _plastic_parts(p)
    ct_i = _cos_theta(wi)
    fi, _, _, _ = fresnel_dielectric(ct_i, eta)
    prob_spec = fi  # specular sampling weight (plastic.cpp importance split)
    pdf_d = square_to_cosine_hemisphere_pdf(wo) * (1.0 - prob_spec)
    valid = (ct_i > 0) & (_cos_theta(wo) > 0)
    return jnp.where(valid, pdf_d, 0.0)


def plastic_sample(p, wi, u2, u1):
    eta, kd, ks, nonlinear = _plastic_parts(p)
    ct_i = _cos_theta(wi)
    fi, _, _, _ = fresnel_dielectric(ct_i, eta)
    pick_spec = u1 < fi
    wo_s = reflect(wi)
    wo_d = square_to_cosine_hemisphere(u2)
    wo = jnp.where(pick_spec[..., None], wo_s, wo_d)
    # specular event: weight = ks (prob = F cancels Fresnel)
    w_spec = ks
    fo, _, _, _ = fresnel_dielectric(_cos_theta(wo), eta)
    diff = _plastic_diffuse_weight(eta, kd, nonlinear)
    w_diff = diff * ((1.0 - fi) * (1.0 - fo)
                     / jnp.maximum(1.0 - fi, 1e-7))[..., None]
    weight = jnp.where(pick_spec[..., None], w_spec, w_diff)
    pdf = jnp.where(pick_spec, fi,
                    (1.0 - fi) * square_to_cosine_hemisphere_pdf(wo))
    valid = ct_i > 0
    return (wo, jnp.where(valid[..., None], weight, 0.0),
            jnp.where(valid, pdf, 0.0), pick_spec,
            jnp.ones(wi.shape[:-1]))


# ---------------------------------------------------------------------------
# rough plastic — GGX coat over internally-scattering diffuse
# (ref: src/bsdfs/roughplastic.cpp)
# ---------------------------------------------------------------------------

def _rp_parts(p):
    eta = jnp.maximum(p[..., 0], 1e-3)
    kd = p[..., 1:4]
    ks = p[..., 4:7]
    nonlinear = p[..., 7]
    alpha = jnp.maximum(p[..., 9], 1e-4)
    dist = p[..., 11].astype(jnp.int32)
    return eta, kd, ks, nonlinear, alpha, dist


def _rough_t(eta, a, ct, dist):
    """External rough transmittance T(η, α, cosθ) per distribution
    (rtrans tables; ref: roughplastic.cpp m_externalRoughTransmittance)."""
    from . import rtrans
    t_ggx = rtrans.lookup(rtrans.transmittance_table(True), eta, a, ct)
    t_bk = rtrans.lookup(rtrans.transmittance_table(False), eta, a, ct)
    return jnp.where(jnp.asarray(dist) == mf.GGX, t_ggx, t_bk)


def _rough_fdr(eta, a, dist):
    """Internal diffuse Fresnel reflectance 1 − evalDiffuse(α)
    (ref: roughplastic.cpp m_internalRoughTransmittance)."""
    from . import rtrans
    d_ggx = rtrans.lookup_diffuse(rtrans.diffuse_transmittance_inv(True),
                                  eta, a)
    d_bk = rtrans.lookup_diffuse(rtrans.diffuse_transmittance_inv(False),
                                 eta, a)
    return 1.0 - jnp.where(jnp.asarray(dist) == mf.GGX, d_ggx, d_bk)


def roughplastic_eval(p, wi, wo):
    eta, kd, ks, nonlinear, a, dist = _rp_parts(p)
    ci, co = _cos_theta(wi), _cos_theta(wo)
    h = normalize(wi + wo)
    fm, _, _, _ = fresnel_dielectric(dot(wi, h), eta)
    d_ndf = mf.eval_d(h, a, a, dist)
    g = mf.smith_g(wi, wo, h, a, a, dist)
    spec = ks * (fm * d_ndf * g / jnp.maximum(4.0 * ci, 1e-7))[..., None]
    # diffuse base seen through the ROUGH interface: T12·T21 rough
    # transmittance + α-dependent internal Fdr (roughplastic.cpp:~300,
    # tables from bsdf/rtrans.py instead of data/microfacet/*.dat)
    t12 = _rough_t(eta, a, ci, dist)
    t21 = _rough_t(eta, a, co, dist)
    fdr = _rough_fdr(eta, a, dist)
    inv_eta2 = 1.0 / (eta * eta)
    denom = jnp.where(nonlinear[..., None] > 0.5,
                      1.0 - kd * fdr[..., None],
                      (1.0 - fdr)[..., None])
    diff = kd * inv_eta2[..., None] / jnp.maximum(denom, 1e-4)
    diffuse = diff * (INV_PI * t12 * t21
                      * jnp.maximum(co, 0.0))[..., None]
    valid = (ci > 0) & (co > 0)
    return jnp.where(valid[..., None], spec + diffuse, 0.0)


def _rp_spec_prob(p, wi):
    eta, _, _, _, _, _ = _rp_parts(p)
    fi, _, _, _ = fresnel_dielectric(_cos_theta(wi), eta)
    # blend toward 0.5 like the reference's specularSamplingWeight clamp
    return jnp.clip(fi, 0.25, 0.9)


def roughplastic_pdf(p, wi, wo):
    _, _, _, _, a, dist = _rp_parts(p)
    prob_s = _rp_spec_prob(p, wi)
    h = normalize(wi + wo)
    is_ggx = jnp.asarray(dist) == mf.GGX
    pdf_h = jnp.where(is_ggx, mf.pdf_visible(wi, h, a, a, dist),
                      mf.pdf_all(h, a, a, dist))
    pdf_s = pdf_h / jnp.maximum(4.0 * jnp.abs(dot(wo, h)), 1e-7)
    pdf_d = square_to_cosine_hemisphere_pdf(wo)
    valid = (_cos_theta(wi) > 0) & (_cos_theta(wo) > 0)
    return jnp.where(valid, prob_s * pdf_s + (1 - prob_s) * pdf_d, 0.0)


def roughplastic_sample(p, wi, u2, u1):
    _, _, _, _, a, dist = _rp_parts(p)
    prob_s = _rp_spec_prob(p, wi)
    pick_s = u1 < prob_s
    is_ggx = (jnp.asarray(dist) == mf.GGX)[..., None]
    m = jnp.where(is_ggx, mf.sample_visible(wi, u2, a, a, dist),
                  mf.sample_all(u2, a, a, dist))
    wo_s = 2.0 * dot(wi, m)[..., None] * m - wi
    wo_d = square_to_cosine_hemisphere(u2)
    wo = jnp.where(pick_s[..., None], wo_s, wo_d)
    pdf = roughplastic_pdf(p, wi, wo)
    f = roughplastic_eval(p, wi, wo)
    w = jnp.where(pdf[..., None] > 1e-12,
                  f / jnp.maximum(pdf, 1e-12)[..., None], 0.0)
    valid = (_cos_theta(wi) > 0) & (_cos_theta(wo) > 0) & (pdf > 1e-12)
    return (wo, jnp.where(valid[..., None], w, 0.0),
            jnp.where(valid, pdf, 0.0), jnp.zeros(wi.shape[:-1], bool),
            jnp.ones(wi.shape[:-1]))


# ---------------------------------------------------------------------------
# phong (ref: src/bsdfs/phong.cpp) — modified Phong, diffuse+glossy mix
# ---------------------------------------------------------------------------

def phong_eval(p, wi, wo):
    kd, ks, n = p[..., 0:3], p[..., 3:6], p[..., 6]
    ct_o = jnp.maximum(_cos_theta(wo), 0.0)
    r = reflect(wi)
    # floor keeps d/dn alpha^n = ln(alpha)·alpha^n finite on masked lanes
    alpha = jnp.maximum(dot(r, wo), 1e-7)
    glossy = ks * ((n + 2.0) * (0.5 * INV_PI)
                   * jnp.power(alpha, n) * ct_o)[..., None]
    diff = kd * (INV_PI * ct_o)[..., None]
    valid = (_cos_theta(wi) > 0) & (_cos_theta(wo) > 0)
    return jnp.where(valid[..., None], glossy + diff, 0.0)


def _phong_spec_prob(p):
    kd, ks = p[..., 0:3], p[..., 3:6]
    sd = jnp.max(kd, axis=-1)
    ss = jnp.max(ks, axis=-1)
    return ss / jnp.maximum(sd + ss, 1e-7)


def phong_pdf(p, wi, wo):
    n = p[..., 6]
    prob_s = _phong_spec_prob(p)
    r = reflect(wi)
    alpha = jnp.maximum(dot(r, wo), 1e-7)
    pdf_s = (n + 1.0) * (0.5 * INV_PI) * jnp.power(alpha, n)
    pdf_d = square_to_cosine_hemisphere_pdf(wo)
    valid = (_cos_theta(wi) > 0) & (_cos_theta(wo) > 0)
    return jnp.where(valid, prob_s * pdf_s + (1 - prob_s) * pdf_d, 0.0)


def phong_sample(p, wi, u2, u1):
    n = p[..., 6]
    prob_s = _phong_spec_prob(p)
    pick_s = u1 < prob_s
    # glossy: sample lobe around mirror direction
    cos_a = jnp.power(jnp.maximum(u2[..., 0], 1e-7), 1.0 / (n + 1.0))
    sin_a = jnp.sqrt(jnp.maximum(1 - cos_a * cos_a, 0.0))
    phi = 2 * jnp.pi * u2[..., 1]
    local = jnp.stack(
        [sin_a * jnp.cos(phi), sin_a * jnp.sin(phi), cos_a], axis=-1)
    r = reflect(wi)
    frame = Frame.from_normal(r)
    wo_s = Frame.to_world(frame, local)
    wo_d = square_to_cosine_hemisphere(u2)
    wo = jnp.where(pick_s[..., None], wo_s, wo_d)
    pdf = phong_pdf(p, wi, wo)
    f = phong_eval(p, wi, wo)
    w = jnp.where(pdf[..., None] > 1e-6,
                  f / jnp.maximum(pdf, 1e-6)[..., None], 0.0)
    return wo, w, pdf, jnp.zeros(wi.shape[:-1], bool), jnp.ones(
        wi.shape[:-1])


# ---------------------------------------------------------------------------
# difftrans — diffuse transmitter (ref: src/bsdfs/difftrans.cpp)
# ---------------------------------------------------------------------------

def difftrans_eval(p, wi, wo):
    tr = p[..., 0:3]
    f = tr * INV_PI * jnp.abs(_cos_theta(wo))[..., None]
    valid = _cos_theta(wi) * _cos_theta(wo) < 0      # opposite hemispheres
    return jnp.where(valid[..., None], f, 0.0)


def difftrans_pdf(p, wi, wo):
    valid = _cos_theta(wi) * _cos_theta(wo) < 0
    return jnp.where(valid,
                     jnp.abs(_cos_theta(wo)) * INV_PI, 0.0)


def difftrans_sample(p, wi, u2, u1):
    wo_up = square_to_cosine_hemisphere(u2)
    # transmit: flip to the side opposite wi
    sgn = jnp.sign(_cos_theta(wi))[..., None]
    wo = wo_up * jnp.concatenate(
        [jnp.ones_like(sgn), jnp.ones_like(sgn), -sgn], axis=-1)
    pdf = jnp.abs(_cos_theta(wo)) * INV_PI
    tr = p[..., 0:3]
    valid = jnp.abs(_cos_theta(wi)) > 0
    return (wo, jnp.where(valid[..., None], tr, 0.0),
            jnp.where(valid, pdf, 0.0), jnp.zeros(wi.shape[:-1], bool),
            jnp.ones(wi.shape[:-1]))


# ---------------------------------------------------------------------------
# Dispatch tables
# ---------------------------------------------------------------------------

_SMOOTH_EVAL = {
    S.MAT_DIFFTRANS: difftrans_eval,
    S.MAT_ROUGH_PLASTIC: roughplastic_eval,
    S.MAT_DIFFUSE: diffuse_eval,
    S.MAT_ROUGH_DIFFUSE: roughdiffuse_eval,
    S.MAT_ANISO_ROUGHDIFFUSE: anisoroughdiffuse_eval,
    S.MAT_ROUGH_CONDUCTOR: roughconductor_eval,
    S.MAT_ROUGH_DIELECTRIC: roughdielectric_eval,
    S.MAT_PLASTIC: plastic_eval,
    S.MAT_PHONG: phong_eval,
    S.MAT_WARD: ward_eval,
}
_SMOOTH_PDF = {
    S.MAT_DIFFTRANS: difftrans_pdf,
    S.MAT_ROUGH_PLASTIC: roughplastic_pdf,
    S.MAT_DIFFUSE: diffuse_pdf,
    S.MAT_ROUGH_DIFFUSE: roughdiffuse_pdf,
    S.MAT_ANISO_ROUGHDIFFUSE: anisoroughdiffuse_pdf,
    S.MAT_ROUGH_CONDUCTOR: roughconductor_pdf,
    S.MAT_ROUGH_DIELECTRIC: roughdielectric_pdf,
    S.MAT_PLASTIC: plastic_pdf,
    S.MAT_PHONG: phong_pdf,
    S.MAT_WARD: ward_pdf,
}
_SAMPLERS = {
    S.MAT_DIFFTRANS: difftrans_sample,
    S.MAT_ROUGH_PLASTIC: roughplastic_sample,
    S.MAT_DIFFUSE: diffuse_sample,
    S.MAT_ROUGH_DIFFUSE: roughdiffuse_sample,
    S.MAT_ANISO_ROUGHDIFFUSE: anisoroughdiffuse_sample,
    S.MAT_CONDUCTOR: conductor_sample,
    S.MAT_ROUGH_CONDUCTOR: roughconductor_sample,
    S.MAT_DIELECTRIC: dielectric_sample,
    S.MAT_ROUGH_DIELECTRIC: roughdielectric_sample,
    S.MAT_THIN_DIELECTRIC: thindielectric_sample,
    S.MAT_PLASTIC: plastic_sample,
    S.MAT_PHONG: phong_sample,
    S.MAT_WARD: ward_sample,
    S.MAT_NULL: null_sample,
}


def resolve_params(scene: S.SceneData, mat_id, uv=None):
    """Fetch material rows with ONE gather (type/texture codes ride in
    param slots 12-14); texture-driven parameters are resolved here
    (bitmap textures override albedo/roughness — texture/texture.py)."""
    mid = jnp.maximum(mat_id, 0)
    params = scene.mat_params[mid]
    mtype = params[..., 12].astype(jnp.int32)
    if uv is not None:
        params = params.at[..., 22].set(uv[..., 0])
        params = params.at[..., 23].set(uv[..., 1])
    if uv is not None and scene.tex_meta.shape[0] > 1:
        from ..texture.texture import eval_texture
        alb_tex = params[..., 13].astype(jnp.int32)
        has_tex = alb_tex >= 0
        tex_val = eval_texture(scene, jnp.maximum(alb_tex, 0), uv)
        albedo = jnp.where(has_tex[..., None], tex_val, params[..., 0:3])
        params = params.at[..., 0:3].set(albedo)
        rough_tex = params[..., 14].astype(jnp.int32)
        has_r = rough_tex >= 0
        rough = eval_texture(scene, jnp.maximum(rough_tex, 0), uv)[..., 0]
        params = params.at[..., 9].set(
            jnp.where(has_r, rough, params[..., 9]))
    return mtype, params


def _codes(table, families):
    """Dispatch set: all registered families, or the static subset actually
    present in the scene (PathTracer.families) — skipping absent families
    removes their elementwise work entirely."""
    if families is None:
        return list(table.items())
    return [(c, f) for c, f in table.items() if c in families]


def _flip_z(v):
    return v * jnp.array([1.0, 1.0, -1.0])


def _twosided_wi(params, wi):
    """twosided adapter (ref: src/bsdfs/twosided.cpp): materials flagged
    two-sided (param slot 15) see back-side incidence mirrored into the
    upper hemisphere; sampled/evaluated directions mirror back."""
    flip = (params[..., 15] > 0.5) & (wi[..., 2] < 0.0)
    return jnp.where(flip[..., None], _flip_z(wi), wi), flip


def eval_bsdf(mtype, params, wi, wo, families=None):
    """f(wi,wo)·cosθo for the smooth component (zero for delta lobes)."""
    wi, flip = _twosided_wi(params, wi)
    wo = jnp.where(flip[..., None], _flip_z(wo), wo)
    out = jnp.zeros(wi.shape[:-1] + (3,))
    for code, fn in _codes(_SMOOTH_EVAL, families):
        out = jnp.where((mtype == code)[..., None], fn(params, wi, wo), out)
    return out


def pdf_bsdf(mtype, params, wi, wo, families=None):
    wi, flip = _twosided_wi(params, wi)
    wo = jnp.where(flip[..., None], _flip_z(wo), wo)
    out = jnp.zeros(wi.shape[:-1])
    for code, fn in _codes(_SMOOTH_PDF, families):
        out = jnp.where(mtype == code, fn(params, wi, wo), out)
    return out


def sample_bsdf(mtype, params, wi, u2, u1, families=None) -> BSDFSample:
    wi, flip = _twosided_wi(params, wi)
    n = wi.shape[:-1]
    wo = jnp.zeros(wi.shape)
    weight = jnp.zeros(wi.shape[:-1] + (3,))
    pdf = jnp.zeros(n)
    is_delta = jnp.zeros(n, bool)
    eta = jnp.ones(n)
    for code, fn in _codes(_SAMPLERS, families):
        w_, wt_, p_, d_, e_ = fn(params, wi, u2, u1)
        sel = mtype == code
        wo = jnp.where(sel[..., None], w_, wo)
        weight = jnp.where(sel[..., None], wt_, weight)
        pdf = jnp.where(sel, p_, pdf)
        is_delta = jnp.where(sel, d_, is_delta)
        eta = jnp.where(sel, e_, eta)
    wo = jnp.where(flip[..., None], _flip_z(wo), wo)
    return BSDFSample(wo, weight, pdf, is_delta, eta)


# ---------------------------------------------------------------------------
# Composite materials: mixture/blend/mask + smooth coating + normal maps
# (ref: src/bsdfs/{mixturebsdf,blendbsdf,mask,coating,normalmap,bumpmap}.cpp)
#
# The wavefront analog of the reference's nested-BSDF object graph: a
# composite row stores child *row ids*; resolve_material gathers the child
# rows (one extra table gather per lane, only compiled in when the scene's
# static family set contains a composite code) and the _ex entry points
# combine the children branchlessly. Children must be leaf families
# (compile_scene flattens nested composites).
# ---------------------------------------------------------------------------

class MatInfo(NamedTuple):
    """Resolved per-lane material: top row + (for composites) child rows.
    For leaf lanes a/b alias the top row and w_a = 1."""
    mtype: jnp.ndarray      # [N] top type code
    params: jnp.ndarray     # [N, P] top row (textures resolved)
    mtype_a: jnp.ndarray    # [N] child-A type (== mtype for leaves)
    params_a: jnp.ndarray   # [N, P]
    mtype_b: jnp.ndarray    # [N] child-B type
    params_b: jnp.ndarray   # [N, P]
    w_a: jnp.ndarray        # [N] mixture weight of child A


def _has_composite(families):
    return families is None or (S.MAT_MIXTURE in families
                                or S.MAT_COATING in families
                                or S.MAT_ROUGH_COATING in families)


def _has_rough_coat(families):
    return families is None or S.MAT_ROUGH_COATING in families


def _tex_override(scene, params, uv, lod_extent=None):
    """Albedo/roughness texture resolution for one row batch
    (factored out of resolve_params so child rows get it too).

    lod_extent: optional per-lane uv-space footprint extent — converted
    to a mip level per texture (TMIPMap trilinear; footprint.py LoD)."""
    if uv is not None:
        # uv rides in slots 22:24 for uv-driven families (irawan cloth)
        params = params.at[..., 22].set(uv[..., 0])
        params = params.at[..., 23].set(uv[..., 1])
    if uv is None or scene.tex_meta.shape[0] <= 1:
        return params
    from ..texture.texture import MAX_MIPS, eval_texture
    alb_tex = params[..., 13].astype(jnp.int32)
    has_tex = alb_tex >= 0

    def lod_for(tex_ids):
        if lod_extent is None:
            return None
        meta = scene.tex_meta[jnp.maximum(tex_ids, 0) * MAX_MIPS]
        size = jnp.maximum(meta[..., 1], meta[..., 2]).astype(jnp.float32)
        return jnp.clip(jnp.log2(jnp.maximum(lod_extent * size, 1.0)),
                        0.0, MAX_MIPS - 1.0)

    tex_val = eval_texture(scene, jnp.maximum(alb_tex, 0), uv,
                           lod_for(alb_tex))
    albedo = jnp.where(has_tex[..., None], tex_val, params[..., 0:3])
    params = params.at[..., 0:3].set(albedo)
    rough_tex = params[..., 14].astype(jnp.int32)
    has_r = rough_tex >= 0
    rough = eval_texture(scene, jnp.maximum(rough_tex, 0), uv,
                         lod_for(rough_tex))[..., 0]
    return params.at[..., 9].set(jnp.where(has_r, rough, params[..., 9]))


def resolve_material(scene: S.SceneData, mat_id, uv=None,
                     families=None, lod_extent=None) -> MatInfo:
    """Fetch + texture-resolve material rows; resolve composite children.
    When the static family set has no composite codes, the child slots
    alias the top row and compile to nothing extra."""
    mid = jnp.maximum(mat_id, 0)
    params = _tex_override(scene, scene.mat_params[mid], uv, lod_extent)
    mtype = params[..., 12].astype(jnp.int32)
    if not _has_composite(families):
        one = jnp.ones(mtype.shape, params.dtype)
        return MatInfo(mtype, params, mtype, params, mtype, params, one)

    def child(slot):
        cid = params[..., slot].astype(jnp.int32)
        crow = scene.mat_params[jnp.maximum(cid, 0)]
        crow = _tex_override(scene, crow, uv, lod_extent)
        return crow[..., 12].astype(jnp.int32), crow

    is_comp = ((mtype == S.MAT_MIXTURE) | (mtype == S.MAT_COATING)
               | (mtype == S.MAT_ROUGH_COATING))
    ta, pa = child(18)
    tb, pb = child(19)
    mtype_a = jnp.where(is_comp, ta, mtype)
    params_a = jnp.where(is_comp[..., None], pa, params)
    mtype_b = jnp.where(is_comp, tb, mtype)
    params_b = jnp.where(is_comp[..., None], pb, params)
    w = params[..., 20]
    if uv is not None and scene.tex_meta.shape[0] > 1:
        from ..texture.texture import eval_texture
        wtex = params[..., 21].astype(jnp.int32)
        has_w = wtex >= 0
        tw = eval_texture(scene, jnp.maximum(wtex, 0), uv)[..., 0]
        w = jnp.where(has_w, tw, w)
    w = jnp.where(mtype == S.MAT_MIXTURE, w, 1.0)
    return MatInfo(mtype, params, mtype_a, params_a, mtype_b, params_b, w)


# -- smooth-coating helpers (ref: src/bsdfs/coating.cpp) --------------------

def _coat_refract_in(v, eta):
    """Bend a direction into the coat: sinθ' = sinθ/η (same azimuth,
    same hemisphere). Returns the bent unit vector."""
    scale = 1.0 / eta[..., None]
    xy = v[..., 0:2] * scale
    z2 = jnp.maximum(1.0 - jnp.sum(xy * xy, axis=-1), 0.0)
    z = jnp.sqrt(z2) * jnp.sign(v[..., 2])
    return jnp.concatenate([xy, z[..., None]], axis=-1)


def _coat_absorption(p, wi_in, wo_in):
    sigma_t = p[..., 1:4]          # sigma_a · thickness
    path = (1.0 / jnp.maximum(jnp.abs(_cos_theta(wi_in)), 1e-4)
            + 1.0 / jnp.maximum(jnp.abs(_cos_theta(wo_in)), 1e-4))
    return jnp.exp(-sigma_t * path[..., None])


def _coating_eval(mat: MatInfo, wi, wo, families):
    """f·cosθo of the smooth (nested) component under the coat; the delta
    coat lobe only appears in sample()."""
    p = mat.params
    eta = jnp.maximum(p[..., 0], 1.0 + 1e-4)
    fi, _, _, _ = fresnel_dielectric(_cos_theta(wi), eta)
    fo, _, _, _ = fresnel_dielectric(_cos_theta(wo), eta)
    wi_in = _coat_refract_in(wi, eta)
    wo_in = _coat_refract_in(wo, eta)
    f_n = eval_bsdf(mat.mtype_a, mat.params_a, wi_in, wo_in, families)
    a = _coat_absorption(p, wi_in, wo_in)
    # eval_n carries cosθo'; convert to cosθo and apply the 1/η² radiance
    # compression (derivation in the module docstring of this block)
    jac = (jnp.abs(_cos_theta(wo))
           / jnp.maximum(jnp.abs(_cos_theta(wo_in)), 1e-6)) / (eta * eta)
    return f_n * a * ((1.0 - fi) * (1.0 - fo) * jac)[..., None]


def _coating_pdf(mat: MatInfo, wi, wo, families):
    p = mat.params
    eta = jnp.maximum(p[..., 0], 1.0 + 1e-4)
    fi, _, _, _ = fresnel_dielectric(_cos_theta(wi), eta)
    wi_in = _coat_refract_in(wi, eta)
    wo_in = _coat_refract_in(wo, eta)
    pdf_n = pdf_bsdf(mat.mtype_a, mat.params_a, wi_in, wo_in, families)
    # solid-angle pdf of the nested strategy mapped out through the coat:
    # dω'/dω = cosθo / (η² cosθo'); selection prob (1-F(wi))
    return (1.0 - fi) * pdf_n * jnp.abs(_cos_theta(wo)) \
        / jnp.maximum((eta * eta) * jnp.abs(_cos_theta(wo_in)), 1e-9)


def _coat_nested_sample(mat: MatInfo, wi, u2, u1, fi, families):
    """Sample the nested child through the coat interface. u1 is the raw
    lobe-choice number; fi = F(wi) the coat pick probability. Returns
    (wo_n, w_nested, pdf_nested, ok_n, delta_n) where pdf_nested includes
    the (1-fi) selection probability and the refraction Jacobian."""
    p = mat.params
    eta = jnp.maximum(p[..., 0], 1.0 + 1e-4)
    # rescale u1 for the child's own lobe choice
    u1_n = jnp.clip((u1 - fi) / jnp.maximum(1.0 - fi, 1e-6), 0.0,
                    1.0 - 1e-6)
    wi_in = _coat_refract_in(wi, eta)
    wo_n_in, w_n, pdf_n, delta_n, _ = _dispatch_sample(
        mat.mtype_a, mat.params_a, wi_in, u2, u1_n, families)
    # refract the nested sample back out: sinθ = η sinθ' (TIR ⇒ dead)
    xy = wo_n_in[..., 0:2] * eta[..., None]
    sin2 = jnp.sum(xy * xy, axis=-1)
    tir = sin2 >= 1.0
    z = jnp.sqrt(jnp.maximum(1.0 - sin2, 0.0)) * jnp.sign(
        wo_n_in[..., 2])
    wo_n = jnp.concatenate([xy, z[..., None]], axis=-1)
    fo, _, _, _ = fresnel_dielectric(_cos_theta(wo_n), eta)
    a = _coat_absorption(p, wi_in, wo_n_in)
    w_nested = w_n * a * (1.0 - fo)[..., None]
    pdf_nested = (1.0 - fi) * pdf_n * jnp.abs(_cos_theta(wo_n)) \
        / jnp.maximum((eta * eta) * jnp.abs(_cos_theta(wo_n_in)), 1e-9)
    ok_n = ~tir & (pdf_n > 0)
    return wo_n, w_nested, pdf_nested, ok_n, delta_n


def _coating_sample(mat: MatInfo, wi, u2, u1, families):
    p = mat.params
    eta = jnp.maximum(p[..., 0], 1.0 + 1e-4)
    fi, _, _, _ = fresnel_dielectric(_cos_theta(wi), eta)
    pick_spec = u1 < fi
    # delta coat reflection
    wo_s = reflect(wi)
    wo_n, w_nested, pdf_nested, ok_n, delta_n = _coat_nested_sample(
        mat, wi, u2, u1, fi, families)

    wo = jnp.where(pick_spec[..., None], wo_s, wo_n)
    weight = jnp.where(pick_spec[..., None],
                       p[..., 4:5] * jnp.ones_like(w_nested),
                       jnp.where(ok_n[..., None], w_nested, 0.0))
    pdf = jnp.where(pick_spec, fi, jnp.where(ok_n, pdf_nested, 0.0))
    is_delta = pick_spec | (~pick_spec & delta_n)
    return wo, weight, pdf, is_delta, jnp.ones(wi.shape[:-1])


# -- rough-coating (ref: src/bsdfs/roughcoating.cpp) -------------------------
# A microfacet-roughened dielectric layer over a nested BSDF. The coat
# reflection is a GGX/Beckmann lobe (visible-normal sampled); the nested
# interaction reuses the smooth coat's refraction bending + absorption
# (the reference also refracts through the macro normal,
# roughcoating.cpp `refractTo`). Both lobes are smooth, so sample()
# returns MIS-consistent eval/pdf weights except for delta children.

def _rough_coat_spec_eval(p, wi, wo):
    """f·cosθo of the rough coat reflection lobe (upper hemisphere)."""
    alpha = mf.clamp_alpha(p[..., 9])
    dist = p[..., 11]
    h = normalize(wi + wo)
    d = mf.eval_d(h, alpha, alpha, dist)
    f, _, _, _ = fresnel_dielectric(
        dot(wi, h), jnp.maximum(p[..., 0], 1.0 + 1e-4))
    g = mf.smith_g(wi, wo, h, alpha, alpha, dist)
    ci = _cos_theta(wi)
    val = p[..., 4] * f * d * g / jnp.maximum(4.0 * jnp.abs(ci), 1e-7)
    return jnp.where((ci > 0) & (_cos_theta(wo) > 0), val, 0.0)


def _rough_coat_spec_pdf(p, wi, wo):
    alpha = mf.clamp_alpha(p[..., 9])
    dist = p[..., 11]
    h = normalize(wi + wo)
    pdf_h = mf.pdf_visible(wi, h, alpha, alpha, dist)
    pdf = pdf_h / jnp.maximum(4.0 * jnp.abs(dot(wo, h)), 1e-7)
    return jnp.where((_cos_theta(wi) > 0) & (_cos_theta(wo) > 0), pdf, 0.0)


def _roughcoating_eval(mat: MatInfo, wi, wo, families):
    spec = _rough_coat_spec_eval(mat.params, wi, wo)
    return _coating_eval(mat, wi, wo, families) + spec[..., None]


def _roughcoating_pdf(mat: MatInfo, wi, wo, families):
    eta = jnp.maximum(mat.params[..., 0], 1.0 + 1e-4)
    fi, _, _, _ = fresnel_dielectric(_cos_theta(wi), eta)
    return (fi * _rough_coat_spec_pdf(mat.params, wi, wo)
            + _coating_pdf(mat, wi, wo, families))


def _roughcoating_sample(mat: MatInfo, wi, u2, u1, families):
    p = mat.params
    alpha = mf.clamp_alpha(p[..., 9])
    dist = p[..., 11]
    eta = jnp.maximum(p[..., 0], 1.0 + 1e-4)
    fi, _, _, _ = fresnel_dielectric(_cos_theta(wi), eta)
    pick_spec = u1 < fi
    m = mf.sample_visible(wi, u2, alpha, alpha, dist)
    wo_s = 2.0 * dot(wi, m)[..., None] * m - wi
    wo_n, w_nested, pdf_nested, ok_n, delta_n = _coat_nested_sample(
        mat, wi, u2, u1, fi, families)

    wo = jnp.where(pick_spec[..., None], wo_s, wo_n)
    # smooth lanes: full combined eval/pdf (MIS-correct across both lobes)
    f_all = _roughcoating_eval(mat, wi, wo, families)
    pdf_all = _roughcoating_pdf(mat, wi, wo, families)
    w_smooth = jnp.where(pdf_all[..., None] > 1e-9,
                         f_all / jnp.maximum(pdf_all, 1e-9)[..., None], 0.0)
    nested_delta = ~pick_spec & delta_n
    weight = jnp.where(nested_delta[..., None],
                       jnp.where(ok_n[..., None], w_nested, 0.0), w_smooth)
    pdf = jnp.where(nested_delta,
                    jnp.where(ok_n, pdf_nested, 0.0), pdf_all)
    # a spec pick below the horizon is a dead sample
    dead = pick_spec & (_cos_theta(wo_s) <= 0)
    weight = jnp.where(dead[..., None], 0.0, weight)
    pdf = jnp.where(dead, 0.0, pdf)
    return wo, weight, pdf, nested_delta, jnp.ones(wi.shape[:-1])


def _dispatch_sample(mtype, params, wi, u2, u1, families):
    """Raw family-table sample dispatch (twosided handled by callers)."""
    n = wi.shape[:-1]
    wo = jnp.zeros(wi.shape)
    weight = jnp.zeros(wi.shape[:-1] + (3,))
    pdf = jnp.zeros(n)
    is_delta = jnp.zeros(n, bool)
    eta = jnp.ones(n)
    for code, fn in _codes(_SAMPLERS, families):
        w_, wt_, p_, d_, e_ = fn(params, wi, u2, u1)
        sel = mtype == code
        wo = jnp.where(sel[..., None], w_, wo)
        weight = jnp.where(sel[..., None], wt_, weight)
        pdf = jnp.where(sel, p_, pdf)
        is_delta = jnp.where(sel, d_, is_delta)
        eta = jnp.where(sel, e_, eta)
    return wo, weight, pdf, is_delta, eta


# -- public _ex entry points (MatInfo-aware) --------------------------------

def eval_bsdf_ex(mat: MatInfo, wi, wo, families=None):
    """Mixture-/coating-aware eval. Leaf lanes cost exactly eval_bsdf."""
    if not _has_composite(families):
        return eval_bsdf(mat.mtype, mat.params, wi, wo, families)
    wi_t, flip = _twosided_wi(mat.params, wi)
    wo_t = jnp.where(flip[..., None], _flip_z(wo), wo)
    f_a = eval_bsdf(mat.mtype_a, mat.params_a, wi_t, wo_t, families)
    is_mix = mat.mtype == S.MAT_MIXTURE
    is_coat = mat.mtype == S.MAT_COATING
    f = f_a
    if families is None or S.MAT_MIXTURE in families:
        f_b = eval_bsdf(mat.mtype_b, mat.params_b, wi_t, wo_t, families)
        f = jnp.where(is_mix[..., None],
                      mat.w_a[..., None] * f_a
                      + (1.0 - mat.w_a)[..., None] * f_b, f)
    if families is None or S.MAT_COATING in families:
        f_c = _coating_eval(mat, wi_t, wo_t, families)
        f = jnp.where(is_coat[..., None], f_c, f)
    if _has_rough_coat(families):
        is_rc = mat.mtype == S.MAT_ROUGH_COATING
        f_rc = _roughcoating_eval(mat, wi_t, wo_t, families)
        f = jnp.where(is_rc[..., None], f_rc, f)
    return f


def pdf_bsdf_ex(mat: MatInfo, wi, wo, families=None):
    if not _has_composite(families):
        return pdf_bsdf(mat.mtype, mat.params, wi, wo, families)
    wi_t, flip = _twosided_wi(mat.params, wi)
    wo_t = jnp.where(flip[..., None], _flip_z(wo), wo)
    p_a = pdf_bsdf(mat.mtype_a, mat.params_a, wi_t, wo_t, families)
    is_mix = mat.mtype == S.MAT_MIXTURE
    is_coat = mat.mtype == S.MAT_COATING
    p = p_a
    if families is None or S.MAT_MIXTURE in families:
        p_b = pdf_bsdf(mat.mtype_b, mat.params_b, wi_t, wo_t, families)
        p = jnp.where(is_mix,
                      mat.w_a * p_a + (1.0 - mat.w_a) * p_b, p)
    if families is None or S.MAT_COATING in families:
        p_c = _coating_pdf(mat, wi_t, wo_t, families)
        p = jnp.where(is_coat, p_c, p)
    if _has_rough_coat(families):
        is_rc = mat.mtype == S.MAT_ROUGH_COATING
        p_rc = _roughcoating_pdf(mat, wi_t, wo_t, families)
        p = jnp.where(is_rc, p_rc, p)
    return p


def sample_bsdf_ex(mat: MatInfo, wi, u2, u1, families=None) -> BSDFSample:
    if not _has_composite(families):
        return sample_bsdf(mat.mtype, mat.params, wi, u2, u1, families)
    wi_t, flip = _twosided_wi(mat.params, wi)
    is_mix = mat.mtype == S.MAT_MIXTURE
    is_coat = mat.mtype == S.MAT_COATING

    # leaf lanes (and child-A reuse): dispatch on mtype_a
    wo, weight, pdf, is_delta, eta = _dispatch_sample(
        mat.mtype_a, mat.params_a, wi_t, u2, u1, families)

    if families is None or S.MAT_MIXTURE in families:
        # mixture: pick child by u1 (sampleReuse as in mixturebsdf.cpp)
        pick_a = u1 < mat.w_a
        u1_a = jnp.clip(u1 / jnp.maximum(mat.w_a, 1e-6), 0.0, 1.0 - 1e-6)
        u1_b = jnp.clip((u1 - mat.w_a) / jnp.maximum(1.0 - mat.w_a, 1e-6),
                        0.0, 1.0 - 1e-6)
        wo_a, wt_a, pdf_a, d_a, eta_a = _dispatch_sample(
            mat.mtype_a, mat.params_a, wi_t, u2, u1_a, families)
        wo_b, wt_b, pdf_b, d_b, eta_b = _dispatch_sample(
            mat.mtype_b, mat.params_b, wi_t, u2, u1_b, families)
        wo_m = jnp.where(pick_a[..., None], wo_a, wo_b)
        d_m = jnp.where(pick_a, d_a, d_b)
        eta_m = jnp.where(pick_a, eta_a, eta_b)
        # smooth sampled lobe: full mixture f/pdf (MIS-correct);
        # delta sampled lobe: child weight (other child is measure-zero)
        f_mix = (mat.w_a[..., None]
                 * eval_bsdf(mat.mtype_a, mat.params_a, wi_t, wo_m,
                             families)
                 + (1.0 - mat.w_a)[..., None]
                 * eval_bsdf(mat.mtype_b, mat.params_b, wi_t, wo_m,
                             families))
        pdf_mix = (mat.w_a * pdf_bsdf(mat.mtype_a, mat.params_a, wi_t,
                                      wo_m, families)
                   + (1.0 - mat.w_a) * pdf_bsdf(mat.mtype_b, mat.params_b,
                                                wi_t, wo_m, families))
        w_pick = jnp.where(pick_a, mat.w_a, 1.0 - mat.w_a)
        pdf_delta = w_pick * jnp.where(pick_a, pdf_a, pdf_b)
        wt_delta = jnp.where(pick_a[..., None], wt_a, wt_b)
        wt_smooth = jnp.where(pdf_mix[..., None] > 1e-12,
                              f_mix / jnp.maximum(pdf_mix, 1e-12)[..., None],
                              0.0)
        wo = jnp.where(is_mix[..., None], wo_m, wo)
        weight = jnp.where(is_mix[..., None],
                           jnp.where(d_m[..., None], wt_delta, wt_smooth),
                           weight)
        pdf = jnp.where(is_mix, jnp.where(d_m, pdf_delta, pdf_mix), pdf)
        is_delta = jnp.where(is_mix, d_m, is_delta)
        eta = jnp.where(is_mix, eta_m, eta)

    if families is None or S.MAT_COATING in families:
        wo_c, wt_c, pdf_c, d_c, eta_c = _coating_sample(
            mat, wi_t, u2, u1, families)
        wo = jnp.where(is_coat[..., None], wo_c, wo)
        weight = jnp.where(is_coat[..., None], wt_c, weight)
        pdf = jnp.where(is_coat, pdf_c, pdf)
        is_delta = jnp.where(is_coat, d_c, is_delta)
        eta = jnp.where(is_coat, eta_c, eta)

    if _has_rough_coat(families):
        is_rc = mat.mtype == S.MAT_ROUGH_COATING
        wo_r, wt_r, pdf_r, d_r, eta_r = _roughcoating_sample(
            mat, wi_t, u2, u1, families)
        wo = jnp.where(is_rc[..., None], wo_r, wo)
        weight = jnp.where(is_rc[..., None], wt_r, weight)
        pdf = jnp.where(is_rc, pdf_r, pdf)
        is_delta = jnp.where(is_rc, d_r, is_delta)
        eta = jnp.where(is_rc, eta_r, eta)

    wo = jnp.where(flip[..., None], _flip_z(wo), wo)
    return BSDFSample(wo, weight, pdf, is_delta, eta)


def perturb_shading_frame(scene: S.SceneData, mat: MatInfo, frame, uv,
                          tangent=None):
    """Normal-/bump-map frame perturbation (ref: src/bsdfs/normalmap.cpp,
    bumpmap.cpp). Texture slot 16 holds either a tangent-space normal map
    (bump_scale == 0) or a height map (bump_scale > 0, finite-difference
    gradient). Applied before BSDF dispatch; returns the new frame."""
    if scene.tex_meta.shape[0] <= 1 or uv is None:
        return frame
    from ..texture.texture import eval_texture
    ntex = mat.params[..., 16].astype(jnp.int32)
    has = ntex >= 0
    tid = jnp.maximum(ntex, 0)
    s, t, n = frame
    tv = eval_texture(scene, tid, uv)
    is_bump = mat.params[..., 17] > 0.0
    # normal-map branch: decode [0,1]³ → tangent-space normal
    nl = tv * 2.0 - 1.0
    # bump branch: forward differences of the height channel
    eps = 1e-3
    du = (eval_texture(scene, tid, uv + jnp.asarray([eps, 0.0]))[..., 0]
          - tv[..., 0]) / eps
    dv = (eval_texture(scene, tid, uv + jnp.asarray([0.0, eps]))[..., 0]
          - tv[..., 0]) / eps
    scalev = mat.params[..., 17]
    nb = jnp.stack([-du * scalev, -dv * scalev,
                    jnp.ones_like(du)], axis=-1)
    nloc = jnp.where(is_bump[..., None], nb, nl)
    nloc = nloc / jnp.maximum(
        jnp.sqrt(jnp.sum(nloc * nloc, axis=-1, keepdims=True)), 1e-6)
    n_new = (s * nloc[..., 0:1] + t * nloc[..., 1:2] + n * nloc[..., 2:3])
    n_new = jnp.where(has[..., None], n_new, n)
    s2, t2, n2 = Frame.from_normal(n_new)
    return (jnp.where(has[..., None], s2, s),
            jnp.where(has[..., None], t2, t),
            jnp.where(has[..., None], n2, n))


# ---------------------------------------------------------------------------
# hk — Hanrahan-Krueger thin slab, single scattering (ref: src/bsdfs/hk.cpp)
# params: sigma_s 0:3, sigma_a 3:6, g 6, thickness 7
# ---------------------------------------------------------------------------

def _hk_terms(p, wi, wo):
    sig_s = p[..., 0:3]
    sig_a = p[..., 3:6]
    g = p[..., 6:7]
    d = p[..., 7:8]
    sig_t = sig_s + sig_a
    tau = sig_t * d
    albedo = jnp.where(sig_t > 0, sig_s / jnp.maximum(sig_t, 1e-12), 0.0)
    mu_i = jnp.abs(_cos_theta(wi))[..., None]
    mu_o = jnp.abs(_cos_theta(wo))[..., None]
    # HG phase at the scattering angle inside the (index-matched) slab
    cosg = dot(-wi, wo)[..., None]
    ph = ((1.0 - g * g)
          / jnp.maximum((1.0 + g * g + 2.0 * g * cosg) ** 1.5, 1e-9)
          / (4.0 * jnp.pi))
    return albedo, tau, mu_i, mu_o, ph


def hk_eval(p, wi, wo):
    """Single-scattering reflection + transmission of the slab
    (HK '93 eqs; hk.cpp eval). Returns f·|cosθo|."""
    albedo, tau, mu_i, mu_o, ph = _hk_terms(p, wi, wo)
    refl = (_cos_theta(wi) * _cos_theta(wo) > 0)[..., None]
    # reflection: α·P·μo/(μi+μo)·(1 − e^{−τ(1/μi+1/μo)})
    f_r = albedo * ph / jnp.maximum(mu_i + mu_o, 1e-6) \
        * (1.0 - jnp.exp(-tau * (1.0 / jnp.maximum(mu_i, 1e-4)
                                 + 1.0 / jnp.maximum(mu_o, 1e-4))))
    # transmission (μi ≠ μo): α·P/(μi−μo)·(e^{−τ/μi} − e^{−τ/μo});
    # series limit at μi = μo: α·P·τ/μ²·e^{−τ/μ}
    dm = mu_i - mu_o
    near = jnp.abs(dm) < 1e-4
    et_i = jnp.exp(-tau / jnp.maximum(mu_i, 1e-4))
    et_o = jnp.exp(-tau / jnp.maximum(mu_o, 1e-4))
    f_t_gen = albedo * ph / jnp.where(near, 1.0, dm) * (et_i - et_o)
    f_t_lim = albedo * ph * tau \
        / jnp.maximum(mu_i * mu_i, 1e-6) * et_i
    f_t = jnp.where(near, f_t_lim, f_t_gen)
    f = jnp.where(refl, f_r, f_t)
    valid = jnp.abs(_cos_theta(wi)) > 1e-5
    return jnp.where(valid[..., None], f * mu_o, 0.0)


def hk_pdf(p, wi, wo):
    # sampling strategy: 50/50 reflect/transmit, cosine-weighted each side
    c = jnp.abs(_cos_theta(wo)) * INV_PI * 0.5
    return jnp.where(jnp.abs(_cos_theta(wi)) > 1e-5, c, 0.0)


def hk_sample(p, wi, u2, u1):
    wo_up = square_to_cosine_hemisphere(u2)
    sgn = jnp.sign(_cos_theta(wi))[..., None]
    transmit = (u1 < 0.5)[..., None]
    wo = wo_up * jnp.concatenate(
        [jnp.ones_like(sgn), jnp.ones_like(sgn),
         jnp.where(transmit, -sgn, sgn)], axis=-1)
    pdf = hk_pdf(p, wi, wo)
    f = hk_eval(p, wi, wo)
    w = jnp.where(pdf[..., None] > 1e-9,
                  f / jnp.maximum(pdf, 1e-9)[..., None], 0.0)
    return (wo, w, pdf, jnp.zeros(wi.shape[:-1], bool),
            jnp.ones(wi.shape[:-1]))


# ---------------------------------------------------------------------------
# tabulated BSDF (ref: winmad src/bsdfs/tabulated_bsdf.cpp:16 — 4D BTF
# tables; here f(θi, θo, Δφ) per channel). Tables are bound at scene
# compile (bsdf/tabulated_pool.py) — compile-time constants like every
# other scene table, read by closure inside jit.
# params: 0 = table index, 1 = scale
# ---------------------------------------------------------------------------

def tabulated_eval(p, wi, wo):
    from .tabulated_pool import get_tables
    tab = get_tables()
    if tab is None:
        return jnp.zeros(wi.shape[:-1] + (3,))
    k, n_ti, n_to, n_ph, _ = tab.shape
    idx = jnp.clip(p[..., 0].astype(jnp.int32), 0, k - 1)
    scale = p[..., 1:2]
    mu_i = jnp.abs(_cos_theta(wi))
    mu_o = jnp.abs(_cos_theta(wo))
    refl = _cos_theta(wi) * _cos_theta(wo) > 0
    ti = jnp.arccos(jnp.clip(mu_i, 0.0, 1.0)) / (jnp.pi / 2)
    to = jnp.arccos(jnp.clip(mu_o, 0.0, 1.0)) / (jnp.pi / 2)
    dphi = jnp.arctan2(wo[..., 1], wo[..., 0]) \
        - jnp.arctan2(wi[..., 1], wi[..., 0])
    dphi = jnp.mod(dphi, 2.0 * jnp.pi) / (2.0 * jnp.pi)

    def lerp_axis(x, n):
        f = jnp.clip(x * n - 0.5, 0.0, n - 1.0)
        i0 = jnp.floor(f).astype(jnp.int32)
        i1 = jnp.minimum(i0 + 1, n - 1)
        return i0, i1, f - i0

    a0, a1, fa = lerp_axis(ti, n_ti)
    b0, b1, fb = lerp_axis(to, n_to)
    c0 = jnp.floor(dphi * n_ph).astype(jnp.int32) % n_ph
    c1 = (c0 + 1) % n_ph
    fc = dphi * n_ph - jnp.floor(dphi * n_ph)

    def tap(a, b, c):
        return tab[idx, a, b, c]

    v = ((tap(a0, b0, c0) * (1 - fc)[..., None]
          + tap(a0, b0, c1) * fc[..., None]) * (1 - fb)[..., None]
         + (tap(a0, b1, c0) * (1 - fc)[..., None]
            + tap(a0, b1, c1) * fc[..., None]) * fb[..., None]
         ) * (1 - fa)[..., None] + (
        (tap(a1, b0, c0) * (1 - fc)[..., None]
         + tap(a1, b0, c1) * fc[..., None]) * (1 - fb)[..., None]
        + (tap(a1, b1, c0) * (1 - fc)[..., None]
           + tap(a1, b1, c1) * fc[..., None]) * fb[..., None]
    ) * fa[..., None]
    f = v * scale * mu_o[..., None]
    return jnp.where((refl & (mu_i > 1e-5))[..., None], f, 0.0)


def tabulated_pdf(p, wi, wo):
    same = _cos_theta(wi) * _cos_theta(wo) > 0
    return jnp.where(same & (jnp.abs(_cos_theta(wi)) > 1e-5),
                     jnp.abs(_cos_theta(wo)) * INV_PI, 0.0)


def tabulated_sample(p, wi, u2, u1):
    wo_up = square_to_cosine_hemisphere(u2)
    sgn = jnp.sign(_cos_theta(wi))[..., None]
    wo = wo_up * jnp.concatenate(
        [jnp.ones_like(sgn), jnp.ones_like(sgn), sgn], axis=-1)
    pdf = tabulated_pdf(p, wi, wo)
    f = tabulated_eval(p, wi, wo)
    w = jnp.where(pdf[..., None] > 1e-9,
                  f / jnp.maximum(pdf, 1e-9)[..., None], 0.0)
    return (wo, w, pdf, jnp.zeros(wi.shape[:-1], bool),
            jnp.ones(wi.shape[:-1]))


_SMOOTH_EVAL[S.MAT_HK] = hk_eval
_SMOOTH_PDF[S.MAT_HK] = hk_pdf
_SAMPLERS[S.MAT_HK] = hk_sample
_SMOOTH_EVAL[S.MAT_TABULATED] = tabulated_eval
_SMOOTH_PDF[S.MAT_TABULATED] = tabulated_pdf
_SAMPLERS[S.MAT_TABULATED] = tabulated_sample

from .irawan import irawan_eval, irawan_pdf, irawan_sample  # noqa: E402

_SMOOTH_EVAL[S.MAT_IRAWAN] = irawan_eval
_SMOOTH_PDF[S.MAT_IRAWAN] = irawan_pdf
_SAMPLERS[S.MAT_IRAWAN] = irawan_sample
