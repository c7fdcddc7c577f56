"""Phase functions: isotropic, HG, Rayleigh, Kajiya-Kay, SGGX, mixture.

Wavefront counterparts of the reference phase plugins (ref: src/phase/
{isotropic,hg,rayleigh,kkay,microflake,mixturephase,SGGX}.cpp; interface
phase.h:148-193). Conventions match the reference exactly: wi points back
toward the radiance source (wi = -ray.d, BSDF-style), wo is the new
outgoing direction (next ray direction); HG eval takes dot(wi, wo) so
forward scattering (g > 0) peaks at dot(wi, wo) = -1 (hg.cpp:79-113,
SURVEY Appendix A.7). All fns broadcast over wavefront axes; g may be a
per-lane array.

The SGGX microflake distribution (winmad's research centerpiece, ref:
src/phase/SGGX.cpp:93-127) represents an anisotropic flake NDF as a 3×3
symmetric positive-definite matrix S; σ(d) = √(dᵀSd) is the projected
area, D(m) = 1/(π √|S| (mᵀS⁻¹m)²) the NDF, and the specular microflake
phase is f(wi→wo) = D_vis(h) / (4 σ(wi)) with h the half vector
(Heitz et al. 2015, "The SGGX microflake distribution").
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core.math import Frame
from ..core.warp import INV_FOUR_PI

PHASE_ISOTROPIC = 0
PHASE_HG = 1
PHASE_RAYLEIGH = 2
PHASE_KKAY = 3
PHASE_SGGX_SPECULAR = 4
PHASE_MIXTURE = 5


def hg_eval(g, cos_theta):
    """HG phase value (1/4π)(1-g²)/(1+g²+2g·cosθ)^{3/2} (hg.cpp:105-113).

    cos_theta = wi·wo with both along propagation (the reference evaluates
    at dot(wi, wo) with its sign convention folded into the formula)."""
    g2 = g * g
    denom = jnp.maximum(1.0 + g2 + 2.0 * g * cos_theta, 1e-8)
    return INV_FOUR_PI * (1.0 - g2) / (denom * jnp.sqrt(denom))


def hg_sample(g, wi, u2):
    """Exact inverse-CDF HG sampling (hg.cpp:79-90). Returns (wo, pdf)."""
    # cosθ measured from -wi in the reference's derivation; careful below
    safe_g = jnp.where(jnp.abs(g) < 1e-4, 1e-4, g)
    sqr = (1.0 - g * g) / (1.0 - g + 2.0 * g * u2[..., 0])
    cos_theta_g = (1.0 + g * g - sqr * sqr) / (2.0 * safe_g)
    cos_theta = jnp.where(jnp.abs(g) < 1e-4,
                          1.0 - 2.0 * u2[..., 0], cos_theta_g)
    cos_theta = jnp.clip(cos_theta, -1.0, 1.0)
    sin_theta = jnp.sqrt(jnp.maximum(1.0 - cos_theta * cos_theta, 0.0))
    phi = 2.0 * jnp.pi * u2[..., 1]
    # local sample about -wi (hg.cpp builds the frame around -wi)
    local = jnp.stack([sin_theta * jnp.cos(phi),
                       sin_theta * jnp.sin(phi), cos_theta], axis=-1)
    frame = Frame.from_normal(-wi)
    wo = Frame.to_world(frame, local)
    pdf = hg_eval(g, jnp.sum(wi * wo, axis=-1))
    return wo, pdf


def hg_pdf(g, wi, wo):
    return hg_eval(g, jnp.sum(wi * wo, axis=-1))


def isotropic_eval(cos_theta):
    return jnp.full(jnp.shape(cos_theta), INV_FOUR_PI)


def rayleigh_eval(cos_theta):
    """(3/16π)(1+cos²θ) (ref: src/phase/rayleigh.cpp)."""
    return (3.0 / (16.0 * jnp.pi)) * (1.0 + cos_theta * cos_theta)


def rayleigh_sample(wi, u2):
    """Exact inverse-CDF Rayleigh sampling: the marginal in cosθ solves the
    depressed cubic x³ + 3x = 4(2u-1) → x = c - 1/c, c = ∛(2z + √(4+4z²)),
    z = 2(2u-1) (rayleigh.cpp sample). Returns (wo, pdf)."""
    z = 2.0 * (2.0 * u2[..., 0] - 1.0)
    c = jnp.cbrt(z + jnp.sqrt(4.0 + z * z))
    cos_theta = jnp.clip(c - 1.0 / c, -1.0, 1.0)
    sin_theta = jnp.sqrt(jnp.maximum(1.0 - cos_theta * cos_theta, 0.0))
    phi = 2.0 * jnp.pi * u2[..., 1]
    local = jnp.stack([sin_theta * jnp.cos(phi),
                       sin_theta * jnp.sin(phi), cos_theta], axis=-1)
    frame = Frame.from_normal(-wi)
    wo = Frame.to_world(frame, local)
    pdf = rayleigh_eval(jnp.sum(wi * wo, axis=-1))
    return wo, pdf


# ---------------------------------------------------------------------------
# Kajiya-Kay hair phase (ref: src/phase/kkay.cpp)
# ---------------------------------------------------------------------------

def kkay_eval(fiber, wi, wo, ks=0.4, kd=0.2, exponent=4.0):
    """Kajiya-Kay fiber phase: diffuse sin + specular cone term around the
    local fiber direction (kkay.cpp; normalization computed as in the
    reference from the exponent integral). wi toward source, wo outgoing.
    fiber: [.., 3] unit fiber tangent (the medium's orientation field)."""
    # angles measured from the fiber axis
    cos_i = jnp.sum(-wi * fiber, axis=-1)          # incident along -wi
    cos_o = jnp.sum(wo * fiber, axis=-1)
    sin_i = jnp.sqrt(jnp.maximum(1.0 - cos_i * cos_i, 0.0))
    sin_o = jnp.sqrt(jnp.maximum(1.0 - cos_o * cos_o, 0.0))
    # specular cone: cos of angle between mirrored-incidence cone and wo
    cs = jnp.maximum(-(cos_i * cos_o) + sin_i * sin_o, 0.0)
    # normalization: diffuse sin term integrates to π²/4·4π-ish; use the
    # reference's constants: diffuse π/4-normalized over the sphere
    diff = kd * sin_o / (jnp.pi * jnp.pi / 4.0) / 4.0
    spec = ks * jnp.power(cs, exponent) \
        * (exponent + 2.0) / (8.0 * jnp.pi)
    return diff + spec


# ---------------------------------------------------------------------------
# SGGX microflake distribution (ref: src/phase/SGGX.cpp:93-127;
# Heitz et al. 2015). S is packed [Sxx, Syy, Szz, Sxy, Sxz, Syz].
# ---------------------------------------------------------------------------

def _s_mat(s6):
    sxx, syy, szz, sxy, sxz, syz = (s6[..., 0], s6[..., 1], s6[..., 2],
                                    s6[..., 3], s6[..., 4], s6[..., 5])
    row0 = jnp.stack([sxx, sxy, sxz], axis=-1)
    row1 = jnp.stack([sxy, syy, syz], axis=-1)
    row2 = jnp.stack([sxz, syz, szz], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2)


def sggx_sigma(s6, d):
    """Projected microflake area σ(d) = √(dᵀ S d) (SGGX.cpp sigma)."""
    S = _s_mat(s6)
    sd = jnp.einsum("...ij,...j->...i", S, d)
    return jnp.sqrt(jnp.maximum(jnp.sum(d * sd, axis=-1), 1e-12))


def sggx_ndf(s6, m):
    """D(m) = 1 / (π √|S| (mᵀ S⁻¹ m)²) (SGGX.cpp ndf)."""
    S = _s_mat(s6)
    det = jnp.linalg.det(S)
    inv = jnp.linalg.inv(S + 1e-9 * jnp.eye(3))
    q = jnp.einsum("...i,...ij,...j->...", m, inv, m)
    return 1.0 / (jnp.pi * jnp.sqrt(jnp.maximum(det, 1e-18))
                  * jnp.maximum(q * q, 1e-12))


def sggx_sample_vndf(s6, wi, u2):
    """Sample the visible-normal distribution D_wi(m) ∝ ⟨wi,m⟩ D(m)
    (SGGX.cpp sampleVNormal; Heitz 2015 §4.1): build an ONB (wk, wj, wi),
    project S, Cholesky-factor the 3×3 projected matrix, warp a uniform
    disk sample through it."""
    wk, wj, _ = Frame.from_normal(wi)
    S = _s_mat(s6)

    def q(a, b):
        return jnp.einsum("...i,...ij,...j->...", a, S, b)

    s_kk, s_jj, s_ii = q(wk, wk), q(wj, wj), q(wi, wi)
    s_kj, s_ki, s_ji = q(wk, wj), q(wk, wi), q(wj, wi)

    sqrt_det = jnp.sqrt(jnp.maximum(jnp.abs(
        s_kk * s_jj * s_ii - s_kj * s_kj * s_ii - s_ki * s_ki * s_jj
        - s_ji * s_ji * s_kk + 2.0 * s_kj * s_ki * s_ji), 1e-18))
    inv_sqrt_sii = 1.0 / jnp.sqrt(jnp.maximum(s_ii, 1e-12))
    tmp = jnp.sqrt(jnp.maximum(s_jj * s_ii - s_ji * s_ji, 1e-12))
    m_k = jnp.stack([sqrt_det / tmp, jnp.zeros_like(tmp),
                     jnp.zeros_like(tmp)], axis=-1)
    m_j = jnp.stack([-inv_sqrt_sii * (s_ki * s_ji - s_kj * s_ii) / tmp,
                     inv_sqrt_sii * tmp, jnp.zeros_like(tmp)], axis=-1)
    m_i = jnp.stack([inv_sqrt_sii * s_ki, inv_sqrt_sii * s_ji,
                     inv_sqrt_sii * s_ii], axis=-1)

    # uniform point on the upper hemisphere disk (projected)
    u, v = u2[..., 0], u2[..., 1]
    r = jnp.sqrt(u)
    phi = 2.0 * jnp.pi * v
    uu = r * jnp.cos(phi)
    vv = r * jnp.sin(phi)
    ww = jnp.sqrt(jnp.maximum(1.0 - uu * uu - vv * vv, 0.0))

    wm_kji = (uu[..., None] * m_k + vv[..., None] * m_j
              + ww[..., None] * m_i)
    norm = jnp.maximum(
        jnp.linalg.norm(wm_kji, axis=-1, keepdims=True), 1e-12)
    wm_kji = wm_kji / norm
    # back to world: components along (wk, wj, wi)
    m = (wm_kji[..., 0:1] * wk + wm_kji[..., 1:2] * wj
         + wm_kji[..., 2:3] * wi)
    return m / jnp.maximum(jnp.linalg.norm(m, axis=-1, keepdims=True),
                           1e-12)


def sggx_specular_eval(s6, wi, wo):
    """Specular microflake phase f(wi→wo) = D(h)/(4 σ(wi)), h = ½(wi+wo)
    normalized (Heitz 2015 eq. 10; SGGX.cpp eval). wi toward source."""
    h = wi + wo
    hn = h / jnp.maximum(jnp.linalg.norm(h, axis=-1, keepdims=True), 1e-9)
    return sggx_ndf(s6, hn) / jnp.maximum(4.0 * sggx_sigma(s6, wi), 1e-9)


def sggx_specular_sample(s6, wi, u2):
    """Sample wo by drawing a visible normal and mirroring wi about it.
    The resulting pdf IS the phase value (perfect importance sampling).
    Returns (wo, pdf)."""
    m = sggx_sample_vndf(s6, wi, u2)
    wo = 2.0 * jnp.sum(wi * m, axis=-1, keepdims=True) * m - wi
    return wo, sggx_specular_eval(s6, wi, wo)


def sggx_diffuse_eval(s6, wi, wo, u2=None):
    """Diffuse microflake phase: ⟨wo,m⟩⁺/π against a visible normal of wi.
    The exact value integrates over visible normals; the reference
    estimates it with ONE sampled normal per query (SGGX.cpp eval for
    diffuse) — we mirror that stochastic estimator when u2 is given, and
    use the deterministic mean normal otherwise."""
    if u2 is not None:
        m = sggx_sample_vndf(s6, wi, u2)
    else:
        # mean visible normal direction ≈ normalize(S·wi projection)
        m = wi
    return jnp.maximum(jnp.sum(wo * m, axis=-1), 0.0) / jnp.pi


# ---------------------------------------------------------------------------
# multi-lobe SGGX mixtures (ref: src/medium/heterogeneous{2,3}.cpp +
# src/phase/SGGX.cpp — winmad's multi-lobe microflake media, where each
# voxel carries K weighted SGGX lobes). Lobes are packed [K, 7] =
# (weight, Sxx, Syy, Szz, Sxy, Sxz, Syz); K is static and small, so the
# per-lobe work unrolls into fused elementwise ops.
# ---------------------------------------------------------------------------

def sggx_mix_sigma(s6w, d):
    """Directional extinction cross-section of a K-lobe microflake
    mixture: σ(d) = Σ_k w_k σ_k(d) (the phase.h:204-231 sigmaDir
    interface generalised; heterogeneous2.cpp accumulates lobes the
    same way)."""
    K = s6w.shape[-2]
    return sum(s6w[..., k, 0] * sggx_sigma(s6w[..., k, 1:], d)
               for k in range(K))


def sggx_mix_specular_eval(s6w, wi, wo):
    """Mixture specular microflake phase:
    f(wi→wo) = Σ_k w_k σ_k(wi) f_k(wi,wo) / Σ_k w_k σ_k(wi) —
    each lobe's phase contribution is weighted by its share of the
    directional extinction (Heitz 2015 §6; heterogeneous3.cpp)."""
    K = s6w.shape[-2]
    num = 0.0
    den = 0.0
    for k in range(K):
        wk, s6 = s6w[..., k, 0], s6w[..., k, 1:]
        sk = wk * sggx_sigma(s6, wi)
        num = num + sk * sggx_specular_eval(s6, wi, wo)
        den = den + sk
    return num / jnp.maximum(den, 1e-12)


def sggx_mix_specular_sample(s6w, wi, u2):
    """Sample the mixture: pick lobe k ∝ w_k σ_k(wi) by inverting the
    first uniform with sample reuse (the reference's
    DiscreteDistribution::sampleReuse idiom), then draw that lobe's
    VNDF-mirrored direction. Perfect importance sampling per lobe makes
    the overall pdf equal the mixture phase value. Returns (wo, pdf)."""
    K = s6w.shape[-2]
    sig = jnp.stack([s6w[..., k, 0] * sggx_sigma(s6w[..., k, 1:], wi)
                     for k in range(K)], axis=-1)       # [..., K]
    cdf = jnp.cumsum(sig, axis=-1)
    tot = jnp.maximum(cdf[..., -1:], 1e-12)
    cdf = cdf / tot
    u0 = u2[..., 0:1]
    k_sel = jnp.sum((u0 >= cdf[..., :-1]).astype(jnp.int32), axis=-1) \
        if K > 1 else jnp.zeros(u2.shape[:-1], jnp.int32)
    # sample reuse: rescale u0 within the chosen lobe's cdf span
    lo = jnp.where(k_sel > 0,
                   jnp.take_along_axis(
                       cdf, jnp.maximum(k_sel - 1, 0)[..., None],
                       axis=-1)[..., 0], 0.0)
    hi = jnp.take_along_axis(cdf, k_sel[..., None], axis=-1)[..., 0]
    u0r = jnp.clip((u2[..., 0] - lo) / jnp.maximum(hi - lo, 1e-12),
                   0.0, 1.0 - 1e-7)
    u2r = jnp.stack([u0r, u2[..., 1]], axis=-1)
    wos = jnp.stack([
        sggx_specular_sample(s6w[..., k, 1:], wi, u2r)[0]
        for k in range(K)], axis=-2)                    # [..., K, 3]
    wo = jnp.take_along_axis(wos, k_sel[..., None, None].repeat(3, -1),
                             axis=-2)[..., 0, :]
    return wo, sggx_mix_specular_eval(s6w, wi, wo)


# ---------------------------------------------------------------------------
# mixture phase (ref: src/phase/mixturephase.cpp): convex combination
# ---------------------------------------------------------------------------

def mixture_eval(w1, eval1, eval2):
    """w1·f1 + (1-w1)·f2 where eval1/eval2 are already-evaluated values."""
    return w1 * eval1 + (1.0 - w1) * eval2


def mixture_hg_sample(w1, g1, g2, wi, u2, u1):
    """Sample a two-lobe HG mixture (the common mixturephase config):
    pick lobe ∝ weight, sample it, pdf = mixture pdf. Returns (wo, pdf)."""
    pick1 = u1 < w1
    g = jnp.where(pick1, g1, g2)
    wo, _ = hg_sample(g, wi, u2)
    ct = jnp.sum(wi * wo, axis=-1)
    pdf = w1 * hg_eval(g1, ct) + (1.0 - w1) * hg_eval(g2, ct)
    return wo, pdf


# ---------------------------------------------------------------------------
# microflake fiber phase (ref: src/phase/microflake.cpp +
# microflake_fiber.h — Zhao et al. 2011 Gaussian fiber distribution).
#
# Flake normals follow D(m) ∝ exp(-cos²θ/(2σ²)) concentrated in the plane
# perpendicular to the local fiber axis. The reference precomputes σT
# series expansions offline and samples cosθ with a Brent solver inside a
# rejection loop; wavefront replacements:
#   * σT(cosθ) = ∫ D(m)|ω·m| dm is tabulated by numpy quadrature at
#     construction (fiber_sigma_t_table) and linearly interpolated;
#   * cosθ sampling inverts the erf CDF in closed form via erfinv
#     (microflake_fiber.h:256 uses BrentSolver on the same CDF);
#   * the visible-flake rejection (accept ∝ |wi·m|, microflake.cpp:146)
#     runs a FIXED number of unrolled masked rounds — lanes that never
#     accept return pdf 0, mirroring the reference's give-up path.
# ---------------------------------------------------------------------------

PHASE_MICROFLAKE = 6

_SQRT2 = 1.4142135623730951


def fiber_norm(stddev: float) -> float:
    """Normalization of D (microflake_fiber.h:206)."""
    import math as _m
    return 1.0 / ((2.0 * _m.pi) ** 1.5 * stddev
                  * _m.erf(1.0 / (_SQRT2 * stddev)))


def fiber_sigma_t_table(stddev: float, n: int = 64,
                        nq: int = 256) -> np.ndarray:
    """σT(cosθ) over cosθ ∈ [0, 1]: numpy Gauss-Legendre × trapezoid
    quadrature of ∫ D(m)|ω·m| dm (replaces the reference's shipped
    fiberSigmaTCoeffs expansion tables)."""
    norm = fiber_norm(stddev)
    mu, wmu = np.polynomial.legendre.leggauss(nq)      # cosθ_m nodes
    phi = np.linspace(0.0, 2.0 * np.pi, nq, endpoint=False)
    dphi = 2.0 * np.pi / nq
    sin_m = np.sqrt(np.maximum(1.0 - mu ** 2, 0.0))
    d_m = norm * np.exp(-mu ** 2 / (2.0 * stddev ** 2))   # [nq]
    cos_w = np.linspace(0.0, 1.0, n)
    sin_w = np.sqrt(np.maximum(1.0 - cos_w ** 2, 0.0))
    # |w·m| = |sinθw sinθm cosφ + cosθw cosθm|
    dots = np.abs(sin_w[:, None, None] * sin_m[None, :, None]
                  * np.cos(phi)[None, None, :]
                  + cos_w[:, None, None] * mu[None, :, None])
    tab = (d_m[None, :, None] * dots * wmu[None, :, None]).sum(
        axis=(1, 2)) * dphi
    return tab.astype(np.float32)


def _fiber_sigma_t(table, cos_theta):
    """Linear interp of the σT table at |cosθ|."""
    n = table.shape[0]
    x = jnp.clip(jnp.abs(cos_theta), 0.0, 1.0) * (n - 1)
    i0 = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, n - 2)
    f = x - i0
    return table[i0] * (1.0 - f) + table[i0 + 1] * f


def microflake_eval(stddev, table, fiber, wi, wo):
    """Phase value (== pdf) for directions wi (toward viewer) and wo.
    fiber: [.., 3] local fiber orientation (zero ⇒ value 0,
    microflake.cpp:106-113)."""
    h = wi + wo
    hlen = jnp.sqrt(jnp.sum(h * h, axis=-1))
    flen = jnp.sqrt(jnp.sum(fiber * fiber, axis=-1))
    cos_h = jnp.sum(h * fiber, axis=-1) \
        / jnp.maximum(hlen * jnp.maximum(flen, 1e-9), 1e-9)
    cos_i = jnp.sum(wi * fiber, axis=-1) / jnp.maximum(flen, 1e-9)
    d_h = jnp.exp(-cos_h ** 2 / (2.0 * stddev ** 2)) * fiber_norm(stddev)
    val = 0.5 * d_h / jnp.maximum(_fiber_sigma_t(table, cos_i), 1e-9)
    return jnp.where((hlen > 1e-9) & (flen > 1e-9), val, 0.0)


def microflake_sigma_dir(table, fiber, d):
    """Directional extinction coefficient 2·σT(cosθ) — scaled so an
    isotropic flake distribution matches an isotropic medium
    (microflake.cpp:183-190)."""
    flen = jnp.sqrt(jnp.sum(fiber * fiber, axis=-1))
    cos_t = jnp.sum(d * fiber, axis=-1) / jnp.maximum(flen, 1e-9)
    return jnp.where(flen > 1e-9,
                     2.0 * _fiber_sigma_t(table, cos_t), 1.0)


def _round_u123(bits0, bits1, r):
    """Three decorrelated uniforms per rejection round, via PCG4D on the
    (u2-bits, round) counter — weak per-round hashes (e.g. TEA on nearly
    identical keys) measurably correlate the candidate with its
    acceptance test and bias the backscatter peak."""
    from ..core.rng import _to_float, pcg4d
    ctr = jnp.stack([bits0, bits1, jnp.broadcast_to(
        jnp.uint32(r), bits0.shape),
        jnp.broadcast_to(jnp.uint32(0x9E3779B9), bits0.shape)], axis=-1)
    out = pcg4d(ctr)
    return (_to_float(out[..., 0]), _to_float(out[..., 1]),
            _to_float(out[..., 2]))


def microflake_sample(stddev, table, fiber, wi, u2, u1, rounds: int = 64):
    """Sample wo by mirroring wi about a visible flake normal. Returns
    (wo, pdf). Candidate normals: closed-form erfinv inversion of the
    cosθ CDF (CDF(c) = ½(1 + erf(c/√2σ)/erf(1/√2σ)),
    microflake_fiber.h:288); visibility rejection |wi·m| over `rounds`
    unrolled masked rounds."""
    from jax.scipy.special import erfinv
    import math as _m
    flen = jnp.sqrt(jnp.sum(fiber * fiber, axis=-1, keepdims=True))
    axis = fiber / jnp.maximum(flen, 1e-9)
    s_f, t_f, n_f = Frame.from_normal(axis)
    wi_l = jnp.stack([jnp.sum(wi * s_f, axis=-1),
                      jnp.sum(wi * t_f, axis=-1),
                      jnp.sum(wi * n_f, axis=-1)], axis=-1)
    c1 = _m.erf(1.0 / (_SQRT2 * stddev))
    bits0 = jax.lax.bitcast_convert_type(u2[..., 0], jnp.uint32)
    bits1 = jax.lax.bitcast_convert_type(
        u2[..., 1] + u1, jnp.uint32)

    accepted = jnp.zeros(wi_l.shape[:-1], bool)
    h_best = jnp.concatenate(
        [jnp.zeros_like(wi_l[..., :2]), jnp.ones_like(wi_l[..., :1])],
        axis=-1)
    for r in range(rounds):
        x1, x2, x3 = _round_u123(bits0, bits1, r)
        cos_t = _SQRT2 * stddev * erfinv((2.0 * x1 - 1.0) * c1)
        cos_t = jnp.clip(cos_t, -1.0, 1.0)
        sin_t = jnp.sqrt(jnp.maximum(1.0 - cos_t ** 2, 0.0))
        phi = 2.0 * jnp.pi * x2
        h = jnp.stack([sin_t * jnp.cos(phi), sin_t * jnp.sin(phi),
                       cos_t], axis=-1)
        acc = x3 < jnp.abs(jnp.sum(wi_l * h, axis=-1))
        take = acc & ~accepted
        h_best = jnp.where(take[..., None], h, h_best)
        accepted = accepted | acc
    wo_l = 2.0 * jnp.sum(wi_l * h_best, axis=-1, keepdims=True) \
        * h_best - wi_l
    wo = (wo_l[..., 0:1] * s_f + wo_l[..., 1:2] * t_f
          + wo_l[..., 2:3] * n_f)
    pdf = microflake_eval(stddev, table, fiber, wi, wo)
    ok = accepted & (flen[..., 0] > 1e-9)
    return jnp.where(ok[..., None], wo, 0.0), jnp.where(ok, pdf, 0.0)
