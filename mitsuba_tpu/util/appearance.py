"""Appearance-prefiltering toolkit (winmad research utilities).

Counterparts of the fork's research components:
  * SphericalDistribution / MultiLobeDistribution — binned spherical
    histograms used as scheduler WorkResults (ref: include/mitsuba/render/
    spherical_distribution.h:14,44, librender/spherical_distribution.cpp)
  * mtsutil bsdfSimulator — distributed MC simulation of a BSDF into
    SphericalDistributions (ref: src/utils/bsdfSimulator/*, SURVEY §2.4)
  * microflake2SGGX / downSampleSGGX — fit/average SGGX S-matrices
    (ref: src/utils/{microflake2SGGX,downSampleSGGX}.cpp; SGGX per
    Heitz et al. 2015, the fork's src/phase/SGGX.cpp)
  * normalMipmap / ndfMipmap / LEADR mapping — downsample a normal map
    into per-mip (mean normal, roughness) LEAN/LEADR moments
    (ref: src/utils/{normalMipmap,ndfMipmap,leadr*}.cpp)

Wavefront shape: all of these are embarrassingly parallel reductions — one
wavefront of samples, scatter-add bins / moment sums. The reference's
Scheduler work-unit plumbing is unnecessary; `jit` + sharded inputs
cover the distributed use (parallel/dist.py).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core import rng


# ---------------------------------------------------------------------------
# SphericalDistribution
# ---------------------------------------------------------------------------

def spherical_distribution(dirs, weights=None, res_theta: int = 32,
                           res_phi: int = 64):
    """Bin weighted directions over the full sphere → [res_theta, res_phi]
    density (per steradian). Equal-angle θ binning like the reference's
    SphericalDistribution::put (spherical_distribution.cpp)."""
    dirs = jnp.asarray(dirs)
    w = jnp.ones(dirs.shape[:-1]) if weights is None \
        else jnp.asarray(weights)
    cos_t = jnp.clip(dirs[..., 2], -1.0, 1.0)
    theta = jnp.arccos(cos_t)
    phi = jnp.arctan2(dirs[..., 1], dirs[..., 0])
    phi = jnp.where(phi < 0, phi + 2 * np.pi, phi)
    ti = jnp.clip((theta / np.pi * res_theta).astype(jnp.int32),
                  0, res_theta - 1)
    pi_ = jnp.clip((phi / (2 * np.pi) * res_phi).astype(jnp.int32),
                   0, res_phi - 1)
    hist = jnp.zeros((res_theta, res_phi)).at[ti, pi_].add(w)
    # solid angle per bin: Δφ · (cosθ0 − cosθ1)
    edges = jnp.cos(jnp.linspace(0.0, np.pi, res_theta + 1))
    dcos = edges[:-1] - edges[1:]
    omega = dcos[:, None] * (2 * np.pi / res_phi)
    n = jnp.maximum(jnp.sum(w), 1e-12)
    return hist / (omega * n)


def simulate_bsdf(mat_code, params, theta_i: float, n_samples: int = 1 << 20,
                  res_theta: int = 32, res_phi: int = 64, seed: int = 0,
                  batch: int = 1 << 18):
    """MC-simulate `sample()` of a compiled material into a spherical
    distribution (the bsdfSimulator utility: fire n_samples, bin outgoing
    directions weighted by the sample weight's luminance; also returns
    the directional albedo). Works for ANY family incl. composites."""
    import mitsuba_tpu.bsdf.bsdf as B
    params = jnp.asarray(params)
    wi = jnp.asarray([np.sin(theta_i), 0.0, np.cos(theta_i)], jnp.float32)
    hist = jnp.zeros((res_theta, res_phi))
    wsum = 0.0
    n_done = 0
    while n_done < n_samples:
        n = min(batch, n_samples - n_done)
        lane = jnp.arange(n_done, n_done + n, dtype=jnp.uint32)
        u2 = rng.sample_2d(seed, lane, 0)
        u1 = rng.sample_1d(seed, lane, 1)
        bs = B.sample_bsdf(jnp.full((n,), mat_code, jnp.int32),
                           jnp.broadcast_to(params, (n,) + params.shape),
                           jnp.broadcast_to(wi, (n, 3)), u2, u1)
        lum = (0.212671 * bs.weight[..., 0] + 0.715160 * bs.weight[..., 1]
               + 0.072169 * bs.weight[..., 2])
        hist = hist + spherical_distribution(
            bs.wo, lum, res_theta, res_phi) * jnp.sum(lum)
        wsum = wsum + float(jnp.sum(lum))
        n_done += n
    albedo = wsum / n_samples
    return hist / max(wsum, 1e-12), albedo


# ---------------------------------------------------------------------------
# SGGX fitting (Heitz et al. 2015)
# ---------------------------------------------------------------------------

def sggx_from_normals(normals, weights=None):
    """Fit an SGGX S-matrix to a (weighted) normal/fiber distribution —
    microflake2SGGX: S = Q diag(σ²) Qᵀ where σ_i are the projected areas
    along the eigenframe of the second-moment matrix E[n nᵀ].

    Returns the symmetric 3×3 S as a [6] vector (Sxx,Syy,Szz,Sxy,Sxz,Syz),
    the storage layout of the fork's SGGX phase (SGGX.cpp:93)."""
    n = np.asarray(normals, np.float64)
    w = np.ones(len(n)) if weights is None else np.asarray(weights,
                                                           np.float64)
    w = w / max(w.sum(), 1e-12)
    m = np.einsum("i,ij,ik->jk", w, n, n)       # E[n nᵀ]
    evals, evecs = np.linalg.eigh(m)
    # projected area along eigen axis k: σ_k = E[|n·e_k|]
    proj = np.einsum("ij,jk->ik", n, evecs)     # [N, 3]
    sigma = np.einsum("i,ik->k", w, np.abs(proj))
    s = evecs @ np.diag(sigma ** 2) @ evecs.T
    return np.array([s[0, 0], s[1, 1], s[2, 2],
                     s[0, 1], s[0, 2], s[1, 2]])


def sggx_downsample(s_list, weights=None):
    """Average child SGGX matrices into a parent (downSampleSGGX.cpp):
    linear interpolation of S is the paper's recommended downsampling."""
    s = np.asarray(s_list, np.float64)
    w = np.ones(len(s)) if weights is None else np.asarray(weights,
                                                           np.float64)
    w = w / max(w.sum(), 1e-12)
    return (w[:, None] * s).sum(0)


def sggx_projected_area(s6, d):
    """σ(d) = sqrt(dᵀ S d) — the microflake projected area the
    heterogeneous medium uses as directional density (SGGX.cpp sigma)."""
    d = jnp.asarray(d)
    sxx, syy, szz, sxy, sxz, syz = (s6[..., i] for i in range(6))
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    q = (x * x * sxx + y * y * syy + z * z * szz
         + 2.0 * (x * y * sxy + x * z * sxz + y * z * syz))
    return jnp.sqrt(jnp.maximum(q, 0.0))


# ---------------------------------------------------------------------------
# normal-map → LEAN/LEADR mip moments
# ---------------------------------------------------------------------------

def normal_mipmap(normal_map, n_levels: int | None = None):
    """Downsample a tangent-space normal map into per-mip LEAN moments:
    each level stores (mean slope x, mean slope y, var x, var y) — the
    normalMipmap/LEADR utilities' output, usable as per-mip roughness
    (α ≈ sqrt(2·var)) for prefiltered shading.

    normal_map: [H, W, 3] in [-1, 1] (unit normals, +z up).
    Returns list of [h, w, 4] float arrays, finest first."""
    n = np.asarray(normal_map, np.float64)
    slope = np.stack([-n[..., 0] / np.maximum(n[..., 2], 1e-3),
                      -n[..., 1] / np.maximum(n[..., 2], 1e-3)], -1)
    m1 = slope                                   # first moments
    m2 = slope ** 2                              # second moments
    levels = []
    while True:
        var = np.maximum(m2 - m1 ** 2, 0.0)
        levels.append(np.concatenate([m1, var], -1).astype(np.float32))
        h, w = m1.shape[:2]
        if (h <= 1 and w <= 1) or (n_levels and len(levels) >= n_levels):
            break
        nh, nw = max(1, h // 2), max(1, w // 2)
        m1 = 0.25 * (m1[:nh*2:2, :nw*2:2] + m1[1:nh*2:2, :nw*2:2]
                     + m1[:nh*2:2, 1:nw*2:2] + m1[1:nh*2:2, 1:nw*2:2])
        m2 = 0.25 * (m2[:nh*2:2, :nw*2:2] + m2[1:nh*2:2, :nw*2:2]
                     + m2[:nh*2:2, 1:nw*2:2] + m2[1:nh*2:2, 1:nw*2:2])
    return levels


# ---------------------------------------------------------------------------
# SH projection of BSDF lobes / phase functions
# ---------------------------------------------------------------------------

def sh_project_bsdf(mat_code, params, theta_i: float, bands: int = 4,
                    n_samples: int = 1 << 18, seed: int = 0):
    """Project a material's outgoing lobe (for incidence θ_i) onto real
    spherical harmonics — the shProjection* utilities (ref:
    src/utils/shProjection*.cpp). MC estimate: coeffs_l^m =
    E[w · Y_l^m(ω_o)] / E_pdf, using sample() importance sampling so the
    estimator is exact for the sampled lobe. Returns luminance SH coeffs
    [(bands)²]."""
    import mitsuba_tpu.bsdf.bsdf as B
    from ..core import sh
    params = jnp.asarray(params)
    wi = jnp.asarray([np.sin(theta_i), 0.0, np.cos(theta_i)], jnp.float32)
    lane = jnp.arange(n_samples, dtype=jnp.uint32)
    u2 = rng.sample_2d(seed, lane, 0)
    u1 = rng.sample_1d(seed, lane, 1)
    bs = B.sample_bsdf(jnp.full((n_samples,), mat_code, jnp.int32),
                       jnp.broadcast_to(params,
                                        (n_samples,) + params.shape),
                       jnp.broadcast_to(wi, (n_samples, 3)), u2, u1)
    lum = (0.212671 * bs.weight[..., 0] + 0.715160 * bs.weight[..., 1]
           + 0.072169 * bs.weight[..., 2])
    basis = sh.eval_basis(bands, bs.wo)               # [N, bands²]
    return jnp.mean(lum[:, None] * basis, axis=0)


# ---------------------------------------------------------------------------
# albedo clustering (k-means over texel albedos)
# ---------------------------------------------------------------------------

def albedo_cluster(albedo_map, k: int = 8, n_iter: int = 25, seed: int = 0):
    """Cluster an albedo map's texels into k representative albedos —
    the albedoCluster utility (ref: src/utils/albedoCluster.cpp), used to
    quantize spatially-varying appearance into a small lobe table.

    albedo_map: [H, W, 3]. Returns (centers [k, 3], labels [H, W])."""
    a = np.asarray(albedo_map, np.float64).reshape(-1, 3)
    rs = np.random.default_rng(seed)
    centers = a[rs.choice(len(a), size=k, replace=len(a) < k)]
    labels = np.zeros(len(a), np.int64)
    for _ in range(n_iter):
        d2 = ((a[:, None, :] - centers[None]) ** 2).sum(-1)
        labels = d2.argmin(1)
        for j in range(k):
            sel = labels == j
            if sel.any():
                centers[j] = a[sel].mean(0)
            else:
                # empty cluster: reseed at the worst-represented texel
                centers[j] = a[d2.min(1).argmax()]
    return (centers.astype(np.float32),
            labels.reshape(np.asarray(albedo_map).shape[:2]))


# ---------------------------------------------------------------------------
# grid-volume resampling (up/down-sampling utilities)
# ---------------------------------------------------------------------------

def volume_downsample(grid, factor: int = 2):
    """Box-average a density grid by an integer factor per axis — the
    volume down-sampling tools (ref: src/utils volume up/down-sampling,
    SURVEY §2.4). grid: [Z, Y, X] or [Z, Y, X, C]."""
    g = np.asarray(grid, np.float64)
    has_c = g.ndim == 4
    if not has_c:
        g = g[..., None]
    z, y, x, c = g.shape
    f = factor
    nz, ny, nx = max(1, z // f), max(1, y // f), max(1, x // f)
    g = g[:nz * f, :ny * f, :nx * f]
    g = g.reshape(nz, f, ny, f, nx, f, c).mean(axis=(1, 3, 5))
    return (g if has_c else g[..., 0]).astype(np.float32)


def volume_upsample(grid, factor: int = 2):
    """Trilinear upsample of a density grid by an integer factor —
    matches gridvolume's trilinear lookup semantics so resampled volumes
    render consistently."""
    g = np.asarray(grid, np.float32)
    has_c = g.ndim == 4
    if not has_c:
        g = g[..., None]
    z, y, x, c = g.shape
    f = factor

    def axis_coords(n):
        # sample positions at new-texel centers in old-texel coordinates
        return np.clip((np.arange(n * f) + 0.5) / f - 0.5, 0, n - 1)

    zc, yc, xc = axis_coords(z), axis_coords(y), axis_coords(x)

    def lerp_axis(arr, coords, axis):
        i0 = np.floor(coords).astype(int)
        i1 = np.minimum(i0 + 1, arr.shape[axis] - 1)
        w = (coords - i0).reshape([-1 if a == axis else 1
                                   for a in range(arr.ndim)])
        return (np.take(arr, i0, axis) * (1 - w)
                + np.take(arr, i1, axis) * w)

    g = lerp_axis(g, zc, 0)
    g = lerp_axis(g, yc, 1)
    g = lerp_axis(g, xc, 2)
    return (g if has_c else g[..., 0]).astype(np.float32)


# ---------------------------------------------------------------------------
# lobe derivatives (the fork's forward-mode appearance derivatives)
# ---------------------------------------------------------------------------

def lobe_derivative(weights, lobe_values):
    """d(mixture BSDF value)/d(lobe weight_k) for a linear multi-lobe
    combination f = Σ_k w_k f_k: the derivative is just the lobe value
    f_k, matching the fork's lobeDerivative accumulators
    (ref: src/utils/bsdfSimulator/lobeDerivative_proc.h, SURVEY A.9 —
    the per-path (TdW[k], LdW[k]) quantities). jax.grad through the
    framework's mixture BSDFs computes the same thing path-wide; this
    helper exposes the per-vertex factor for parity tests."""
    weights = jnp.asarray(weights)
    lobe_values = jnp.asarray(lobe_values)
    f = jnp.sum(weights[..., None] * lobe_values, axis=-2) \
        if lobe_values.ndim > weights.ndim else \
        jnp.sum(weights * lobe_values, axis=-1)
    return f, lobe_values
