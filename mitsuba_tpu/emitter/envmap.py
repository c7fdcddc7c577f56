"""Environment map emitter: lat-long image with 2D CDF importance sampling.

Counterpart of the reference envmap plugin (ref: src/emitters/envmap.cpp:
99-106,282,567-601; SURVEY Appendix A.4): the luminance×sinθ density over
the lat-long image drives a marginal-row/conditional-column CDF pair;
sampling picks a row then a column (sample-reuse within each bin for the
continuous offset), and the pdf divides out the sinθ Jacobian of the
mapping. Direction convention matches envmap.cpp:595-600 (y-up):

    d(u, v) = (sinθ sinφ, cosθ, -sinθ cosφ),  φ = u·2π, θ = v·π
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..core.spectrum import luminance


def build_env_tables(img: np.ndarray):
    """Host-side: density/cdf tables from a lat-long HDR image [H, W, 3].

    Returns dict of numpy arrays to be placed in SceneData: env_img,
    env_row_cdf [H+1], env_col_cdf [H, W+1], env_density [H, W] (pdf over
    the unit square).
    """
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    lum = (img * np.array([0.212671, 0.715160, 0.072169])).sum(-1)
    sin_theta = np.sin(np.pi * (np.arange(h) + 0.5) / h)
    dens = np.maximum(lum, 0.0) * sin_theta[:, None]
    total = dens.sum()
    if total <= 0:
        dens = np.ones_like(dens)
        total = dens.sum()
    row_w = dens.sum(1)
    row_pmf = row_w / total
    row_cdf = np.concatenate([[0.0], np.cumsum(row_pmf)])
    row_cdf[-1] = 1.0
    col_pmf = dens / np.maximum(row_w[:, None], 1e-300)
    col_cdf = np.concatenate([np.zeros((h, 1)), np.cumsum(col_pmf, 1)], 1)
    col_cdf[:, -1] = 1.0
    density_sq = (dens / total * (h * w)).astype(np.float32)
    return {
        "env_img": img,
        "env_row_cdf": row_cdf.astype(np.float32),
        "env_col_cdf": col_cdf.astype(np.float32),
        "env_density": density_sq,
        "env_alias": build_alias_table(dens.reshape(-1) / total),
    }


def build_alias_table(pmf: np.ndarray) -> np.ndarray:
    """Walker alias table for a discrete pmf → [K, 2] (accept prob,
    alias index as float32). Sampling: k = floor(u·K); take k if
    u' < prob[k] else alias[k] — exact, O(1), one packed row gather
    (the wavefront replacement for the per-lane column-CDF scan)."""
    pmf = np.asarray(pmf, np.float64)
    k = len(pmf)
    scaled = pmf * k / max(pmf.sum(), 1e-300)
    prob = np.ones(k)
    alias = np.arange(k)
    small = [i for i in range(k) if scaled[i] < 1.0]
    large = [i for i in range(k) if scaled[i] >= 1.0]
    while small and large:
        s = small.pop()
        g = large.pop()
        prob[s] = scaled[s]
        alias[s] = g
        scaled[g] = scaled[g] - (1.0 - scaled[s])
        (small if scaled[g] < 1.0 else large).append(g)
    out = np.empty((k, 2), np.float32)
    out[:, 0] = prob
    out[:, 1] = alias.astype(np.float32)
    return out


def _uv_to_dir(u, v):
    phi = u * (2.0 * jnp.pi)
    theta = v * jnp.pi
    st = jnp.sin(theta)
    return jnp.stack([st * jnp.sin(phi), jnp.cos(theta),
                      -st * jnp.cos(phi)], axis=-1)


def _dir_to_uv(d):
    theta = jnp.arccos(jnp.clip(d[..., 1], -1.0, 1.0))
    phi = jnp.arctan2(d[..., 0], -d[..., 2])
    phi = jnp.where(phi < 0, phi + 2 * jnp.pi, phi)
    return phi / (2.0 * jnp.pi), theta / jnp.pi


def sample_env(scene, u2):
    """Importance-sample a direction. Returns (d [N,3], pdf_sa [N],
    radiance [N,3]).

    Fast path: Walker alias table (one packed [K,2] row gather; the
    leftover uniforms become the in-texel jitter, so the continuous
    distribution is identical to the CDF path's — only the u→sample
    mapping differs). Falls back to the marginal/conditional CDF pair
    when the scene predates the alias table."""
    h, w = scene.env_density.shape
    if getattr(scene, "env_alias", None) is not None:
        k = h * w
        x = u2[..., 0] * k
        bin0 = jnp.clip(x.astype(jnp.int32), 0, k - 1)
        frac = jnp.clip(x - bin0.astype(jnp.float32), 0.0, 1.0 - 1e-6)
        pa = scene.env_alias[bin0]                     # [N, 2]
        accept = u2[..., 1] < pa[..., 0]
        texel = jnp.where(accept, bin0,
                          pa[..., 1].astype(jnp.int32))
        # rescale the accept draw into a fresh in-texel jitter
        u_rs = jnp.where(accept,
                         u2[..., 1] / jnp.maximum(pa[..., 0], 1e-12),
                         (u2[..., 1] - pa[..., 0])
                         / jnp.maximum(1.0 - pa[..., 0], 1e-12))
        u_rs = jnp.clip(u_rs, 0.0, 1.0 - 1e-6)
        row = texel // w
        col = texel - row * w
        u = (col.astype(jnp.float32) + frac) / w
        v = (row.astype(jnp.float32) + u_rs) / h
        d = _uv_to_dir(u, v)
        pdf_sq = scene.env_density[row, col]
        sin_theta = jnp.sqrt(jnp.maximum(1.0 - d[..., 1] ** 2, 1e-12))
        pdf_sa = pdf_sq / (2.0 * jnp.pi * jnp.pi * sin_theta)
        return d, pdf_sa, scene.env_img[row, col]
    row = jnp.clip(
        jnp.searchsorted(scene.env_row_cdf, u2[..., 0], side="right") - 1,
        0, h - 1)
    # continuous offset within the row bin (sampleReuse)
    r_lo = scene.env_row_cdf[row]
    r_p = jnp.maximum(scene.env_row_cdf[row + 1] - r_lo, 1e-12)
    v_frac = jnp.clip((u2[..., 0] - r_lo) / r_p, 0.0, 1.0 - 1e-6)

    ccdf = scene.env_col_cdf[row]                      # [N, W+1]
    col = jnp.clip(jnp.sum(ccdf <= u2[..., 1][..., None], axis=-1) - 1,
                   0, w - 1)
    c_lo = jnp.take_along_axis(ccdf, col[..., None], axis=-1)[..., 0]
    c_hi = jnp.take_along_axis(ccdf, col[..., None] + 1, axis=-1)[..., 0]
    u_frac = jnp.clip((u2[..., 1] - c_lo) / jnp.maximum(c_hi - c_lo, 1e-12),
                      0.0, 1.0 - 1e-6)

    u = (col.astype(jnp.float32) + u_frac) / w
    v = (row.astype(jnp.float32) + v_frac) / h
    d = _uv_to_dir(u, v)
    pdf_sq = scene.env_density[row, col]
    sin_theta = jnp.sqrt(jnp.maximum(1.0 - d[..., 1] ** 2, 1e-12))
    pdf_sa = pdf_sq / (2.0 * jnp.pi * jnp.pi * sin_theta)
    rad = scene.env_img[row, col]
    return d, pdf_sa, rad


def pdf_env_dir(scene, d):
    """Solid-angle pdf of sample_env for an arbitrary direction."""
    h, w = scene.env_density.shape
    u, v = _dir_to_uv(d)
    col = jnp.clip((u * w).astype(jnp.int32), 0, w - 1)
    row = jnp.clip((v * h).astype(jnp.int32), 0, h - 1)
    pdf_sq = scene.env_density[row, col]
    sin_theta = jnp.sqrt(jnp.maximum(1.0 - d[..., 1] ** 2, 1e-12))
    return pdf_sq / (2.0 * jnp.pi * jnp.pi * sin_theta)


def eval_env_dir(scene, d):
    """Radiance along d (bilinear lookup, envmap.cpp:389-407)."""
    h, w = scene.env_img.shape[:2]
    u, v = _dir_to_uv(d)
    fx = u * w - 0.5
    fy = v * h - 0.5
    x0 = jnp.floor(fx).astype(jnp.int32)
    y0 = jnp.floor(fy).astype(jnp.int32)
    tx = (fx - x0)[..., None]
    ty = (fy - y0)[..., None]

    def texel(xi, yi):
        xi = jnp.mod(xi, w)            # wrap in φ
        yi = jnp.clip(yi, 0, h - 1)    # clamp at poles
        return scene.env_img[yi, xi]

    c00 = texel(x0, y0)
    c10 = texel(x0 + 1, y0)
    c01 = texel(x0, y0 + 1)
    c11 = texel(x0 + 1, y0 + 1)
    return ((c00 * (1 - tx) + c10 * tx) * (1 - ty)
            + (c01 * (1 - tx) + c11 * tx) * ty)
