"""Real spherical harmonics: evaluation, projection, and sampling.

Counterpart of the reference's SHVector/SHSampler machinery (ref:
include/mitsuba/core/shvector.h:486, src/libcore/shvector.cpp) used by the
shProjection utilities and sh_scaled BSDFs. Wavefront design: a band-L
expansion is a flat coefficient vector [L², ] evaluated with elementwise-only
recurrences over whole wavefronts; projection is a single matmul of the
basis matrix against function samples (matmul); sampling uses a precomputed
2D CDF over a (θ, φ) grid of the reconstructed function (the reference's
hierarchical SHSampler serves the same role, shvector.h:486).

Conventions match the reference: real SH with Condon-Shortley phase
folded out, y_l^m(θ, φ) ordered by (l, m) with index l(l+1)+m, z-up.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def n_coeffs(bands: int) -> int:
    return bands * bands


def sh_index(l: int, m: int) -> int:
    return l * (l + 1) + m


def eval_basis(bands: int, d):
    """Evaluate all L² real SH basis functions at unit directions d
    [..., 3]. Returns [..., L²]. Pure elementwise math (stable upward recurrence
    on associated Legendre polynomials, matching shvector.cpp eval)."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    ct = z
    st = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
    # azimuth via recurrence on (cos mφ, sin mφ): avoids atan2
    safe = jnp.maximum(st, 1e-12)
    cp1, sp1 = x / safe, y / safe
    cp1 = jnp.where(st < 1e-12, 1.0, cp1)
    sp1 = jnp.where(st < 1e-12, 0.0, sp1)

    out = []
    # P_m^m with sin^m folded in: pmm_s = (-1)^m (2m-1)!! st^m — tracked
    # incrementally; K normalization per (l, m).
    pmm = jnp.ones_like(ct)
    cm, sm = jnp.ones_like(ct), jnp.zeros_like(ct)   # cos/sin of m·φ
    coeffs = [None] * (bands * bands)
    for m in range(bands):
        if m > 0:
            pmm = pmm * (2 * m - 1) * st
            cm, sm = cm * cp1 - sm * sp1, sm * cp1 + cm * sp1
        p_prev2, p_prev = None, None
        for l in range(m, bands):
            if l == m:
                p = pmm
            elif l == m + 1:
                p = ct * (2 * m + 1) * pmm
            else:
                p = ((2 * l - 1) * ct * p_prev
                     - (l + m - 1) * p_prev2) / (l - m)
            p_prev2, p_prev = p_prev, p
            k = np.sqrt((2 * l + 1) / (4 * np.pi)
                        * _factorial_ratio(l - m, l + m))
            if m == 0:
                coeffs[sh_index(l, 0)] = k * p
            else:
                s2 = np.sqrt(2.0)
                coeffs[sh_index(l, m)] = s2 * k * p * cm
                coeffs[sh_index(l, -m)] = s2 * k * p * sm
    return jnp.stack(coeffs, axis=-1)


def _factorial_ratio(a: int, b: int) -> float:
    """(a)! / (b)! computed stably in log space."""
    from math import lgamma, exp
    return exp(lgamma(a + 1) - lgamma(b + 1))


def eval_sh(coeffs, d):
    """Reconstruct f(d) = Σ c_i y_i(d). coeffs [..., L²], d [..., 3]."""
    bands = int(np.sqrt(coeffs.shape[-1]))
    basis = eval_basis(bands, d)
    return jnp.sum(coeffs * basis, axis=-1)


def project(bands: int, fn_vals, dirs, weights):
    """Project sampled function values onto SH: c_i = Σ w_k f_k y_i(d_k).
    fn_vals [N], dirs [N, 3], weights [N] (quadrature or 4π/N for MC).
    One [L², N] × [N] matmul — matmul-friendly for large N."""
    basis = eval_basis(bands, dirs)                  # [N, L²]
    return jnp.einsum("nk,n->k", basis, fn_vals * weights)


def project_grid(bands: int, fn, res_theta: int = 64, res_phi: int = 128):
    """Gauss-free lat-long quadrature projection of a callable fn(d)->[N]
    (the reference's SHVector::project, shvector.cpp)."""
    theta = (np.arange(res_theta) + 0.5) / res_theta * np.pi
    phi = (np.arange(res_phi) + 0.5) / res_phi * 2.0 * np.pi
    tt, pp = np.meshgrid(theta, phi, indexing="ij")
    st = np.sin(tt)
    d = np.stack([st * np.cos(pp), st * np.sin(pp), np.cos(tt)],
                 axis=-1).reshape(-1, 3)
    w = (st * (np.pi / res_theta) * (2.0 * np.pi / res_phi)).reshape(-1)
    vals = fn(jnp.asarray(d, jnp.float32))
    return project(bands, vals, jnp.asarray(d, jnp.float32),
                   jnp.asarray(w, jnp.float32))


def rotate_z(coeffs, angle):
    """Rotation about z: trivial in SH (each m pair rotates by m·angle) —
    the cheap case of shvector.cpp's SHRotation."""
    bands = int(np.sqrt(np.asarray(coeffs).shape[-1]))
    out = []
    for l in range(bands):
        for m in range(-l, l + 1):
            i_pos = sh_index(l, abs(m))
            i_neg = sh_index(l, -abs(m))
            c, s = jnp.cos(abs(m) * angle), jnp.sin(abs(m) * angle)
            if m == 0:
                out.append(coeffs[..., sh_index(l, 0)])
            elif m > 0:
                out.append(c * coeffs[..., i_pos] - s * coeffs[..., i_neg])
            else:
                out.append(s * coeffs[..., i_pos] + c * coeffs[..., i_neg])
    return jnp.stack(out, axis=-1)


class SHSampler:
    """Tabulated inverse-CDF sampler for a non-negative SH expansion
    (role of the reference's hierarchical SHSampler, shvector.h:486):
    reconstruct on a (θ, φ) grid, build row/column CDFs, sample with two
    uniforms. warp(u2) returns (d, pdf)."""

    def __init__(self, coeffs, res: int = 64):
        import numpy as np
        theta = (np.arange(res) + 0.5) / res * np.pi
        phi = (np.arange(2 * res) + 0.5) / (2 * res) * 2.0 * np.pi
        tt, pp = np.meshgrid(theta, phi, indexing="ij")
        st = np.sin(tt)
        d = np.stack([st * np.cos(pp), st * np.sin(pp), np.cos(tt)],
                     axis=-1)
        vals = np.maximum(np.asarray(
            eval_sh(jnp.asarray(coeffs),
                    jnp.asarray(d.reshape(-1, 3), jnp.float32))
        ).reshape(res, 2 * res), 0.0)
        cell = vals * st                     # include solid-angle density
        total = cell.sum()
        self.res = res
        self.row_cdf = np.cumsum(cell.sum(axis=1)) / max(total, 1e-12)
        safe_rows = np.maximum(cell.sum(axis=1, keepdims=True), 1e-12)
        self.col_cdf = np.cumsum(cell, axis=1) / safe_rows
        self.vals = vals
        self.total = total
        d_theta = np.pi / res
        d_phi = 2.0 * np.pi / (2 * res)
        self.cell_solid = st * d_theta * d_phi

    def warp(self, u2):
        import numpy as np
        u2 = np.asarray(u2)
        r = np.searchsorted(self.row_cdf, u2[..., 0])
        r = np.clip(r, 0, self.res - 1)
        c = np.array([np.searchsorted(self.col_cdf[ri], u)
                      for ri, u in zip(np.atleast_1d(r),
                                       np.atleast_1d(u2[..., 1]))])
        c = np.clip(c, 0, 2 * self.res - 1)
        theta = (r + 0.5) / self.res * np.pi
        phi = (c + 0.5) / (2 * self.res) * 2.0 * np.pi
        st = np.sin(theta)
        d = np.stack([st * np.cos(phi), st * np.sin(phi),
                      np.cos(theta)], axis=-1)
        pdf = (self.vals[r, c] * self.cell_solid[r, c]
               / max(self.total, 1e-12)) / self.cell_solid[r, c]
        return d, pdf
