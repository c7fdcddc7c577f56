"""Fresnel reflectance for dielectrics and conductors.

Semantics follow the reference's exact formulations (ref: include/mitsuba/
core/util.h:473-567 — fresnelDielectricExt / fresnelConductorExact), written
branchless for wide vector units.
"""
from __future__ import annotations

import jax.numpy as jnp

from .math import safe_sqrt


def fresnel_dielectric(cos_theta_i, eta):
    """Unpolarized Fresnel for a dielectric interface.

    cos_theta_i may be signed (negative = ray arriving from inside);
    eta = int_ior/ext_ior > 0. Returns (F, cos_theta_t, eta_it, eta_ti) where
    cos_theta_t carries the transmitted-side sign, matching the reference's
    fresnelDielectricExt (util.h:473 / util.cpp).
    """
    # clamp keeps values/gradients finite when this runs masked-off on
    # non-dielectric wavefront lanes whose eta rows are zero
    eta = jnp.maximum(eta, 1e-3)
    outside = cos_theta_i >= 0.0
    eta_it = jnp.where(outside, eta, 1.0 / eta)   # relative ior along transmission
    eta_ti = 1.0 / eta_it

    cos_i = jnp.abs(cos_theta_i)
    sin_t2 = eta_ti * eta_ti * (1.0 - cos_i * cos_i)
    tir = sin_t2 >= 1.0
    # floor: d/dx sqrt(x)|₀ = inf would NaN masked-lane gradients at TIR
    cos_t = jnp.sqrt(jnp.maximum(1.0 - sin_t2, 1e-12))
    cos_t = jnp.where(tir, 0.0, cos_t)

    # 1e-4 floors keep 1/den² finite in f32 backward at grazing incidence
    rs = (cos_i - eta_it * cos_t) / jnp.maximum(cos_i + eta_it * cos_t, 1e-4)
    rp = (eta_it * cos_i - cos_t) / jnp.maximum(eta_it * cos_i + cos_t, 1e-4)
    f = 0.5 * (rs * rs + rp * rp)
    f = jnp.where(tir, 1.0, f)
    # transmitted cosine is on the opposite side of the interface
    cos_theta_t = jnp.where(tir, 0.0, jnp.where(outside, -cos_t, cos_t))
    return f, cos_theta_t, eta_it, eta_ti


def fresnel_conductor_exact(cos_theta_i, eta, k):
    """Exact unpolarized conductor Fresnel (ref: util.h:544-567).

    eta, k broadcast over the channel axis — pass [..., 3] spectra; cos_theta_i
    is [...] and gets a channel axis appended.
    """
    c = jnp.maximum(cos_theta_i, 0.0)[..., None]
    c2 = c * c
    s2 = 1.0 - c2
    e2 = eta * eta
    k2 = k * k

    t0 = e2 - k2 - s2
    # sqrt args floored at a tiny positive value: d/dx sqrt(0) = inf would
    # poison gradients on lanes where this family is masked off
    a2pb2 = jnp.sqrt(jnp.maximum(t0 * t0 + 4.0 * e2 * k2, 1e-12))
    t1 = a2pb2 + c2
    a = jnp.sqrt(jnp.maximum(0.5 * (a2pb2 + t0), 1e-12))
    t2 = 2.0 * a * c
    rs = (t1 - t2) / jnp.maximum(t1 + t2, 1e-6)
    t3 = c2 * a2pb2 + s2 * s2
    t4 = t2 * s2
    rp = rs * (t3 - t4) / jnp.maximum(t3 + t4, 1e-6)
    return 0.5 * (rp + rs)


def fresnel_diffuse_reflectance(eta):
    """Average (hemispherically integrated) Fresnel reflectance — polynomial
    fit used by `plastic`/`roughplastic` for internal scattering compensation
    (ref: libcore/util.cpp fresnelDiffuseReflectance fast path)."""
    eta = jnp.asarray(eta)
    inv_eta = 1.0 / eta
    # eta < 1: Egan & Hilgeman (1973) fit; eta >= 1: d'Eon & Irving (2011) fit
    below = -1.4399 * (eta * eta) + 0.7099 * eta + 0.6681 + 0.0636 * inv_eta
    ie2 = inv_eta * inv_eta
    ie3 = ie2 * inv_eta
    above = (0.919317 - 3.4793 * inv_eta + 6.75335 * ie2
             - 7.80989 * ie3 + 4.98554 * ie2 * ie2 - 1.36881 * ie2 * ie3)
    return jnp.where(eta < 1.0, below, above)
