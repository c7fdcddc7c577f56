"""Heterogeneous medium: Woodcock/delta tracking against a density grid.

Counterpart of the reference's heterogeneous medium (ref: src/medium/
heterogeneous.cpp:59,175-290 — delta tracking with a max-density majorant)
and gridvolume data source (src/volume/gridvolume.cpp, trilinear lookups).
Wavefront shape: the tracking loop is a bounded `lax.fori_loop` with masked lanes
(every lane does MAX_STEPS candidate flights; terminated lanes ride along),
and density lookups are trilinear fetches from a [Z, Y, X] grid in device memory.

Transmittance along shadow rays uses the ratio-tracking estimator
(unbiased, low-variance analog of the reference's residual transmittance
estimation).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

MAX_STEPS = 64


def trilinear(grid, p01):
    """grid [Z, Y, X]; p01 [..., 3] in [0,1]³ (x, y, z order).
    Zero outside the unit box."""
    zr, yr, xr = grid.shape
    inside = jnp.all((p01 >= 0.0) & (p01 <= 1.0), axis=-1)
    fx = jnp.clip(p01[..., 0], 0.0, 1.0) * (xr - 1)
    fy = jnp.clip(p01[..., 1], 0.0, 1.0) * (yr - 1)
    fz = jnp.clip(p01[..., 2], 0.0, 1.0) * (zr - 1)
    x0 = jnp.clip(jnp.floor(fx).astype(jnp.int32), 0, xr - 2) \
        if xr > 1 else jnp.zeros_like(fx, jnp.int32)
    y0 = jnp.clip(jnp.floor(fy).astype(jnp.int32), 0, yr - 2) \
        if yr > 1 else jnp.zeros_like(fy, jnp.int32)
    z0 = jnp.clip(jnp.floor(fz).astype(jnp.int32), 0, zr - 2) \
        if zr > 1 else jnp.zeros_like(fz, jnp.int32)
    tx = fx - x0
    ty = fy - y0
    tz = fz - z0
    x1 = jnp.minimum(x0 + 1, xr - 1)
    y1 = jnp.minimum(y0 + 1, yr - 1)
    z1 = jnp.minimum(z0 + 1, zr - 1)

    def g(zi, yi, xi):
        return grid[zi, yi, xi]

    c000, c100 = g(z0, y0, x0), g(z0, y0, x1)
    c010, c110 = g(z0, y1, x0), g(z0, y1, x1)
    c001, c101 = g(z1, y0, x0), g(z1, y0, x1)
    c011, c111 = g(z1, y1, x0), g(z1, y1, x1)
    c00 = c000 * (1 - tx) + c100 * tx
    c10 = c010 * (1 - tx) + c110 * tx
    c01 = c001 * (1 - tx) + c101 * tx
    c11 = c011 * (1 - tx) + c111 * tx
    c0 = c00 * (1 - ty) + c10 * ty
    c1 = c01 * (1 - ty) + c11 * ty
    val = c0 * (1 - tz) + c1 * tz
    return jnp.where(inside, val, 0.0)


def _to_grid01(p, bb_min, bb_extent):
    return (p - bb_min) / bb_extent


def sample_distance_woodcock(grid, bb_min, bb_extent, sigma_scale,
                             majorant, o, d, t_surf, seed_bits):
    """Delta tracking (heterogeneous.cpp:270-290).

    grid [Z,Y,X] density; sigma_scale scalar (σt per unit density);
    majorant = max density · sigma_scale; o, d [N,3]; t_surf [N];
    seed_bits [N] uint32 — per-lane stream for the flight loop.

    Returns (sampled [N] bool, t [N], sigma_t_at_event [N]). The standard
    delta-tracking weights are 1 (events are distributed ∝ the true free
    path); scattering albedo is applied by the caller.
    """
    inv_maj = 1.0 / jnp.maximum(majorant, 1e-8)

    def hash_f(bits, k):
        # per-step PCG-style mix producing a uniform in [0,1)
        ku = jnp.asarray(k, jnp.uint32) * jnp.uint32(0x9E3779B9)
        h = (bits ^ ku) * jnp.uint32(0x85EBCA6B)
        h = (h ^ (h >> jnp.uint32(13))) * jnp.uint32(0xC2B2AE35)
        h = h ^ (h >> jnp.uint32(16))
        return (h >> jnp.uint32(8)).astype(jnp.float32) / (1 << 24)

    def body(k, carry):
        t, done, sampled, sig_ev = carry
        u1 = hash_f(seed_bits, 2 * k)
        u2 = hash_f(seed_bits, 2 * k + 1)
        t_new = t - jnp.log1p(-jnp.clip(u1, 0.0, 1.0 - 1e-7)) * inv_maj
        p = o + t_new[..., None] * d
        dens = trilinear(grid, _to_grid01(p, bb_min, bb_extent))
        sig = dens * sigma_scale
        real = u2 < sig * inv_maj
        hit_surf = t_new >= t_surf
        newly_sampled = ~done & ~hit_surf & real
        sampled = sampled | newly_sampled
        sig_ev = jnp.where(newly_sampled, sig, sig_ev)
        t = jnp.where(done, t, t_new)
        done = done | hit_surf | newly_sampled
        return t, done, sampled, sig_ev

    n = o.shape[0]
    init = (jnp.zeros(n), jnp.zeros(n, bool), jnp.zeros(n, bool),
            jnp.zeros(n))
    t, done, sampled, sig_ev = jax.lax.fori_loop(0, MAX_STEPS, body, init)
    # lanes that never terminated within MAX_STEPS: treat as surface
    return sampled, t, sig_ev


def transmittance_ratio(grid, bb_min, bb_extent, sigma_scale, majorant,
                        o, d, dist, seed_bits, n_steps: int = MAX_STEPS):
    """Ratio-tracking transmittance estimator along [0, dist]."""
    inv_maj = 1.0 / jnp.maximum(majorant, 1e-8)

    def hash_f(bits, k):
        ku = jnp.asarray(k, jnp.uint32) * jnp.uint32(0x27D4EB2F)
        h = (bits ^ ku) * jnp.uint32(0x165667B1)
        h = (h ^ (h >> jnp.uint32(15))) * jnp.uint32(0xD3A2646C)
        h = h ^ (h >> jnp.uint32(16))
        return (h >> jnp.uint32(8)).astype(jnp.float32) / (1 << 24)

    def body(k, carry):
        t, tr, done = carry
        u = hash_f(seed_bits, k)
        t_new = t - jnp.log1p(-jnp.clip(u, 0.0, 1.0 - 1e-7)) * inv_maj
        past = t_new >= dist
        p = o + t_new[..., None] * d
        dens = trilinear(grid, _to_grid01(p, bb_min, bb_extent))
        sig = dens * sigma_scale
        tr = jnp.where(done | past, tr,
                       tr * jnp.maximum(1.0 - sig * inv_maj, 0.0))
        t = jnp.where(done, t, t_new)
        done = done | past
        return t, tr, done

    n = o.shape[0]
    init = (jnp.zeros(n), jnp.ones(n), jnp.zeros(n, bool))
    _, tr, done = jax.lax.fori_loop(0, n_steps, body, init)
    return jnp.where(done, tr, 0.0)
