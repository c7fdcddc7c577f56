"""Perlin gradient noise, fBm, and turbulence.

Counterpart of the reference's noise utilities (ref:
include/mitsuba/core/noise.h:34, src/libcore/noise.cpp — Perlin's
improved noise as used by procedural textures). Wavefront design: the
permutation table is generated from a seed at build time and baked as a
constant; lookups are vectorized gathers over the wavefront, all else is
elementwise polynomial math. Matches the classic reference semantics: values in
[-1, 1], C² fade curve 6t⁵-15t⁴+10t³, 12 gradient directions.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def _build_perm(seed: int = 0x9E3779B9) -> np.ndarray:
    rs = np.random.RandomState(seed & 0x7FFFFFFF)
    p = rs.permutation(256).astype(np.int32)
    return np.concatenate([p, p])


_PERM = jnp.asarray(_build_perm())

# 12 edge-of-cube gradients (Perlin 2002)
_GRADS = jnp.asarray(np.array([
    [1, 1, 0], [-1, 1, 0], [1, -1, 0], [-1, -1, 0],
    [1, 0, 1], [-1, 0, 1], [1, 0, -1], [-1, 0, -1],
    [0, 1, 1], [0, -1, 1], [0, 1, -1], [0, -1, -1],
], np.float32))


def _fade(t):
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def _grad_dot(hash_val, x, y, z):
    g = _GRADS[hash_val % 12]
    return g[..., 0] * x + g[..., 1] * y + g[..., 2] * z


def perlin(p):
    """Perlin noise at world positions p [..., 3] → values in [-1, 1]
    (noise.cpp perlinNoise)."""
    pi = jnp.floor(p).astype(jnp.int32) & 255
    pf = p - jnp.floor(p)
    xi, yi, zi = pi[..., 0], pi[..., 1], pi[..., 2]
    xf, yf, zf = pf[..., 0], pf[..., 1], pf[..., 2]
    u, v, w = _fade(xf), _fade(yf), _fade(zf)

    def h(ix, iy, iz):
        return _PERM[_PERM[_PERM[ix] + iy] + iz]

    def lerp(a, b, t):
        return a + t * (b - a)

    c000 = _grad_dot(h(xi, yi, zi), xf, yf, zf)
    c100 = _grad_dot(h(xi + 1, yi, zi), xf - 1, yf, zf)
    c010 = _grad_dot(h(xi, yi + 1, zi), xf, yf - 1, zf)
    c110 = _grad_dot(h(xi + 1, yi + 1, zi), xf - 1, yf - 1, zf)
    c001 = _grad_dot(h(xi, yi, zi + 1), xf, yf, zf - 1)
    c101 = _grad_dot(h(xi + 1, yi, zi + 1), xf - 1, yf, zf - 1)
    c011 = _grad_dot(h(xi, yi + 1, zi + 1), xf, yf - 1, zf - 1)
    c111 = _grad_dot(h(xi + 1, yi + 1, zi + 1), xf - 1, yf - 1, zf - 1)

    x00 = lerp(c000, c100, u)
    x10 = lerp(c010, c110, u)
    x01 = lerp(c001, c101, u)
    x11 = lerp(c011, c111, u)
    y0 = lerp(x00, x10, v)
    y1 = lerp(x01, x11, v)
    return lerp(y0, y1, w)


def fbm(p, octaves: int = 6, lacunarity: float = 2.0, gain: float = 0.5):
    """Fractional Brownian motion: Σ gainⁱ · perlin(lacunarityⁱ · p)
    (noise.cpp fbm; omega=gain maxOctaves=octaves)."""
    total = jnp.zeros(p.shape[:-1])
    amp = 1.0
    freq = 1.0
    for _ in range(octaves):
        total = total + amp * perlin(p * freq)
        freq *= lacunarity
        amp *= gain
    return total


def turbulence(p, octaves: int = 6, lacunarity: float = 2.0,
               gain: float = 0.5):
    """Like fbm with |noise| per octave (noise.cpp turbulence)."""
    total = jnp.zeros(p.shape[:-1])
    amp = 1.0
    freq = 1.0
    for _ in range(octaves):
        total = total + amp * jnp.abs(perlin(p * freq))
        freq *= lacunarity
        amp *= gain
    return total
