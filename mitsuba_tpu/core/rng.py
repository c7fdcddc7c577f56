"""Counter-based, stateless RNG for replayable wavefront sampling.

Replaces the reference's stateful SFMT streams (ref: include/mitsuba/core/
random.h:88, src/samplers/independent.cpp) with a pure hash: every random
number is a deterministic function of (seed, pixel_index, sample_index,
dimension). This is the property path-replay backpropagation needs — the
backward pass regenerates the exact forward sample stream from indices alone,
with no stored tape (SURVEY.md §7 "Differentiable mode").

The hash is PCG4D (Jarzynski & Olano, JCGT 2020): pure uint32 mul/add/xor/shift
— vector-friendly, and reimplemented bit-identically in numpy by the CPU oracle
(tests/oracle/rng.py) so image allclose tests share one sample stream.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

_U32 = jnp.uint32
# 1/2^24 — uniform floats built from the top 24 bits are exact in f32 and in [0,1)
_INV_2_24 = float(1.0 / (1 << 24))


def pcg4d(v: jax.Array) -> jax.Array:
    """PCG4D hash: uint32[..., 4] -> uint32[..., 4]."""
    v = v.astype(_U32)
    v = v * _U32(1664525) + _U32(1013904223)
    x, y, z, w = v[..., 0], v[..., 1], v[..., 2], v[..., 3]
    x = x + y * w
    y = y + z * x
    z = z + x * y
    w = w + y * z
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    w = w ^ (w >> 16)
    x = x + y * w
    y = y + z * x
    z = z + x * y
    w = w + y * z
    return jnp.stack([x, y, z, w], axis=-1)


def _to_float(bits: jax.Array) -> jax.Array:
    """uint32 → float32 uniform in [0, 1) using the top 24 bits."""
    return (bits >> _U32(8)).astype(jnp.float32) * _INV_2_24


def hash_u32(seed, idx, dim, samp=0) -> jax.Array:
    """Raw 4-lane uint32 hash for counter tuple (seed, idx, dim, samp).

    `samp` (the per-pixel sample index) gets its own counter word so
    samplers can address the (pixel, sample, dimension) lattice directly;
    legacy callers fold sample into idx and leave samp=0."""
    seed = jnp.asarray(seed, _U32)
    idx = jnp.asarray(idx, _U32)
    dim = jnp.asarray(dim, _U32)
    samp = jnp.asarray(samp, _U32)
    seed, idx, dim, samp = jnp.broadcast_arrays(seed, idx, dim, samp)
    ctr = jnp.stack([idx, dim, seed, samp + _U32(0x9E3779B9)], axis=-1)
    return pcg4d(ctr)


def sample_1d(seed, idx, dim, samp=0) -> jax.Array:
    """One uniform float per counter tuple. Shape = broadcast of args."""
    return _to_float(hash_u32(seed, idx, dim, samp)[..., 0])


def sample_2d(seed, idx, dim, samp=0) -> jax.Array:
    """Two uniform floats per counter tuple; shape [..., 2]."""
    h = hash_u32(seed, idx, dim, samp)
    return _to_float(h[..., 0:2])


def sample_4d(seed, idx, dim, samp=0) -> jax.Array:
    h = hash_u32(seed, idx, dim, samp)
    return _to_float(h)


class DimAllocator:
    """Tracks the per-path sample dimension during tracing so every draw gets
    a unique `dim` — the functional analog of the reference sampler's
    advancing stream (ref: include/mitsuba/render/sampler.h:150). Trace-time
    Python state only: `dim` values become compile-time constants when the
    draw count per bounce is static, or ride in the scan carry otherwise."""

    def __init__(self, start: int = 0):
        self.dim = start

    def next(self, n: int = 1) -> int:
        d = self.dim
        self.dim += n
        return d
