"""Reconstruction filters (ref: src/rfilters/*.cpp, rfilter.h).

Each filter is (radius, eval(x)) with x the 1D offset from the sample — the
reference discretizes into a lookup; here the closed forms run directly on
elementwise math inside the splat kernel. All separable, as in the reference.
"""
from __future__ import annotations

import jax.numpy as jnp

BOX = 0
TENT = 1
GAUSSIAN = 2
MITCHELL = 3
CATMULLROM = 4
LANCZOS = 5

RADIUS = {
    BOX: 0.5,
    TENT: 1.0,
    GAUSSIAN: 2.0,
    MITCHELL: 2.0,
    CATMULLROM: 2.0,
    LANCZOS: 3.0,
}

NAMES = {"box": BOX, "tent": TENT, "gaussian": GAUSSIAN,
         "mitchell": MITCHELL, "catmullrom": CATMULLROM, "lanczos": LANCZOS}


def _mitchell_ab(x, b, c):
    ax = jnp.abs(x)
    ax2, ax3 = ax * ax, ax * ax * ax
    p1 = ((12 - 9 * b - 6 * c) * ax3 + (-18 + 12 * b + 6 * c) * ax2
          + (6 - 2 * b)) / 6.0
    p2 = ((-b - 6 * c) * ax3 + (6 * b + 30 * c) * ax2
          + (-12 * b - 48 * c) * ax + (8 * b + 24 * c)) / 6.0
    return jnp.where(ax < 1.0, p1, jnp.where(ax < 2.0, p2, 0.0))


def eval_filter(ftype: int, x):
    """1D filter weight at offset x (static ftype — resolved at trace time)."""
    ax = jnp.abs(x)
    if ftype == BOX:
        return jnp.where(ax <= 0.5, 1.0, 0.0)
    if ftype == TENT:
        return jnp.maximum(1.0 - ax, 0.0)
    if ftype == GAUSSIAN:
        # alpha=2, truncated at r=2 and shifted to zero there (gaussian.cpp)
        alpha = 2.0
        base = jnp.exp(-alpha * 4.0)
        return jnp.maximum(jnp.exp(-alpha * x * x) - base, 0.0)
    if ftype == MITCHELL:
        return _mitchell_ab(x, 1.0 / 3.0, 1.0 / 3.0)
    if ftype == CATMULLROM:
        return _mitchell_ab(x, 0.0, 0.5)
    if ftype == LANCZOS:
        # sinc(x)·sinc(x/3), 3-lobe (lanczos.cpp)
        px = jnp.pi * jnp.maximum(ax, 1e-6)
        val = (jnp.sin(px) / px) * (jnp.sin(px / 3.0) / (px / 3.0))
        return jnp.where(ax < 1e-6, 1.0, jnp.where(ax <= 3.0, val, 0.0))
    raise ValueError(f"unknown filter {ftype}")
