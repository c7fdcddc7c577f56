"""Discrete distributions: 1D CDF tables and 2D marginal/conditional tables.

Wavefront counterparts of the reference's DiscreteDistribution (ref:
include/mitsuba/core/pmf.h) and the envmap's row/column CDF scheme (ref:
src/emitters/envmap.cpp:99-106,567-601). CDFs are built host-side (numpy) at
scene-compile time and live in device memory as flat arrays; sampling is a vectorized
searchsorted + sample-reuse, matching `DiscreteDistribution::sampleReuse`.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np


class Discrete1D(NamedTuple):
    """Normalized CDF table. cdf[k] = P(X < k), cdf has K+1 entries with
    cdf[0] = 0 and cdf[K] = 1. pmf holds the normalized probabilities."""
    pmf: jnp.ndarray        # [K]
    cdf: jnp.ndarray        # [K+1]
    total: jnp.ndarray      # scalar — unnormalized sum (ref pmf.h getSum)

    @staticmethod
    def build(weights: np.ndarray) -> "Discrete1D":
        w = np.asarray(weights, np.float64).reshape(-1)
        w = np.maximum(w, 0.0)
        total = w.sum()
        if total <= 0:
            w = np.ones_like(w)
            total_n = w.sum()
            pmf = w / total_n
        else:
            pmf = w / total
        cdf = np.concatenate([[0.0], np.cumsum(pmf)])
        cdf[-1] = 1.0
        return Discrete1D(jnp.asarray(pmf, jnp.float32),
                          jnp.asarray(cdf, jnp.float32),
                          jnp.asarray(total, jnp.float32))

    def sample(self, u):
        """u ∈ [0,1) → index (pmf.h sample)."""
        idx = jnp.searchsorted(self.cdf, u, side="right") - 1
        return jnp.clip(idx, 0, self.pmf.shape[0] - 1)

    def sample_reuse(self, u):
        """Sample an index and rescale u to [0,1) within the chosen bin
        (pmf.h sampleReuse — reference reuses the random number to avoid
        burning a dimension, scene.cpp:832)."""
        idx = self.sample(u)
        lo = self.cdf[idx]
        p = jnp.maximum(self.pmf[idx], 1e-20)
        u_re = jnp.clip((u - lo) / p, 0.0, 1.0 - 1e-7)
        return idx, u_re, self.pmf[idx]


class Discrete2D(NamedTuple):
    """Row-marginal + per-row-conditional CDFs over an [H, W] density —
    the envmap importance table (envmap.cpp:282)."""
    density: jnp.ndarray    # [H, W] normalized so mean * H * W = 1-ish
    row_cdf: jnp.ndarray    # [H+1]
    col_cdf: jnp.ndarray    # [H, W+1]
    row_pmf: jnp.ndarray    # [H]
    col_pmf: jnp.ndarray    # [H, W]

    @staticmethod
    def build(density: np.ndarray) -> "Discrete2D":
        d = np.maximum(np.asarray(density, np.float64), 0.0)
        h, w = d.shape
        row_w = d.sum(axis=1)
        total = row_w.sum()
        if total <= 0:
            d = np.ones_like(d)
            row_w = d.sum(axis=1)
            total = row_w.sum()
        row_pmf = row_w / total
        row_cdf = np.concatenate([[0.0], np.cumsum(row_pmf)])
        row_cdf[-1] = 1.0
        col_pmf = d / np.maximum(row_w[:, None], 1e-300)
        col_cdf = np.concatenate(
            [np.zeros((h, 1)), np.cumsum(col_pmf, axis=1)], axis=1)
        col_cdf[:, -1] = 1.0
        # density normalized to a pdf over the unit square: value * H * W
        pdf_sq = d / total * (h * w)
        return Discrete2D(jnp.asarray(pdf_sq, jnp.float32),
                          jnp.asarray(row_cdf, jnp.float32),
                          jnp.asarray(col_cdf, jnp.float32),
                          jnp.asarray(row_pmf, jnp.float32),
                          jnp.asarray(col_pmf, jnp.float32))

    def sample(self, u2):
        """u ∈ [0,1)² → (row, col, pdf_wrt_unit_square)."""
        row = jnp.clip(
            jnp.searchsorted(self.row_cdf, u2[..., 0], side="right") - 1,
            0, self.row_pmf.shape[0] - 1)
        ccdf = self.col_cdf[row]
        col = jnp.clip(
            (jnp.sum(ccdf <= u2[..., 1][..., None], axis=-1) - 1),
            0, self.col_pmf.shape[1] - 1)
        pdf = self.density[row, col]
        return row, col, pdf

    def pdf(self, row, col):
        return self.density[row, col]
