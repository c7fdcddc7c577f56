"""Compile-time table pool for the tabulated BSDF family.

The reference's tabulated/BTF plugins (ref: src/bsdfs/tabulated_bsdf.cpp,
tabulated_btf_4d.cpp) load measured tables per plugin instance; here
`compile_scene` binds all tables as one [K, n_ti, n_to, n_phi, 3] array.
They are scene-compile constants — jit
captures them by closure, so switching scenes retriggers specialization.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

_POOL = {"tables": None}


def register_tables(tables) -> None:
    """tables: [K, n_ti, n_to, n_phi, 3] BSDF values f(θi, θo, Δφ)
    (WITHOUT the cosine; eval multiplies |cosθo|)."""
    _POOL["tables"] = (None if tables is None
                       else jnp.asarray(np.asarray(tables, np.float32)))


def get_tables():
    return _POOL["tables"]


def tabulate_lambertian(albedo=(0.5, 0.5, 0.5), n_ti=8, n_to=8,
                        n_phi=16) -> np.ndarray:
    """Reference table for tests: constant f = albedo/π."""
    a = np.asarray(albedo, np.float32) / np.pi
    return np.broadcast_to(a, (n_ti, n_to, n_phi, 3)).copy()
