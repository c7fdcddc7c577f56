"""Specular manifold walks (Manifold Exploration, Jakob & Marschner 2012).

Counterpart of the reference's `SpecularManifold` (ref:
include/mitsuba/bidir/manifold.h:35, src/libbidir/manifold.cpp — the
Newton solver behind the `mut_manifold` MLT mutation, mut_manifold.cpp).
Given a chain  a → x₁ → … → x_k → b  whose interior vertices lie on
specular triangles, the walk moves the interior vertices *on their
triangles* until each one satisfies its reflection/refraction constraint:
the generalized half-vector

    h_i = normalize( normalize(x_{i-1} − x_i) + η_i · normalize(x_{i+1} − x_i) )

must be parallel to the surface normal at x_i (η_i = 1 for mirrors, the
relative IOR for refraction). The constraint is expressed in the local
tangent frame, c_i(U) = (h_i·t_i, h_i·b_i) ∈ ℝ², and the stacked system
c(U) = 0 over U = (u_i, v_i)_{i=1..k} is solved by damped Newton.

Wavefront redesign vs the reference: manifold.cpp hand-derives the sparse
block-tridiagonal Jacobian and back-substitutes one path at a time. Here
the chain is a pure function of U, the Jacobian comes from `jax.jacfwd`
(forward-mode over 2k ≤ 8 unknowns — one trace, no hand derivatives),
the 2k×2k dense solve is a few matmul-sized ops, and the whole walk vmaps
over thousands of chains at once (`manifold_walk` is `vmap`/`jit`
compatible; fixed iteration count, masked convergence — no data-dependent
control flow).

Smooth shading: pass per-corner normals and the constraint uses the
barycentric-interpolated normal exactly like `fillIntersectionRecord`.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["manifold_walk", "chain_constraint"]


def _normalize(v, eps=1e-20):
    return v * jax.lax.rsqrt(jnp.maximum(jnp.sum(v * v, -1, keepdims=True),
                                         eps))


def _chain_points(tri_a, tri_e1, tri_e2, uv):
    """x_i = A_i + u_i·E1_i + v_i·E2_i  for uv [k, 2] on tris [k, 3]."""
    return tri_a + uv[:, 0:1] * tri_e1 + uv[:, 1:2] * tri_e2


def _vertex_normals(tri_n0, tri_n1, tri_n2, uv):
    """Barycentric-interpolated unit normals at each chain vertex."""
    w = 1.0 - uv[:, 0:1] - uv[:, 1:2]
    n = w * tri_n0 + uv[:, 0:1] * tri_n1 + uv[:, 1:2] * tri_n2
    return _normalize(n)


def chain_constraint(uv, a, b, tri_a, tri_e1, tri_e2,
                     tri_n0, tri_n1, tri_n2, eta):
    """Stacked tangent-plane constraint c(U) ∈ ℝ^{2k}.

    uv:      [k, 2] barycentric unknowns
    a, b:    [3] fixed chain endpoints
    tri_*:   [k, 3] triangle origin/edges and corner normals
    eta:     [k] relative IOR per vertex (1 = mirror reflection)
    """
    x = _chain_points(tri_a, tri_e1, tri_e2, uv)            # [k, 3]
    n = _vertex_normals(tri_n0, tri_n1, tri_n2, uv)         # [k, 3]
    prev = jnp.concatenate([a[None], x[:-1]], axis=0)       # x_{i-1}
    nxt = jnp.concatenate([x[1:], b[None]], axis=0)         # x_{i+1}
    wi = _normalize(prev - x)
    wo = _normalize(nxt - x)
    h = wi + eta[:, None] * wo
    # half-vector sign is irrelevant; normalize for conditioning
    h = _normalize(h)
    # tangent frame from the geometric edges (independent of uv), then
    # orthogonalized against the *shading* normal so c = 0 ⇔ h ∥ n
    t = _normalize(tri_e1 - jnp.sum(tri_e1 * n, -1, keepdims=True) * n)
    bvec = jnp.cross(n, t)
    return jnp.stack([jnp.sum(h * t, -1), jnp.sum(h * bvec, -1)],
                     axis=-1).reshape(-1)                   # [2k]


def manifold_walk(a, b, tri_a, tri_e1, tri_e2, uv0,
                  tri_n0=None, tri_n1=None, tri_n2=None, eta=None,
                  n_steps: int = 24, damping: float = 1.0,
                  tol: float = 1e-6):
    """Newton-solve the specular chain; returns (uv [k,2], x [k,3], ok).

    ok is True when the final |c|_∞ < tol AND every vertex stays inside
    its triangle (u, v, 1−u−v ≥ −1e-4 — the reference's walk fails a
    mutation when a vertex leaves the manifold, manifold.cpp `move`).
    Flat shading: omit tri_n* (geometric normals from E1×E2).
    """
    k = uv0.shape[0]
    if tri_n0 is None:
        ng = _normalize(jnp.cross(tri_e1, tri_e2))
        tri_n0 = tri_n1 = tri_n2 = ng
    if eta is None:
        eta = jnp.ones((k,))

    def cfun(uv_flat):
        return chain_constraint(uv_flat.reshape(k, 2), a, b, tri_a,
                                tri_e1, tri_e2, tri_n0, tri_n1, tri_n2,
                                eta)

    def step(uv_flat, _):
        c = cfun(uv_flat)
        jac = jax.jacfwd(cfun)(uv_flat)                     # [2k, 2k]
        # damped Newton with Tikhonov guard against singular Jacobians
        jtj = jac.T @ jac + 1e-9 * jnp.eye(2 * k)
        delta = jnp.linalg.solve(jtj, jac.T @ c)
        # keep the step bounded (trust region in barycentric units)
        norm = jnp.sqrt(jnp.sum(delta * delta))
        scale = jnp.minimum(1.0, 0.5 * k / jnp.maximum(norm, 1e-12))
        new = uv_flat - damping * scale * delta
        # if the constraint norm did not decrease, halve the step
        better = jnp.sum(cfun(new) ** 2) <= jnp.sum(c ** 2)
        new = jnp.where(better, new,
                        uv_flat - 0.5 * damping * scale * delta)
        return new, None

    uv_flat, _ = jax.lax.scan(step, uv0.reshape(-1), None,
                              length=n_steps)
    uv = uv_flat.reshape(k, 2)
    c = cfun(uv_flat)
    inside = ((uv[:, 0] >= -1e-4) & (uv[:, 1] >= -1e-4)
              & (uv[:, 0] + uv[:, 1] <= 1.0 + 1e-4)).all()
    ok = (jnp.max(jnp.abs(c)) < tol) & inside
    x = _chain_points(tri_a, tri_e1, tri_e2, uv)
    return uv, x, ok
