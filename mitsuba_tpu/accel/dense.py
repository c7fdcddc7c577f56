"""Dense ray-triangle intersection: dense Woop-transform clusters.

Design (SURVEY.md §7): instead of porting the reference's pointer-chasing SAH
kd-tree (ref: include/mitsuba/render/gkdtree.h:706, sahkdtree3.h:179 Havran
traversal, triaccel.h:33 Wald projection tests), intersection is reformulated
as dense linear algebra:

  For each triangle precompute the inverse affine map M⁻¹ taking world space
  to the triangle's barycentric frame (columns [e1, e2, n] at p0 — Woop's
  unit-triangle transform). Then for a wavefront of rays (o, d):

      o' = M⁻¹ (o - p0)   →  [N, 4] @ [4, 3T] matmul (homogeneous)
      d' = M⁻¹ d          →  [N, 3] @ [3, 3T] matmul
      t  = -o'_z / d'_z,  u = o'_x + t d'_x,  v = o'_y + t d'_y
      hit ⇔ u ≥ 0 ∧ v ≥ 0 ∧ u+v ≤ 1 ∧ t ∈ (mint, maxt)

  Everything is a matmul + elementwise mask + min-reduction: the exact shape
  of computation a wide vector machine is built for. No divergence, no stacks,
  no gather-per-node. Large scenes chunk the triangle axis with `lax.scan`
  (cluster streaming); a two-level variant with AABB cluster culling lives in
  accel/clusters.py.

This replaces the kd-tree for the *device* hot path; equivalent capability
(arbitrary triangle meshes, instancing via pre-transform at compile time).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..scene.scene import Intersection, SceneData

# Rays whose transformed direction w-component is below this are parallel to
# the triangle plane (no hit) — mirrors TriAccel's determinant epsilon.
_DZ_EPS = 1e-12


def build_woop(p0: np.ndarray, e1: np.ndarray, e2: np.ndarray):
    """Host-side precompute of packed Woop transforms.

    Returns (woop_o [4, 3T], woop_d [3, 3T]) in float32. Degenerate
    triangles (zero-area) get transforms that can never produce a hit.
    """
    t = p0.shape[0]
    from .. import native
    nat = native.woop_invert(p0, e1, e2) if native.available() else None
    if nat is not None:
        minv, trans = nat
    else:
        n = np.cross(e1, e2)
        m = np.stack([e1, e2, n], axis=-1)      # [T, 3, 3] cols e1,e2,n
        area2 = np.linalg.norm(n, axis=-1)
        good = area2 > 1e-18
        m_safe = np.where(good[:, None, None], m, np.eye(3)[None])
        minv = np.linalg.inv(m_safe)             # [T, 3, 3]
        # Degenerate: map all rays to "parallel" (d'_z = 0, o'_z = 1)
        minv = np.where(good[:, None, None], minv, 0.0)
        trans = -np.einsum("tij,tj->ti", minv, p0)   # [T, 3]
        trans = np.where(good[:, None], trans,
                         np.array([0.0, 0.0, 1.0]))

    # Pack: out[n, 3t+k] = sum_j in[n, j] * W[j, 3t+k]
    # woop_d[j, 3t+k] = minv[t, k, j];  woop_o adds the affine row
    # trans flattened as [3t+k] = trans[t, k]
    d_t = minv.transpose(0, 2, 1)            # d_t[t, j, k] = minv[t, k, j]
    woop_d = d_t.transpose(1, 0, 2).reshape(3, t * 3)
    woop_o = np.concatenate([woop_d, trans.reshape(-1)[None, :]], axis=0)
    return (np.ascontiguousarray(woop_o, np.float32),
            np.ascontiguousarray(woop_d, np.float32))


def _transform_rays(o, d, woop_o, woop_d, precision):
    """Apply packed transforms: returns o' [N, T, 3], d' [N, T, 3]."""
    n = o.shape[0]
    oh = jnp.concatenate([o, jnp.ones((n, 1), o.dtype)], axis=-1)
    op = jnp.dot(oh, woop_o, precision=precision)     # [N, 3T]
    dp = jnp.dot(d, woop_d, precision=precision)      # [N, 3T]
    t3 = woop_o.shape[1]
    return op.reshape(n, t3 // 3, 3), dp.reshape(n, t3 // 3, 3)


def intersect_cluster(o, d, woop_o, woop_d, mint, maxt,
                      precision=jax.lax.Precision.HIGHEST):
    """Intersect N rays against one triangle cluster (all T tris at once).

    Returns (t [N], u [N], v [N], local tri index [N], hit [N]).
    """
    op, dp = _transform_rays(o, d, woop_o, woop_d, precision)
    dz = dp[..., 2]
    safe_dz = jnp.where(jnp.abs(dz) < _DZ_EPS, _DZ_EPS, dz)
    t = -op[..., 2] / safe_dz                          # [N, T]
    u = op[..., 0] + t * dp[..., 0]
    v = op[..., 1] + t * dp[..., 1]
    hit = ((jnp.abs(dz) >= _DZ_EPS) & (u >= 0.0) & (v >= 0.0)
           & (u + v <= 1.0)
           & (t > mint[:, None]) & (t < maxt[:, None]))
    t_m = jnp.where(hit, t, jnp.inf)
    idx = jnp.argmin(t_m, axis=-1)                     # [N]
    ar = jnp.arange(o.shape[0])
    t_best = t_m[ar, idx]
    return (t_best, u[ar, idx], v[ar, idx], idx.astype(jnp.int32),
            jnp.isfinite(t_best))


def intersect_soup(o, d, woop_o, woop_d, mint, maxt, cluster_size=512,
                   precision=jax.lax.Precision.HIGHEST):
    """Intersect rays against the full soup, streaming triangle clusters
    with lax.scan to bound the [N, C] working set.

    Returns (t [N], u [N], v [N], tri_id [N] (global), hit [N]).
    """
    t3 = woop_o.shape[1]
    n_tris = t3 // 3
    if n_tris <= cluster_size:
        t, u, v, idx, hit = intersect_cluster(
            o, d, woop_o, woop_d, mint, maxt, precision)
        return t, u, v, idx, hit

    # pad to a multiple of cluster_size (builder guarantees this normally)
    n_clusters = -(-n_tris // cluster_size)
    pad = n_clusters * cluster_size - n_tris
    if pad:
        wo = jnp.pad(woop_o, ((0, 0), (0, 3 * pad)))
        wd = jnp.pad(woop_d, ((0, 0), (0, 3 * pad)))
    else:
        wo, wd = woop_o, woop_d
    wo = wo.reshape(4, n_clusters, 3 * cluster_size).transpose(1, 0, 2)
    wd = wd.reshape(3, n_clusters, 3 * cluster_size).transpose(1, 0, 2)

    def body(carry, cluster):
        bt, bu, bv, bid = carry
        cwo, cwd, base = cluster
        t, u, v, idx, hit = intersect_cluster(o, d, cwo, cwd, mint, maxt,
                                              precision)
        closer = t < bt
        bt = jnp.where(closer, t, bt)
        bu = jnp.where(closer, u, bu)
        bv = jnp.where(closer, v, bv)
        bid = jnp.where(closer, idx + base, bid)
        return (bt, bu, bv, bid), None

    n = o.shape[0]
    init = (jnp.full((n,), jnp.inf), jnp.zeros((n,)), jnp.zeros((n,)),
            jnp.zeros((n,), jnp.int32))
    bases = (jnp.arange(n_clusters, dtype=jnp.int32) * cluster_size)
    (bt, bu, bv, bid), _ = jax.lax.scan(body, init, (wo, wd, bases))
    hit = jnp.isfinite(bt)
    return bt, bu, bv, bid, hit


def fill_intersection(scene: SceneData, o, d, t, u, v, tri_id, hit
                      ) -> Intersection:
    """Gather per-triangle attributes for the chosen hits — the analog of
    Shape::fillIntersectionRecord (ref: shape.h:307). All attributes come
    from ONE row gather of the packed tri_attr table (one index pass instead of
    six); shading normal/uv are barycentric-
    interpolated."""
    w = 1.0 - u - v
    bary = jnp.stack([w, u, v], axis=-1)               # [N, 3]
    tri_id_c = jnp.where(hit, tri_id, 0)
    attr = scene.tri_attr[tri_id_c]                     # [N, 24]
    ng = attr[..., 0:3]
    vn = attr[..., 3:12].reshape(attr.shape[:-1] + (3, 3))
    vuv = attr[..., 12:18].reshape(attr.shape[:-1] + (3, 2))
    ns = jnp.sum(vn * bary[..., None], axis=-2)
    ns = ns * jax.lax.rsqrt(
        jnp.maximum(jnp.sum(ns * ns, axis=-1, keepdims=True), 1e-20))
    uv = jnp.sum(vuv * bary[..., None], axis=-2)
    t_safe = jnp.where(hit, t, 1.0)
    p = o + t_safe[..., None] * d
    mat_id = attr[..., 18].astype(jnp.int32)
    em_id = attr[..., 19].astype(jnp.int32)
    return Intersection(
        valid=hit, t=t, p=p, ng=ng, ns=ns, uv=uv,
        tri_id=tri_id_c,
        mat_id=jnp.where(hit, mat_id, -1),
        em_id=jnp.where(hit, em_id, -1))


def ray_intersect(scene: SceneData, o, d, mint=None, maxt=None,
                  cluster_size=512,
                  precision=jax.lax.Precision.HIGHEST) -> Intersection:
    """Full scene intersection (ref: Scene::rayIntersect, scene.h:187)."""
    n = o.shape[0]
    if mint is None:
        mint = jnp.full((n,), 1e-4)
    if maxt is None:
        maxt = jnp.full((n,), jnp.inf)
    t, u, v, tri, hit = intersect_soup(
        o, d, scene.woop_o, scene.woop_d, mint, maxt, cluster_size, precision)
    return fill_intersection(scene, o, d, t, u, v, tri, hit)


def ray_test(scene: SceneData, o, d, mint, maxt, cluster_size=512,
             precision=jax.lax.Precision.HIGHEST):
    """Shadow-ray predicate (ref: Scene::rayIntersect bool variant) —
    any-hit within (mint, maxt). Returns occluded [N] bool."""
    _, _, _, _, hit = intersect_soup(
        o, d, scene.woop_o, scene.woop_d, mint, maxt, cluster_size, precision)
    return hit
