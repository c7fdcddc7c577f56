"""Per-ray-time ray/triangle intersection for deforming geometry.

Counterpart of the reference's `deformable` shape — a 4D (space+time)
kd-tree whose leaves lerp vertex positions at the ray's time before the
triangle test (ref: src/shapes/deformable.cpp, sahkdtree4.h). The
wavefront replacement keeps two keyframe vertex buffers resident and
evaluates a Möller–Trumbore test against PER-RAY linearly-interpolated
triangles: unlike the static path (accel/dense.py), the Woop inverse
cannot be pre-baked because it is not linear in the vertex positions, so
the motion path trades the matmul formulation for fused elementwise FMAs
(still branchless, still cluster-streamed with lax.scan).

Used by integrator/motion.py `render_motion` when exact per-ray times
are requested, and directly for time-aware visibility queries. For
shading, the caller lerps per-vertex attributes with the same time.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

_DET_EPS = 1e-12


def triangle_buffers(mesh0, mesh1):
    """Host-side: two keyframe meshes (same topology) → (p0, e1, e2)
    pairs as float32 [T, 3] each."""
    assert mesh0.faces.shape == mesh1.faces.shape, "topology must match"
    f = mesh0.faces
    out = []
    for m in (mesh0, mesh1):
        v = np.asarray(m.vertices, np.float32)
        p0 = v[f[:, 0]]
        out += [p0, v[f[:, 1]] - p0, v[f[:, 2]] - p0]
    return tuple(np.ascontiguousarray(x) for x in out)


def intersect_motion_cluster(o, d, time, p0a, e1a, e2a, p0b, e1b, e2b,
                             mint, maxt):
    """Möller–Trumbore over one cluster with per-ray vertex lerp.

    o, d: [N, 3]; time: [N] in [0, 1]; p0a..e2b: [T, 3] keyframes.
    Returns (t [N], u, v, local idx, hit)."""
    tt = time[:, None, None]                           # [N, 1, 1]
    p0 = p0a[None] + tt * (p0b - p0a)[None]            # [N, T, 3]
    e1 = e1a[None] + tt * (e1b - e1a)[None]
    e2 = e2a[None] + tt * (e2b - e2a)[None]
    dv = d[:, None, :]
    pvec = jnp.cross(dv, e2)                           # [N, T, 3]
    det = jnp.sum(e1 * pvec, -1)
    inv_det = 1.0 / jnp.where(jnp.abs(det) < _DET_EPS, _DET_EPS, det)
    tvec = o[:, None, :] - p0
    u = jnp.sum(tvec * pvec, -1) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(dv * qvec, -1) * inv_det
    t = jnp.sum(e2 * qvec, -1) * inv_det
    hit = ((jnp.abs(det) >= _DET_EPS) & (u >= 0.0) & (v >= 0.0)
           & (u + v <= 1.0) & (t > mint[:, None]) & (t < maxt[:, None]))
    t_m = jnp.where(hit, t, jnp.inf)
    idx = jnp.argmin(t_m, axis=-1)
    ar = jnp.arange(o.shape[0])
    t_best = t_m[ar, idx]
    return (t_best, u[ar, idx], v[ar, idx], idx.astype(jnp.int32),
            jnp.isfinite(t_best))


def intersect_motion(o, d, time, bufs, mint=None, maxt=None,
                     cluster_size: int = 256):
    """Full-soup per-ray-time intersection, cluster-streamed.

    bufs = (p0a, e1a, e2a, p0b, e1b, e2b) from `triangle_buffers`.
    Returns (t, u, v, tri_id, hit)."""
    p0a = bufs[0]
    n = o.shape[0]
    if mint is None:
        mint = jnp.full((n,), 1e-4)
    if maxt is None:
        maxt = jnp.full((n,), jnp.inf)
    n_tris = p0a.shape[0]
    if n_tris <= cluster_size:
        return intersect_motion_cluster(o, d, time, *bufs, mint, maxt)

    n_clusters = -(-n_tris // cluster_size)
    pad = n_clusters * cluster_size - n_tris
    padded = []
    for b in bufs:
        b = jnp.asarray(b)
        if pad:
            b = jnp.pad(b, ((0, pad), (0, 0)))
        padded.append(b.reshape(n_clusters, cluster_size, 3))

    def body(carry, cl):
        bt, bu, bv, bid = carry
        (ca0, ce1, ce2, cb0, cf1, cf2, base) = cl
        t, u, v, idx, hit = intersect_motion_cluster(
            o, d, time, ca0, ce1, ce2, cb0, cf1, cf2, mint, maxt)
        closer = t < bt
        return (jnp.where(closer, t, bt), jnp.where(closer, u, bu),
                jnp.where(closer, v, bv),
                jnp.where(closer, idx + base, bid)), None

    init = (jnp.full((n,), jnp.inf), jnp.zeros((n,)), jnp.zeros((n,)),
            jnp.zeros((n,), jnp.int32))
    bases = jnp.arange(n_clusters, dtype=jnp.int32) * cluster_size
    (bt, bu, bv, bid), _ = jax.lax.scan(
        body, init, tuple(padded) + (bases,))
    return bt, bu, bv, bid, jnp.isfinite(bt)
