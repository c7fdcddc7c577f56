"""Fused trace kernel (Pallas through Triton): Woop-transform intersection
with every intermediate in registers.

The XLA intersector (accel/dense.py) writes the transformed ray
coordinates op/dp, [N, 3·cluster_size] f32 each, to device memory for
every cluster step. This kernel keeps them on chip:

  grid = (ray blocks,); one program owns a power-of-two block of B rays
  and loops over the triangle clusters itself. Per cluster:
    1. slab test of the cluster's world AABB against the block; a
       cluster no ray of the block can enter is skipped whole;
    2. broadcast-FMA Woop transform of the [B, TC] ray × triangle tile,
       t/u/v and the hit mask, all in registers;
    3. row min over the TC triangles, first index achieving it, and a
       best-so-far (t, tri) per ray carried in registers across clusters.

The any-hit (shadow) variant stops walking clusters once every live ray
of the block has found an occluder.

The kernel returns the hit triangle index only. t/u/v for that one
triangle are recomputed in jnp from its Woop rows (`hit_from_woop`), so
AD through a trace gives exactly what it gives through dense.py and no
custom VJP is needed; the kernel's inputs are detached.

This replaces the reference's SAH kd-tree traversal as the device hot
path (ref: sahkdtree3.h:179 Havran traversal, triaccel.h:33): one level of
spatially compact (Morton-ordered) triangle clusters with AABB culling.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..scene.scene import Intersection, SceneData
from .dense import _DZ_EPS, fill_intersection

TRACE_TC = 32           # triangles per cluster step (tile columns)
TRACE_BLOCK = 128       # rays per program (tile rows)
TRACE_WARPS = 4
_MISS = 3.0e38


def build_cluster_aabbs(p0, e1, e2, tc: int, c_clusters: int
                        ) -> np.ndarray:
    """World AABB per tc-sized trace cluster → [C, 8] f32 (min xyz,
    max xyz, 2 pad columns). Empty clusters (all padding) get an inverted
    box, so the slab test rejects every ray. Clusters are consecutive
    triangle ranges — with the builder's Morton order they are spatially
    compact, the LBVH-style leaf level that replaces the kd-tree."""
    n = len(p0)
    out = np.empty((c_clusters, 8), np.float32)
    out[:, 0:3] = 1e30
    out[:, 3:6] = -1e30
    out[:, 6:8] = 0.0
    if n:
        v0 = np.asarray(p0, np.float64)
        v1 = v0 + np.asarray(e1, np.float64)
        v2 = v0 + np.asarray(e2, np.float64)
        lo = np.minimum(np.minimum(v0, v1), v2)
        hi = np.maximum(np.maximum(v0, v1), v2)
        for c in range(min(c_clusters, -(-n // tc))):
            s = slice(c * tc, min((c + 1) * tc, n))
            out[c, 0:3] = lo[s].min(0)
            out[c, 3:6] = hi[s].max(0)
    return out


def build_trace_tables(woop_o: np.ndarray, p0, e1, e2, n_real: int,
                       tc: int = TRACE_TC):
    """Kernel layout of the first `n_real` triangles.

    Returns (woop [12, C·tc] f32: row 4k+j holds Woop matrix entry (k, j)
    of every triangle, k ∈ {x', y', z'}, j ∈ {x, y, z, translation};
    boxes [8, C] f32: the transposed build_cluster_aabbs table). Padding
    triangles get a zero matrix with translation z' = 1, so d'_z = 0 and
    they never hit. Triangle ids are those of the scene arrays."""
    n_tris = woop_o.shape[1] // 3
    n_real = min(n_real, n_tris)
    c = max(1, -(-n_real // tc))
    w = np.zeros((4, c * tc, 3), np.float32)
    w[3, :, 2] = 1.0
    w[:, :n_real] = woop_o.reshape(4, n_tris, 3)[:, :n_real]
    woop = np.ascontiguousarray(w.transpose(2, 0, 1).reshape(12, c * tc))
    boxes = build_cluster_aabbs(p0[:n_real], e1[:n_real], e2[:n_real],
                                tc, c)
    return woop, np.ascontiguousarray(boxes.T)


def _safe_inv(x):
    return jnp.where(jnp.abs(x) < 1e-12,
                     jnp.where(x >= 0.0, 1e30, -1e30), 1.0 / x)


def _trace_kernel(rays_ref, woop_ref, box_ref, tri_ref, *, tc: int,
                  n_clusters: int, any_hit: bool):
    """One program: B rays against every cluster. rays_ref rows: o xyz,
    d xyz, mint, maxt; a lane with maxt <= mint is dead (reports miss)."""
    ox, oy, oz = rays_ref[0, :], rays_ref[1, :], rays_ref[2, :]
    dx, dy, dz = rays_ref[3, :], rays_ref[4, :], rays_ref[5, :]
    mint, maxt = rays_ref[6, :], rays_ref[7, :]
    b = ox.shape[0]
    live = maxt > mint
    ix, iy, iz = _safe_inv(dx), _safe_inv(dy), _safe_inv(dz)
    cols = jax.lax.broadcasted_iota(jnp.int32, (b, tc), 1)
    col = lambda x: x[:, None]

    def visit(c, t_best, tri_best):
        # top level: slab test of the cluster AABB against the block
        t0x = (box_ref[0, c] - ox) * ix
        t1x = (box_ref[3, c] - ox) * ix
        t0y = (box_ref[1, c] - oy) * iy
        t1y = (box_ref[4, c] - oy) * iy
        t0z = (box_ref[2, c] - oz) * iz
        t1z = (box_ref[5, c] - oz) * iz
        cap = jnp.minimum(maxt, t_best)
        if any_hit:
            cap = jnp.where(tri_best >= 0, -1.0, cap)
        near = jnp.maximum(jnp.maximum(jnp.minimum(t0x, t1x),
                                       jnp.minimum(t0y, t1y)),
                           jnp.maximum(jnp.minimum(t0z, t1z), mint))
        far = jnp.minimum(jnp.minimum(jnp.maximum(t0x, t1x),
                                      jnp.maximum(t0y, t1y)),
                          jnp.minimum(jnp.maximum(t0z, t1z), cap))
        enter = jnp.max(jnp.where(live & (near <= far), 1, 0)) > 0

        def test(t_best, tri_best):
            base = c * tc
            w = [woop_ref[r, pl.ds(base, tc)][None, :] for r in range(12)]

            def xf(k):
                w0, w1, w2, tr = w[4 * k:4 * k + 4]
                return (w0 * col(ox) + w1 * col(oy) + w2 * col(oz) + tr,
                        w0 * col(dx) + w1 * col(dy) + w2 * col(dz))

            opx, dpx = xf(0)
            opy, dpy = xf(1)
            opz, dpz = xf(2)
            safe_dz = jnp.where(jnp.abs(dpz) < _DZ_EPS, _DZ_EPS, dpz)
            t = -opz / safe_dz
            u = opx + t * dpx
            v = opy + t * dpy
            mask = ((jnp.abs(dpz) >= _DZ_EPS) & (u >= 0.0) & (v >= 0.0)
                    & (u + v <= 1.0) & (t > col(mint)) & (t < col(maxt)))
            tm = jnp.where(mask, t, _MISS)
            t_c = jnp.min(tm, axis=1)
            j = jnp.min(jnp.where(tm == col(t_c), cols, tc), axis=1)
            closer = t_c < t_best
            return (jnp.where(closer, t_c, t_best),
                    jnp.where(closer, base + j, tri_best))

        return jax.lax.cond(enter, test, lambda t, i: (t, i),
                            t_best, tri_best)

    def walk():
        init = (jnp.full((b,), _MISS, jnp.float32),
                jnp.full((b,), -1, jnp.int32))
        if not any_hit:
            return jax.lax.fori_loop(
                0, n_clusters, lambda c, s: visit(c, *s), init)[1]

        def more(s):
            pending = jnp.max(jnp.where(live & (s[2] < 0), 1, 0)) > 0
            return (s[0] < n_clusters) & pending

        def step(s):
            return (s[0] + 1,) + visit(s[0], s[1], s[2])

        return jax.lax.while_loop(more, step, (jnp.int32(0),) + init)[2]

    any_live = jnp.max(jnp.where(live, 1, 0)) > 0
    tri_ref[:] = jax.lax.cond(any_live, walk,
                              lambda: jnp.full((b,), -1, jnp.int32))


@functools.partial(jax.jit, static_argnames=("any_hit", "block", "tc",
                                             "num_warps", "interpret"))
def trace_ids(woop, boxes, rays, *, any_hit: bool = False,
              block: int = TRACE_BLOCK, tc: int = TRACE_TC,
              num_warps: int = TRACE_WARPS, interpret: bool = False):
    """Hit triangle id per ray, -1 for a miss.

    woop [12, C·tc], boxes [8, C] (build_trace_tables); rays [8, N] with
    N a multiple of `block` (rows o xyz, d xyz, mint, maxt). any_hit=True
    returns SOME occluder in (mint, maxt), not the closest. `interpret`
    runs the kernel on the CPU, for tests only."""
    n = rays.shape[1]
    assert n % block == 0, (n, block)
    n_clusters = boxes.shape[1]
    assert woop.shape == (12, n_clusters * tc), (woop.shape, tc)
    kernel = functools.partial(_trace_kernel, tc=tc, n_clusters=n_clusters,
                               any_hit=any_hit)
    # under shard_map the rays vary over mesh axes and the scene tables do
    # not; the kernel takes (and its ids keep) the rays' variance
    vma = jax.typeof(rays).vma
    if vma:
        woop, boxes = (jax.lax.pcast(x, tuple(vma), to="varying")
                       for x in (woop, boxes))
    return pl.pallas_call(
        kernel,
        grid=(n // block,),
        in_specs=[pl.BlockSpec((8, block), lambda i: (0, i)),
                  pl.BlockSpec(woop.shape, lambda i: (0, 0)),
                  pl.BlockSpec(boxes.shape, lambda i: (0, 0))],
        out_specs=pl.BlockSpec((block,), lambda i: (i,)),
        out_shape=jax.ShapeDtypeStruct((n,), jnp.int32, vma=vma),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        interpret=interpret,
        name="any_hit_trace" if any_hit else "closest_hit_trace",
    )(rays, woop, boxes)


def _pack_rays(o, d, mint, maxt, live, block):
    """[8, N_pad] kernel ray rows; dead and padding lanes get maxt = -inf."""
    n = o.shape[0]
    maxt = jnp.broadcast_to(maxt, (n,))
    if live is not None:
        maxt = jnp.where(live, maxt, -jnp.inf)
    rows = jnp.concatenate([o.T, d.T, jnp.broadcast_to(mint, (n,))[None],
                            maxt[None]], axis=0).astype(jnp.float32)
    n_pad = (-n) % block
    if n_pad:
        fill = jnp.zeros((8, n_pad), jnp.float32).at[7].set(-jnp.inf)
        rows = jnp.concatenate([rows, fill], axis=1)
    return jax.lax.stop_gradient(rows)


def hit_from_woop(woop_o, woop_d, o, d, tri, hit):
    """(t, u, v) of triangle `tri` per ray from its Woop rows — the same
    arithmetic as dense.intersect_cluster on one column, written as
    elementwise sums (no reduced-precision matmul). It reads woop_o for
    the origin and woop_d for the direction as dense.py does, so AD
    through it lands where AD through dense.py does. Misses give t = inf,
    u = v = 0."""
    n_tris = woop_o.shape[1] // 3
    ro = woop_o.T.reshape(n_tris, 3, 4)[tri]              # [N, k, j]
    rd = woop_d.T.reshape(n_tris, 3, 3)[tri]
    op = (ro[..., 0] * o[:, None, 0] + ro[..., 1] * o[:, None, 1]
          + ro[..., 2] * o[:, None, 2] + ro[..., 3])
    dp = (rd[..., 0] * d[:, None, 0] + rd[..., 1] * d[:, None, 1]
          + rd[..., 2] * d[:, None, 2])
    dz = dp[:, 2]
    safe_dz = jnp.where(jnp.abs(dz) < _DZ_EPS, _DZ_EPS, dz)
    t = -op[:, 2] / safe_dz
    u = op[:, 0] + t * dp[:, 0]
    v = op[:, 1] + t * dp[:, 1]
    return (jnp.where(hit, t, jnp.inf), jnp.where(hit, u, 0.0),
            jnp.where(hit, v, 0.0))


def kernel_intersect(scene: SceneData, o, d, mint, maxt=jnp.inf,
                     live=None, interpret: bool = False) -> Intersection:
    """Closest-hit trace through the kernel; hit record from the Woop
    recompute and one packed-attribute gather. `live`: optional [N] lane
    mask — dead lanes report a miss and all-dead blocks skip tracing."""
    n = o.shape[0]
    rays = _pack_rays(o, d, mint, maxt, live, TRACE_BLOCK)
    tri = trace_ids(scene.trace_woop, scene.trace_box, rays,
                    interpret=interpret)[:n]
    hit = tri >= 0
    tri = jnp.maximum(tri, 0)
    t, u, v = hit_from_woop(scene.woop_o, scene.woop_d, o, d, tri, hit)
    return fill_intersection(scene, o, d, t, u, v, tri, hit)


def kernel_occluded(scene: SceneData, o, d, mint, maxt, live=None,
                    interpret: bool = False):
    """Any-hit (shadow) trace: occluded [N] bool."""
    n = o.shape[0]
    rays = _pack_rays(o, d, mint, maxt, live, TRACE_BLOCK)
    tri = trace_ids(scene.trace_woop, scene.trace_box, rays, any_hit=True,
                    interpret=interpret)
    return tri[:n] >= 0
