"""Unidirectional path tracer with NEE + MIS + Russian roulette.

Wavefront re-design of the reference MIPathTracer (ref: src/integrators/
path/path.cpp:120-295; exact semantics in SURVEY Appendix A.2): the per-ray
`while` loop becomes a `lax.scan` over bounce index carrying masked wavefront
state — position, direction, throughput, accumulated radiance, the previous
BSDF pdf for MIS, and the RR eta scale. No recursion, no divergence: dead
lanes ride along masked (compacted each bounce on the trace-kernel path).

Defaults match the reference: rr_depth=5, RR continue prob
q = min(max(throughput)·η², 0.95) (path.cpp:278-289); MIS = power heuristic;
depth counts path vertices (camera vertex = 1), loop breaks when
depth ≥ max_depth (path.cpp:157-166).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import jax
import jax.numpy as jnp

from ..accel.dense import ray_intersect, ray_test
from ..bsdf.bsdf import (eval_bsdf_ex, pdf_bsdf_ex, perturb_shading_frame,
                         resolve_material, sample_bsdf_ex)
from ..core import rng
from ..core.math import SHADOW_EPSILON, Frame, dot
from ..emitter.emitter import (eval_area, eval_env, pdf_direct_area,
                               pdf_direct_env, sample_direct)
from ..scene.scene import SceneData
from .common import (DIM_BSDF_U1, DIM_BSDF_U2, DIM_NEE_POS, DIM_NEE_SEL,
                     DIM_RR, bounce_dim, mis_power, offset_ray_origin,
                     ray_mint)


# The intersector each JAX platform runs: the fused Triton trace kernel on
# the GPU, the XLA matmul intersector on the CPU (tests, oracles). There
# is no fallback between them.
TRACE_PATHS = {"gpu": "kernel", "cpu": "dense"}

# Scenes with at least this many trace-kernel clusters get their live
# lanes sorted by (origin cluster, direction octant) every bounce.
SORT_MIN_CLUSTERS = 32


def trace_path(platform: str | None = None) -> str:
    """"kernel" or "dense" for `platform` (default: JAX's backend)."""
    platform = platform or jax.default_backend()
    try:
        return TRACE_PATHS[platform]
    except KeyError:
        raise ValueError(f"no intersector for platform {platform!r}; "
                         f"supported: {sorted(TRACE_PATHS)}") from None


@dataclass(frozen=True)
class PathTracer:
    """Config mirroring MonteCarloIntegrator (ref: integrator.h:448-474).

    The intersector follows the platform (`trace_path`); on the kernel
    path the wavefront is compacted every bounce so dead lanes form
    all-dead ray blocks that the kernel skips, and on scenes of at least
    SORT_MIN_CLUSTERS clusters the live lanes are sorted for coherence.
    """
    max_depth: int = 8          # vertices incl. camera; -1 (∞) not supported
    rr_depth: int = 5
    hide_emitters: bool = False
    cluster_size: int = 512
    families: tuple | None = None   # static BSDF-family subset (dispatch)
    sampler: str = "independent"    # sampler/sampler.py kind
    spp: int = 0                    # strata count for stratified/ld samplers

    def _d1(self, seed, pixel, samp, dim):
        from ..sampler.sampler import draw_1d
        return draw_1d(self.sampler, seed, pixel, samp, self.spp, dim)

    def _d2(self, seed, pixel, samp, dim):
        from ..sampler.sampler import draw_2d
        return draw_2d(self.sampler, seed, pixel, samp, self.spp, dim)

    def specialized_for(self, scene) -> "PathTracer":
        """Restrict BSDF dispatch to the families this concrete scene uses
        (host-side; call before jit)."""
        import numpy as np
        fams = tuple(sorted(int(x) for x in np.unique(
            np.asarray(scene.mat_type))))
        return dataclasses.replace(self, families=fams)

    def _use_kernel(self):
        return trace_path() == "kernel"

    def _intersect(self, scene, o, d, mint, live=None):
        if self._use_kernel():
            from ..accel.pallas_trace import kernel_intersect
            return kernel_intersect(scene, o, d, mint, live=live)
        return ray_intersect(scene, o, d, mint=mint,
                             cluster_size=self.cluster_size)

    def _occluded(self, scene, o, d, mint, maxt, live=None):
        if self._use_kernel():
            from ..accel.pallas_trace import kernel_occluded
            return kernel_occluded(scene, o, d, mint, maxt, live=live)
        return ray_test(scene, o, d, mint, maxt,
                        cluster_size=self.cluster_size)

    def _shade(self, scene, its, frame, mat, wi_local, d, throughput,
               L, ds, hit, active, nee_allowed, depth, eta_scale,
               seed, pixel_id, sample_idx, bounce, compact, orig):
        """Shading tail: NEE eval + shadow trace + MIS + BSDF sample
        + RR."""
        wo_nee = Frame.to_local(frame, ds.d)
        f_nee = eval_bsdf_ex(mat, wi_local, wo_nee, self.families)
        contributes = nee_allowed & (ds.pdf > 0) & (
            jnp.any(f_nee > 0, axis=-1))
        # shadow ray: [ε, dist·(1-ShadowEpsilon)] (scene.cpp:846)
        so = offset_ray_origin(its.p, its.ng, ds.d)
        smax = ds.dist * (1.0 - SHADOW_EPSILON)
        occluded = self._occluded(
            scene, so, ds.d, ray_mint(so), smax,
            live=contributes if compact else None)
        contributes = contributes & ~occluded
        bsdf_pdf_nee = pdf_bsdf_ex(mat, wi_local, wo_nee,
                                   self.families)
        w_nee = jnp.where(ds.is_delta, 1.0,
                          mis_power(ds.pdf, bsdf_pdf_nee))
        L = L + jnp.where(contributes[..., None],
                          throughput * ds.value * f_nee
                          * w_nee[..., None], 0.0)

        # ---- BSDF sampling → next ray ------------------------------
        u2 = self._d2(seed, pixel_id, sample_idx,
                      bounce_dim(bounce, DIM_BSDF_U2))
        u1 = self._d1(seed, pixel_id, sample_idx,
                      bounce_dim(bounce, DIM_BSDF_U1))
        bs = sample_bsdf_ex(mat, wi_local, u2, u1, self.families)
        d_next = Frame.to_world(frame, bs.wo)
        o_next = offset_ray_origin(its.p, its.ng, d_next)
        bsdf_ok = bs.pdf > 0
        throughput_next = throughput * bs.weight
        alive = hit & bsdf_ok & jnp.any(throughput_next > 0, axis=-1)

        # depth cutoff: stop when depth ≥ max_depth (path.cpp:157-166)
        if self.max_depth > 0:
            alive = alive & (depth <= self.max_depth)

        # ---- Russian roulette (path.cpp:278-289) -------------------
        eta_scale_next = eta_scale * bs.eta
        q = jnp.minimum(
            jnp.max(throughput_next, axis=-1) * eta_scale_next ** 2,
            0.95)
        u_rr = self._d1(seed, pixel_id, sample_idx,
                        bounce_dim(bounce, DIM_RR))
        do_rr = depth >= self.rr_depth
        rr_continue = ~do_rr | (u_rr < q)
        throughput_next = jnp.where(
            (do_rr & rr_continue)[..., None],
            throughput_next / jnp.maximum(q, 1e-6)[..., None],
            throughput_next)
        alive = alive & rr_continue

        return (o_next, jnp.where(alive[..., None], d_next, d),
                jnp.where(alive[..., None], throughput_next, 0.0),
                L, alive, eta_scale_next,
                jnp.where(bs.is_delta, 1.0, bs.pdf),
                bs.is_delta, pixel_id, sample_idx, orig)

    def li(self, scene: SceneData, o, d, seed, pixel_id, sample_idx=0):
        """Radiance along primary rays (o, d) [N, 3].

        seed: uint32 scalar; pixel_id: [N] uint32; sample_idx: scalar or
        [N] uint32 — together they key every random draw through the
        configured sampler (replayable for path-replay AD).
        """
        return self.li_stats(scene, o, d, seed, pixel_id, sample_idx)[0]

    def li_stats(self, scene: SceneData, o, d, seed, pixel_id,
                 sample_idx=0, tex_lod=None):
        """Like li, but also returns the traced-ray count (intersection +
        shadow rays over live lanes) — the wavefront analog of the
        reference's "Normal/Shadow rays traced" counters
        (ref: skdtree.cpp:46-47).

        tex_lod: optional [N] primary-hit uv footprint extents — texture
        lookups at bounce 0 go through the matching mip level (LoD path
        tracing, integrator/footprint.py)."""
        n = o.shape[0]
        # Per-bounce lane compaction: dead lanes pack into the tail each
        # bounce (O(N) partition; pixel/sample ids ride along so the
        # counter RNG streams are untouched), and the trace kernel skips
        # all-dead ray blocks. The dense path keeps the plain loop.
        compact = self._use_kernel()
        tc_trace = scene.trace_woop.shape[1] // scene.trace_box.shape[1]
        sort_lanes = compact and (
            scene.trace_box.shape[1] >= SORT_MIN_CLUSTERS)
        pix0 = jnp.broadcast_to(jnp.asarray(pixel_id, jnp.uint32), (n,))
        samp0 = jnp.broadcast_to(
            jnp.asarray(sample_idx, jnp.uint32), (n,))

        def step(args, bounce):
            (o, d, throughput, L, active, eta_scale, prev_pdf,
             prev_delta, pixel_id, sample_idx, orig, n_rays) = args

            its = self._intersect(scene, o, d, ray_mint(o),
                                  live=active if compact else None)

            # ---- escaped rays: environment emitter ---------------------
            escaped = active & ~its.valid
            env_rad = eval_env(scene, d)
            env_pdf = pdf_direct_env(scene, d)
            w_env = jnp.where(prev_delta, 1.0, mis_power(prev_pdf, env_pdf))
            first = bounce == 0
            w_env = jnp.where(first & self.hide_emitters, 0.0, w_env)
            L = L + jnp.where(escaped[..., None],
                              throughput * env_rad * w_env[..., None], 0.0)

            # ---- emitter hit on a surface ------------------------------
            hit = active & its.valid
            cos_surf = -dot(d, its.ng)          # >0 ⇒ hit the front side
            le = eval_area(scene, its.em_id, cos_surf)
            nee_pdf_hit = pdf_direct_area(scene, its.em_id, d, its.t,
                                          cos_surf)
            w_hit = jnp.where(prev_delta, 1.0,
                              mis_power(prev_pdf, nee_pdf_hit))
            w_hit = jnp.where(first & self.hide_emitters, 0.0, w_hit)
            L = L + jnp.where(hit[..., None],
                              throughput * le * w_hit[..., None], 0.0)

            # current path depth (vertices): camera=1, this hit adds one
            depth = bounce + 2

            # ---- set up shading frame ----------------------------------
            # (tex_lod is only consulted at bounce 0, before any
            # compaction has reordered lanes)
            lod0 = None if tex_lod is None else \
                jnp.where(bounce == 0, tex_lod, 0.0)
            mat = resolve_material(scene, its.mat_id, its.uv,
                                   self.families, lod_extent=lod0)
            frame = Frame.from_normal(its.ns)
            frame = perturb_shading_frame(scene, mat, frame, its.uv)
            wi_local = Frame.to_local(frame, -d)

            # ---- next-event estimation ---------------------------------
            # skip when the *next* vertex would exceed max_depth
            nee_allowed = hit & (depth + 1 <= self.max_depth + 1) \
                if self.max_depth > 0 else hit
            u_sel = self._d1(seed, pixel_id, sample_idx,
                             bounce_dim(bounce, DIM_NEE_SEL))
            u_pos = self._d2(seed, pixel_id, sample_idx,
                             bounce_dim(bounce, DIM_NEE_POS))
            ds = sample_direct(scene, its.p, u_sel, u_pos)
            n_rays = (n_rays + jnp.sum(active.astype(jnp.uint32))
                      + jnp.sum((nee_allowed & (ds.pdf > 0))
                                .astype(jnp.uint32)))
            out = self._shade(
                scene, its, frame, mat, wi_local, d, throughput, L,
                ds, hit, active, nee_allowed, depth, eta_scale,
                seed, pixel_id, sample_idx, bounce, compact, orig)
            if compact:
                if sort_lanes:
                    # coherence sort: live lanes ordered by (origin
                    # cluster, direction octant), dead lanes to the tail
                    # as in the partition. Cluster ids are
                    # Morton-ordered (builder), so nearby ids = nearby
                    # space: consecutive trace blocks then see rays with
                    # tight origins, and the trace kernel's per-block
                    # cluster-AABB slab gate can actually reject
                    # clusters (incoherent blocks almost never can).
                    # Same estimator, same per-lane values — the RNG is
                    # keyed by (pixel, sample) ids that ride along.
                    alive_o = out[4]
                    clus = (jnp.where(alive_o, its.tri_id, 0)
                            // tc_trace).astype(jnp.uint32)
                    octant = ((out[1][:, 0] < 0).astype(jnp.uint32) * 4
                              + (out[1][:, 1] < 0).astype(jnp.uint32) * 2
                              + (out[1][:, 2] < 0).astype(jnp.uint32))
                    key = jnp.where(alive_o, (clus << 3) | octant,
                                    jnp.uint32(0xFFFFFFFF))
                    src_idx = jnp.argsort(key).astype(jnp.int32)
                else:
                    # stable partition: live-lane prefix, dead-lane suffix
                    ai = out[4].astype(jnp.int32)
                    live_rank = jnp.cumsum(ai) - ai
                    dead_rank = jnp.cumsum(1 - ai) - (1 - ai)
                    dest = jnp.where(out[4], live_rank,
                                     jnp.sum(ai) + dead_rank)
                    src_idx = jnp.zeros((n,), jnp.int32).at[dest].set(
                        jnp.arange(n, dtype=jnp.int32))
                # ONE [N, 19] row gather instead of 11 array gathers:
                # one index pass moves the whole carry. Integer lanes
                # ride as bitcast f32 (gathers move bits; the round-trip
                # is exact).
                as_f = lambda x: jax.lax.bitcast_convert_type(
                    x, jnp.float32)[..., None]
                packed = jnp.concatenate([
                    out[0], out[1], out[2], out[3],           # 4×[N,3]
                    out[4].astype(jnp.float32)[..., None],    # alive
                    out[5][..., None], out[6][..., None],
                    out[7].astype(jnp.float32)[..., None],    # is_delta
                    as_f(out[8]), as_f(out[9]), as_f(out[10]),
                ], axis=1)[src_idx]
                as_u = lambda x: jax.lax.bitcast_convert_type(
                    x[..., 0], jnp.uint32)
                out = (packed[:, 0:3], packed[:, 3:6], packed[:, 6:9],
                       packed[:, 9:12],
                       packed[:, 12] > 0.5,
                       packed[:, 13], packed[:, 14],
                       packed[:, 15] > 0.5,
                       as_u(packed[:, 16:17]), as_u(packed[:, 17:18]),
                       jax.lax.bitcast_convert_type(
                           packed[:, 18:19][..., 0], jnp.int32))
            return out + (n_rays,)

        def bounce_body(carry, bounce):
            return step(carry, bounce), None

        n_bounces = self.max_depth if self.max_depth > 0 else 32
        # Derive carry inits from `o` so they inherit its varying-axes
        # status under shard_map (constants would trip the scan vma check).
        zf = o[..., 0] * 0.0            # [N] zeros, varying like o
        zero3 = jnp.zeros_like(o)
        orig0 = zf.astype(jnp.int32) + jnp.arange(n, dtype=jnp.int32)
        init = (o, d, zero3 + 1.0, zero3, zf < 1.0,
                zf + 1.0, zf + 1.0, zf < 1.0,
                pix0 + zf.astype(jnp.uint32),
                samp0 + zf.astype(jnp.uint32), orig0,
                (zf.sum() * 0.0).astype(jnp.uint32))
        (o_, d_, tp, L, _a, _e, _p, _pd, _px, _sp, orig, n_rays), _ = \
            jax.lax.scan(bounce_body, init, jnp.arange(n_bounces))
        if compact:
            # restore caller lane order (lanes moved with the partition)
            L = jnp.zeros_like(L).at[orig].set(L)
        return L, n_rays
