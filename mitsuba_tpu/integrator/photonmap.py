"""Photon mapping: photon tracing, spatial-hash map, density estimation,
and progressive (PPM/SPPM-class) refinement.

Counterpart of the reference's photon-map family (ref: src/integrators/
photonmapper/{photonmapper,ppm,sppm}.cpp over render/photonmap.h:34,
particleproc.h:128, gatherproc.h:35). Wavefront redesign:

  * the balanced point kd-tree with kNN gather (photonmap.h, photon.h:57)
    becomes a **sorted spatial hash grid**: photons are hashed to cells of
    side = gather radius, sorted by cell id (one argsort), and cell spans
    found with searchsorted — all jittable, no pointers;
  * kNN density estimation becomes fixed-radius estimation with the
    progressive radius schedule of Knaus & Zwicker 2011 ("Progressive
    photon mapping: a probabilistic approach"): rᵢ² ∝ Π (k+α)/(k+1) → the
    same vanishing-bias guarantee as the reference's `ppm`/`sppm`
    per-pixel statistics, without mutable per-pixel state;
  * photon tracing reuses the particle-walk of integrator/ptracer.py; the
    estimator is: camera ray → (through delta chains) first smooth hit →
    emitted + direct NEE + photon estimate of indirect (photons deposited
    at depth ≥ 2 only, so NEE direct light is not double counted).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..bsdf.bsdf import (eval_bsdf_ex, resolve_material, sample_bsdf_ex)
from ..core import rng
from ..core.math import SHADOW_EPSILON, Frame, dot
from ..core.warp import square_to_cosine_hemisphere
from ..emitter.emitter import eval_area, eval_env, sample_direct
from ..scene.scene import EM_AREA, SceneData
from .common import (DIM_BSDF_U1, DIM_BSDF_U2, DIM_NEE_POS, DIM_NEE_SEL,
                     DIM_RR, bounce_dim, offset_ray_origin, ray_mint)
from .path import PathTracer

# photon RNG dimension block is offset so photon streams never collide
# with eye-path streams of the same seed
_PHOTON_DIM_BASE = 4096


class PhotonMap(NamedTuple):
    """Sorted-hash-grid photon map (device arrays).
    P photons (padded; dead photons carry power 0 and park in cell 0)."""
    pos: jnp.ndarray        # [P, 3] sorted by cell id
    power: jnp.ndarray      # [P, 3] flux (W) — already divided by count
    normal: jnp.ndarray     # [P, 3] surface normal at deposit
    wi: jnp.ndarray         # [P, 3] incoming direction (toward source)
    cell_of: jnp.ndarray    # [P] int32 sorted cell ids
    grid_min: jnp.ndarray   # [3]
    inv_cell: jnp.ndarray   # scalar 1/cell_size
    n_cells_dim: int        # static cells per axis (power of two)
    radius: jnp.ndarray     # gather radius the grid was built for


def _cell_id(pos, grid_min, inv_cell, n_dim):
    c = jnp.floor((pos - grid_min) * inv_cell).astype(jnp.int32)
    c = jnp.clip(c, 0, n_dim - 1)
    return (c[..., 0] * n_dim + c[..., 1]) * n_dim + c[..., 2]


def trace_photons(scene: SceneData, tracer: PathTracer, n_photons: int,
                  seed, max_depth: int = 8):
    """Random-walk photons from the emitters; returns (pos, power, normal,
    wi, valid) of every *deposit* (depth ≥ 2 vertices: indirect only),
    flattened over bounces [n_photons · (max_depth-1), ...].

    Mirrors GatherPhotonProcess semantics (ref: render/gatherproc.h:35,
    particleproc.cpp): power = Le·A·π/ (pmf·N) with cosine start sampling.
    """
    n = n_photons
    pid = jnp.arange(n, dtype=jnp.uint32)
    seed = jnp.uint32(seed)
    dim0 = _PHOTON_DIM_BASE

    # emitter start vertex (area emitters; cosine direction)
    u_sel = rng.sample_1d(seed, pid, dim0 + 0)
    u_pos = rng.sample_2d(seed, pid, dim0 + 1)
    em_id, u_re, em_pmf = scene.em_pmf.sample_reuse(u_sel)
    is_area = scene.em_type[em_id] == EM_AREA
    key = em_id.astype(jnp.float32) + jnp.clip(u_re, 0.0, 1.0 - 1e-7)
    hi = jnp.clip(jnp.searchsorted(scene.em_tri_cdfg, key, "right"),
                  0, max(scene.em_tris.shape[0] - 1, 0))
    row = scene.em_tri_data[hi]
    sq = jnp.sqrt(jnp.maximum(1.0 - u_pos[..., 0], 0.0))
    b0 = 1.0 - sq
    b1 = u_pos[..., 1] * sq
    p0 = (row[..., 0:3] + b0[..., None] * row[..., 3:6]
          + b1[..., None] * row[..., 6:9])
    n_l = row[..., 9:12]
    le = scene.em_radiance[em_id]
    area = scene.em_area[em_id]
    # emitted power Φ = Le·A·π; per-photon α = Φ / (pmf · N)
    alpha = le * (area * np.pi / jnp.maximum(em_pmf, 1e-12))[..., None] / n
    alpha = jnp.where(is_area[..., None], alpha, 0.0)

    u_dir = rng.sample_2d(seed, pid, dim0 + 2)
    fr = Frame.from_normal(n_l)
    d0 = Frame.to_world(fr, square_to_cosine_hemisphere(u_dir))
    o0 = offset_ray_origin(p0, n_l, d0)

    def bounce_body(carry, bounce):
        o, d, alpha, active = carry
        its = tracer._intersect(scene, o, d, ray_mint(o))
        hit = active & its.valid
        mat = resolve_material(scene, its.mat_id, its.uv, tracer.families)
        frame = Frame.from_normal(its.ns)
        wi_local = Frame.to_local(frame, -d)

        u2 = rng.sample_2d(seed, pid, dim0 + bounce_dim(bounce + 1,
                                                        DIM_BSDF_U2))
        u1 = rng.sample_1d(seed, pid, dim0 + bounce_dim(bounce + 1,
                                                        DIM_BSDF_U1))
        bs = sample_bsdf_ex(mat, wi_local, u2, u1, tracer.families)
        # deposit at this vertex IF it is the 2nd+ light vertex and the
        # surface is smooth (delta lobes store no photons)
        depth = bounce + 2                 # light vertex count incl. emitter
        deposit = hit & ~bs.is_delta & (depth >= 3)
        photon = (its.p, alpha, its.ns, -d, deposit)

        d_next = Frame.to_world(frame, bs.wo)
        o_next = offset_ray_origin(its.p, its.ng, d_next)
        alpha_next = alpha * bs.weight
        alive = hit & (bs.pdf > 0) & jnp.any(alpha_next > 0, axis=-1)
        if max_depth > 0:
            alive = alive & (depth <= max_depth)
        u_rr = rng.sample_1d(seed, pid, dim0 + bounce_dim(bounce + 1,
                                                          DIM_RR))
        q = jnp.clip(jnp.max(alpha_next, axis=-1)
                     / jnp.maximum(jnp.max(alpha, axis=-1), 1e-20),
                     0.05, 0.95)
        do_rr = depth >= tracer.rr_depth
        rr_cont = ~do_rr | (u_rr < q)
        alpha_next = jnp.where((do_rr & rr_cont)[..., None],
                               alpha_next / jnp.maximum(q, 1e-6)[..., None],
                               alpha_next)
        alive = alive & rr_cont
        return ((o_next, jnp.where(alive[..., None], d_next, d),
                 jnp.where(alive[..., None], alpha_next, 0.0), alive),
                photon)

    n_bounces = max_depth if max_depth > 0 else 16
    zf = o0[..., 0] * 0.0
    init = (o0, d0, alpha, (zf < 1.0) & is_area)
    _, (pp, pw, pn, pwi, pv) = jax.lax.scan(
        bounce_body, init, jnp.arange(n_bounces))
    flat = lambda x: x.reshape((-1,) + x.shape[2:])
    return flat(pp), flat(pw), flat(pn), flat(pwi), flat(pv)


def build_photon_map(pos, power, normal, wi, valid, radius,
                     scene_min, scene_max, n_cells_dim: int = 64
                     ) -> PhotonMap:
    """Sort photons into a dense n³ grid with cell side ≥ radius.
    Invalid photons get power 0 and park in the last cell."""
    extent = jnp.maximum(jnp.max(scene_max - scene_min), 1e-6)
    cell = jnp.maximum(extent / n_cells_dim, radius)
    inv_cell = 1.0 / cell
    cid = _cell_id(pos, scene_min, inv_cell, n_cells_dim)
    cid = jnp.where(valid, cid, n_cells_dim ** 3)
    order = jnp.argsort(cid)
    return PhotonMap(
        pos=pos[order], power=jnp.where(valid[order][..., None],
                                        power[order], 0.0),
        normal=normal[order], wi=wi[order],
        cell_of=cid[order], grid_min=scene_min, inv_cell=inv_cell,
        n_cells_dim=n_cells_dim, radius=radius)


def gather_radiance(pmap: PhotonMap, mat, frame, p, wi_local, radius,
                    families=None, max_per_cell: int = 32):
    """Density estimate L_indirect(p, wo=wi_local) = Σ f(wi_ph→wo)·Φ/(πr²)
    over photons within `radius` (ref: PhotonMap::estimateRadiance,
    photonmap.cpp). Scans the 27 neighbor cells; within a cell walks at
    most max_per_cell photons (sorted spans via searchsorted)."""
    nd = pmap.n_cells_dim
    r2 = radius * radius
    base_cell = jnp.floor((p - pmap.grid_min) * pmap.inv_cell
                          ).astype(jnp.int32)

    def one_cell(acc, offset):
        ox, oy, oz = offset
        c = base_cell + jnp.asarray([ox, oy, oz])
        ok_cell = jnp.all((c >= 0) & (c < nd), axis=-1)
        cid = (c[..., 0] * nd + c[..., 1]) * nd + c[..., 2]
        start = jnp.searchsorted(pmap.cell_of, cid, "left")
        end = jnp.searchsorted(pmap.cell_of, cid, "right")
        count = jnp.minimum(end - start, max_per_cell)

        def body(k, acc):
            idx = jnp.minimum(start + k, pmap.pos.shape[0] - 1)
            live = (k < count) & ok_cell
            php = pmap.pos[idx]
            dist2 = jnp.sum((php - p) ** 2, axis=-1)
            inside = live & (dist2 <= r2)
            ph_wi = Frame.to_local(frame, pmap.wi[idx])
            # reciprocity: f(wi_ph→wo_cam) = f(wo_cam→wi_ph); eval returns
            # f·cos(ph_wi.z), so strip that cosine — the PM estimate is
            # L = Σ f·ΔΦ/(πr²) with no extra cosine (photonmap.cpp)
            f = eval_bsdf_ex(mat, wi_local, ph_wi, families)
            # photon stored on the front side only: require same hemisphere
            same = dot(pmap.normal[idx], frame[2]) > 0.1
            contrib = f * pmap.power[idx] / jnp.maximum(
                jnp.abs(ph_wi[..., 2:3]), 1e-3)
            return acc + jnp.where((inside & same)[..., None], contrib,
                                   0.0)

        return jax.lax.fori_loop(0, max_per_cell, body, acc), None

    acc = jnp.zeros(p.shape[:-1] + (3,))
    for ox in (-1, 0, 1):
        for oy in (-1, 0, 1):
            for oz in (-1, 0, 1):
                acc, _ = one_cell(acc, (ox, oy, oz))
    return acc / jnp.asarray(np.pi * r2)[..., None]


@dataclass(frozen=True)
class PhotonMapper(PathTracer):
    """Classic photon mapping (ref: photonmapper.cpp): direct light via
    NEE + emitted, indirect via photon density estimate at the first
    smooth hit (delta chains followed). `progressive` renders multiple
    passes with the Knaus-Zwicker shrinking radius (ppm/sppm class)."""
    n_photons: int = 1 << 16
    gather_radius: float = 0.1
    photon_depth: int = 8
    specular_chain: int = 4      # max delta bounces before the gather

    def build_map(self, scene: SceneData, seed, radius=None) -> PhotonMap:
        pp, pw, pn, pwi, pv = trace_photons(
            scene, self, self.n_photons, seed, self.photon_depth)
        nt = scene.n_tris
        verts = jnp.concatenate([scene.p0[:nt],
                                 (scene.p0 + scene.e1)[:nt],
                                 (scene.p0 + scene.e2)[:nt]], axis=0)
        # mask out far-away degenerate padding triangles
        real = jnp.abs(verts) < 1e29
        smin = jnp.min(jnp.where(real, verts, 1e30), axis=0)
        smax = jnp.max(jnp.where(real, verts, -1e30), axis=0)
        r = self.gather_radius if radius is None else radius
        return build_photon_map(pp, pw, pn, pwi, pv, r, smin, smax)

    def li_with_map(self, scene: SceneData, pmap: PhotonMap, o, d, seed,
                    pixel_id, sample_idx=0):
        """Eye pass: walk through delta lobes, then emitted + NEE direct
        + photon indirect at the first smooth vertex."""
        n = o.shape[0]
        L = jnp.zeros((n, 3))
        throughput = jnp.ones((n, 3))
        active = jnp.ones((n,), bool)
        prev_delta = jnp.ones((n,), bool)

        for bounce in range(self.specular_chain):
            its = self._intersect(scene, o, d, ray_mint(o))
            escaped = active & ~its.valid
            L = L + jnp.where(escaped[..., None],
                              throughput * eval_env(scene, d), 0.0)
            hit = active & its.valid
            cos_surf = -dot(d, its.ng)
            le = eval_area(scene, its.em_id, cos_surf)
            # only on delta chains (NEE covers the rest) — first hit is a
            # delta chain of length 0
            L = L + jnp.where((hit & prev_delta)[..., None],
                              throughput * le, 0.0)

            mat = resolve_material(scene, its.mat_id, its.uv,
                                   self.families)
            frame = Frame.from_normal(its.ns)
            wi_local = Frame.to_local(frame, -d)

            u2 = self._d2(seed, pixel_id, sample_idx,
                          bounce_dim(bounce, DIM_BSDF_U2))
            u1 = self._d1(seed, pixel_id, sample_idx,
                          bounce_dim(bounce, DIM_BSDF_U1))
            bs = sample_bsdf_ex(mat, wi_local, u2, u1, self.families)
            smooth = hit & ~bs.is_delta

            # ---- smooth vertex: direct NEE + photon gather -------------
            u_sel = self._d1(seed, pixel_id, sample_idx,
                             bounce_dim(bounce, DIM_NEE_SEL))
            u_pos = self._d2(seed, pixel_id, sample_idx,
                             bounce_dim(bounce, DIM_NEE_POS))
            ds = sample_direct(scene, its.p, u_sel, u_pos)
            wo_nee = Frame.to_local(frame, ds.d)
            f_nee = eval_bsdf_ex(mat, wi_local, wo_nee, self.families)
            so = offset_ray_origin(its.p, its.ng, ds.d)
            occ = self._occluded(scene, so, ds.d, ray_mint(so),
                                 ds.dist * (1.0 - SHADOW_EPSILON))
            ok = smooth & (ds.pdf > 0) & ~occ
            L = L + jnp.where(ok[..., None],
                              throughput * ds.value * f_nee, 0.0)

            ind = gather_radiance(pmap, mat, frame, its.p, wi_local,
                                  pmap.radius, self.families)
            L = L + jnp.where(smooth[..., None], throughput * ind, 0.0)

            # ---- delta vertex: continue the chain -----------------------
            cont = hit & bs.is_delta & (bs.pdf > 0)
            d_next = Frame.to_world(frame, bs.wo)
            o = jnp.where(cont[..., None],
                          offset_ray_origin(its.p, its.ng, d_next), o)
            d = jnp.where(cont[..., None], d_next, d)
            throughput = jnp.where(cont[..., None],
                                   throughput * bs.weight, throughput)
            prev_delta = cont
            active = cont
        return L

    def li(self, scene: SceneData, o, d, seed, pixel_id, sample_idx=0):
        pmap = self.build_map(scene, jnp.uint32(seed) ^ jnp.uint32(0x5bd1))
        return self.li_with_map(scene, pmap, o, d, seed, pixel_id,
                                sample_idx)

    def li_stats(self, scene, o, d, seed, pixel_id, sample_idx=0):
        L = self.li(scene, o, d, seed, pixel_id, sample_idx)
        n_rays = jnp.asarray(o.shape[0] * 2 + self.n_photons, jnp.uint32)
        return L, n_rays


def render_progressive(scene: SceneData, camera, film, pm: PhotonMapper,
                       n_passes: int = 8, spp_per_pass: int = 4,
                       seed: int = 0, alpha: float = 0.7):
    """PPM/SPPM-class progressive render (ref: src/integrators/
    photonmapper/{ppm,sppm}.cpp): pass i re-traces photons with a fresh
    seed and gathers with radius rᵢ, rᵢ² = r₀²·Πₖ₌₁^{i-1}(k+α)/(k+1)
    (Knaus & Zwicker 2011) — bias ↓ 0 as passes accumulate."""
    import numpy as np
    from ..render import render as render_once
    h, w = film.height, film.width
    acc = np.zeros((h, w, 3), np.float32)
    r2 = pm.gather_radius ** 2
    for i in range(n_passes):
        pm_i = PhotonMapper(
            max_depth=pm.max_depth, rr_depth=pm.rr_depth,
            families=pm.families,
            n_photons=pm.n_photons, gather_radius=float(np.sqrt(r2)),
            photon_depth=pm.photon_depth,
            specular_chain=pm.specular_chain)
        img = render_once(scene, camera, film, pm_i, spp=spp_per_pass,
                          seed=seed + 7919 * i)
        acc += (np.asarray(img) - acc) / (i + 1)
        r2 *= (i + 1 + alpha) / (i + 2)
    return acc
