"""Lightcuts over a VPL light tree (winmad research integrator).

Counterpart of the fork's `lightcuts` plugin (ref: src/integrators/
lightcuts/lightcuts.cpp:14, librender/{lighttree,lightcutter}.cpp:
LightTree binary tree over VPLs + Lightcutter::evalLightcut's
error-bounded adaptive cut).

Wavefront redesign: the reference grows each pixel's cut with a
priority queue until the error bound drops below 2% of the estimate —
unbounded, data-dependent work. Here every pixel gets a FIXED-size cut
of K nodes grown by K−1 refinement steps: start at the root; each step
replaces the cut node with the largest error bound by its two children
(an argmax + masked swap over a [K]-lane register array — branchless and
shape-static). Cluster error bounds follow the paper: |flux| ·
G_ub(bbox) · ρ/π, with G_ub from the minimum squared distance to the
node's bounding box. One shadow ray per cut node per pixel.

Tree build is host-side numpy (median-split over VPL positions — the
reference builds its tree on the host too), flattened to arrays:
children [M, 2], flux [M, 3], bbox [M, 6], representative [M, 3+3]
(position, normal) picked flux-proportionally.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import rng
from ..core.math import SHADOW_EPSILON, Frame, dot
from ..scene.scene import SceneData
from .common import DIM_PIXEL, offset_ray_origin, ray_mint
from .vpl import VPLIntegrator


class LightTree(NamedTuple):
    """Flattened binary tree, root = index 0. Leaves have child -1."""
    child: jax.Array      # [M, 2] int32
    flux: jax.Array       # [M, 3] cluster flux sum
    bb_min: jax.Array     # [M, 3]
    bb_max: jax.Array     # [M, 3]
    rep_p: jax.Array      # [M, 3] representative VPL position
    rep_n: jax.Array      # [M, 3]
    rep_wi: jax.Array     # [M, 3]
    rep_mat: jax.Array    # [M] int32


def build_light_tree(vpls) -> LightTree:
    """Median-split tree over valid VPLs (host-side, ref lighttree.cpp)."""
    valid = np.asarray(vpls.valid)
    p = np.asarray(vpls.p)[valid]
    n_ = np.asarray(vpls.n)[valid]
    wi = np.asarray(vpls.wi)[valid]
    flux = np.asarray(vpls.flux)[valid]
    mat = np.asarray(vpls.mat_id)[valid]
    nv = len(p)
    assert nv > 0, "no valid VPLs"

    child, fluxes, bmin, bmax = [], [], [], []
    rp, rn, rwi, rm = [], [], [], []

    def build(idx):
        me = len(child)
        child.append([-1, -1])
        f = flux[idx].sum(0)
        fluxes.append(f)
        bmin.append(p[idx].min(0))
        bmax.append(p[idx].max(0))
        # flux-proportional representative (lighttree.cpp repr. light)
        lum = flux[idx].sum(-1)
        rep = idx[np.argmax(lum)] if lum.sum() <= 0 else \
            idx[np.searchsorted(np.cumsum(lum), 0.5 * lum.sum())
                .clip(0, len(idx) - 1)]
        rp.append(p[rep]); rn.append(n_[rep]); rwi.append(wi[rep])
        rm.append(mat[rep])
        if len(idx) > 1:
            ext = p[idx].max(0) - p[idx].min(0)
            ax = int(np.argmax(ext))
            order = idx[np.argsort(p[idx, ax], kind="stable")]
            half = len(order) // 2
            a = build(order[:half])
            b = build(order[half:])
            child[me] = [a, b]
        return me

    import sys
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 4 * nv + 100))
    build(np.arange(nv))
    sys.setrecursionlimit(old)
    return LightTree(
        jnp.asarray(np.asarray(child, np.int32)),
        jnp.asarray(np.asarray(fluxes, np.float32)),
        jnp.asarray(np.asarray(bmin, np.float32)),
        jnp.asarray(np.asarray(bmax, np.float32)),
        jnp.asarray(np.asarray(rp, np.float32)),
        jnp.asarray(np.asarray(rn, np.float32)),
        jnp.asarray(np.asarray(rwi, np.float32)),
        jnp.asarray(np.asarray(rm, np.int32)))


@dataclass(frozen=True)
class LightcutsIntegrator(VPLIntegrator):
    """maxLights/errorRatio of the reference map to the static cut_size
    here (the error bound drives WHICH nodes refine, the budget is
    fixed)."""
    cut_size: int = 32

    def _node_error(self, tree: LightTree, node, x):
        """Lightcuts upper bound for cluster `node` at points x [N, 3]:
        |flux| · 1/d²_min(bbox) (diffuse material bound folded into the
        caller's BSDF eval)."""
        lo = tree.bb_min[node]
        hi = tree.bb_max[node]
        d = jnp.maximum(jnp.maximum(lo - x, x - hi), 0.0)
        d2 = jnp.sum(d * d, axis=-1)
        lum = jnp.sum(tree.flux[node], axis=-1)
        leaf = tree.child[node, 0] < 0
        err = lum / jnp.maximum(d2, 1e-4)
        return jnp.where(leaf, 0.0, err)    # leaves can't refine

    def li_with_tree(self, scene: SceneData, tree: LightTree, o, d,
                     seed, pixel_id, sample_idx=0):
        from ..bsdf.bsdf import (eval_bsdf_ex, perturb_shading_frame,
                                 resolve_material)
        from ..emitter.emitter import eval_area, eval_env

        its = self._intersect(scene, o, d, ray_mint(o))
        hit = its.valid
        cos_surf = -dot(d, its.ng)
        le = eval_area(scene, its.em_id, cos_surf)
        L = jnp.where(hit[..., None], le, eval_env(scene, d))

        mat = resolve_material(scene, its.mat_id, its.uv, self.families)
        frame = Frame.from_normal(its.ns)
        frame = perturb_shading_frame(scene, mat, frame, its.uv)
        wi_local = Frame.to_local(frame, -d)

        n = o.shape[0]
        k = self.cut_size
        # ---- grow the cut: [N, K] node ids ----------------------------
        cut = jnp.full((n, k), -1, jnp.int32).at[:, 0].set(0)

        def refine(i, cut):
            nodes = jnp.maximum(cut, 0)
            err = jax.vmap(lambda nd, x: self._node_error(tree, nd, x)
                           )(nodes, its.p)          # [N, K]
            err = jnp.where(cut >= 0, err, -1.0)
            worst = jnp.argmax(err, axis=-1)         # [N]
            node_w = jnp.take_along_axis(cut, worst[:, None],
                                         axis=-1)[:, 0]
            ca = tree.child[jnp.maximum(node_w, 0), 0]
            cb = tree.child[jnp.maximum(node_w, 0), 1]
            can = (node_w >= 0) & (ca >= 0)
            # replace worst by child a; append child b at slot i+1
            cut = jnp.where(
                (jnp.arange(k)[None, :] == worst[:, None]) & can[:, None],
                jnp.broadcast_to(ca[:, None], cut.shape), cut)
            cut = cut.at[:, i + 1].set(jnp.where(can, cb, -1))
            return cut

        cut = jax.lax.fori_loop(0, k - 1, refine, cut)

        # ---- evaluate the cut (one shadow ray per node) ----------------
        valid_t = scene.tri_area > 0
        radius = jnp.max(jnp.where(valid_t[:, None], jnp.abs(scene.p0),
                                   0.0))
        min_d2 = (self.clamping * radius) ** 2

        def shade_node(carry, j):
            L = carry
            node = jnp.maximum(cut[:, j], 0)
            ok0 = cut[:, j] >= 0
            yp = tree.rep_p[node]
            yn = tree.rep_n[node]
            ywi = tree.rep_wi[node]
            yflux = tree.flux[node]
            ymat = tree.rep_mat[node]

            v = yp - its.p
            d2 = jnp.sum(v * v, axis=-1)
            dist = jnp.sqrt(jnp.maximum(d2, 1e-20))
            w = v / dist[..., None]
            cos_y = -dot(w, yn)
            g = jnp.maximum(cos_y, 0.0) / jnp.maximum(d2, min_d2)

            is_em = ymat < 0
            yfr = Frame.from_normal(yn)
            ymat_r = resolve_material(scene, jnp.maximum(ymat, 0),
                                      jnp.zeros((n, 2)), self.families)
            f_y_b = eval_bsdf_ex(ymat_r, Frame.to_local(yfr, ywi),
                                 Frame.to_local(yfr, -w), self.families)
            f_y = jnp.where(is_em[..., None], 1.0 / np.pi,
                            f_y_b / jnp.maximum(cos_y, 1e-6)[..., None])
            f_x = eval_bsdf_ex(mat, wi_local, Frame.to_local(frame, w),
                               self.families)
            contrib = f_x * f_y * (g[..., None] * yflux)
            ok = ok0 & hit & (cos_y > 1e-6) & jnp.any(contrib > 0,
                                                      axis=-1)
            so = offset_ray_origin(its.p, its.ng, w)
            occ = self._occluded(scene, so, w, ray_mint(so),
                                 dist * (1.0 - SHADOW_EPSILON))
            ok = ok & ~occ
            return L + jnp.where(ok[..., None], contrib, 0.0), None

        L, _ = jax.lax.scan(shade_node, L, jnp.arange(k))
        return L

    def li(self, scene: SceneData, o, d, seed, pixel_id, sample_idx=0):
        vpls = self.generate_vpls(scene, seed)
        tree = build_light_tree(vpls)
        return self.li_with_tree(scene, tree, o, d, seed, pixel_id,
                                 sample_idx)

    def render(self, scene: SceneData, camera, film, spp: int = 1,
               seed: int = 0):
        vpls = self.generate_vpls(scene, seed)
        tree = build_light_tree(jax.device_get(vpls))
        return _render_lightcuts(scene, camera, film, self, tree, spp,
                                 seed)


@partial(jax.jit, static_argnames=("camera", "film", "integ", "spp"))
def _render_lightcuts(scene, camera, film, integ, tree, spp, seed):
    h, w = film.height, film.width
    n = h * w
    px = jnp.arange(n, dtype=jnp.uint32)
    pix_x = (px % w).astype(jnp.float32)
    pix_y = (px // w).astype(jnp.float32)

    def sample_pass(s, accum):
        s = jnp.uint32(s)
        jitter = rng.sample_2d(seed, px, DIM_PIXEL, s)
        pos = jnp.stack([pix_x + jitter[..., 0],
                         pix_y + jitter[..., 1]], axis=-1)
        o, d = camera.sample_ray(pos)
        radiance = integ.li_with_tree(scene, tree, o, d,
                                      jnp.uint32(seed), px, s)
        return film.splat(accum, pos, radiance)

    accum = jax.lax.fori_loop(0, spp, sample_pass, film.new_accumulator())
    return film.develop(accum)
