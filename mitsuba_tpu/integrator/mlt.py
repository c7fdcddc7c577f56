"""Path-space Metropolis light transport (Veach MLT mutation strategies).

Counterpart of the reference `mlt` plugin and the libbidir mutator suite
(ref: src/integrators/mlt/{mlt.cpp,mlt_proc.cpp}; src/libbidir/mut_bidir.cpp,
mut_lens.cpp, mut_caustic.cpp, mut_mchain.cpp, mut_manifold.cpp;
include/mitsuba/bidir/mutator.h:33). The reference mutates explicit
`Path` vertex arrays; the Wavefront redesign keeps thousands of vmapped
chains in the *primary sample space* of the wavefront path tracer — whose
RNG dimension layout is STATIC (integrator/common.py) — and realises each
Veach strategy as a structured mutation of the corresponding dimension
block, replaying the path deterministically through the existing jitted
tracer:

- **bidirectional mutation** (mut_bidir.cpp:80-220: delete a subpath
  [s, s+l), regenerate it): resample the per-bounce dim blocks of a
  uniformly chosen bounce range with fresh uniforms, keeping the rest.
  Uniform block resampling is a symmetric proposal in PSV, so the Veach
  acceptance collapses to min(1, I'/I). A whole-vector variant doubles as
  the ergodicity-restoring large step.
- **lens perturbation** (mut_lens.cpp:60-140: move the image point by an
  exp-distributed radius r ∈ [r1, r2], re-trace the eye subpath through
  the same chain): perturb only the DIM_PIXEL dims with the reference's
  exp kernel; all downstream BSDF/NEE dims are reused, so diffuse-chain
  decisions survive and specular chains follow deterministically.
- **caustic perturbation** (mut_caustic.cpp: perturb the direction out of
  the vertex adjacent to the eye, propagate through the specular chain):
  exp-kernel perturbation of the first bounce's BSDF-direction dims.
- **multi-chain perturbation** (mut_mchain.cpp: correlated small steps at
  every non-specular vertex of the chain): Kelemen log-scaled small step
  applied to ALL dims at once.
- **manifold behavior** (mut_manifold.cpp / SpecularManifold walks): for
  delta chains the wavefront tracer consumes the specular vertices'
  direction dims without using them — moving a neighbouring diffuse
  anchor and replaying re-solves the specular chain *exactly*, which is
  the effect the reference's Newton manifold walk approximates. The
  explicit solver is therefore subsumed by PSV replay for delta BSDFs.

Each strategy's proposal is symmetric and the per-step strategy draw is
state-independent, so the mixture kernel is symmetric and detailed
balance holds with a = min(1, I'/I). Both states are splatted every step
with expected-value weights a and (1-a) scaled by b/I (standard MLT
estimator; normalisation constant b from the uniform bootstrap exactly as
mlt_proc.cpp's luminance pass).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core import rng
from ..film.film import Film
from ..integrator.common import (DIM_PIXEL, DIMS_PER_BOUNCE, SENSOR_DIMS,
                                 bounce_dim)
from ..scene.scene import SceneData
from .pssmlt import _PSVPathTracer, _fresh_psv, _luminance, _mutate_small

# strategy codes
_BIDIR = 0
_LENS = 1
_CAUSTIC = 2
_MCHAIN = 3

# chain-driver RNG dim bases (disjoint from path dims, cf. pssmlt.py)
_DIM_ACCEPT = 1 << 21
_DIM_STRAT = 1 << 22
_DIM_BOOT_SEL = 1 << 23
_DIM_BLOCK = 1 << 24


def _exp_kernel(u_r, u_phi, r1, r2):
    """Exponentially distributed 2D offset with radius in [r1, r2]
    (ref: mut_lens.cpp:98-110 perturbation kernel)."""
    r = r2 * jnp.exp(-jnp.log(r2 / r1) * u_r)
    phi = 2.0 * jnp.pi * u_phi
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi)], axis=-1)


@dataclass(frozen=True)
class MLT:
    """Veach path-space MLT over vmapped chains.

    Properties mirror the reference plugin (ref: mlt.cpp:60-130:
    maxDepth, directSamples→bootstrap, bidirectionalMutation,
    lensPerturbation, causticPerturbation, multiChainPerturbation;
    manifold perturbation subsumed — see module docstring)."""
    max_depth: int = 8
    n_chains: int = 4096
    boot_mult: int = 4
    cluster_size: int = 512
    families: tuple | None = None
    # strategy mixture weights (normalised at trace time)
    w_bidir: float = 0.3
    w_lens: float = 0.3
    w_caustic: float = 0.2
    w_mchain: float = 0.2
    # lens/caustic kernel radii: fraction of image size / of the unit square
    lens_r1: float = 0.001
    lens_r2: float = 0.05
    p_large: float = 0.3     # inside bidir: chance of whole-vector resample

    @property
    def n_dims(self):
        return SENSOR_DIMS + self.max_depth * DIMS_PER_BOUNCE

    def specialized_for(self, scene):
        fams = tuple(sorted(int(x) for x in np.unique(
            np.asarray(scene.mat_type))))
        return dataclasses.replace(self, families=fams)

    def _core(self, psv):
        return _PSVPathTracer(
            max_depth=self.max_depth, rr_depth=10 ** 6,
            cluster_size=self.cluster_size,
            families=self.families, psv=psv)

    def _eval(self, scene, camera, width, height, psv):
        n = psv.shape[0]
        upix = jnp.take(psv, DIM_PIXEL, axis=1)
        pos = upix * jnp.asarray([width, height], jnp.float32)
        ap = jnp.take(psv, 1, axis=1)
        o, d = camera.sample_ray(pos, ap)
        zeros = jnp.zeros((n,), jnp.uint32)
        L = self._core(psv).li(scene, o, d, jnp.uint32(0), zeros, zeros)
        return L, pos, _luminance(L)

    # ------------------------------------------------------------------

    def _propose(self, psv, seed, chain, step):
        """One structured mutation per chain; symmetric mixture kernel."""
        n, D, _ = psv.shape
        noise = _fresh_psv(seed + jnp.uint32(1), chain, D, step)
        coin = _fresh_psv(seed + jnp.uint32(2), chain, D, step)
        aux = rng.sample_2d(seed, chain, jnp.uint32(_DIM_BLOCK), step)
        aux2 = rng.sample_2d(seed, chain, jnp.uint32(_DIM_BLOCK + 1), step)

        w = jnp.asarray([self.w_bidir, self.w_lens, self.w_caustic,
                         self.w_mchain], jnp.float32)
        cdf = jnp.cumsum(w / jnp.sum(w))
        u_strat = rng.sample_1d(seed, chain, jnp.uint32(_DIM_STRAT), step)
        strat = jnp.searchsorted(cdf, u_strat, side="right")  # [n]

        dim_ids = jnp.arange(D, dtype=jnp.int32)

        # --- bidirectional: resample bounce blocks [s, s+l) -------------
        nb = self.max_depth
        s0 = jnp.floor(aux[:, 0] * nb).astype(jnp.int32)
        # geometric-ish length in [1, nb]
        ln = 1 + jnp.floor(aux[:, 1] * aux[:, 1] * nb).astype(jnp.int32)
        lo = SENSOR_DIMS + s0 * DIMS_PER_BOUNCE
        hi = SENSOR_DIMS + jnp.minimum(s0 + ln, nb) * DIMS_PER_BOUNCE
        in_blk = ((dim_ids[None, :] >= lo[:, None])
                  & (dim_ids[None, :] < hi[:, None]))
        large = aux2[:, 0] < self.p_large
        in_blk = in_blk | large[:, None]
        psv_bidir = jnp.where(in_blk[..., None], noise, psv)

        # --- lens: exp-kernel move of the image point --------------------
        off = _exp_kernel(aux[:, 0], aux[:, 1], self.lens_r1, self.lens_r2)
        pix = psv[:, DIM_PIXEL, :] + off
        pix = pix - jnp.floor(pix)          # wrap on the unit square
        psv_lens = psv.at[:, DIM_PIXEL, :].set(pix)

        # --- caustic: exp-kernel on bounce-0 BSDF direction dims ---------
        d_b0 = bounce_dim(0, 2)             # DIM_BSDF_U2 of the 1st bounce
        u0 = psv[:, d_b0, :] + _exp_kernel(aux[:, 0], aux[:, 1],
                                           self.lens_r1, self.lens_r2)
        u0 = u0 - jnp.floor(u0)
        psv_caustic = psv.at[:, d_b0, :].set(u0)

        # --- multi-chain: Kelemen small step on everything ---------------
        psv_mchain = _mutate_small(psv, noise, coin)

        sel = strat[:, None, None]
        out = jnp.where(sel == _BIDIR, psv_bidir,
              jnp.where(sel == _LENS, psv_lens,
              jnp.where(sel == _CAUSTIC, psv_caustic, psv_mchain)))
        return out, strat

    # ------------------------------------------------------------------

    def render(self, scene: SceneData, camera, film: Film,
               n_mutations: int = 256, seed: int = 0):
        return _render_mlt(scene, camera, film, self, n_mutations, seed)

    def render_full(self, scene: SceneData, camera, film: Film,
                    spp: int, seed: int = 0):
        mlt = self
        if mlt.families is None:
            mlt = mlt.specialized_for(scene)
        n_mut = max(1, spp * film.width * film.height // mlt.n_chains)
        img, _b, _acc = _render_mlt(scene, camera, film, mlt, n_mut, seed)
        return img


@partial(jax.jit, static_argnames=("camera", "film", "mlt", "n_mutations"))
def _render_mlt(scene, camera, film, mlt: MLT, n_mutations, seed):
    seed = jnp.asarray(seed, jnp.uint32)
    w, h = film.width, film.height
    n, D = mlt.n_chains, mlt.n_dims
    chain = jnp.arange(n, dtype=jnp.uint32)

    # bootstrap: luminance pass + categorical seed selection
    # (ref: mlt_proc.cpp luminance estimation == pssmlt's)
    m = n * mlt.boot_mult
    boot_ids = jnp.arange(m, dtype=jnp.uint32)
    psv_boot = _fresh_psv(seed, boot_ids, D, jnp.uint32(0xB007))

    def boot_body(i, acc):
        sl = jax.lax.dynamic_slice_in_dim(psv_boot, i * n, n, axis=0)
        _, _, I = mlt._eval(scene, camera, w, h, sl)
        return jax.lax.dynamic_update_slice_in_dim(acc, I, i * n, axis=0)
    I_boot = jax.lax.fori_loop(0, mlt.boot_mult, boot_body,
                               jnp.zeros((m,), jnp.float32))
    b = jnp.mean(I_boot)
    cdf = jnp.cumsum(I_boot)
    tot = jnp.maximum(cdf[-1], 1e-30)
    u_sel = rng.sample_1d(seed, chain, jnp.uint32(_DIM_BOOT_SEL))
    idx = jnp.clip(jnp.searchsorted(cdf, u_sel * tot, side="right"),
                   0, m - 1)
    psv0 = psv_boot[idx]

    L0, pos0, I0 = mlt._eval(scene, camera, w, h, psv0)
    I0 = jnp.maximum(I0, 1e-12)

    def step(carry, s):
        psv, L, pos, I, accum = carry
        s32 = s.astype(jnp.uint32)
        psv_prop, _strat = mlt._propose(psv, seed, chain, s32)
        L_p, pos_p, I_p = mlt._eval(scene, camera, w, h, psv_prop)

        a = jnp.minimum(1.0, I_p / I)
        # standard MLT expected-value splats scaled by b/I
        w_prop = a * b / jnp.maximum(I_p, 1e-12) / n_mutations
        w_cur = (1.0 - a) * b / I / n_mutations
        w_prop = jnp.where(jnp.isfinite(w_prop) & (I_p > 0), w_prop, 0.0)
        accum = film.splat(accum, pos, L * w_cur[:, None])
        accum = film.splat(accum, pos_p, L_p * w_prop[:, None])

        acc = rng.sample_1d(seed, chain, jnp.uint32(_DIM_ACCEPT), s32) < a
        accm = acc[:, None]
        return ((jnp.where(accm[..., None], psv_prop, psv),
                 jnp.where(accm, L_p, L),
                 jnp.where(accm, pos_p, pos),
                 jnp.maximum(jnp.where(acc, I_p, I), 1e-12),
                 accum), a.mean())

    init = (psv0, L0, pos0, I0, film.new_accumulator())
    (_, _, _, _, accum), accept_rate = jax.lax.scan(
        step, init, jnp.arange(n_mutations))

    img = accum[..., 0:3] * (w * h / n)
    return img, b, accept_rate.mean()
