"""Primary-sample-space Metropolis light transport (Kelemen PSSMLT).

Counterpart of the reference `pssmlt` plugin (ref: src/integrators/pssmlt/
{pssmlt.cpp,pssmlt_sampler.cpp,pssmlt_proc.cpp}; SURVEY.md §3.5). The
reference runs one Markov chain per scheduler work unit, each wrapping a
lazy `PSSMLTSampler` around `PathSampler::sampleSplats`. The wavefront
redesign runs THOUSANDS of independent chains as one wavefront:

- the primary sample space is materialised as a dense tensor
  u ∈ [0,1)^{[n_chains, D, 2]} (one 2-vector per RNG dimension slot of the
  wavefront path tracer — the lazy infinite-dimension trick in
  pssmlt_sampler.cpp:70-120 becomes a fixed D = sensor + bounce dims,
  exact because the path tracer's dimension layout is static);
- the target function is the existing wavefront `PathTracer.li` evaluated
  with a sampler that reads `u` instead of hashing counters — so PSSMLT
  automatically supports every BSDF/emitter/medium the path tracer does;
- Kelemen mutations (large step p_large, log-scaled small steps with
  s1=1/1024, s2=1/64 — pssmlt_sampler.cpp:30-37,96) are elementwise tensor
  ops over all chains at once; Metropolis accept/reject is a masked select;
- both proposed and current states are splatted every step with Kelemen's
  expected-value weights combining large steps as ordinary MC
  (pssmlt_proc.cpp:180-210 semantics), so large-step samples double as an
  unbiased direct estimator;
- the two-phase bootstrap (BidirectionalUtils::renderLuminanceSamples →
  seed selection proportional to luminance, pssmlt_proc.h:34-60) becomes a
  batched luminance evaluation + categorical resampling via searchsorted.

Normalisation: with stationary density I(u)/b (b = E_uniform[I], estimated
by the bootstrap), each mutation splat is an unbiased estimate of
img/(W·H); the final image is accum · (W·H) / n_total_mutations.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core import rng
from ..film.film import Film
from ..integrator.common import (DIM_APERTURE, DIM_PIXEL, DIMS_PER_BOUNCE,
                                 SENSOR_DIMS)
from ..scene.scene import SceneData
from .path import PathTracer

# Kelemen small-step kernel constants (ref: pssmlt_sampler.cpp:30-37)
_S1 = 1.0 / 1024.0
_S2 = 1.0 / 64.0
_LOG_RATIO = float(np.log(_S2 / _S1))

# RNG dim bases for the chain driver itself (disjoint from path dims)
_DIM_ACCEPT = 1 << 21    # per-step accept draw
_DIM_LARGE = 1 << 22     # per-step large-step coin
_DIM_BOOT_SEL = 1 << 23  # bootstrap resampling


@dataclass(frozen=True, eq=False)
class _PSVPathTracer(PathTracer):
    """Path tracer whose random draws come from an explicit primary-sample
    tensor instead of the counter hash — the wavefront analog of wrapping
    the integrator in a PSSMLTSampler (ref: pssmlt.cpp:160-190)."""
    psv: object = None          # [N, D, 2] traced array

    def _d2(self, seed, pixel, samp, dim):
        return jnp.take(self.psv, jnp.asarray(dim), axis=1)

    def _d1(self, seed, pixel, samp, dim):
        return jnp.take(self.psv, jnp.asarray(dim), axis=1)[..., 0]


def _mutate_small(u, r, coin):
    """Kelemen log-scaled symmetric perturbation of every coordinate.

    u' = u ± s2·exp(-log(s2/s1)·r)  (mod 1)   (pssmlt_sampler.cpp:96-120)
    """
    dv = _S2 * jnp.exp(-_LOG_RATIO * r)
    up = jnp.where(coin < 0.5, u + dv, u - dv)
    return up - jnp.floor(up)


def _luminance(L):
    return (0.212671 * L[..., 0] + 0.715160 * L[..., 1]
            + 0.072169 * L[..., 2])


@dataclass(frozen=True)
class PSSMLT:
    """Config mirroring the reference plugin's properties
    (ref: pssmlt.cpp:60-110: maxDepth, rrDepth→not used (fixed-length
    truncation keeps chain dimensionality static), pLarge, luminanceSamples
    → n_chains·boot_mult, directSamples folded into the large-step MIS)."""
    max_depth: int = 8
    p_large: float = 0.3
    n_chains: int = 4096
    boot_mult: int = 4          # bootstrap candidates per chain
    cluster_size: int = 512
    families: tuple | None = None

    @property
    def n_dims(self):
        return SENSOR_DIMS + self.max_depth * DIMS_PER_BOUNCE

    def specialized_for(self, scene):
        """Restrict BSDF dispatch to the scene's families (host-side,
        before jit) — large compile-time win, as PathTracer."""
        import dataclasses

        import numpy as np
        fams = tuple(sorted(int(x) for x in np.unique(
            np.asarray(scene.mat_type))))
        return dataclasses.replace(self, families=fams)

    def _core(self, psv):
        return _PSVPathTracer(
            max_depth=self.max_depth, rr_depth=10 ** 6,
            cluster_size=self.cluster_size,
            families=self.families, psv=psv)

    # ------------------------------------------------------------------

    def _eval(self, scene, camera, width, height, psv):
        """Map primary samples → (radiance, pixel pos, luminance)."""
        n = psv.shape[0]
        upix = jnp.take(psv, DIM_PIXEL, axis=1)
        pos = upix * jnp.asarray([width, height], jnp.float32)
        ap = jnp.take(psv, DIM_APERTURE, axis=1)
        o, d = camera.sample_ray(pos, ap)
        zeros = jnp.zeros((n,), jnp.uint32)
        L = self._core(psv).li(scene, o, d, jnp.uint32(0), zeros, zeros)
        return L, pos, _luminance(L)

    def render(self, scene: SceneData, camera, film: Film,
               n_mutations: int = 256, seed: int = 0):
        """Full two-phase PSSMLT render → (image, b, acceptance rate)."""
        return _render_pssmlt(scene, camera, film, self, n_mutations,
                              seed)

    def render_full(self, scene: SceneData, camera, film: Film,
                    spp: int, seed: int = 0):
        """Uniform-API entry (CLI): spp ≈ mutations per pixel equivalent."""
        import dataclasses
        mlt = self
        if mlt.families is None:
            import numpy as np
            fams = tuple(sorted(int(x) for x in np.unique(
                np.asarray(scene.mat_type))))
            mlt = dataclasses.replace(mlt, families=fams)
        n_mut = max(1, spp * film.width * film.height // mlt.n_chains)
        img, _b, _acc = _render_pssmlt(scene, camera, film, mlt, n_mut,
                                       seed)
        return img


def _fresh_psv(seed, chain_ids, n_dims, step):
    """Independent uniforms for every (chain, dim) slot at a given step."""
    dims = jnp.arange(n_dims, dtype=jnp.uint32)[None, :]
    return rng.sample_2d(seed, chain_ids[:, None], dims, step)


@partial(jax.jit, static_argnames=("camera", "film", "mlt", "n_mutations"))
def _render_pssmlt(scene, camera, film, mlt: PSSMLT, n_mutations, seed):
    seed = jnp.asarray(seed, jnp.uint32)
    w, h = film.width, film.height
    n = mlt.n_chains
    D = mlt.n_dims
    chain = jnp.arange(n, dtype=jnp.uint32)

    # ---- phase 1: bootstrap (luminance pass + seed selection) ----------
    # (ref: BidirectionalUtils::renderLuminanceSamples, bidir/util.cpp)
    m = n * mlt.boot_mult
    boot_ids = jnp.arange(m, dtype=jnp.uint32)
    psv_boot = _fresh_psv(seed, boot_ids, D, jnp.uint32(0xB007))
    # evaluate bootstrap candidates in n-sized slices to bound memory
    def boot_body(i, acc):
        sl = jax.lax.dynamic_slice_in_dim(psv_boot, i * n, n, axis=0)
        _, _, I = mlt._eval(scene, camera, w, h, sl)
        return jax.lax.dynamic_update_slice_in_dim(acc, I, i * n, axis=0)
    I_boot = jax.lax.fori_loop(0, mlt.boot_mult, boot_body,
                               jnp.zeros((m,), jnp.float32))
    b = jnp.mean(I_boot)                       # E_uniform[I]
    cdf = jnp.cumsum(I_boot)
    tot = jnp.maximum(cdf[-1], 1e-30)
    u_sel = rng.sample_1d(seed, chain, _DIM_BOOT_SEL)
    idx = jnp.clip(jnp.searchsorted(cdf, u_sel * tot, side="right"),
                   0, m - 1)
    psv0 = psv_boot[idx]

    # ---- phase 2: Metropolis chains ------------------------------------
    L0, pos0, I0 = mlt._eval(scene, camera, w, h, psv0)
    I0 = jnp.maximum(I0, 1e-12)
    p_large = mlt.p_large

    def step(carry, s):
        psv, L, pos, I, accum = carry
        s32 = s.astype(jnp.uint32)
        noise = _fresh_psv(seed + jnp.uint32(1), chain, D, s32)
        coin = _fresh_psv(seed + jnp.uint32(2), chain, D, s32)
        large = rng.sample_1d(seed, chain, _DIM_LARGE, s32) < p_large
        psv_small = _mutate_small(psv, noise, coin)
        psv_prop = jnp.where(large[:, None, None], noise, psv_small)

        L_p, pos_p, I_p = mlt._eval(scene, camera, w, h, psv_prop)

        a = jnp.minimum(1.0, I_p / I)
        # Kelemen expected-value weights with large-step MIS
        # (ref: pssmlt_proc.cpp splat weighting)
        w_prop = (a + large.astype(jnp.float32)) / (
            I_p / b + p_large) / n_mutations
        w_cur = (1.0 - a) / (I / b + p_large) / n_mutations
        w_prop = jnp.where(jnp.isfinite(w_prop), w_prop, 0.0)
        accum = film.splat(accum, pos, L * w_cur[:, None])
        accum = film.splat(accum, pos_p, L_p * w_prop[:, None])

        acc = rng.sample_1d(seed, chain, _DIM_ACCEPT, s32) < a
        accm = acc[:, None]
        return ((jnp.where(accm[..., None], psv_prop, psv),
                 jnp.where(accm, L_p, L),
                 jnp.where(accm, pos_p, pos),
                 jnp.maximum(jnp.where(acc, I_p, I), 1e-12),
                 accum), a.mean())

    init = (psv0, L0, pos0, I0, film.new_accumulator())
    (_, _, _, _, accum), accept_rate = jax.lax.scan(
        step, init, jnp.arange(n_mutations))

    # normalisation: accum holds Σ splats; each mutation's splats estimate
    # img/(W·H) in expectation and we pre-divided by n_mutations, so
    # img = accum · (W·H) / n_chains.
    img = accum[..., 0:3] * (w * h / n)
    return img, b, accept_rate.mean()
