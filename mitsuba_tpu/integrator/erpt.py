"""Energy Redistribution Path Tracing (Cline et al. 2005).

Counterpart of the reference `erpt` plugin (ref: src/integrators/erpt/
{erpt.cpp,erpt_proc.cpp}): ordinary path-traced samples seed short
Metropolis chains that redistribute each sample's energy to nearby paths
(small mutations only — the reference uses lens/caustic/multi-chain and
manifold perturbations, this build uses Kelemen small steps in primary
sample space, which perturb the same degrees of freedom through the
sample-to-path map).

Estimator (equal-deposition ERPT, Cline §5): a seed with luminance I
spawns on average I/(e_d·M) chains of M mutations, each mutation
depositing a fixed energy quantum e_d (in color, rgb/lum·e_d) at the
chain's current path. Chain counts are realised by categorical
resampling of seeds ∝ I over a fixed wavefront of chains — the wavefront
equivalent of the reference's per-seed `numChains = floor(u + I/(e_d·M))`
loop — which makes every lane shape-static.

Deposition with Metropolis acceptance a: both current and proposed states
receive e_d-scaled splats weighted (1-a)/a, exactly the reference's
`ERPTProcess` transition rule.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp

from ..core import rng
from ..film.film import Film
from ..scene.scene import SceneData
from .pssmlt import PSSMLT, _fresh_psv, _luminance, _mutate_small

_DIM_SEED_SEL = 1 << 24


@dataclass(frozen=True)
class ERPT(PSSMLT):
    """numChains/maxChains/chainLength per erpt.cpp properties map to the
    fixed chain wavefront + mutations_per_chain here."""
    mutations_per_chain: int = 100          # ref default chainLength
    seeds_per_chain: int = 4                # bootstrap factor

    def render(self, scene: SceneData, camera, film: Film,
               n_mutations: int = 0, seed: int = 0):
        """n_mutations ignored (chain length is config); kept for API
        symmetry with PSSMLT. Returns (image, b, acceptance)."""
        return _render_erpt(scene, camera, film, self, seed)

    def render_full(self, scene: SceneData, camera, film: Film,
                    spp: int, seed: int = 0):
        import dataclasses

        import numpy as np
        mlt = self
        if mlt.families is None:
            fams = tuple(sorted(int(x) for x in np.unique(
                np.asarray(scene.mat_type))))
            mlt = dataclasses.replace(mlt, families=fams)
        img, _b, _acc = _render_erpt(scene, camera, film, mlt, seed)
        return img


@partial(jax.jit, static_argnames=("camera", "film", "cfg"))
def _render_erpt(scene, camera, film, cfg: ERPT, seed):
    seed = jnp.asarray(seed, jnp.uint32)
    w, h = film.width, film.height
    n = cfg.n_chains
    D = cfg.n_dims
    M = cfg.mutations_per_chain
    chain = jnp.arange(n, dtype=jnp.uint32)

    # ---- phase 1: path-traced seed samples ------------------------------
    m = n * cfg.seeds_per_chain
    seed_ids = jnp.arange(m, dtype=jnp.uint32)
    psv_seeds = _fresh_psv(seed, seed_ids, D, jnp.uint32(0xE497))

    def eval_slice(i, acc):
        sl = jax.lax.dynamic_slice_in_dim(psv_seeds, i * n, n, axis=0)
        _, _, I = cfg._eval(scene, camera, w, h, sl)
        return jax.lax.dynamic_update_slice_in_dim(acc, I, i * n, axis=0)
    I_seed = jax.lax.fori_loop(0, cfg.seeds_per_chain, eval_slice,
                               jnp.zeros((m,), jnp.float32))
    b = jnp.mean(I_seed)
    # energy quantum: with chains already drawn ∝ I, unbiasedness pins
    # e_d = b/M — each chain then deposits exactly the average seed
    # energy b over its M mutations (Cline's equal-deposition invariant)
    e_d = jnp.maximum(b, 1e-12) / M

    # chains ∝ seed luminance (expected count I/(e_d·M), realised by
    # resampling a fixed wavefront — unbiased for the deposited total)
    cdf = jnp.cumsum(I_seed)
    tot = jnp.maximum(cdf[-1], 1e-30)
    u_sel = rng.sample_1d(seed, chain, _DIM_SEED_SEL)
    idx = jnp.clip(jnp.searchsorted(cdf, u_sel * tot, side="right"),
                   0, m - 1)
    psv0 = psv_seeds[idx]
    L0, pos0, I0 = cfg._eval(scene, camera, w, h, psv0)
    I0 = jnp.maximum(I0, 1e-12)

    # ---- phase 2: redistribution chains (small steps only) -------------
    def step(carry, s):
        psv, L, pos, I, accum = carry
        s32 = s.astype(jnp.uint32)
        noise = _fresh_psv(seed + jnp.uint32(1), chain, D, s32)
        coin = _fresh_psv(seed + jnp.uint32(2), chain, D, s32)
        psv_prop = _mutate_small(psv, noise, coin)
        L_p, pos_p, I_p = cfg._eval(scene, camera, w, h, psv_prop)
        a = jnp.minimum(1.0, I_p / I)
        # deposit e_d at both states, transition-weighted (Cline eq. 8)
        dep_cur = (1.0 - a) * e_d / jnp.maximum(I, 1e-12)
        dep_prop = a * e_d / jnp.maximum(I_p, 1e-12)
        dep_prop = jnp.where(I_p > 0, dep_prop, 0.0)
        accum = film.splat(accum, pos, L * dep_cur[:, None])
        accum = film.splat(accum, pos_p, L_p * dep_prop[:, None])
        acc = rng.sample_1d(seed, chain, _DIM_SEED_SEL + 1, s32) < a
        accm = acc[:, None]
        return ((jnp.where(accm[..., None], psv_prop, psv),
                 jnp.where(accm, L_p, L),
                 jnp.where(accm, pos_p, pos),
                 jnp.maximum(jnp.where(acc, I_p, I), 1e-12),
                 accum), a.mean())

    init = (psv0, L0, pos0, I0, film.new_accumulator())
    (_, _, _, _, accum), acc_rate = jax.lax.scan(
        step, init, jnp.arange(M))

    # each deposit already divides by the state's luminance and carries
    # e_d; the image estimate is accum · (W·H) / n (chain average), as in
    # pssmlt's normalisation
    img = accum[..., 0:3] * (w * h / n)
    return img, b, acc_rate.mean()
