"""Multi-channel integrator: render several sub-integrators at once.

Counterpart of the reference `multichannel` plugin (ref: src/integrators/
misc/multichannel.cpp): groups N sub-integrators and invokes them *for the
same pixel samples*; each result lands in its own channel group of one
multi-channel EXR (e.g. path RGB + shNormal RGB + distance Y).

Wavefront design: one jitted wavefront pass generates the camera rays
once, evaluates every child's `li` on them, and filter-splats each result
into its own film accumulator — the children share rays exactly as the
reference shares the per-pixel sampler stream.  Like the reference, no
negative/NaN screening is applied to AOV channels (multichannel.cpp doc
block: checks for negative/infinite radiance are disabled).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core import rng
from ..film.film import Film
from ..integrator.common import DIM_APERTURE, DIM_PIXEL
from ..scene.scene import SceneData
from .path import PathTracer


@dataclass(frozen=True)
class MultiChannelIntegrator(PathTracer):
    """children: tuple of SamplingIntegrator-style integrators (each must
    expose `li(scene, o, d, seed, pixel_id, sample_idx)`), names: channel
    group names written into the EXR (ref multichannel example:
    "color, normal, distance")."""
    children: tuple = ()
    names: tuple = ()

    def channel_names(self):
        names = self.names or tuple(
            f"ch{i}" for i in range(len(self.children)))
        out = []
        for name in names:
            out += [f"{name}.R", f"{name}.G", f"{name}.B"]
        return out

    def li(self, scene: SceneData, o, d, seed, pixel_id, sample_idx=0):
        """Concatenated [N, 3*len(children)] sample vector."""
        outs = [c.li(scene, o, d, seed, pixel_id, sample_idx)
                for c in self.children]
        return jnp.concatenate(outs, axis=-1)

    def render(self, scene: SceneData, camera, film: Film, spp: int = 16,
               seed: int = 0):
        """Returns [H, W, 3*len(children)] — one RGB group per child."""
        return _render_mc(scene, camera, film, self, spp, seed)


@partial(jax.jit, static_argnames=("camera", "film", "integ", "spp"))
def _render_mc(scene, camera, film: Film, integ: MultiChannelIntegrator,
               spp, seed):
    h, w = film.height, film.width
    n = h * w
    px = jnp.arange(n, dtype=jnp.uint32)
    pix_x = (px % w).astype(jnp.float32)
    pix_y = (px // w).astype(jnp.float32)
    k = len(integ.children)

    def sample_pass(s, accums):
        s = jnp.uint32(s)
        jitter = integ._d2(seed, px, s, DIM_PIXEL)
        pos = jnp.stack([pix_x + jitter[..., 0],
                         pix_y + jitter[..., 1]], axis=-1)
        ap = rng.sample_2d(seed, px, DIM_APERTURE, s)
        o, d = camera.sample_ray(pos, ap)
        # Shared rays: every child sees the identical sample stream
        # (multichannel.cpp invokes children "at the same time for each
        # pixel").
        return tuple(
            film.splat(acc, pos,
                       integ.children[i].li(scene, o, d, jnp.uint32(seed),
                                            px, s))
            for i, acc in enumerate(accums))

    accums = jax.lax.fori_loop(
        0, spp, sample_pass,
        tuple(film.new_accumulator() for _ in range(k)))
    return jnp.concatenate([film.develop(a) for a in accums], axis=-1)


def write_multichannel_exr(path: str, img, names):
    """Write an [H, W, C] image with explicit channel names (the
    hdrfilm `pixelFormat`/`channelNames` mechanism, hdrfilm.cpp)."""
    from ..io.image import write_exr
    write_exr(path, np.asarray(img, np.float32), channel_names=list(names))
