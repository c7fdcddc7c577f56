"""Film: sample splatting + accumulation + develop.

Wavefront analog of ImageBlock/Film (ref: include/mitsuba/render/
imageblock.h:40,124-200, film.h:37; SURVEY Appendix A.6). The image is a
[H, W, 4] accumulator (RGB + filter weight, the reference's
ESpectrumAlphaWeight layout minus alpha). Splatting walks the static K×K
filter footprint with scatter-adds — atomics on a GPU, so the float sums
may land in another order from run to run (chip_smoke.py phase 7 reports
whether two renders are bit-identical), and for the box
filter it collapses to a single scatter per sample. NaN samples are
rejected, not propagated (imageblock.h:146-151).
"""
from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp

from . import rfilter


@dataclass(frozen=True)
class Film:
    """hdrfilm analog (ref: src/films/hdrfilm.cpp)."""
    width: int = 256
    height: int = 256
    filter_name: str = "box"
    banner: bool = False    # stamp the corner banner at develop time
                            # (ref: hdrfilm.cpp "banner" property)
    component_format: str = "float32"   # EXR channel type: "float16"
                                        # (OpenEXR default) or "float32"
                                        # (ref: hdrfilm componentFormat)
    compression: str = "zip"            # EXR chunk compression:
                                        # zip/zips/none (io/image.py)

    @property
    def ftype(self):
        return rfilter.NAMES[self.filter_name]

    @property
    def radius(self):
        return rfilter.RADIUS[self.ftype]

    def new_accumulator(self):
        return jnp.zeros((self.height, self.width, 4), jnp.float32)

    def splat(self, accum, pos, value):
        """Splat samples into the accumulator.

        pos [N, 2] continuous pixel coords (x, y); value [N, 3].
        Returns the updated accumulator.
        """
        # reject invalid (NaN/Inf) samples
        finite = jnp.all(jnp.isfinite(value), axis=-1) & jnp.all(
            jnp.isfinite(pos), axis=-1)
        value = jnp.where(finite[..., None], value, 0.0)
        pos = jnp.where(finite[..., None], pos, -100.0)

        r = self.radius
        ftype = self.ftype
        if ftype == rfilter.BOX:
            px = jnp.floor(pos[..., 0]).astype(jnp.int32)
            py = jnp.floor(pos[..., 1]).astype(jnp.int32)
            inside = ((px >= 0) & (px < self.width)
                      & (py >= 0) & (py < self.height) & finite)
            px = jnp.clip(px, 0, self.width - 1)
            py = jnp.clip(py, 0, self.height - 1)
            contrib = jnp.concatenate(
                [value, jnp.ones(value.shape[:-1] + (1,))], axis=-1)
            contrib = jnp.where(inside[..., None], contrib, 0.0)
            return accum.at[py, px].add(contrib)

        # general separable filter: static K×K footprint
        # window = ceil(pos - r + 0.5)... per imageblock.h:144: the sample at
        # continuous position p affects pixels whose centers (ix+0.5) lie
        # within [p - r, p + r].
        k = int(2 * r + 0.9999)
        x0 = jnp.floor(pos[..., 0] - r + 0.5).astype(jnp.int32)
        y0 = jnp.floor(pos[..., 1] - r + 0.5).astype(jnp.int32)
        for dy in range(k + 1):
            for dx in range(k + 1):
                ix = x0 + dx
                iy = y0 + dy
                wx = rfilter.eval_filter(
                    ftype, (ix.astype(jnp.float32) + 0.5) - pos[..., 0])
                wy = rfilter.eval_filter(
                    ftype, (iy.astype(jnp.float32) + 0.5) - pos[..., 1])
                w = wx * wy
                inside = ((ix >= 0) & (ix < self.width)
                          & (iy >= 0) & (iy < self.height) & finite)
                w = jnp.where(inside, w, 0.0)
                ixc = jnp.clip(ix, 0, self.width - 1)
                iyc = jnp.clip(iy, 0, self.height - 1)
                contrib = jnp.concatenate(
                    [value * w[..., None], w[..., None]], axis=-1)
                accum = accum.at[iyc, ixc].add(contrib)
        return accum

    def develop(self, accum):
        """Weighted average → [H, W, 3] radiance image
        (ref: hdrfilm.cpp:481-494 Bitmap::convert weight division)."""
        w = accum[..., 3:4]
        return jnp.where(w > 0, accum[..., 0:3] / jnp.maximum(w, 1e-20), 0.0)
