"""Benchmark: 8-bounce path-trace throughput on the Cornell box.

Prints ONE JSON line: {"metric", "value", "unit", "device"}, with the
device as JAX reports it (platform, kind, count). Runs on whatever
jax.devices() provides; on the CPU (JAX_PLATFORMS=cpu) it is a smoke test
of the script, not a measurement of any accelerator.

Ray accounting matches the reference's "Normal/Shadow rays traced" counters
(ref: src/librender/skdtree.cpp:46-47): one count per live intersection ray
plus one per attempted NEE shadow ray, measured exactly by on-device
counters — not estimated.
"""
from __future__ import annotations

import json
import time

import jax
import jax.numpy as jnp

from mitsuba_tpu.core import rng
from mitsuba_tpu.integrator.common import DIM_PIXEL
from mitsuba_tpu.integrator.path import PathTracer
from mitsuba_tpu.scene.builder import compile_scene
from mitsuba_tpu.scene.presets import cornell_box, cornell_camera
from mitsuba_tpu.util.compile_cache import setup_compile_cache

WIDTH = HEIGHT = 256
SPP_PER_PASS = 16
N_TIMED_PASSES = 4
MAX_DEPTH = 8


def _bench_wavefront(scene, camera):
    integrator = PathTracer(max_depth=MAX_DEPTH).specialized_for(scene)
    n_pix = WIDTH * HEIGHT
    n = n_pix * SPP_PER_PASS
    px = jnp.arange(n, dtype=jnp.uint32) % jnp.uint32(n_pix)
    pix_x = (px % WIDTH).astype(jnp.float32)
    pix_y = (px // WIDTH).astype(jnp.float32)
    samp = jnp.arange(n, dtype=jnp.uint32) // jnp.uint32(n_pix)

    @jax.jit
    def one_pass(scene, seed):
        s = samp + seed * jnp.uint32(SPP_PER_PASS)
        jitter = rng.sample_2d(seed, px, DIM_PIXEL, s)
        pos = jnp.stack([pix_x + jitter[..., 0], pix_y + jitter[..., 1]],
                        axis=-1)
        o, d = camera.sample_ray(pos)
        radiance, n_rays = integrator.li_stats(scene, o, d, seed, px, s)
        return jnp.mean(radiance), n_rays

    mean_r, n_rays = one_pass(scene, jnp.uint32(0))
    mean_r.block_until_ready()
    t0 = time.perf_counter()
    outs = [one_pass(scene, jnp.uint32(s))
            for s in range(1, N_TIMED_PASSES + 1)]
    jax.block_until_ready(outs)
    elapsed = time.perf_counter() - t0
    return sum(int(r) for _, r in outs) / elapsed


def main():
    setup_compile_cache()
    scene = compile_scene(cornell_box())
    camera = cornell_camera(width=WIDTH, height=HEIGHT)
    rays_per_s = _bench_wavefront(scene, camera)
    dev = jax.devices()[0]
    print(json.dumps({
        "metric": "cornell_pt8_rays_per_s",
        "value": rays_per_s,
        "unit": "rays/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
