"""Motion-blur rendering: time-sliced distribution ray tracing.

Counterpart of the reference's motion-blur machinery — AnimatedTransform
sensors/shapes (track.h), the `deformable` 4D-kd-tree shape and sensor
shutter sampling (sensor.h time sampling; the `motion` integrator
visualises it). Wavefront redesign rationale in core/track.py: per-ray
continuous time would make every intersection data-dependent on t, so
the shutter is stratified into n_t compile-time slices; each slice is an
ordinary static render of the scene evaluated at that time, and the film
averages them. Unbiased for piecewise-static scenes, and for continuous
motion converges to the true integral as n_t grows (the time axis is
just another stratified integration dimension).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..film.film import Film
from ..render import render
from ..scene.builder import SceneDesc, compile_scene


def render_motion(desc_at, camera_at, film: Film, integrator, spp: int,
                  shutter_open: float = 0.0, shutter_close: float = 1.0,
                  n_time: int = 8, seed: int = 0,
                  cluster_size: int = 512, jitter_time: bool = True):
    """Render with motion blur.

    desc_at(t) -> SceneDesc (or a constant SceneDesc for static scenes);
    camera_at(t) -> camera (or a constant camera). Each of the n_t
    stratified shutter strata renders spp//n_t samples. With
    `jitter_time` (default) each stratum's evaluation time is drawn
    uniformly inside the stratum from a counter-based stream, so the
    estimator integrates the CONTINUOUS shutter (unbiased for arbitrary
    motion — matching the reference's per-ray time sampling,
    sensor.h shutter semantics) instead of quantizing to stratum
    centers; geometry shapes are unchanged so the jitted render reuses
    its compilation across strata."""
    from ..core import rng as _rng
    spp_slice = max(1, spp // n_time)
    img = None
    for i in range(n_time):
        if jitter_time:
            u = float(np.asarray(_rng.sample_1d(
                jnp.uint32(seed ^ 0x5EED), jnp.uint32(i), 101, 0)))
        else:
            u = 0.5
        t = shutter_open + (i + u) / n_time * (shutter_close
                                               - shutter_open)
        desc = desc_at(t) if callable(desc_at) else desc_at
        cam = camera_at(t) if callable(camera_at) else camera_at
        scene = compile_scene(desc, cluster_size)
        integ = (integrator.specialized_for(scene)
                 if hasattr(integrator, "specialized_for")
                 and integrator.families is None else integrator)
        out = np.asarray(render(scene, cam, film, integ, spp_slice,
                                seed + i * 7919))
        img = out if img is None else img + out
    return img / n_time
