"""mitsuba_tpu — a differentiable wavefront path-tracing framework.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of Mitsuba 0.5
(winmad research fork). Wavefront structure-of-arrays scene representation,
dense-math ray-scene intersection with a fused GPU trace kernel, `lax.scan` integrators, counter-based
replayable RNG, and `jax.sharding` multi-chip distribution. See SURVEY.md for
the component map and ARCHITECTURE.md for design rationale.
"""

__version__ = "0.1.0"

from . import core

__all__ = ["core"]
