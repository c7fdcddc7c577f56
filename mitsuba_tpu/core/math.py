"""Vector math, shading frames, and geometric helpers.

Wavefront counterpart of the reference's fixed-size vector/frame headers
(ref: include/mitsuba/core/vector.h, frame.h, util.h). Everything here is
structure-of-arrays: a "vector" is a jnp array whose *last* axis has size 3,
and all ops broadcast over arbitrary leading (wavefront) axes.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

# Epsilons mirroring the reference's conventions (include/mitsuba/core/constants.h)
EPSILON = 1e-4
SHADOW_EPSILON = 1e-3   # ref: ShadowEpsilon, scene.cpp:846 shadow-ray clipping
DELTA_EPSILON = 1e-3    # ref: DeltaEpsilon for discrete-lobe direction tests
RAY_EPSILON = 1e-3      # base ray offset epsilon (adaptive eps: skdtree.cpp:127)
INF = jnp.inf
import numpy as _np

# numpy, not jnp: keep module import free of device-backend initialization
ONE_MINUS_EPS = float(_np.nextafter(_np.float32(1.0), _np.float32(0.0)))


def matmul(a: jax.Array, b: jax.Array) -> jax.Array:
    """f32 matrix product at full precision (a GPU would otherwise be free
    to run a default-precision `@` in TF32, ~3 decimal digits)."""
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


def dot(a: jax.Array, b: jax.Array) -> jax.Array:
    """Batched dot product over the trailing axis (keeps leading axes)."""
    return jnp.sum(a * b, axis=-1)


def absdot(a: jax.Array, b: jax.Array) -> jax.Array:
    return jnp.abs(dot(a, b))


def cross(a: jax.Array, b: jax.Array) -> jax.Array:
    return jnp.cross(a, b)


def length(a: jax.Array) -> jax.Array:
    return jnp.sqrt(jnp.maximum(jnp.sum(a * a, axis=-1), 0.0))


def squared_length(a: jax.Array) -> jax.Array:
    return jnp.sum(a * a, axis=-1)


def normalize(a: jax.Array) -> jax.Array:
    """Safe normalize: returns a/|a|; zero vectors map to zero."""
    l2 = jnp.sum(a * a, axis=-1, keepdims=True)
    return a * jax.lax.rsqrt(jnp.maximum(l2, 1e-30))


def lerp(a, b, t):
    return a + (b - a) * t


def safe_sqrt(x):
    return jnp.sqrt(jnp.maximum(x, 0.0))


def safe_rsqrt(x):
    return jax.lax.rsqrt(jnp.maximum(x, 1e-30))


def safe_div(a, b, eps: float = 1e-8):
    """a/b with tiny b clamped (sign-preserving guard).

    eps is 1e-8, not smaller: the backward pass computes a/b² and f32
    overflows past ~1e38 — inf partials turn masked lanes into NaN grads."""
    return a / jnp.where(jnp.abs(b) < eps, jnp.where(b < 0, -eps, eps), b)


def coordinate_system(n: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Branchless orthonormal basis from a unit normal.

    Duff et al. 2017 construction — replaces the reference's branchy
    ``coordinateSystem`` (src/libcore/util.cpp) with vector-friendly select-free
    math. Returns (s, t) with [s, t, n] right-handed orthonormal.
    """
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    sign = jnp.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    s = jnp.stack([1.0 + sign * nx * nx * a, sign * b, -sign * nx], axis=-1)
    t = jnp.stack([b, sign + ny * ny * a, -ny], axis=-1)
    return s, t


class Frame:
    """Shading frame helpers (ref: include/mitsuba/core/frame.h).

    Represented as three direction arrays (s, t, n) with trailing axis 3.
    Functional style: pass the tuple around, no object state.
    """

    @staticmethod
    def from_normal(n: jax.Array):
        s, t = coordinate_system(n)
        return s, t, n

    @staticmethod
    def to_local(frame, v: jax.Array) -> jax.Array:
        s, t, n = frame
        return jnp.stack([dot(v, s), dot(v, t), dot(v, n)], axis=-1)

    @staticmethod
    def to_world(frame, v: jax.Array) -> jax.Array:
        s, t, n = frame
        return (s * v[..., 0:1] + t * v[..., 1:2] + n * v[..., 2:3])

    # Local-frame trig helpers (frame.h:110-160 semantics)
    @staticmethod
    def cos_theta(v):
        return v[..., 2]

    @staticmethod
    def abs_cos_theta(v):
        return jnp.abs(v[..., 2])

    @staticmethod
    def sin_theta2(v):
        return jnp.maximum(1.0 - v[..., 2] * v[..., 2], 0.0)

    @staticmethod
    def sin_theta(v):
        return jnp.sqrt(Frame.sin_theta2(v))

    @staticmethod
    def tan_theta(v):
        return Frame.sin_theta(v) / v[..., 2]


def reflect(wi: jax.Array, n: jax.Array | None = None) -> jax.Array:
    """Mirror reflection. Without n: local-frame reflection about +z
    (ref: conductor.cpp `reflect`). With n: world-space about normal."""
    if n is None:
        return jnp.stack([-wi[..., 0], -wi[..., 1], wi[..., 2]], axis=-1)
    return 2.0 * dot(wi, n)[..., None] * n - wi


def refract_local(wi: jax.Array, eta: jax.Array, cos_theta_t: jax.Array) -> jax.Array:
    """Local-frame refraction given precomputed transmitted cosine
    (ref: util.cpp refract / dielectric.cpp). eta = int_ior/ext_ior ratio
    already oriented; cos_theta_t carries the sign of the transmitted side."""
    scale = jnp.where(cos_theta_t < 0, 1.0 / eta, eta)
    return jnp.stack(
        [-scale * wi[..., 0], -scale * wi[..., 1], cos_theta_t], axis=-1
    )


def spherical_direction(theta: jax.Array, phi: jax.Array) -> jax.Array:
    """(θ, φ) → unit vector, z-up (ref: util.cpp sphericalDirection)."""
    sin_t = jnp.sin(theta)
    return jnp.stack(
        [sin_t * jnp.cos(phi), sin_t * jnp.sin(phi), jnp.cos(theta)], axis=-1
    )


def spherical_coordinates(d: jax.Array) -> tuple[jax.Array, jax.Array]:
    """unit vector → (θ, φ) with φ ∈ [0, 2π) (ref: util.cpp toSphericalCoordinates)."""
    theta = jnp.arccos(jnp.clip(d[..., 2], -1.0, 1.0))
    phi = jnp.arctan2(d[..., 1], d[..., 0])
    phi = jnp.where(phi < 0.0, phi + 2.0 * jnp.pi, phi)
    return theta, phi
