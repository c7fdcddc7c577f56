"""Sensors: perspective (+ thin-lens DoF), orthographic, spherical.

Counterpart of the reference sensor hierarchy (ref: include/mitsuba/render/
sensor.h:66,143,393,492 and src/sensors/{perspective,thinlens,orthographic,
spherical}.cpp). Functional: a camera is a small dataclass of static config
+ host-precomputed transform; `sample_ray` maps film-plane samples [N, 2]
(continuous pixel coords) + aperture samples to world-space rays, fully
vectorized.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from ..core import transform as tf
from ..core.math import matmul, normalize
from ..core.warp import square_to_uniform_disk_concentric


class _HashableByValue:
    """Cameras ride through jit as static args; hash/eq by config bytes so
    identical configs share one compilation cache entry."""

    def _key(self):
        vals = []
        for f_ in self.__dataclass_fields__:
            v = getattr(self, f_)
            vals.append(v.tobytes() if isinstance(v, np.ndarray) else v)
        return tuple(vals)

    def __hash__(self):
        return hash(self._key())

    def __eq__(self, other):
        return (type(self) is type(other)
                and self._key() == other._key())


@dataclass(frozen=True, eq=False)
class PerspectiveCamera(_HashableByValue):
    """Pinhole perspective camera (ref: src/sensors/perspective.cpp).

    fov_x in degrees along the x (width) axis, matching the reference's
    default `fov` axis handling. Optional thin-lens parameters enable DoF
    (ref: src/sensors/thinlens.cpp) when aperture_radius > 0.
    """
    width: int = 256
    height: int = 256
    fov_x: float = 39.0
    to_world: np.ndarray = field(default_factory=tf.identity)
    near_clip: float = 1e-2
    far_clip: float = 1e4
    aperture_radius: float = 0.0
    focus_distance: float = 1.0

    def _precompute(self):
        tan_half = np.tan(np.radians(self.fov_x) / 2.0)
        aspect = self.height / self.width
        m = self.to_world
        return (np.float32(tan_half), np.float32(aspect),
                jnp.asarray(m[:3, :3], jnp.float32),
                jnp.asarray(m[:3, 3], jnp.float32))

    def sample_ray(self, pixel_xy, aperture_uv=None):
        """pixel_xy: [N, 2] continuous pixel coordinates in [0,W)x[0,H).
        Returns (o [N,3], d [N,3]) world-space; d normalized.

        Film convention: row 0 = image top, column 0 = image left. The
        camera's local frame is (left, up, forward) per the reference's
        lookAt (transform.h); its camera-to-sample transform flips x so the
        image is not mirrored (perspective.cpp) — hence image-left maps to
        +x (the left axis) here.
        """
        tan_half, aspect, r, t = self._precompute()
        ndc_x = 1.0 - (pixel_xy[..., 0] / self.width) * 2.0
        ndc_y = 1.0 - (pixel_xy[..., 1] / self.height) * 2.0
        dx = ndc_x * tan_half
        dy = ndc_y * tan_half * aspect
        d_local = jnp.stack([dx, dy, jnp.ones_like(dx)], axis=-1)
        o_local = jnp.zeros_like(d_local)

        if self.aperture_radius > 0.0 and aperture_uv is not None:
            # thin lens: focus plane at focus_distance along +z
            p_focus = d_local * self.focus_distance
            lens = square_to_uniform_disk_concentric(aperture_uv)
            lens = lens * self.aperture_radius
            o_local = jnp.stack(
                [lens[..., 0], lens[..., 1], jnp.zeros_like(lens[..., 0])],
                axis=-1)
            d_local = p_focus - o_local

        d_world = normalize(matmul(d_local, r.T))
        o_world = matmul(o_local, r.T) + t
        return o_world, d_world

    def project(self, p_world):
        """World point → (raster_xy [N,2], visible [N], importance W [N]).

        The sensor-importance side of the reference's light-tracing support
        (ref: PerspectiveCamera::sampleDirect / importance, sensor.h:246,
        perspective.cpp): W = d²/(A cos³θ) with A the area of the image
        plane at unit distance — so that splatting W·f·G-weighted particle
        contributions reproduces radiance in the same units as eye paths.
        """
        tan_half, aspect, r, t = self._precompute()
        rel = p_world - t
        # world → camera local (r is orthonormal: inverse = transpose)
        local = matmul(rel, r)
        z = local[..., 2]
        visible = z > self.near_clip
        zs = jnp.maximum(z, 1e-6)
        x = local[..., 0] / zs
        y = local[..., 1] / zs
        px = (1.0 - x / tan_half) * 0.5 * self.width
        py = (1.0 - y / (tan_half * aspect)) * 0.5 * self.height
        visible = visible & (px >= 0) & (px < self.width) \
            & (py >= 0) & (py < self.height)
        # image-plane area at unit distance
        area = 4.0 * tan_half * (tan_half * aspect)
        cos_theta = zs * jax.lax.rsqrt(
            jnp.maximum(jnp.sum(local * local, axis=-1), 1e-12))
        w = 1.0 / jnp.maximum(area * cos_theta ** 3, 1e-9)
        return jnp.stack([px, py], axis=-1), visible, w

    @property
    def position(self):
        return jnp.asarray(self.to_world[:3, 3], jnp.float32)

    @property
    def n_pixels(self):
        return self.width * self.height


@dataclass(frozen=True, eq=False)
class OrthographicCamera(_HashableByValue):
    """Orthographic sensor (ref: src/sensors/orthographic.cpp). The image
    plane spans [-1,1]² in local xy before to_world scaling."""
    width: int = 256
    height: int = 256
    to_world: np.ndarray = field(default_factory=tf.identity)

    def sample_ray(self, pixel_xy, aperture_uv=None):
        r = jnp.asarray(self.to_world[:3, :3], jnp.float32)
        t = jnp.asarray(self.to_world[:3, 3], jnp.float32)
        x = 1.0 - (pixel_xy[..., 0] / self.width) * 2.0
        y = 1.0 - (pixel_xy[..., 1] / self.height) * 2.0
        o_local = jnp.stack([x, y, jnp.zeros_like(x)], axis=-1)
        d_local = jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0]), o_local.shape)
        return matmul(o_local, r.T) + t, normalize(matmul(d_local, r.T))

    @property
    def n_pixels(self):
        return self.width * self.height


@dataclass(frozen=True, eq=False)
class RadianceMeter(_HashableByValue):
    """Single-ray radiance probe (ref: src/sensors/radiancemeter.cpp):
    measures incident radiance along to_world's +z axis from its origin.
    Renders as a 1×1 film."""
    width: int = 1
    height: int = 1
    to_world: np.ndarray = field(default_factory=tf.identity)

    def sample_ray(self, pixel_xy, aperture_uv=None):
        r = jnp.asarray(self.to_world[:3, :3], jnp.float32)
        t = jnp.asarray(self.to_world[:3, 3], jnp.float32)
        n = pixel_xy.shape[0]
        o = jnp.broadcast_to(t, (n, 3))
        d = jnp.broadcast_to(normalize(r[:, 2]), (n, 3))
        return o, d

    @property
    def n_pixels(self):
        return 1


@dataclass(frozen=True, eq=False)
class IrradianceMeter(_HashableByValue):
    """Hemispherical irradiance probe (ref: src/sensors/
    irradiancemeter.cpp): cosine-weighted rays over the +z hemisphere of
    to_world; the 1×1 film average times π estimates irradiance E."""
    width: int = 1
    height: int = 1
    to_world: np.ndarray = field(default_factory=tf.identity)

    def sample_ray(self, pixel_xy, aperture_uv=None):
        from ..core.warp import square_to_cosine_hemisphere
        r = jnp.asarray(self.to_world[:3, :3], jnp.float32)
        t = jnp.asarray(self.to_world[:3, 3], jnp.float32)
        n = pixel_xy.shape[0]
        u = aperture_uv if aperture_uv is not None else \
            jnp.zeros((n, 2)) + 0.5
        d_local = square_to_cosine_hemisphere(u)
        o = jnp.broadcast_to(t, (n, 3))
        return o, normalize(matmul(d_local, r.T))

    @property
    def n_pixels(self):
        return 1


@dataclass(frozen=True, eq=False)
class SphericalCamera(_HashableByValue):
    """Lat-long 360° sensor (ref: src/sensors/spherical.cpp)."""
    width: int = 512
    height: int = 256
    to_world: np.ndarray = field(default_factory=tf.identity)

    def sample_ray(self, pixel_xy, aperture_uv=None):
        r = jnp.asarray(self.to_world[:3, :3], jnp.float32)
        t = jnp.asarray(self.to_world[:3, 3], jnp.float32)
        phi = (1.0 - pixel_xy[..., 0] / self.width) * 2.0 * jnp.pi
        theta = (pixel_xy[..., 1] / self.height) * jnp.pi
        st = jnp.sin(theta)
        d_local = jnp.stack(
            [st * jnp.sin(phi), jnp.cos(theta), -st * jnp.cos(phi)], axis=-1)
        o = jnp.broadcast_to(t, d_local.shape)
        return o, normalize(matmul(d_local, r.T))

    @property
    def n_pixels(self):
        return self.width * self.height


@dataclass(frozen=True, eq=False)
class TelecentricCamera(_HashableByValue):
    """Telecentric lens sensor (ref: src/sensors/telecentric.cpp):
    orthographic projection with a finite aperture — parallel chief rays,
    depth of field around focus_distance."""
    width: int = 256
    height: int = 256
    to_world: np.ndarray = field(default_factory=tf.identity)
    aperture_radius: float = 0.0
    focus_distance: float = 1.0

    def sample_ray(self, pixel_xy, aperture_uv=None):
        from ..core.warp import square_to_uniform_disk_concentric
        r = jnp.asarray(self.to_world[:3, :3], jnp.float32)
        t = jnp.asarray(self.to_world[:3, 3], jnp.float32)
        x = 1.0 - (pixel_xy[..., 0] / self.width) * 2.0
        y = 1.0 - (pixel_xy[..., 1] / self.height) * 2.0
        o_local = jnp.stack([x, y, jnp.zeros_like(x)], axis=-1)
        d_local = jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0]),
                                   o_local.shape)
        if self.aperture_radius > 0.0 and aperture_uv is not None:
            focus = o_local + d_local * self.focus_distance
            lens = square_to_uniform_disk_concentric(aperture_uv) \
                * self.aperture_radius
            o_local = o_local + jnp.stack(
                [lens[..., 0], lens[..., 1],
                 jnp.zeros_like(lens[..., 0])], axis=-1)
            d_local = focus - o_local
        return matmul(o_local, r.T) + t, normalize(matmul(d_local, r.T))

    @property
    def n_pixels(self):
        return self.width * self.height


@dataclass(frozen=True, eq=False)
class PerspectiveRDistCamera(_HashableByValue):
    """Perspective sensor with polynomial radial distortion (ref:
    src/sensors/perspective_rdist.cpp, kc two-term Brown model): the
    normalized image point is scaled by 1 + kc0·r² + kc1·r⁴ before the
    ray is formed — matching the reference's calibration convention."""
    width: int = 256
    height: int = 256
    fov_x: float = 39.0
    to_world: np.ndarray = field(default_factory=tf.identity)
    kc0: float = 0.0
    kc1: float = 0.0

    def sample_ray(self, pixel_xy, aperture_uv=None):
        tan_half = np.tan(np.radians(self.fov_x) / 2.0)
        aspect = self.height / self.width
        r = jnp.asarray(self.to_world[:3, :3], jnp.float32)
        t = jnp.asarray(self.to_world[:3, 3], jnp.float32)
        ndc_x = 1.0 - (pixel_xy[..., 0] / self.width) * 2.0
        ndc_y = 1.0 - (pixel_xy[..., 1] / self.height) * 2.0
        dx = ndc_x * tan_half
        dy = ndc_y * tan_half * aspect
        r2 = dx * dx + dy * dy
        factor = 1.0 + self.kc0 * r2 + self.kc1 * r2 * r2
        d_local = jnp.stack([dx * factor, dy * factor,
                             jnp.ones_like(dx)], axis=-1)
        o_world = jnp.broadcast_to(t, d_local.shape)
        return o_world, normalize(matmul(d_local, r.T))

    @property
    def n_pixels(self):
        return self.width * self.height


@dataclass(frozen=True, eq=False)
class FluenceMeter(_HashableByValue):
    """Fluence probe (ref: src/sensors/fluencemeter.cpp): integrates
    radiance over the FULL sphere at to_world's origin; the 1×1 film
    average times 4π estimates the fluence φ(p)."""
    width: int = 1
    height: int = 1
    to_world: np.ndarray = field(default_factory=tf.identity)

    def sample_ray(self, pixel_xy, aperture_uv=None):
        from ..core.warp import square_to_uniform_sphere
        t = jnp.asarray(self.to_world[:3, 3], jnp.float32)
        n = pixel_xy.shape[0]
        u = aperture_uv if aperture_uv is not None else \
            jnp.zeros((n, 2)) + 0.5
        d = square_to_uniform_sphere(u)
        o = jnp.broadcast_to(t, (n, 3))
        return o, d

    @property
    def n_pixels(self):
        return 1
