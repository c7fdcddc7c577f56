"""Color/spectrum utilities (linear-RGB mode, SPECTRUM_SAMPLES = 3).

The reference compiles with a configurable channel count (ref: include/
mitsuba/core/spectrum.h:25-33,663); this build keeps the channel axis generic
(trailing axis N_CHANNELS) but ships RGB=3 like the reference default.
"""
from __future__ import annotations

import jax.numpy as jnp

N_CHANNELS = 3

# ITU-R BT.709 luminance weights (ref: spectrum.cpp `getLuminance`)
_LUM = jnp.array([0.212671, 0.715160, 0.072169], dtype=jnp.float32)

# sRGB <-> XYZ matrices (ref: spectrum.cpp:toLinearRGB/fromLinearRGB)
_XYZ_TO_RGB = jnp.array(
    [[3.240479, -1.537150, -0.498535],
     [-0.969256, 1.875991, 0.041556],
     [0.055648, -0.204043, 1.057311]], dtype=jnp.float32)
_RGB_TO_XYZ = jnp.array(
    [[0.412453, 0.357580, 0.180423],
     [0.212671, 0.715160, 0.072169],
     [0.019334, 0.119193, 0.950227]], dtype=jnp.float32)


def luminance(c):
    return jnp.sum(c * _LUM, axis=-1)


def rgb_to_xyz(c):
    return c @ _RGB_TO_XYZ.T


def xyz_to_rgb(c):
    return c @ _XYZ_TO_RGB.T


def to_srgb(c):
    """Linear → sRGB gamma (ref: spectrum.cpp toSRGBComponent)."""
    c = jnp.clip(c, 0.0, 1.0)
    return jnp.where(c <= 0.0031308, 12.92 * c,
                     1.055 * jnp.power(jnp.maximum(c, 1e-8), 1.0 / 2.4) - 0.055)


def from_srgb(c):
    return jnp.where(c <= 0.04045, c / 12.92,
                     jnp.power((c + 0.055) / 1.055, 2.4))


def blackbody(temperature_k, lambdas_nm):
    """Planck's law, W/(m² · sr · nm) scale (ref: spectrum.cpp BlackBodySpectrum)."""
    h = 6.62607015e-34
    c = 2.99792458e8
    kb = 1.380649e-23
    lam = lambdas_nm * 1e-9
    return (2.0 * h * c * c) / (
        lam ** 5 * (jnp.exp(h * c / (lam * kb * temperature_k)) - 1.0)) * 1e-9


# ---------------------------------------------------------------------------
# Full-spectral mode (SPECTRUM_SAMPLES > 3)
# ---------------------------------------------------------------------------
# The reference recompiles with SPECTRUM_SAMPLES spectral bins over
# 360-830nm (spectrum.h:25-33); BSDF/emitter values become interpolated
# spectra (InterpolatedSpectrum, .spd files) integrated against the CIE
# observer at output time. This renderer renders spectrally WITHOUT a
# channel-count rebuild: the 3-channel pipeline evaluates 3 spectral bins
# per pass (integrator/spectral.py render_spectral), so K bins cost K/3
# renders and every code path (BSDFs, media, kernels) is reused as-is —
# including wavelength-dependent IOR per band (dispersion).

SPECTRUM_MIN_NM = 360.0      # spectrum.h:29
SPECTRUM_MAX_NM = 830.0

# CIE 1931 standard observer, 10nm samples 360..830nm (public tabulation,
# interpolated linearly in between) — the integration weights the
# reference stores in spectrum.cpp's CIE arrays.
CIE_LAMBDA = jnp.arange(360.0, 831.0, 10.0)
CIE_X = jnp.array([
    0.0001299, 0.0004149, 0.001368, 0.004243, 0.01431, 0.04351, 0.13438,
    0.2839, 0.34828, 0.3362, 0.2908, 0.19536, 0.09564, 0.03201, 0.0049,
    0.0093, 0.06327, 0.1655, 0.2904, 0.4334475, 0.5945, 0.7621, 0.9163,
    1.0263, 1.0622, 1.0026, 0.8544499, 0.6424, 0.4479, 0.2835, 0.1649,
    0.0874, 0.04677, 0.0227, 0.011359, 0.005790346, 0.002899327,
    0.001439971, 0.0006900786, 0.0003323011, 0.0001661505, 8.30753e-05,
    4.150994e-05, 2.067383e-05, 1.025398e-05, 5.085868e-06,
    2.522525e-06, 1.251141e-06])
CIE_Y = jnp.array([
    3.917e-06, 1.239e-05, 3.9e-05, 0.00012, 0.000396, 0.00121, 0.004,
    0.0116, 0.023, 0.038, 0.06, 0.09098, 0.13902, 0.20802, 0.323,
    0.503, 0.71, 0.862, 0.954, 0.9949501, 0.995, 0.952, 0.87, 0.757,
    0.631, 0.503, 0.381, 0.265, 0.175, 0.107, 0.061, 0.032, 0.017,
    0.00821, 0.004102, 0.002091, 0.001047, 0.00052, 0.0002492,
    0.00012, 6e-05, 3e-05, 1.499e-05, 7.4657e-06, 3.7029e-06,
    1.8366e-06, 9.1093e-07, 4.5181e-07])
CIE_Z = jnp.array([
    0.0006061, 0.001946, 0.006450001, 0.02005001, 0.06785001, 0.2074,
    0.6456, 1.3856, 1.74706, 1.77211, 1.6692, 1.28764, 0.8129501,
    0.46518, 0.272, 0.1582, 0.07824999, 0.04216, 0.0203, 0.008749999,
    0.0039, 0.0021, 0.001650001, 0.0011, 0.0008, 0.00034, 0.00019,
    4.999999e-05, 2e-05, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
    0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0])


def cie_xyz_at(lambdas_nm):
    """Interpolated CIE observer values at arbitrary wavelengths [K] →
    [K, 3]."""
    lam = jnp.asarray(lambdas_nm)
    x = jnp.interp(lam, CIE_LAMBDA, CIE_X)
    y = jnp.interp(lam, CIE_LAMBDA, CIE_Y)
    z = jnp.interp(lam, CIE_LAMBDA, CIE_Z)
    return jnp.stack([x, y, z], axis=-1)


def spectral_to_xyz(lambdas_nm, values):
    """Integrate spectral samples (…, K over the last axis) against the
    CIE observer → XYZ (…, 3), normalised so an equal-energy spectrum of
    unit radiance has Y = 1 (spectrum.cpp toXYZ convention)."""
    cmf = cie_xyz_at(lambdas_nm)                  # [K, 3]
    norm = jnp.sum(cmf[:, 1])
    return jnp.einsum("...k,kc->...c", jnp.asarray(values), cmf) / norm


def spectral_to_rgb(lambdas_nm, values):
    return xyz_to_rgb(spectral_to_xyz(lambdas_nm, values))


class InterpolatedSpectrum:
    """Linearly interpolated spectrum (ref: spectrum.h
    InterpolatedSpectrum + .spd file I/O)."""

    def __init__(self, wavelengths, values):
        import numpy as np
        self.wl = np.asarray(wavelengths, np.float64)
        self.v = np.asarray(values, np.float64)
        assert (np.diff(self.wl) > 0).all(), "wavelengths must ascend"

    @classmethod
    def from_file(cls, path: str) -> "InterpolatedSpectrum":
        """Read the reference's .spd format: 'lambda value' lines,
        '#' comments (ref: spectrum.cpp InterpolatedSpectrum(fs::path))."""
        wl, v = [], []
        with open(path) as f:
            for line in f:
                line = line.split("#", 1)[0].strip()
                if not line:
                    continue
                a, b = line.split()[:2]
                wl.append(float(a))
                v.append(float(b))
        return cls(wl, v)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            for a, b in zip(self.wl, self.v):
                f.write(f"{a:g} {b:g}\n")

    def eval(self, lambdas_nm):
        import numpy as np
        return np.interp(np.asarray(lambdas_nm), self.wl, self.v,
                         left=0.0, right=0.0)

    def to_rgb(self, emitter: bool = False):
        """Project onto linear RGB (the reference's toLinearRGB path used
        when compiled at SPECTRUM_SAMPLES=3)."""
        import numpy as np
        lam = np.arange(SPECTRUM_MIN_NM, SPECTRUM_MAX_NM + 1.0, 5.0)
        rgb = spectral_to_rgb(lam, self.eval(lam) * 1.0)
        return np.asarray(rgb)
