"""Chi-square GOF tests for the warp library — the wavefront analog of the
reference's test_chisquare.cpp over warp.h warps."""
import jax.numpy as jnp
import numpy as np
import pytest

from mitsuba_tpu.core import chi2, rng, warp


def _uniforms(n, seed=0):
    return np.asarray(rng.sample_2d(seed, np.arange(n), 0))


@pytest.mark.parametrize("name,warp_fn,pdf_fn", [
    ("sphere", warp.square_to_uniform_sphere,
     warp.square_to_uniform_sphere_pdf),
    ("hemisphere", warp.square_to_uniform_hemisphere,
     lambda d: jnp.where(d[..., 2] >= 0,
                         warp.square_to_uniform_hemisphere_pdf(d), 0.0)),
    ("cosine", warp.square_to_cosine_hemisphere,
     warp.square_to_cosine_hemisphere_pdf),
])
def test_warp_chi2(name, warp_fn, pdf_fn):
    passed, stats = chi2.chi2_test(
        lambda n: np.asarray(warp_fn(_uniforms(n))),
        lambda d: np.asarray(pdf_fn(d)),
        n_samples=500_000)
    assert passed, (name, stats)
    assert abs(stats["total_pdf_mass"] - 1.0) < 1e-2, stats


def test_cone_chi2():
    cutoff = 0.8
    passed, stats = chi2.chi2_test(
        lambda n: np.asarray(warp.square_to_uniform_cone(_uniforms(n), cutoff)),
        lambda d: np.where(d[:, 2] >= cutoff - 1e-6,
                           np.asarray(warp.square_to_uniform_cone_pdf(d, cutoff)),
                           0.0),
        n_samples=500_000)
    assert passed, stats


def test_disk_concentric_uniform():
    p = np.asarray(warp.square_to_uniform_disk_concentric(_uniforms(400_000)))
    r2 = (p ** 2).sum(-1)
    assert r2.max() <= 1.0 + 1e-5
    # radius² of a uniform disk sample is uniform in [0,1]
    hist, _ = np.histogram(r2, bins=32, range=(0, 1))
    expected = len(r2) / 32
    assert ((hist - expected) ** 2 / expected).sum() < 70


def test_triangle_warp():
    b = np.asarray(warp.square_to_uniform_triangle(_uniforms(200_000)))
    assert (b >= 0).all() and (b.sum(-1) <= 1 + 1e-6).all()
    # mean barycentric of uniform triangle samples = 1/3
    assert np.allclose(b.mean(0), [1 / 3, 1 / 3], atol=5e-3)
