"""Specular manifold walk (ref: include/mitsuba/bidir/manifold.h:35,
src/libbidir/manifold.cpp Newton solver; mut_manifold.cpp usage)."""
import jax
import jax.numpy as jnp
import numpy as np

from mitsuba_tpu.integrator.manifold import chain_constraint, manifold_walk


def _plane_tri(z, flip=False):
    """Large triangle in the z=const plane containing the origin region."""
    a = np.array([-2.0, -2.0, z])
    e1 = np.array([5.0, 0.0, 0.0])
    e2 = np.array([0.0, 5.0, 0.0])
    if flip:
        e1, e2 = e2, e1      # reverses the geometric normal
    return jnp.asarray(a), jnp.asarray(e1), jnp.asarray(e2)


def test_single_mirror_reflection():
    """One mirror vertex on z=0: endpoints (±1, 0, 1) reflect at the
    origin (classic equal-angle solution)."""
    ta, te1, te2 = _plane_tri(0.0)
    a = jnp.array([-1.0, 0.0, 1.0])
    b = jnp.array([1.0, 0.0, 1.0])
    uv0 = jnp.array([[0.1, 0.2]])    # start far from the solution
    uv, x, ok = manifold_walk(a, b, ta[None], te1[None], te2[None], uv0)
    assert bool(ok)
    assert np.allclose(np.asarray(x[0]), [0, 0, 0], atol=1e-5)
    # constraint residual is actually ~0
    c = chain_constraint(uv, a, b, ta[None], te1[None], te2[None],
                         jnp.array([[0., 0., 1.]]),
                         jnp.array([[0., 0., 1.]]),
                         jnp.array([[0., 0., 1.]]), jnp.ones(1))
    assert float(jnp.abs(c).max()) < 1e-5


def test_two_mirror_periscope():
    """Chain through parallel mirrors z=0 and z=2; symmetric endpoints
    (±2, 0, 1) give the analytic solution x1=(-1,0,0), x2=(1,0,2)."""
    t0 = _plane_tri(0.0)
    t1 = _plane_tri(2.0, flip=True)   # normal facing down
    ta = jnp.stack([t0[0], t1[0]])
    te1 = jnp.stack([t0[1], t1[1]])
    te2 = jnp.stack([t0[2], t1[2]])
    a = jnp.array([-2.0, 0.0, 1.0])
    b = jnp.array([2.0, 0.0, 1.0])
    uv0 = jnp.array([[0.3, 0.3], [0.5, 0.3]])
    uv, x, ok = manifold_walk(a, b, ta, te1, te2, uv0)
    assert bool(ok)
    assert np.allclose(np.asarray(x[0]), [-1, 0, 0], atol=1e-4)
    assert np.allclose(np.asarray(x[1]), [1, 0, 2], atol=1e-4)


def test_refraction_snell():
    """One refractive vertex on z=0 (air→glass, η=1.5): the walk's
    solution must satisfy Snell's law; cross-check the crossing point
    against an independent 1D bisection."""
    eta = 1.5
    a = np.array([-1.0, 0.0, 1.0])    # in air
    b = np.array([1.0, 0.0, -1.0])    # in glass

    def snell_residual(x0):
        s1 = (x0 - a[0]) / np.hypot(x0 - a[0], a[2])
        s2 = (b[0] - x0) / np.hypot(b[0] - x0, b[2])
        return s1 - eta * s2

    lo, hi = a[0], b[0]
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        if snell_residual(lo) * snell_residual(mid) <= 0:
            hi = mid
        else:
            lo = mid
    x_ref = 0.5 * (lo + hi)

    ta, te1, te2 = _plane_tri(0.0)
    uv, x, ok = manifold_walk(
        jnp.asarray(a), jnp.asarray(b), ta[None], te1[None], te2[None],
        jnp.array([[0.4, 0.4]]), eta=jnp.array([eta]))
    assert bool(ok)
    assert abs(float(x[0, 0]) - x_ref) < 1e-4
    assert abs(float(x[0, 1])) < 1e-5


def test_vmapped_chains_converge():
    """The walk vmaps over a wavefront of chains (the wavefront execution
    shape used by a manifold mutation stage)."""
    ta, te1, te2 = _plane_tri(0.0)
    n = 64
    key = jax.random.PRNGKey(0)
    ax = jax.random.uniform(key, (n,), minval=-1.2, maxval=-0.2)
    bx = jax.random.uniform(jax.random.fold_in(key, 1), (n,),
                            minval=0.2, maxval=1.2)
    a = jnp.stack([ax, jnp.zeros(n), jnp.ones(n)], -1)
    b = jnp.stack([bx, jnp.zeros(n), jnp.full((n,), 0.7)], -1)

    walk = jax.vmap(lambda aa, bb: manifold_walk(
        aa, bb, ta[None], te1[None], te2[None], jnp.array([[0.3, 0.3]])))
    uv, x, ok = jax.jit(walk)(a, b)
    assert bool(jnp.all(ok))
    # law of reflection at every solved vertex (normal = +z):
    # wo = (-wi_x, -wi_y, wi_z) for unit vectors wi, wo pointing away
    # from the vertex toward a and b
    wi = a - x[:, 0]
    wo = b - x[:, 0]
    wi = wi / jnp.linalg.norm(wi, axis=-1, keepdims=True)
    wo = wo / jnp.linalg.norm(wo, axis=-1, keepdims=True)
    assert np.allclose(np.asarray(wo[:, 0]), -np.asarray(wi[:, 0]),
                       atol=1e-4)
    assert np.allclose(np.asarray(wo[:, 1]), -np.asarray(wi[:, 1]),
                       atol=1e-4)
    assert np.allclose(np.asarray(wo[:, 2]), np.asarray(wi[:, 2]),
                       atol=1e-4)
