"""Trace kernel (accel/pallas_trace.py) in interpret mode against the XLA
intersector (accel/dense.py): closest- and any-hit, ragged ray counts,
all-dead blocks, multi-cluster soups; the gradient rule; the platform's
choice of intersector; the compile-cache location; chip_smoke's device
check. The compiled kernel itself runs only on a GPU (`gpu` marker)."""
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mitsuba_tpu.accel import pallas_trace as pt
from mitsuba_tpu.accel.dense import ray_intersect, ray_test
from mitsuba_tpu.integrator import path as path_mod
from mitsuba_tpu.integrator.path import PathTracer
from mitsuba_tpu.scene.builder import SceneDesc, compile_scene
from mitsuba_tpu.scene.presets import cornell_box, cornell_camera
from mitsuba_tpu.scene.shapes import Mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@functools.lru_cache(maxsize=None)
def _scene(kind):
    if kind == "cornell":
        return compile_scene(cornell_box())
    # random soup of 300 small triangles in a unit cube: several kernel
    # clusters, Morton-ordered by the builder
    rng = np.random.default_rng(7)
    c = rng.uniform(0.0, 1.0, (300, 1, 3))
    v = (c + rng.normal(0.0, 0.08, (300, 3, 3))).reshape(-1, 3)
    d = SceneDesc()
    d.add_shape(Mesh(v, np.arange(900).reshape(300, 3)))
    return compile_scene(d, cluster_size=64)


def _rays(kind, n, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "cornell":
        cam = cornell_camera(width=32, height=32)
        pix = rng.uniform(0.0, 32.0, (n, 2)).astype(np.float32)
        o, d = cam.sample_ray(jnp.asarray(pix))
        return o, d
    o = rng.uniform(-0.5, 1.5, (n, 3))
    d = rng.uniform(0.0, 1.0, (n, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32)


CASES = {
    # name: (scene, ray count, dead lanes)
    "cornell_ragged_1": ("cornell", 1, None),
    "cornell_ragged_77": ("cornell", 77, None),
    "soup_ragged_300": ("soup", 300, None),
    # lanes 0..255 (two whole blocks) dead plus every third lane
    "soup_dead_blocks": ("soup", 400,
                         lambda i: (i < 2 * pt.TRACE_BLOCK) | (i % 3 == 0)),
}


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_dense(case, any_hit):
    kind, n, dead_fn = CASES[case]
    scene = _scene(kind)
    o, d = _rays(kind, n)
    mint = jnp.full((n,), 1e-4)
    # shadow segments end inside the scene: some blocked, some free
    seg = 2.6 if kind == "cornell" else 0.9
    maxt = jnp.full((n,), seg if any_hit else jnp.inf)
    live = None if dead_fn is None else ~dead_fn(np.arange(n))
    if any_hit:
        got = np.asarray(pt.kernel_occluded(scene, o, d, mint, maxt,
                                            live=live, interpret=True))
        ref = np.asarray(ray_test(scene, o, d, mint, maxt))
    else:
        its = pt.kernel_intersect(scene, o, d, mint, live=live,
                                  interpret=True)
        got = np.asarray(its.valid)
        ref_its = ray_intersect(scene, o, d, mint=mint)
        ref = np.asarray(ref_its.valid)
    if live is not None:
        assert not got[~live].any(), "dead lanes must report a miss"
        got, ref = got[live], ref[live]
    if n >= 64:
        assert ref.any()
        if any_hit or kind == "soup":
            assert not ref.all()
    np.testing.assert_array_equal(got, ref)
    if not any_hit:
        keep = np.ones(n, bool) if live is None else live
        v = np.asarray(its.valid) & keep
        np.testing.assert_allclose(np.asarray(its.t)[v],
                                   np.asarray(ref_its.t)[v], rtol=1e-5)
        np.testing.assert_allclose(np.asarray(its.p)[v],
                                   np.asarray(ref_its.p)[v], atol=1e-5)


def test_trace_tables_layout():
    """Woop rows and boxes cover exactly the real triangles; padding
    columns can never hit (d'_z = 0)."""
    scene = _scene("soup")
    woop, box = np.asarray(scene.trace_woop), np.asarray(scene.trace_box)
    assert woop.shape == (12, box.shape[1] * pt.TRACE_TC)
    assert box.shape[1] == -(-300 // pt.TRACE_TC)
    wo = np.asarray(scene.woop_o).reshape(4, -1, 3)[:, :300]
    np.testing.assert_array_equal(
        woop[:, :300], wo.transpose(2, 0, 1).reshape(12, 300))
    pad = woop[:, 300:]
    assert not pad[8:11].any() and (pad[11] == 1.0).all()


def test_gradient_rule():
    """AD through the kernel path lands where AD through dense.py does:
    same gradients w.r.t. ray origins, directions and both Woop tables."""
    scene = _scene("soup")
    o, d = _rays("soup", 96, seed=3)
    mint = jnp.full((96,), 1e-4)
    w = jnp.asarray(np.random.default_rng(1).normal(size=(96, 3)),
                    jnp.float32)

    def loss(trace, o, d, wo, wd):
        its = trace(scene._replace(woop_o=wo, woop_d=wd), o, d, mint)
        t = jnp.where(its.valid, its.t, 0.0)
        return (jnp.sum(t * w[:, 0]) + jnp.sum(its.p * w)
                + jnp.sum(its.uv * w[:, 1:]) + jnp.sum(its.ns * w))

    kern = lambda sc, o, d, m: pt.kernel_intersect(sc, o, d, m,
                                                   interpret=True)
    dense = lambda sc, o, d, m: ray_intersect(sc, o, d, mint=m)
    args = (o, d, scene.woop_o, scene.woop_d)
    g_k = jax.grad(functools.partial(loss, kern), argnums=(0, 1, 2, 3))(*args)
    g_d = jax.grad(functools.partial(loss, dense), argnums=(0, 1, 2, 3))(
        *args)
    for a, b in zip(g_k, g_d):
        a, b = np.asarray(a), np.asarray(b)
        assert np.isfinite(a).all() and np.abs(b).max() > 0
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=1e-5 * np.abs(b).max())


@pytest.mark.parametrize("sort", [False, True], ids=["partition", "sorted"])
def test_path_tracer_kernel_path_matches_dense(monkeypatch, sort):
    """PathTracer on the kernel path (compaction on, with and without the
    coherence sort; kernel in interpret mode) gives the dense path's
    radiance and albedo gradients."""
    scene = compile_scene(cornell_box())
    monkeypatch.setattr(path_mod, "SORT_MIN_CLUSTERS",
                        1 if sort else scene.trace_box.shape[1] + 1)
    cam = cornell_camera(width=8, height=8)
    px = jnp.arange(64, dtype=jnp.uint32)
    pix = jnp.stack([(px % 8).astype(jnp.float32) + 0.5,
                     (px // 8).astype(jnp.float32) + 0.5], -1)
    o, d = cam.sample_ray(pix)
    integ = PathTracer(max_depth=4).specialized_for(scene)

    def run(mat):
        sc = scene._replace(mat_params=mat)
        return integ.li(sc, o, d, jnp.uint32(5), px, 0)

    def both():
        fn = lambda m: jnp.mean(run(m))
        return (np.asarray(run(scene.mat_params)),
                np.asarray(jax.grad(fn)(scene.mat_params)))

    l_dense, g_dense = both()
    monkeypatch.setattr(path_mod, "trace_path", lambda p=None: "kernel")
    monkeypatch.setattr(pt, "kernel_intersect", functools.partial(
        pt.kernel_intersect, interpret=True))
    monkeypatch.setattr(pt, "kernel_occluded", functools.partial(
        pt.kernel_occluded, interpret=True))
    l_kern, g_kern = both()
    assert l_dense.mean() > 0
    np.testing.assert_allclose(l_kern, l_dense, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(g_kern, g_dense, rtol=1e-3,
                               atol=1e-6 * np.abs(g_dense).max())


@pytest.mark.parametrize("platform,expect", [("gpu", "kernel"),
                                             ("cpu", "dense")])
def test_trace_path_by_platform(platform, expect):
    assert path_mod.trace_path(platform) == expect


def test_trace_path_rejects_other_platforms():
    with pytest.raises(ValueError, match="no intersector"):
        path_mod.trace_path("rocm")


def test_trace_path_default_is_backend():
    assert path_mod.trace_path() == "dense"      # the suite runs on CPU


@pytest.mark.parametrize("env_set", [False, True], ids=["default", "env"])
def test_compile_cache_dir(monkeypatch, tmp_path, env_set):
    from mitsuba_tpu.util import compile_cache as cc
    seen = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: seen.__setitem__(k, v))
    if env_set:
        monkeypatch.setenv(cc.ENV_VAR, str(tmp_path))
        assert cc.setup_compile_cache() == str(tmp_path)
        assert seen == {}, "JAX reads the variable itself"
    else:
        monkeypatch.delenv(cc.ENV_VAR, raising=False)
        path = cc.setup_compile_cache()
        assert path == os.path.join(REPO, ".jax_cache")
        assert seen == {"jax_compilation_cache_dir": path}
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_chip_smoke_fails_without_gpu():
    """On the CPU chip_smoke stops at its device check: non-zero exit,
    and no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "gpu" in (r.stdout + r.stderr).lower()


@pytest.mark.gpu
def test_kernel_compiled_matches_dense(gpu):
    """The compiled Triton kernel on the card against dense.py at
    HIGHEST precision, closest- and any-hit, on Cornell."""
    hp = jax.lax.Precision.HIGHEST
    scene = _scene("cornell")
    n = 1 << 14
    o, d = _rays("cornell", n, seed=2)
    mint = jnp.full((n,), 1e-4)
    a = jax.jit(lambda o, d: pt.kernel_intersect(scene, o, d, mint))(o, d)
    b = ray_intersect(scene, o, d, mint=mint, precision=hp)
    assert (np.asarray(a.valid) != np.asarray(b.valid)).mean() < 1e-3
    v = np.asarray(a.valid & b.valid)
    np.testing.assert_allclose(np.asarray(a.t)[v], np.asarray(b.t)[v],
                               rtol=1e-5)
    maxt = jnp.full((n,), 0.8)
    occ = pt.kernel_occluded(scene, o, d, mint, maxt)
    ref = ray_test(scene, o, d, mint, maxt, precision=hp)
    assert (np.asarray(occ) != np.asarray(ref)).mean() < 1e-3
