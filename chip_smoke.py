"""On-card smoke test of the renderer's main path on one NVIDIA GPU.

    python3 chip_smoke.py              # phases 1-7 on one card
    python3 chip_smoke.py --cards 4    # sharded render + gradient on 4 cards

Everything runs in this one process (a JAX process reserves most of the
card's memory). Phases:

  1. device: JAX's first device is a GPU; the card's name and power limit
  2. flagship frame: Cornell 512², PathTracer(max_depth=8), 64 spp through
     render() — compile and render seconds, rays/s from the exact
     li_stats count, peak device memory, mean radiance in its band
  3. plain reference: 48², 8 spp, depth 8 against the matched-seed numpy
     oracle (tests/oracle/render.py) at the tolerances of test_render.py
  4. CLI: scenes/cornell.xml and scenes/volumetric.xml to EXR in-process
  5. PRB: li_and_grad at 256² against jax.grad through PathTracer
  6. trace kernel: closest- and any-hit at 2^18 rays on Cornell and on a
     100k-triangle noise terrain against dense.py at HIGHEST precision,
     with both timings
  7. determinism: the same seed rendered twice, bit-identical or not

Any failure raises, so the exit code is non-zero and no result line is
printed. The last line of a passing run is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))


def log(msg: str) -> None:
    print(msg, flush=True)


def card_info() -> str:
    """name, power.limit of every card, from nvidia-smi (no JAX)."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip()


def check_device(n_cards: int):
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke needs a GPU; JAX found "
                         f"{devs[0].platform!r} ({devs[0].device_kind})")
    if len(devs) < n_cards:
        raise SystemExit(f"need {n_cards} GPUs, JAX found {len(devs)}")
    return devs


def timed(fn, *args, reps: int = 3):
    """(first-call seconds, best later-call seconds, last result)."""
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return first, best, out


def phase_flagship(card: str, width: int = 512, spp: int = 64):
    import jax
    import numpy as np

    from mitsuba_tpu.film.film import Film
    from mitsuba_tpu.integrator.path import PathTracer
    from mitsuba_tpu.render import render
    from mitsuba_tpu.scene.builder import compile_scene
    from mitsuba_tpu.scene.presets import cornell_box, cornell_camera

    scene = compile_scene(cornell_box())
    cam = cornell_camera(width=width, height=width)
    film = Film(width=width, height=width, filter_name="box")
    integ = PathTracer(max_depth=8).specialized_for(scene)
    frame = lambda seed: render(scene, cam, film, integ, spp, seed,
                                stats=True)
    first, best, (img, n_rays) = timed(frame, 0, reps=2)
    img = np.asarray(img)
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    mean = float(img.mean())
    log(f"[flagship] cornell {width}x{width} spp={spp} depth=8: "
        f"compile+first {first:.3f} s, compile ~{first - best:.3f} s, "
        f"render {best:.4f} s")
    log(f"[flagship] rays traced {n_rays} -> {n_rays / best:.6e} rays/s "
        f"on {card}")
    log(f"[flagship] peak_bytes_in_use {peak}, mean radiance {mean:.5f}")
    assert img.shape == (width, width, 3) and np.isfinite(img).all()
    assert 0.2 < mean < 0.3, mean
    return img


def phase_oracle():
    import numpy as np

    from mitsuba_tpu.film.film import Film
    from mitsuba_tpu.integrator.path import PathTracer
    from mitsuba_tpu.render import render
    from mitsuba_tpu.scene.builder import compile_scene
    from mitsuba_tpu.scene.presets import cornell_box, cornell_camera
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from oracle.render import render_oracle

    scene = compile_scene(cornell_box())
    cam = cornell_camera(width=48, height=48)
    film = Film(width=48, height=48, filter_name="box")
    img = np.asarray(render(scene, cam, film, PathTracer(max_depth=8),
                            spp=8, seed=3))
    ref = render_oracle(scene, cam, 48, 48, spp=8, seed=3, max_depth=8)
    rel = np.abs(img - ref) / np.maximum(ref, 1e-3)
    frac_bad = float((rel > 5e-2).mean())
    mean_rel = float(abs(img.mean() - ref.mean()) / ref.mean())
    log(f"[oracle] 48x48 spp=8 depth=8: boundary-pixel fraction "
        f"{frac_bad:.5f} (< 1e-2), mean rel diff {mean_rel:.2e} (< 5e-3)")
    assert frac_bad < 1e-2 and mean_rel < 5e-3, (frac_bad, mean_rel)


def phase_cli(tmp: str):
    import numpy as np

    from mitsuba_tpu import cli
    from mitsuba_tpu.io.image import read_exr

    for name in ("cornell", "volumetric"):
        out = os.path.join(tmp, f"{name}.exr")
        t0 = time.perf_counter()
        rc = cli.main([os.path.join(REPO, "scenes", f"{name}.xml"),
                       "-o", out, "-q"])
        secs = time.perf_counter() - t0
        img = read_exr(out)
        log(f"[cli] {name}.xml -> {img.shape} rc={rc} in {secs:.2f} s, "
            f"mean {float(img.mean()):.5f}")
        assert rc == 0 and np.isfinite(img).all() and img.mean() > 1e-3


def phase_prb(width: int = 256, max_depth: int = 3):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from mitsuba_tpu.integrator.path import PathTracer
    from mitsuba_tpu.integrator.prb import PRBPathTracer
    from mitsuba_tpu.scene.builder import compile_scene
    from mitsuba_tpu.scene.presets import cornell_box, cornell_camera

    scene = compile_scene(cornell_box())
    cam = cornell_camera(width=width, height=width)
    n = width * width
    px = jnp.arange(n, dtype=jnp.uint32)
    pix = jnp.stack([(px % width).astype(jnp.float32) + 0.5,
                     (px // width).astype(jnp.float32) + 0.5], -1)
    o, d = cam.sample_ray(pix)
    seed = jnp.uint32(0)
    prb = PRBPathTracer(max_depth=max_depth).specialized_for(scene)
    dL = jnp.full((n, 3), 1.0 / (n * 3))
    t0 = time.perf_counter()
    L, grads = jax.block_until_ready(jax.jit(
        lambda: prb.li_and_grad(scene, o, d, seed, px, 0, dL))())
    t_prb = time.perf_counter() - t0
    integ = PathTracer(max_depth=max_depth).specialized_for(scene)

    def loss(mat, em):
        sc = scene._replace(mat_params=mat, em_radiance=em)
        return jnp.mean(integ.li(sc, o, d, seed, px, 0))

    t0 = time.perf_counter()
    g_mat, g_em = jax.block_until_ready(jax.jit(jax.grad(
        loss, argnums=(0, 1)))(scene.mat_params, scene.em_radiance))
    t_ad = time.perf_counter() - t0
    L_ref = np.asarray(jax.jit(integ.li)(scene, o, d, seed, px, 0))
    gm_prb = np.asarray(grads["mat_params"])[:, 0:3]
    gm_ad = np.asarray(g_mat)[:, 0:3]
    ge_prb, ge_ad = np.asarray(grads["em_radiance"]), np.asarray(g_em)
    log(f"[prb] {width}x{width} depth={max_depth}: li_and_grad "
        f"{t_prb:.2f} s, jax.grad {t_ad:.2f} s (both incl. compile); "
        f"max |dmat| prb {np.abs(gm_prb).max():.4e} ad "
        f"{np.abs(gm_ad).max():.4e}, |dem| prb {np.abs(ge_prb).max():.4e} "
        f"ad {np.abs(ge_ad).max():.4e}")
    assert np.isfinite(gm_prb).all() and np.isfinite(ge_prb).all()
    np.testing.assert_allclose(np.asarray(L), L_ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gm_prb, gm_ad, rtol=2e-2,
                               atol=2e-4 * max(abs(gm_ad).max(), 1))
    np.testing.assert_allclose(ge_prb, ge_ad, rtol=2e-2,
                               atol=2e-4 * max(abs(ge_ad).max(), 1))


def trace_workload(kind: str, n_side: int = 512, seed: int = 0):
    """(scene, o, d, shadow_o, shadow_d, shadow_maxt): n_side² camera
    rays in pixel order, and shadow segments from their dense.py hit
    points to random points on the light (camera rays that miss keep a
    free segment)."""
    import jax.numpy as jnp
    import numpy as np

    from mitsuba_tpu.accel.dense import ray_intersect
    from mitsuba_tpu.integrator.common import offset_ray_origin
    from mitsuba_tpu.scene.builder import compile_scene
    from mitsuba_tpu.scene import presets

    if kind == "cornell":
        scene = compile_scene(presets.cornell_box())
        cam = presets.cornell_camera(width=n_side, height=n_side)
        lo, hi = np.array([0.37, 0.9, 0.35]), np.array([0.63, 0.99, 0.62])
    else:
        scene = compile_scene(presets.noise_terrain(seed=seed))
        cam = presets.terrain_camera(width=n_side, height=n_side)
        lo, hi = np.array([-0.3, -0.3, 1.4]), np.array([0.3, 0.3, 1.5])
    n = n_side * n_side
    rng = np.random.default_rng(seed)
    # jittered pixel grid in row-major order, as render() emits it
    px = np.arange(n)
    pix = np.stack([px % n_side, px // n_side], -1) + rng.uniform(
        0.0, 1.0, (n, 2))
    o, d = cam.sample_ray(jnp.asarray(pix, jnp.float32))
    its = ray_intersect(scene, o, d, mint=jnp.full((n,), 1e-4))
    p = jnp.where(its.valid[:, None], its.p, o + d)
    target = jnp.asarray(rng.uniform(lo, hi, (n, 3)), jnp.float32)
    sd = target - p
    dist = jnp.linalg.norm(sd, axis=-1)
    sd = sd / dist[:, None]
    so = offset_ray_origin(p, jnp.where(its.valid[:, None], its.ng, -sd),
                           sd)
    return scene, o, d, so, sd, dist * (1.0 - 1e-3)


def phase_trace(card: str, n_side: int = 512):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from mitsuba_tpu.accel.dense import ray_intersect, ray_test
    from mitsuba_tpu.accel.pallas_trace import (kernel_intersect,
                                                kernel_occluded)

    hp = jax.lax.Precision.HIGHEST
    for kind in ("cornell", "terrain"):
        scene, o, d, so, sd, smax = trace_workload(kind, n_side)
        n = o.shape[0]
        mint = jnp.full((n,), 1e-4)
        smin = jnp.full((n,), 1e-4)
        k_hit = jax.jit(lambda o, d: kernel_intersect(scene, o, d, mint))
        x_hit = jax.jit(lambda o, d: ray_intersect(scene, o, d, mint=mint,
                                                   precision=hp))
        k_occ = jax.jit(lambda o, d: kernel_occluded(scene, o, d, smin,
                                                     smax))
        x_occ = jax.jit(lambda o, d: ray_test(scene, o, d, smin, smax,
                                              precision=hp))
        kc, kt, a = timed(k_hit, o, d)
        xc, xt, b = timed(x_hit, o, d)
        kc2, kt2, occ_k = timed(k_occ, so, sd)
        xc2, xt2, occ_x = timed(x_occ, so, sd)
        va, vb = np.asarray(a.valid), np.asarray(b.valid)
        ia, ib = np.asarray(a.tri_id), np.asarray(b.tri_id)
        # where both sides chose the same triangle, t must agree to 1e-5
        same = va & vb & (ia == ib)
        ta, tb = np.asarray(a.t)[same], np.asarray(b.t)[same]
        t_rel = np.abs(ta - tb) / np.abs(tb)
        # elsewhere (one side misses, or the two chose different
        # triangles) the ray must graze an edge: f32 rounding decides
        # hit or miss only there
        tie = np.nonzero((va != vb) | (va & vb & (ia != ib)))[0]
        margin = nearest_hit_edge_margin(scene, o, d, tie, ia, va, ib, vb)
        frac = tie.size / n
        bad_occ = float((np.asarray(occ_k) != np.asarray(occ_x)).mean())
        n_real = int((np.asarray(scene.tri_area) > 0).sum())
        log(f"[trace] {kind} ({n_real} tris, {n} rays) closest-hit: "
            f"kernel {kt * 1e3:.3f} ms, dense {xt * 1e3:.3f} ms "
            f"(compile+first {kc:.2f} / {xc:.2f} s); hit share "
            f"{va.mean():.4f}; same triangle on {int(same.sum())} lanes, "
            f"max t rel diff {t_rel.max() if t_rel.size else 0.0:.2e}; "
            f"{tie.size} edge-tie lanes ({frac:.2e}), edge margin of "
            f"their nearest hit {margin.max() if margin.size else 0.0:.2e}")
        log(f"[trace] {kind} any-hit: kernel {kt2 * 1e3:.3f} ms, dense "
            f"{xt2 * 1e3:.3f} ms; occluded share "
            f"{np.asarray(occ_x).mean():.4f}, mismatch {bad_occ:.2e} "
            f"on {card}")
        assert same.sum() > 0.4 * n and t_rel.max() < 1e-5, t_rel.max()
        assert frac < 1e-4 and bad_occ < 1e-4, (frac, bad_occ)
        assert (margin < 1e-4).all(), ("a mismatch away from any edge",
                                       tie[margin >= 1e-4])


def nearest_hit_edge_margin(scene, o, d, lanes, ia, va, ib, vb):
    """For each lane, |min(u, v, 1-u-v)| in float64 of the nearer of the
    two sides' hits (the only hit if one side missed): how far the ray
    passes from an edge of the first surface it meets."""
    import numpy as np

    o = np.asarray(o, np.float64)[lanes]
    d = np.asarray(d, np.float64)[lanes]
    p0, e1, e2 = (np.asarray(x, np.float64)
                  for x in (scene.p0, scene.e1, scene.e2))

    def hit(tri):
        # Moller-Trumbore: t and barycentric edge margin per lane
        a, b, c = p0[tri], e1[tri], e2[tri]
        pv = np.cross(d, c)
        det = (b * pv).sum(-1)
        tv = o - a
        u = (tv * pv).sum(-1) / det
        qv = np.cross(tv, b)
        v = (d * qv).sum(-1) / det
        t = (c * qv).sum(-1) / det
        return t, np.abs(np.minimum(np.minimum(u, v), 1.0 - u - v))

    ta, ma = hit(ia[lanes])
    tb, mb = hit(ib[lanes])
    ta = np.where(va[lanes], ta, np.inf)
    tb = np.where(vb[lanes], tb, np.inf)
    return np.where(ta <= tb, ma, mb)


def phase_determinism(width: int = 256, spp: int = 16):
    import numpy as np

    from mitsuba_tpu.film.film import Film
    from mitsuba_tpu.integrator.path import PathTracer
    from mitsuba_tpu.render import render
    from mitsuba_tpu.scene.builder import compile_scene
    from mitsuba_tpu.scene.presets import cornell_box, cornell_camera

    scene = compile_scene(cornell_box())
    cam = cornell_camera(width=width, height=width)
    film = Film(width=width, height=width, filter_name="gaussian")
    integ = PathTracer(max_depth=8).specialized_for(scene)
    a = np.asarray(render(scene, cam, film, integ, spp, 11))
    b = np.asarray(render(scene, cam, film, integ, spp, 11))
    same = bool((a == b).all())
    log(f"[determinism] {width}x{width} spp={spp} gaussian film, seed 11 "
        f"twice: bit-identical={same}, max abs diff "
        f"{float(np.abs(a - b).max()):.3e}")
    assert np.isfinite(a).all() and np.abs(a - b).max() < 1e-4


def phase_cards(n_cards: int, w: int = 512, spp: int = 64):
    """render_sharded and render_grad_sharded over n_cards against the
    single-card result of the same frame and seed (by default the
    flagship frame, so each card's share is a full-width wavefront)."""
    import jax
    import numpy as np

    from mitsuba_tpu.film.film import Film
    from mitsuba_tpu.integrator.path import PathTracer
    from mitsuba_tpu.parallel.dist import (make_mesh, render_grad_sharded,
                                           render_sharded, replicate_scene)
    from mitsuba_tpu.render import render
    from mitsuba_tpu.scene.builder import compile_scene
    from mitsuba_tpu.scene.presets import cornell_box, cornell_camera

    devs = jax.devices()[:n_cards]
    mem = lambda key: [(d.memory_stats() or {}).get(key, 0) for d in devs]
    scene = compile_scene(cornell_box())
    integ = PathTracer(max_depth=8).specialized_for(scene)
    mesh = make_mesh(devs)
    sc_n = replicate_scene(scene, mesh)

    cam = cornell_camera(width=w, height=w)
    film = Film(width=w, height=w, filter_name="box")
    wg, sppg = 64, 2
    cam_g = cornell_camera(width=wg, height=wg)
    film_g = Film(width=wg, height=wg, filter_name="box")
    grad = lambda m, sc: render_grad_sharded(sc, cam_g, film_g, integ,
                                             sppg, 5, m)
    t0 = time.perf_counter()
    many = jax.jit(lambda sc: render_sharded(
        sc, cam, film, integ, spp, 5, mesh)).lower(sc_n).compile()
    grad_n = jax.jit(lambda sc: grad(mesh, sc)).lower(sc_n).compile()
    work = many.memory_analysis().temp_size_in_bytes
    before = mem("peak_bytes_in_use")
    log(f"[cards] sharded render + gradient compiled in "
        f"{time.perf_counter() - t0:.1f} s; per-card render working set "
        f"{work} B; peak_bytes_in_use per card before any run {before}")
    _, tn, imgn = timed(many, sc_n, reps=2)
    loss_n, g_n = jax.block_until_ready(grad_n(sc_n))
    after = mem("peak_bytes_in_use")
    log(f"[cards] after the sharded runs: peak_bytes_in_use per card "
        f"{after}, bytes_in_use {mem('bytes_in_use')}")
    # every card allocated the render's working set: each ran its share
    # (peaks are monotone, so card 0's may still be its compile-time one)
    assert min(after) >= work > 0, (after, work)

    _, t1, img1 = timed(lambda: render(scene, cam, film, integ, spp, 5),
                        reps=2)
    img1, imgn = np.asarray(img1), np.asarray(imgn)
    err = float(np.abs(imgn - img1).max() / np.abs(img1).max())
    log(f"[cards] render_sharded {w}x{w} spp={spp} over {n_cards} cards "
        f"{tn:.4f} s vs render() on one card {t1:.4f} s "
        f"({t1 / tn:.2f}x); max rel diff {err:.2e}")
    assert np.isfinite(imgn).all() and err < 1e-4, err

    mesh1 = make_mesh(devs[:1])
    sc_1 = replicate_scene(scene, mesh1)
    loss_1, g_1 = jax.block_until_ready(
        jax.jit(lambda sc: grad(mesh1, sc))(sc_1))
    for k in g_1:
        a, b = np.asarray(g_n[k]), np.asarray(g_1[k])
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, b, rtol=1e-3,
                                   atol=1e-5 * max(np.abs(b).max(), 1e-9))
    log(f"[cards] render_grad_sharded {wg}x{wg} spp={sppg}: loss "
        f"{float(loss_n):.6f} vs one card {float(loss_1):.6f}; gradients "
        f"agree (rtol 1e-3)")
    assert abs(float(loss_n) - float(loss_1)) <= 1e-5 * abs(float(loss_1))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run only the sharded render/gradient phase")
    args = ap.parse_args(argv)

    devs = check_device(args.cards)
    sys.path.insert(0, REPO)
    from mitsuba_tpu.util.compile_cache import setup_compile_cache
    log(f"[device] {devs[0].platform} {devs[0].device_kind} x{len(devs)}; "
        f"compile cache {setup_compile_cache()}")
    card = card_info()
    log(f"[device] nvidia-smi name, power.limit: {card}")
    card = card.splitlines()[0]

    t_start = time.perf_counter()
    if args.cards > 1:
        phase_cards(args.cards)
    else:
        phase_flagship(card)
        phase_oracle()
        with tempfile.TemporaryDirectory() as tmp:
            phase_cli(tmp)
        phase_prb()
        phase_trace(card)
        phase_determinism()
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
