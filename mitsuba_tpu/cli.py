"""Command-line renderer — the `mitsuba` executable analog.

Mirrors the reference CLI's core flags (ref: src/mitsuba/mitsuba.cpp:55-86):
scene XML in, image out, -D parameter substitution, -o output, spp/depth
overrides, periodic partial-image flush (-r), and the statistics table at
exit. Run as `python -m mitsuba_tpu scene.xml [options]`.
"""
from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="mitsuba_tpu",
        description="Differentiable path tracer in JAX "
                    "(Mitsuba-compatible subset)")
    ap.add_argument("scene", nargs="+", help="scene .xml file(s); "
                    "several render back to back (mitsuba.cpp -j)")
    ap.add_argument("-o", "--output", default=None,
                    help="output image (exr/pfm/png/npy); default: "
                         "scene name + .exr")
    ap.add_argument("-D", action="append", default=[], metavar="key=value",
                    help="scene parameter substitution ($key in XML)")
    ap.add_argument("-s", "--spp", type=int, default=None,
                    help="override samples per pixel")
    ap.add_argument("-d", "--max-depth", type=int, default=None,
                    help="override path depth")
    ap.add_argument("-r", "--refresh", type=float, default=0.0,
                    help="write partial image every N seconds "
                         "(progressive passes)")
    ap.add_argument("-p", "--devices", type=int, default=0,
                    help="shard across first N devices (0 = single)")
    ap.add_argument("-x", "--skip-existing", action="store_true",
                    help="skip scenes whose output already exists "
                         "(mitsuba.cpp:78 -x)")
    ap.add_argument("-q", "--quiet", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from .util.compile_cache import setup_compile_cache
    setup_compile_cache()
    if args.output is not None and len(args.scene) > 1:
        ap.error("-o is only valid with a single scene")
    rc = 0
    for scene_path in args.scene:
        rc = max(rc, _render_one(args, scene_path))
    return rc


def _render_one(args, scene_path: str) -> int:
    import os

    import numpy as np

    from .io.image import write_image
    from .render import render
    from .scene.xml import load_xml
    from .util.stats import (ProgressReporter, counter_add, log,
                             print_stats)

    params = {}
    for kv in args.D:
        k, _, v = kv.partition("=")
        params[k] = v

    t0 = time.time()
    out = args.output or (scene_path.rsplit(".", 1)[0] + ".exr")
    if args.skip_existing and os.path.exists(out):
        log.info("Skipping %s: %s exists (-x)", scene_path, out)
        return 0
    log.info("Loading scene %s", scene_path)
    loaded = load_xml(scene_path, parameters=params)
    if args.max_depth is not None:
        loaded.integrator_config["max_depth"] = args.max_depth
    spp = args.spp if args.spp is not None else loaded.spp
    scene = loaded.compile()
    integ = loaded.make_integrator()
    if hasattr(integ, "specialized_for"):
        integ = integ.specialized_for(scene)
    import dataclasses
    if loaded.sampler != "independent" and hasattr(integ, "sampler"):
        integ = dataclasses.replace(integ, sampler=loaded.sampler, spp=spp)
    log.info("Scene compiled: %d triangles, %d emitters (%.2fs)",
             int((np.asarray(scene.tri_area) > 0).sum()),
             scene.n_emitters, time.time() - t0)

    # integrators with their own outer loop (PSSMLT chains, adaptive
    # sample control) render through the uniform render_full entry
    if hasattr(integ, "render_full"):
        t1 = time.time()
        img = np.asarray(integ.render_full(scene, loaded.camera,
                                           loaded.film, spp, args.seed))
        write_image(out, img)
        counter_add("Render time (s)", time.time() - t1)
        if not args.quiet:
            log.info("Wrote %s (%.2fs render)", out, time.time() - t1)
            print_stats()
        return 0

    mesh = None
    if args.devices > 1:
        import jax

        from .parallel.dist import make_mesh, replicate_scene
        mesh = make_mesh(jax.devices()[:args.devices])
        scene = replicate_scene(scene, mesh)
        log.info("Sharding over %d devices", mesh.devices.size)

    t1 = time.time()
    # progressive rendering: pass-sized chunks so -r can flush partials
    chunk = max(1, min(spp, 8)) if args.refresh > 0 else spp
    done = 0
    accum_img = None
    progress = ProgressReporter("Rendering", spp)
    last_flush = time.time()
    while done < spp:
        this = min(chunk, spp - done)
        if mesh is not None:
            from .parallel.dist import render_sharded
            img = np.asarray(render_sharded(
                scene, loaded.camera, loaded.film, integ, this,
                args.seed + done, mesh))
        elif hasattr(integ, "li_stats"):
            img, n_rays = render(scene, loaded.camera, loaded.film, integ,
                                 this, args.seed + done, stats=True)
            img = np.asarray(img)
            counter_add("Rays traced", int(n_rays))
        else:
            img = np.asarray(render(scene, loaded.camera, loaded.film,
                                    integ, this, args.seed + done))
        accum_img = img * this if accum_img is None \
            else accum_img + img * this
        done += this
        progress.update(done)
        if args.refresh > 0 and time.time() - last_flush > args.refresh:
            write_image(out, accum_img / done)
            last_flush = time.time()
    render_s = time.time() - t1
    final = accum_img / done
    if loaded.film.banner:
        from .io.image import stamp_banner
        final = stamp_banner(final)
    if out.lower().endswith(".exr"):
        # embed render metadata like the reference (renderjob.cpp:109)
        from .io.image import write_exr
        write_exr(out, final, annotations={
            "renderTime": float(render_s), "spp": int(spp),
            "generatedBy": "mitsuba_tpu"},
            compression=loaded.film.compression,
            pixel_type="half"
            if loaded.film.component_format == "float16" else "float")
    else:
        write_image(out, final)
    counter_add("Render time (s)", render_s)
    counter_add("Samples per pixel", spp)
    counter_add("Pixels", loaded.film.width * loaded.film.height)
    if not args.quiet:
        log.info("Wrote %s (%.2fs render)", out, render_s)
        print_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
