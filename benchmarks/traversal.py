"""Ray-scene queries at real size: the traversal engines against each other
and against the brute-force oracle.

Four wavefronts over one scene (hall by default), all from the preset
camera at res x res:

  primary_closest   camera rays
  primary_shadow    any-hit from the primary hits to the first light
  bounce_closest    one diffuse bounce off the primary hits (dead lanes,
                    where the primary ray missed, carry tmax = -1 as in
                    integrate/path.py)
  bounce_shadow     any-hit from the bounce hits to the first light

Each engine's time per query is the median over --reps runs of one jitted
call, after a compile-and-warm call. --frame adds the end-to-end number:
ms per 1-spp frame of the scene at res x res and --bounces through
render_sample, with every intersection routed to that engine. --check compares every engine with
brute.py: closest-hit tri_id must agree on >= 99.9% of rays and t within
1e-4 relative where it does; any-hit booleans on >= 99.9%. The residue is
float order: an edge shared by two triangles can go to either.

    python benchmarks/traversal.py [--scene hall] [--res 256] [--reps 5]
        [--engines bvh_kernel,bvh] [--check] [--frame] [--bounces 2]

Prints one JSON line per measurement, each naming the device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

ID_AGREE = 0.999
T_RTOL = 1e-4


def make_queries(scene, camera, res, seed=0, method="bvh"):
    """{name: (o, d, tmin, tmax, any_hit)} for the four wavefronts. The
    secondary rays start from hits found by `method`."""
    import jax
    import jax.numpy as jnp
    from optixpathtracer_tpu.camera.camera import generate_rays
    from optixpathtracer_tpu.core.math import cross, normalize
    from optixpathtracer_tpu.intersect import intersect_closest

    pos, iv, ip = camera.raygen_params(res, res)
    o, d = generate_rays(pos, iv, ip, res, res)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    r = o.shape[0]
    light = scene.light_pos[0]

    def shadow(o, d, hit):
        n = normalize(cross(scene.tri_e1[jnp.maximum(hit.tri_id, 0)],
                            scene.tri_e2[jnp.maximum(hit.tri_id, 0)]))
        n = jnp.where((jnp.sum(n * d, -1) > 0)[:, None], -n, n)
        p = o + hit.t[:, None] * d + 1e-3 * n
        to_l = light - p
        dist = jnp.linalg.norm(to_l, axis=-1)
        return p, n, to_l / dist[:, None], jnp.where(hit.hit, dist, -1.0)

    closest = jax.jit(lambda o, d, tmax: intersect_closest(
        scene, o, d, 0.0, tmax, method=method))
    tmax0 = jnp.full((r,), 100.0, jnp.float32)
    h0 = closest(o, d, tmax0)
    p0, n0, l0, s0 = shadow(o, d, h0)

    # cosine-ish diffuse bounce: normal + a random unit vector
    rnd = jax.random.normal(jax.random.PRNGKey(seed), (r, 3), jnp.float32)
    d1 = normalize(n0 + normalize(rnd))
    tmax1 = jnp.where(h0.hit, 100.0, -1.0)
    h1 = closest(p0, d1, tmax1)
    p1, _, l1, s1 = shadow(p0, d1, h1)
    s1 = jnp.where(h0.hit, s1, -1.0)
    return {
        "primary_closest": (o, d, 0.0, tmax0, False),
        "primary_shadow": (p0, l0, 0.0, s0, True),
        "bounce_closest": (p0, d1, 0.0, tmax1, False),
        "bounce_shadow": (p1, l1, 0.0, s1, True),
    }


def load_preset(name: str):
    """A preset, or "material_test:<kind>:<n_theta>,<n_phi>" for the
    material-test scene at another sphere tessellation (e.g. 4,9 gives
    1,954 triangles, just under the brute-force limit of 2,048)."""
    from optixpathtracer_tpu.scene.procedural import (PRESETS,
                                                      scene_material_test)
    if name.startswith("material_test:"):
        _, kind, seg = name.split(":")
        return scene_material_test(kind, segments=tuple(
            int(x) for x in seg.split(",")))
    return PRESETS[name]()


def query_fn(scene, engine: str, any_hit: bool):
    """A jitted (o, d, tmin, tmax) -> result for one engine."""
    import jax
    from optixpathtracer_tpu.intersect import api
    mod = api._engine(engine)
    if any_hit:
        return jax.jit(lambda o, d, lo, hi: mod.intersect_any(
            scene, o, d, lo, hi))
    return jax.jit(lambda o, d, lo, hi: mod.intersect_closest(
        scene, o, d, lo, hi)[:2])


def compare(got, ref, any_hit: bool) -> dict:
    """Agreement of one engine's answer with brute's."""
    if any_hit:
        agree = float(np.mean(np.asarray(got) == np.asarray(ref)))
        return {"agree": agree, "ok": agree >= ID_AGREE}
    t, tid = np.asarray(got[0]), np.asarray(got[1])
    rt, rid = np.asarray(ref[0]), np.asarray(ref[1])
    same = tid == rid
    hit = same & (rid >= 0)
    rel = (np.abs(t[hit] - rt[hit]) / np.maximum(np.abs(rt[hit]), 1e-6)
           if hit.any() else np.zeros(1))
    agree = float(same.mean())
    return {"agree": agree, "t_rel_max": float(rel.max()),
            "ok": agree >= ID_AGREE and float(rel.max()) <= T_RTOL}


def timed(fn, args, reps):
    """(compile+first-run seconds, median ms over reps, result)."""
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        times.append((time.perf_counter() - t0) * 1e3)
    return first, float(np.median(times)), out


def frame_fn(scene, camera, res, bounces, engine):
    """A jitted frame_id -> [res, res, 3] 1-spp render through `engine`."""
    import jax
    from optixpathtracer_tpu.integrate.cutout import scene_uses_alpha_cutout
    from optixpathtracer_tpu.integrate.path import render_sample
    from optixpathtracer_tpu.scene.flatten import (scene_active_lobes,
        scene_flat_shading, scene_uses_textures)
    pos, iv, ip = camera.raygen_params(res, res)
    kw = dict(active_lobes=scene_active_lobes(scene),
              use_textures=scene_uses_textures(scene),
              use_alpha_cutout=scene_uses_alpha_cutout(scene),
              flat_shading=scene_flat_shading(scene))
    return jax.jit(lambda s: render_sample(
        scene, pos, iv, ip, res, res, s, bounces, engine, **kw))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="hall")
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--engines", default="bvh_kernel,bvh")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--frame", action="store_true")
    ap.add_argument("--bounces", type=int, default=2)
    args = ap.parse_args(argv)

    import jax
    from optixpathtracer_tpu.runtime import (card_info, enable_compile_cache,
                                             require_gpu, set_xla_flags)
    from optixpathtracer_tpu.scene import flatten_model

    set_xla_flags()
    enable_compile_cache()
    dev = require_gpu()
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices()), "card": card_info()}
    model, camera, lights = load_preset(args.scene)
    scene = flatten_model(model, lights)
    device["triangles"] = int(scene.tri_valid.sum())
    queries = make_queries(scene, camera, args.res)
    failed = False
    for name, (o, d, lo, hi, any_hit) in queries.items():
        ref = None
        if args.check:
            ref = query_fn(scene, "brute", any_hit)(o, d, lo, hi)
        for engine in args.engines.split(","):
            first, ms, out = timed(query_fn(scene, engine, any_hit),
                                   (o, d, lo, hi), args.reps)
            row = {"query": name, "engine": engine, "scene": args.scene,
                   "rays": int(o.shape[0]), "ms": ms,
                   "compile_s": first, "device": device}
            if ref is not None:
                row.update(compare(out, ref, any_hit))
                failed |= not row["ok"]
            print(json.dumps(row), flush=True)
    if args.frame:
        import jax.numpy as jnp
        for engine in args.engines.split(","):
            first, ms, img = timed(
                frame_fn(scene, camera, args.res, args.bounces, engine),
                (jnp.uint32(1),), args.reps)
            img = np.asarray(img)
            print(json.dumps({
                "frame": args.scene, "engine": engine, "res": args.res,
                "bounces": args.bounces, "ms": ms, "compile_s": first,
                "mean": float(img.mean()),
                "finite": bool(np.isfinite(img).all()),
                "device": device}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
