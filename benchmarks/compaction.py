"""Live-lane fraction measurement: is wavefront compaction worth it?

VERDICT r2 item 7: measure the live-lane fraction per bounce on the five
README material scenes (+ Cornell + the hall). The reference never needs
this - SIMT threads that break out of `SamplePath` just retire
(`devicePrograms.cu:646-653`); in the wavefront every lane computes every
bounce's shading, so the wasted fraction is (1 - live%) of the shading cost
(intersection already retires dead lanes via tmax=-1, integrate/path.py).

Decision rule from the VERDICT: if live% < 60% by bounce 2, implement
material-sorted / liveness-sorted dispatch; otherwise commit the measurement
as proof it isn't needed at the reference's default bounce budget
(max_bounces=2, `main.cpp:87`).

Usage: python benchmarks/compaction.py [--bounces 8] [--width 256] [--out COMPACTION.md]
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np


def live_fractions(scene, camera, width, height, max_bounces,
                   frames=4, intersect_method="auto"):
    """Per-bounce live-lane fraction (pre-shading: lanes still tracing at
    the START of each bounce), averaged over `frames` 1-spp frames."""
    import jax
    import jax.numpy as jnp
    from optixpathtracer_tpu.bsdf import dispatch
    from optixpathtracer_tpu.camera.camera import generate_rays
    from optixpathtracer_tpu.core import rng
    from optixpathtracer_tpu.core.math import length
    from optixpathtracer_tpu.integrate.cutout import (
        intersect_closest_cutout, scene_uses_alpha_cutout)
    from optixpathtracer_tpu.integrate.path import (BETA_EPS, RAY_TMAX,
                                                    SHADOW_OFFSET)
    from optixpathtracer_tpu.integrate.surface import make_surface
    from optixpathtracer_tpu.intersect import intersect_closest
    from optixpathtracer_tpu.scene.flatten import (scene_active_lobes,
        scene_flat_shading, scene_uses_textures)
    from optixpathtracer_tpu.core.math import abs_cos_theta, normalize

    lobes = scene_active_lobes(scene)
    use_tex = scene_uses_textures(scene)
    flat = scene_flat_shading(scene)
    use_cutout = scene_uses_alpha_cutout(scene)
    pos, iv, ip = camera.raygen_params(width, height)

    @jax.jit
    def run(scene, frame_id):
        # a re-instrumented copy of trace_paths' loop that records `alive`
        # at the top of each bounce (the shading-wavefront occupancy)
        o, d = generate_rays(pos, iv, ip, width, height)
        o = o.reshape(-1, 3)
        d = d.reshape(-1, 3)
        r = o.shape[0]
        ys, xs = jnp.meshgrid(jnp.arange(height, dtype=jnp.uint32),
                              jnp.arange(width, dtype=jnp.uint32),
                              indexing="ij")
        seed = rng.pixel_seed(width, xs.reshape(-1), ys.reshape(-1),
                              frame_id)
        beta = jnp.ones((r, 3), jnp.float32)
        alive = jnp.ones((r,), bool)
        fracs = []
        for b in range(max_bounces):
            ray_tmax = jnp.where(alive, RAY_TMAX, -1.0) if b else RAY_TMAX
            if use_cutout:
                hit = intersect_closest_cutout(scene, o, d, 0.0, ray_tmax,
                                               method=intersect_method)
            else:
                hit = intersect_closest(scene, o, d, 0.0, ray_tmax,
                                        method=intersect_method)
            alive = alive & hit.hit
            fracs.append(alive.mean())  # lanes that will be SHADED this bounce
            seed, surf = make_surface(seed, scene, o, d, hit,
                                      use_textures=use_tex,
                                      flat_shading=flat)
            seed, bs = dispatch.sample(seed, surf.mat, surf.wo_local, lobes)
            ok = bs.valid & (bs.pdf > 0.0)
            new_beta = (beta * bs.color
                        * abs_cos_theta(bs.direction)[..., None]
                        / jnp.where(bs.pdf == 0.0, 1.0, bs.pdf)[..., None])
            alive = alive & ok
            wi_world = normalize(surf.to_world(bs.direction))
            off = jnp.where(bs.direction[..., 2] < 0.0, -1.0, 1.0)
            new_o = surf.position + (SHADOW_OFFSET * off)[..., None] * surf.g_normal
            beta = jnp.where(alive[..., None], new_beta, beta)
            o = jnp.where(alive[..., None], new_o, o)
            d = jnp.where(alive[..., None], wi_world, d)
            alive = alive & (length(beta) > BETA_EPS)
        return jnp.stack(fracs)

    acc = np.zeros(max_bounces)
    for f in range(frames):
        acc += np.asarray(run(scene, jnp.uint32(f)))
    return acc / frames


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--bounces", type=int, default=8)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--scenes", default="conductor,diffuse,dielectric,"
                    "dielectric20,layered,scene3_cornell,hall_small")
    ap.add_argument("--method", default="auto")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    from optixpathtracer_tpu.scene import flatten_model
    from optixpathtracer_tpu.scene.procedural import PRESETS

    rows = []
    for name in args.scenes.split(","):
        model, camera, lights = PRESETS[name]()
        scene = flatten_model(model, lights)
        fr = live_fractions(scene, camera, args.width, args.height,
                            args.bounces, intersect_method=args.method)
        row = {"scene": name,
               "live_pct_per_bounce": [round(100 * float(x), 1) for x in fr]}
        print(json.dumps(row), flush=True)
        rows.append(row)

    if args.out:
        lines = [
            "# COMPACTION — live-lane occupancy per bounce",
            "",
            "Fraction of wavefront lanes still alive at the START of each",
            "bounce's shading stage (after the closest-hit; miss/killed lanes",
            "excluded), averaged over 4 frames at "
            f"{args.width}x{args.height}. Measured by",
            "`benchmarks/compaction.py`. Intersection already skips dead",
            "lanes en masse (tmax=-1 block culling, integrate/path.py); this",
            "table is the *shading* occupancy that compaction could recover.",
            "",
            "| Scene | " + " | ".join(f"b{i}" for i in range(args.bounces))
            + " |",
            "|---|" + "---|" * args.bounces,
        ]
        for r in rows:
            lines.append("| " + r["scene"] + " | "
                         + " | ".join(f"{x}%" for x in
                                      r["live_pct_per_bounce"]) + " |")
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
        print(f"wrote {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
