"""Backward-pass stage breakdown + roofline (VERDICT r4 item 3).

The training step's backward half - reverse-mode through the wavefront -
against its forward. This script measures, on the default device at
256x256 on the layered scene:

  fwd              jitted forward render_sample
  fwd+bwd          value_and_grad of mean(render) wrt the material table
  bwd (derived)    fwd+bwd - fwd
  shade fwd        isolated surface+NEE-f+BSDF-sample stage (fixed hits)
  shade fwd+bwd    value_and_grad of the same subgraph
  refine fwd(+bwd) the differentiable hit refinement alone

The intersection engines run detached (hit ids carry no tangents,
intersect/api.py), so the backward sweep re-traverses NOTHING: its cost is
the VJP of shading (the layered walk dominates - its backward replays the
10-step lax.fori walk with rematerialized intermediates) plus the
refinement VJP.

Usage: python benchmarks/profile_backward.py [--scene layered] [--res 256]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="layered")
    ap.add_argument("--res", type=int, default=256)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from optixpathtracer_tpu.scene import flatten_model
    from optixpathtracer_tpu.scene.procedural import PRESETS
    from optixpathtracer_tpu.scene.flatten import (scene_active_lobes,
        scene_flat_shading, scene_uses_textures)
    from optixpathtracer_tpu.camera.camera import generate_rays
    from optixpathtracer_tpu.integrate.path import (render_sample,
                                                    _shade_wave)
    from optixpathtracer_tpu.intersect.api import (intersect_closest,
                                                   _refine)

    model, cam, lights = PRESETS[args.scene]()
    scene = flatten_model(model, lights)
    lobes = scene_active_lobes(scene)
    use_tex = scene_uses_textures(scene)
    flat = scene_flat_shading(scene)
    w = h = args.res
    pos, iv, ip = cam.raygen_params(w, h)
    diff_fields = ("mat_albedo", "mat_metallic", "mat_roughness", "mat_ior")

    def timeit(f, *a, reps=5):
        out = f(*a)
        jax.block_until_ready(out)
        out = f(*a)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for _ in range(reps):
            out = f(*a)
        jax.block_until_ready(out)
        return (time.perf_counter() - t0) / reps * 1e3

    # --- full forward / forward+backward
    def fwd(params):
        s = scene._replace(**params)
        img = render_sample(s, pos, iv, ip, w, h, jnp.uint32(0), 2, "auto",
                            False, lobes, use_tex, flat_shading=flat)
        return jnp.mean(img)

    params = {f: getattr(scene, f) for f in diff_fields}
    ms_fwd = timeit(jax.jit(fwd), params)
    ms_fb = timeit(jax.jit(jax.value_and_grad(fwd)), params)

    # --- isolated shading stage (fixed primary hits)
    o, d = generate_rays(pos, iv, ip, w, h)
    o = o.reshape(-1, 3)
    d = d.reshape(-1, 3)
    hit = jax.jit(lambda s: intersect_closest(s, o, d))(scene)
    hit = jax.tree.map(jax.lax.stop_gradient, hit)
    seed0 = jnp.arange(o.shape[0], dtype=jnp.uint32)
    alive0 = jnp.asarray(np.asarray(hit.hit))
    beta0 = jnp.ones((o.shape[0], 3), jnp.float32)
    rad0 = jnp.zeros((o.shape[0], 3), jnp.float32)

    def shade(params):
        s = scene._replace(**params)
        seed, radiance, beta, oo, dd, alive = _shade_wave(
            s, o, d, seed0, hit, beta0, alive0, rad0, False, use_tex,
            flat, "auto", lobes, False)
        return jnp.mean(radiance) + jnp.mean(beta)

    ms_sh = timeit(jax.jit(shade), params)
    ms_shb = timeit(jax.jit(jax.value_and_grad(shade)), params)

    # --- refinement-only VJP (geometry-side backward cost)
    def refine_loss(v0):
        s = scene._replace(tri_v0=v0)
        ref = _refine(s, o, d, hit, jnp.full(o.shape[:1], 100.0))
        return jnp.mean(jnp.where(ref.hit, ref.t, 0.0))

    ms_rf = timeit(jax.jit(refine_loss), scene.tri_v0)
    ms_rfb = timeit(jax.jit(jax.value_and_grad(refine_loss)), scene.tri_v0)

    out = {
        "scene": args.scene, "res": args.res,
        "fwd_ms": round(ms_fwd, 1),
        "fwd_bwd_ms": round(ms_fb, 1),
        "bwd_ms": round(ms_fb - ms_fwd, 1),
        "bwd_over_fwd": round((ms_fb - ms_fwd) / ms_fwd, 2),
        "shade_fwd_ms": round(ms_sh, 1),
        "shade_fwd_bwd_ms": round(ms_shb, 1),
        "shade_bwd_ms": round(ms_shb - ms_sh, 1),
        "refine_fwd_ms": round(ms_rf, 1),
        "refine_bwd_ms": round(ms_rfb - ms_rf, 1),
    }
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
