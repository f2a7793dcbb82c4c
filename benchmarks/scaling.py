"""Scaling benchmark: rays/s vs device count (BASELINE.md: >85% efficiency
1 -> 2 hosts; report 1 chip / 1 host / N hosts).

On a multi-GPU host this measures real scaling; on a CPU box set
XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu to
validate the sharding structure only (CPU rates are not device numbers).

    python benchmarks/scaling.py [--width 256] [--height 256] [--frames 4]

Prints one JSON line per mesh size plus a summary with efficiency relative
to the single-device rate.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--max-bounces", type=int, default=2)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from optixpathtracer_tpu.dist import make_mesh, render_sample_sharded
    from optixpathtracer_tpu.scene import flatten_model
    from optixpathtracer_tpu.scene.procedural import PRESETS

    model, camera, lights = PRESETS["scene3_cornell"]()
    scene = flatten_model(model, lights)
    pos, iv, ip = camera.raygen_params(args.width, args.height)

    n_dev = len(jax.devices())
    sizes = [n for n in (1, 2, 4, 8, 16, 32) if n <= n_dev]
    results = {}
    for n in sizes:
        mesh = make_mesh(n)
        h = args.height - (args.height % n) if args.height % n else args.height

        def run(fid):
            return render_sample_sharded(mesh, scene, pos, iv, ip,
                                         args.width, h, jnp.uint32(fid),
                                         args.max_bounces)

        run(0).block_until_ready()  # compile
        t0 = time.time()
        for f in range(args.frames):
            out = run(f + 1)
        out.block_until_ready()
        dt = time.time() - t0
        rays = args.frames * args.width * h * args.max_bounces * 2
        mrays = rays / dt / 1e6
        results[n] = mrays
        print(json.dumps({"devices": n, "mrays_per_s": round(mrays, 3),
                          "mrays_per_s_per_device": round(mrays / n, 3)}))

    base = results[sizes[0]]
    for n in sizes[1:]:
        eff = results[n] / (base * n / sizes[0])
        print(json.dumps({"devices": n, "scaling_efficiency": round(eff, 3)}))


if __name__ == "__main__":
    main()
