"""Chip smoke test: the path tracer's main path, once, on one NVIDIA GPU.

    python chip_smoke.py              # one card, phases 1-7
    python chip_smoke.py --cards 4    # the sharded path on four cards only
    python chip_smoke.py --rehearse   # tiny sizes, any backend (a dry run)

One process holds the card(s) throughout. Phases, in order (each prints its
numbers on its own lines; any failure exits non-zero before the last line):

  1 device     JAX's devices and the card's name and power limit; refuses
               anything but a GPU.
  2 cpu        scene3_cornell, 64x64, 4 spp, brute, on the GPU and on this
               process's CPU device.
  3 goldens    the four tests/test_golden.py cases with 'auto' routing
               against the committed CPU brute renders.
  4 traversal  the BVH kernel against brute.py on hall at 256x256: primary
               rays, one diffuse bounce, and shadow rays from both.
  5 cli        two renders through cli.main: config3 (dielectric, 512x512,
               5 bounces) at 16 spp and hall at 512x512, 4 spp, 2 bounces;
               then compile seconds, steady ms per frame, the compiled
               frame's memory analysis and the device's peak bytes.
  6 grad       two material_grad_step iterations on 'layered' at 256x256,
               2 bounces, inside one lax.fori_loop.
  7 gpu tests  the tests marked `gpu` (pytest, in this process).

With --cards 4 it runs only the multi-card path: config5's scene1_spheres at
1024x1024, 4 spp, through render_config on a 4-card mesh and on a 1-card
mesh, and material_grad_step (256x256, one bounce) on 4 cards and on 1.

Outputs go to chip_smoke_out/ (not tracked). The last line of standard output
is {"ok": true, "device": {"platform", "kind", "count"}}.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(REPO, "chip_smoke_out")
sys.path.insert(0, REPO)

# Phase 2: the same deterministic render on two backends differs only by
# operation order (fused multiply-adds, transcendental approximations) and
# the knife-edge hits and sampling branches that order flips. A flipped
# path is a different Monte Carlo sample: at 4 spp it can move its pixel
# by the light's whole contribution, so the ~0.4% of channels that diverge
# (H100, 700 W) move the image mean by ~3e-3. A systematic error (TF32
# ray directions, a wrong kernel) moves most channels instead.
CPU_CHANNEL_ATOL = 1e-3
CPU_CHANNEL_SHARE = 0.995
CPU_MEAN_RTOL = 1e-2
# Phase 3: the goldens are CPU brute renders; on the GPU the three 20k-
# triangle scenes go through the traversal kernel, which adds the
# occasional tie between triangles that share an edge. At 1-2 spp a few
# diverged pixels move the mean of a 32x32 or 48x48 image by up to ~1%.
GOLDEN_ATOL = 1e-3
GOLDEN_PIXEL_SHARE = 0.98
GOLDEN_MEAN_RTOL = 3e-2
# --cards 4: rows are independent, so a pixel's arithmetic is the same on
# any mesh - but each card compiles the frame for a quarter of the rows,
# and a differently shaped program may fuse (and round) differently, which
# can flip a knife-edge path. psum order moves the loss and the updated
# table in the last bits.
SHARD_ATOL = 1e-5
SHARD_PIXEL_SHARE = 0.999
GRAD_RTOL = 1e-5


def log(msg):
    print(msg, flush=True)


def _load(relpath):
    """Import a module of this checkout by path: `tests` and `benchmarks`
    are not packages, and an installed distribution may own those names."""
    import importlib.util
    name = "chip_smoke_" + os.path.splitext(relpath)[0].replace("/", "_")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, relpath))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class PhaseError(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise PhaseError(what)


def phase(name):
    log(f"== phase {name}")
    return time.perf_counter()


@dataclasses.dataclass
class Sizes:
    """What --rehearse shrinks. Widths, bounces and scenes stay."""
    parity_res: int = 64
    traversal_res: int = 256
    traversal_scene: str = "hall"
    cli_res: int = 512
    cli_spp: int = 16
    hall_spp: int = 4
    grad_res: int = 256
    multi_res: int = 1024
    multi_spp: int = 4
    reps: int = 3
    gpu_tests: bool = True


REHEARSAL = Sizes(parity_res=16, traversal_res=16,
                  traversal_scene="hall_small", cli_res=32, cli_spp=2,
                  hall_spp=1, grad_res=16, multi_res=32, multi_spp=1, reps=1,
                  gpu_tests=False)


def device_phase(rehearse):
    import jax
    from optixpathtracer_tpu.runtime import card_info
    phase("1 device")
    devs = jax.devices()
    dev = devs[0]
    log(f"devices: platform={dev.platform} kind={dev.device_kind} "
        f"count={len(devs)}")
    if dev.platform != "gpu" and not rehearse:
        raise PhaseError(f"JAX found no GPU (first device: {dev.platform})")
    card = card_info() if dev.platform == "gpu" else "no card (rehearsal)"
    log(f"card: {card}")
    return dev, card


def cpu_parity_phase(sz, card):
    import jax
    import numpy as np
    from optixpathtracer_tpu.integrate import render
    from optixpathtracer_tpu.scene import flatten_model
    from optixpathtracer_tpu.scene.procedural import PRESETS
    t0 = phase("2 cpu parity")
    res = sz.parity_res

    def run():
        model, camera, lights = PRESETS["scene3_cornell"]()
        scene = flatten_model(model, lights)
        return np.asarray(render(scene, camera, res, res, spp=4,
                                 max_bounces=2, intersect_method="brute"))

    img = run()
    with jax.default_device(jax.devices("cpu")[0]):
        ref = run()
    close = np.abs(img - ref) <= CPU_CHANNEL_ATOL
    mean_rel = abs(img.mean() - ref.mean()) / max(abs(ref.mean()), 1e-12)
    log(f"cpu parity: {close.mean():.6f} of channels within "
        f"{CPU_CHANNEL_ATOL}, mean {img.mean():.6f} vs {ref.mean():.6f} "
        f"(rel {mean_rel:.2e}), {time.perf_counter() - t0:.1f} s [{card}]")
    check(np.isfinite(img).all(), "GPU render not finite")
    check(close.mean() >= CPU_CHANNEL_SHARE,
          f"only {close.mean():.4f} of channels match the CPU render")
    check(mean_rel <= CPU_MEAN_RTOL, f"image mean off by {mean_rel:.2e}")


def goldens_phase(sz, card):
    import numpy as np
    from optixpathtracer_tpu.film import read_exr
    from optixpathtracer_tpu.integrate import render
    from optixpathtracer_tpu.intersect.api import _resolve
    from optixpathtracer_tpu.scene import flatten_model
    from optixpathtracer_tpu.scene.procedural import PRESETS
    golden_tests = _load("tests/test_golden.py")
    CASES, GOLDEN_DIR = golden_tests.CASES, golden_tests.GOLDEN_DIR
    phase("3 goldens")
    for name, (preset, w, h, spp, bounces) in sorted(CASES.items()):
        t0 = time.perf_counter()
        model, camera, lights = PRESETS[preset]()
        scene = flatten_model(model, lights)
        img = np.asarray(render(scene, camera, w, h, spp=spp,
                                max_bounces=bounces))
        golden = read_exr(os.path.join(GOLDEN_DIR, f"{name}.exr"))
        check(img.shape == golden.shape, f"{name}: shape {img.shape}")
        close = np.isclose(img, golden, atol=GOLDEN_ATOL,
                           rtol=10 * GOLDEN_ATOL).all(axis=-1)
        mean_rel = (abs(img.mean() - golden.mean())
                    / max(abs(golden.mean()), 1e-12))
        log(f"golden {name}: engine={_resolve('auto', scene)} "
            f"{close.mean():.6f} of pixels match, mean rel {mean_rel:.2e}, "
            f"{time.perf_counter() - t0:.1f} s [{card}]")
        check(np.isfinite(img).all(), f"{name}: not finite")
        check(close.mean() >= GOLDEN_PIXEL_SHARE,
              f"{name}: only {close.mean():.4f} of pixels match")
        check(mean_rel <= GOLDEN_MEAN_RTOL, f"{name}: mean off {mean_rel}")


def traversal_phase(sz, card):
    tr = _load("benchmarks/traversal.py")
    compare, make_queries, query_fn, timed = (tr.compare, tr.make_queries,
                                              tr.query_fn, tr.timed)
    from optixpathtracer_tpu.scene import flatten_model
    from optixpathtracer_tpu.scene.procedural import PRESETS
    phase("4 traversal")
    model, camera, lights = PRESETS[sz.traversal_scene]()
    scene = flatten_model(model, lights)
    log(f"scene {sz.traversal_scene}: {int(scene.tri_valid.sum())} "
        f"triangles, {scene.bvh_min.shape[0]} nodes")
    queries = make_queries(scene, camera, sz.traversal_res,
                           method="bvh_kernel")
    for name, (o, d, lo, hi, any_hit) in queries.items():
        ref = query_fn(scene, "brute", any_hit)(o, d, lo, hi)
        first, ms, got = timed(query_fn(scene, "bvh_kernel", any_hit),
                               (o, d, lo, hi), sz.reps)
        row = compare(got, ref, any_hit)
        log(f"traversal {name}: {o.shape[0]} rays, agree "
            f"{row['agree']:.6f}"
            + (f", t rel max {row['t_rel_max']:.2e}" if not any_hit else "")
            + f", {ms:.3f} ms/query, first call {first:.1f} s [{card}]")
        check(row["ok"], f"traversal {name} disagrees with brute: {row}")


def _compile_render(cfg, card):
    """Compile, ahead of time, the program render_config runs for `cfg`
    (integrate.path.render_chunk with the same arguments), so its compile
    seconds are set-up that the CLI run then finds in the compile cache.
    Returns (compiled, its dynamic arguments, frames per launch)."""
    import jax.numpy as jnp
    from optixpathtracer_tpu.integrate.cutout import scene_uses_alpha_cutout
    from optixpathtracer_tpu.integrate.path import render_chunk
    from optixpathtracer_tpu.render import load_scene
    from optixpathtracer_tpu.scene.flatten import (scene_active_lobes,
        scene_flat_shading, scene_uses_textures)
    scene, camera = load_scene(cfg)
    pos, iv, ip = camera.raygen_params(cfg.width, cfg.height)
    chunk = min(cfg.frames_per_launch, cfg.spp)
    accum = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)
    t0 = time.perf_counter()
    compiled = render_chunk.lower(
        scene, pos, iv, ip, cfg.width, cfg.height, accum, jnp.uint32(0),
        chunk, cfg.max_bounces, cfg.intersect, cfg.reference_compat,
        scene_active_lobes(scene), scene_uses_textures(scene),
        scene_uses_alpha_cutout(scene),
        flat_shading=scene_flat_shading(scene)).compile()
    log(f"  compile {time.perf_counter() - t0:.1f} s (set-up), "
        f"{chunk} frames per launch [{card}]")
    log(f"  memory_analysis: {compiled.memory_analysis()} [{card}]")
    return compiled, (scene, pos, iv, ip, accum), chunk


def cli_phase(sz, card):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from optixpathtracer_tpu import cli
    from optixpathtracer_tpu.film import read_exr
    phase("5 cli")
    os.makedirs(OUT, exist_ok=True)
    runs = [
        ("dielectric", ["--config", os.path.join(REPO, "scenes",
                                                 "config3_dielectric.json"),
                        "--spp", str(sz.cli_spp)]),
        ("hall", ["--scene", "hall", "--spp", str(sz.hall_spp),
                  "--max-bounces", "2"]),
    ]
    for name, argv in runs:
        exr = os.path.join(OUT, f"{name}.exr")
        argv = argv + ["--width", str(sz.cli_res), "--height",
                       str(sz.cli_res), "--out-exr", exr,
                       "--out-png", os.path.join(OUT, f"{name}.png")]
        log(f"cli {name}: {' '.join(argv)}")
        cfg = cli.config_from_args(cli.build_parser().parse_args(argv))
        compiled, dyn, chunk = _compile_render(cfg, card)
        t0 = time.perf_counter()
        check(cli.main(argv) == 0, f"cli {name} failed")
        wall = time.perf_counter() - t0
        img = read_exr(exr)
        log(f"  cli.main: {img.shape}, mean {img.mean():.6f}, wall "
            f"{wall:.1f} s [{card}]")
        check(img.shape == (sz.cli_res, sz.cli_res, 3), f"{name}: shape")
        check(np.isfinite(img).all(), f"{name}: not finite")
        check(img.mean() > 0.0, f"{name}: black image")
        times = []
        for i in range(sz.reps):
            t0 = time.perf_counter()
            jax.block_until_ready(compiled(*dyn, jnp.uint32(i * chunk)))
            times.append((time.perf_counter() - t0) * 1e3 / chunk)
        stats = jax.devices()[0].memory_stats() or {}
        log(f"  steady {np.median(times):.3f} ms/frame (median of "
            f"{sz.reps} launches of {chunk} frames), peak_bytes_in_use "
            f"{stats.get('peak_bytes_in_use')} [{card}]")


def grad_phase(sz, card):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from optixpathtracer_tpu.dist import make_mesh, material_grad_step
    from optixpathtracer_tpu.scene import flatten_model
    from optixpathtracer_tpu.scene.flatten import scene_active_lobes
    from optixpathtracer_tpu.scene.procedural import PRESETS
    t0 = phase("6 grad")
    model, camera, lights = PRESETS["layered"]()
    scene = flatten_model(model, lights)
    res, steps = sz.grad_res, 2
    cam = camera.raygen_params(res, res)
    target = jnp.zeros((res, res, 3), jnp.float32)
    mesh = make_mesh(1)
    lobes = scene_active_lobes(scene)

    @jax.jit
    def train(s):
        def body(i, carry):
            s, _ = carry
            return material_grad_step(mesh, s, cam, target, res, res,
                                      i.astype(jnp.uint32), max_bounces=2,
                                      active_lobes=lobes)
        return jax.lax.fori_loop(0, steps, body, (s, jnp.float32(0.0)))

    t1 = time.perf_counter()
    compiled = train.lower(scene).compile()
    t2 = time.perf_counter()
    new, loss = jax.block_until_ready(compiled(scene))
    t3 = time.perf_counter()
    moved = float(jnp.abs(new.mat_albedo - scene.mat_albedo).max())
    log(f"grad: loss {float(loss):.6f}, albedo moved by up to {moved:.3e}; "
        f"compile {t2 - t1:.1f} s (set-up), {steps} steps {t3 - t2:.3f} s, "
        f"phase {t3 - t0:.1f} s [{card}]")
    log(f"  memory_analysis: {compiled.memory_analysis()} [{card}]")
    check(np.isfinite(float(loss)), "loss not finite")
    check(moved > 0.0, "the albedo table did not move")


def gpu_tests_phase():
    import pytest
    phase("7 gpu tests")
    env = dict(os.environ)
    try:
        rc = pytest.main([os.path.join(REPO, "tests"), "-q", "-m", "gpu",
                          "-p", "no:cacheprovider", "-p", "no:xdist",
                          "-p", "no:randomly"])
    finally:
        os.environ.clear()
        os.environ.update(env)
    check(rc == 0, f"gpu-marked tests failed (pytest exit {rc})")


def multi_card_phase(sz, card):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from optixpathtracer_tpu.config import RenderConfig
    from optixpathtracer_tpu.dist import make_mesh, material_grad_step
    from optixpathtracer_tpu.render import load_scene, render_config
    from optixpathtracer_tpu.scene.flatten import scene_active_lobes
    n = len(jax.devices())
    check(n >= 4, f"--cards 4 needs four devices, JAX has {n}")
    t0 = phase("4-card sharded render")
    with open(os.path.join(REPO, "scenes", "config5_full.json")) as f:
        cfg = RenderConfig(**json.load(f))
    cfg = dataclasses.replace(cfg, width=sz.multi_res, height=sz.multi_res,
                              spp=sz.multi_spp, checkpoint=None,
                              out_exr=None, out_png=None, out_bmp=None)
    scene, camera = load_scene(cfg)
    imgs = {}
    for cards in (4, 1):
        t = time.perf_counter()
        imgs[cards] = render_config(cfg, scene, camera,
                                    mesh=make_mesh(cards))
        log(f"sharded render on {cards} card(s): mean "
            f"{imgs[cards].mean():.6f}, {time.perf_counter() - t:.1f} s "
            f"including compile [{card}]")
    diff = float(np.abs(imgs[4] - imgs[1]).max())
    close = np.isclose(imgs[4], imgs[1], atol=SHARD_ATOL,
                       rtol=10 * SHARD_ATOL).all(axis=-1).mean()
    log(f"4 vs 1 card: bit-equal {bool((imgs[4] == imgs[1]).all())}, max "
        f"abs diff {diff:.3e}, {close:.6f} of pixels within {SHARD_ATOL}")
    check(np.isfinite(imgs[4]).all() and imgs[4].mean() > 0, "bad frame")
    check(close >= SHARD_PIXEL_SHARE, f"only {close} of pixels match")

    # One bounce: the psum-by-transpose structure is the same at any depth,
    # and each mesh size compiles its own training program.
    phase("4-card grad step")
    res = sz.grad_res
    cam = camera.raygen_params(res, res)
    target = jnp.zeros((res, res, 3), jnp.float32)
    lobes = scene_active_lobes(scene)
    out = {}
    for cards in (4, 1):
        mesh = make_mesh(cards)
        step = jax.jit(lambda s, mesh=mesh: material_grad_step(
            mesh, s, cam, target, res, res, jnp.uint32(0), max_bounces=1,
            active_lobes=lobes))
        new, loss = jax.block_until_ready(step(scene))
        out[cards] = (float(loss), np.asarray(new.mat_albedo))
        log(f"grad step on {cards} card(s): loss {float(loss):.8f}")
    loss_rel = abs(out[4][0] - out[1][0]) / max(abs(out[1][0]), 1e-12)
    alb = float(np.abs(out[4][1] - out[1][1]).max())
    log(f"4 vs 1 card: loss rel diff {loss_rel:.3e}, albedo max abs diff "
        f"{alb:.3e} (tolerance {GRAD_RTOL}) [{card}]")
    check(loss_rel <= GRAD_RTOL, f"loss differs by {loss_rel}")
    check(alb <= GRAD_RTOL, f"albedo differs by {alb}")
    log(f"4-card phases: {time.perf_counter() - t0:.1f} s")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1)
    ap.add_argument("--rehearse", action="store_true",
                    help="tiny sizes on any backend; never a chip result")
    args = ap.parse_args(argv)
    sz = REHEARSAL if args.rehearse else Sizes()

    from optixpathtracer_tpu.runtime import enable_compile_cache, set_xla_flags
    set_xla_flags()
    enable_compile_cache()
    t0 = time.perf_counter()
    dev, card = device_phase(args.rehearse)
    if args.cards == 4:
        multi_card_phase(sz, card)
    else:
        cpu_parity_phase(sz, card)
        goldens_phase(sz, card)
        traversal_phase(sz, card)
        cli_phase(sz, card)
        grad_phase(sz, card)
        if sz.gpu_tests:
            gpu_tests_phase()
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s [{card}]")
    import jax
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
