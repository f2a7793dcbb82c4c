"""Command-line interface - the real CLI the reference never had
(configuration there = editing `main.cpp` and recompiling, SURVEY.md
section 5.6).

    python -m optixpathtracer_tpu.cli --scene scene3_cornell \
        --width 512 --height 512 --spp 64 --out-png cornell.png

    python -m optixpathtracer_tpu.cli --config render.json
    python -m optixpathtracer_tpu.cli --list-scenes
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

from .config import RenderConfig
from .intersect.api import METHODS


def build_parser():
    p = argparse.ArgumentParser(
        prog="optixpathtracer_tpu",
        description="Differentiable wavefront path tracer in JAX")
    p.add_argument("--config", help="JSON config file (flags override it)")
    p.add_argument("--scene", help="preset name or .gltf/.glb path")
    p.add_argument("--width", type=int)
    p.add_argument("--height", type=int)
    p.add_argument("--spp", type=int)
    p.add_argument("--max-bounces", type=int, dest="max_bounces")
    p.add_argument("--intersect", choices=list(METHODS))
    p.add_argument("--sharded", action="store_true", default=None,
                   help="shard pixel rows across all local devices")
    p.add_argument("--distributed", action="store_true",
                   help="initialize jax.distributed for multi-host runs "
                        "(auto-detects coordinator from the environment)")
    p.add_argument("--tonemap", choices=["srgb", "agx", "none"])
    p.add_argument("--reference-compat", action="store_true", default=None,
                   dest="reference_compat",
                   help="reproduce reference quirks/bugs for image parity")
    p.add_argument("--out-exr", dest="out_exr")
    p.add_argument("--out-png", dest="out_png")
    p.add_argument("--out-bmp", dest="out_bmp")
    p.add_argument("--checkpoint")
    p.add_argument("--checkpoint-every", type=int, dest="checkpoint_every")
    p.add_argument("--list-scenes", action="store_true")
    p.add_argument("--preview", type=int, nargs="?", const=8000,
                   metavar="PORT",
                   help="serve an interactive progressive preview (browser "
                        "viewport + WASD/drag fly camera) instead of a "
                        "batch render")
    p.add_argument("--preview-seconds", type=float, default=None,
                   help="auto-stop the preview after N seconds")
    p.add_argument("--profile", metavar="DIR",
                   help="write a jax.profiler trace of the render to DIR")
    return p


def config_from_args(args) -> RenderConfig:
    """The --config file (or the defaults), overridden by the flags given."""
    cfg = (RenderConfig.from_json(args.config) if args.config
           else RenderConfig())
    for f in dataclasses.fields(RenderConfig):
        v = getattr(args, f.name, None)
        if v is not None:
            setattr(cfg, f.name, v)
    return cfg


def main(argv=None):
    args = build_parser().parse_args(argv)
    from .runtime import enable_compile_cache, set_xla_flags
    set_xla_flags()
    enable_compile_cache()

    if args.list_scenes:
        from .scene.procedural import PRESETS
        for name in sorted(PRESETS):
            print(name)
        return 0

    cfg = config_from_args(args)

    if args.distributed:
        from .dist import initialize_distributed
        if initialize_distributed():
            import jax
            print(f"distributed: process {jax.process_index()}/"
                  f"{jax.process_count()}, {jax.device_count()} devices")

    if args.preview is not None:
        from .preview import run_preview
        from .render import load_scene
        scene, camera = load_scene(cfg)
        run_preview(scene, camera, cfg.width, cfg.height, cfg.max_bounces,
                    cfg.intersect, port=args.preview,
                    max_seconds=args.preview_seconds,
                    reference_compat=cfg.reference_compat)
        return 0

    if not (cfg.out_exr or cfg.out_png or cfg.out_bmp):
        print("warning: no --out-exr/--out-png/--out-bmp; rendering only",
              file=sys.stderr)

    from .render import render_config
    if args.profile:
        import jax
        with jax.profiler.trace(args.profile):
            img = render_config(cfg)
    else:
        img = render_config(cfg)
    print(f"done: {cfg.width}x{cfg.height}x{cfg.spp}spp "
          f"mean={float(img.mean()):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
