"""Accuracy eval against the reference's shipped golden images.

The reference validates by comparing its renders of the five README material
scenes against PBRT-v4 renders with PBRT's image tools
(`README.md:40-46`, raw numbers `Images/Diffs.txt:1-14`); the image pairs
ship in `/root/reference/Images/PNGs/{scene}{,PBRT}.png`. This script
renders the same five scenes (geometry reconstructed from the goldens -
scene/procedural.py `GOLDEN_GEO`) and scores ours-vs-PBRT and
ours-vs-reference MSE/FLIP in-repo (film/metrics.py), writing the table to
ACCURACY.md and BASELINE.json["published"].

Comparison convention: goldens are 8-bit sRGB PNGs, so images are compared
as sRGB-encoded [0,1] arrays (what PBRT's imgtool sees after PNG decode).
Renders default to 480x270 with goldens area-downsampled to match; use
--width 1920 --height 1080 on the GPU for the full-resolution numbers.

Usage:
    python benchmarks/accuracy.py [--spp 256] [--width 480] [--height 270]
        [--scenes conductor,diffuse,...] [--out ACCURACY.md] [--update-baseline]
    python benchmarks/accuracy.py --tune   # coordinate-descent geometry fit
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

REF_PNG_DIR = "/root/reference/Images/PNGs"
SCENES = ["conductor", "diffuse", "dielectric", "dielectric20", "layered"]
# reference's own numbers vs PBRT (Images/Diffs.txt:1-14)
REF_MSE = {"conductor": 2.571821e-7, "dielectric": 1.2437624e-7,
           "dielectric20": 4.9750368e-5, "diffuse": 4.586374e-6,
           "layered": 8.8446933e-7}
REF_FLIP = {"conductor": 0.0017468039, "dielectric": 0.00084382464,
            "dielectric20": 0.007553334, "diffuse": 0.006595257,
            "layered": 0.0032398894}


def load_golden(name: str, width: int, height: int, pbrt: bool):
    """Load a reference PNG as sRGB-encoded float [H, W, 3], area-resampled
    to the render resolution."""
    from PIL import Image
    suffix = "PBRT" if pbrt else ""
    path = os.path.join(REF_PNG_DIR, f"{name}{suffix}.png")
    im = Image.open(path).convert("RGB")
    if (im.width, im.height) != (width, height):
        im = im.resize((width, height), Image.BOX)
    return np.asarray(im, np.float32) / 255.0


def render_scene(name: str, width: int, height: int, spp: int,
                 max_bounces: int = 2, geo=None, method: str = "auto"):
    """Render one golden scene; returns sRGB-encoded float [H, W, 3]."""
    from optixpathtracer_tpu.film.color import linear_to_srgb
    from optixpathtracer_tpu.integrate import render
    from optixpathtracer_tpu.scene import flatten_model
    from optixpathtracer_tpu.scene.procedural import scene_material_test
    model, camera, lights = scene_material_test(name, geo, segments=(24, 48))
    scene = flatten_model(model, lights)
    img = render(scene, camera, width, height, spp=spp,
                 max_bounces=max_bounces, intersect_method=method)
    return np.clip(np.asarray(linear_to_srgb(np.asarray(img))), 0.0, 1.0)


def score(ours: np.ndarray, golden: np.ndarray):
    from optixpathtracer_tpu.film.metrics import flip, mse
    return (mse(ours, golden),
            float(flip(golden, ours, inputs_are_linear=False)))


def run_eval(args):
    rows = []
    scenes = args.scenes.split(",") if args.scenes else SCENES
    for name in scenes:
        t0 = time.time()
        ours = render_scene(name, args.width, args.height, args.spp,
                            method=args.method)
        dt = time.time() - t0
        g_pbrt = load_golden(name, args.width, args.height, pbrt=True)
        g_ref = load_golden(name, args.width, args.height, pbrt=False)
        mse_p, flip_p = score(ours, g_pbrt)
        mse_r, flip_r = score(ours, g_ref)
        row = {"scene": name, "mse_vs_pbrt": mse_p, "flip_vs_pbrt": flip_p,
               "mse_vs_ref": mse_r, "flip_vs_ref": flip_r,
               "ref_mse_vs_pbrt": REF_MSE[name],
               "ref_flip_vs_pbrt": REF_FLIP[name],
               "spp": args.spp, "width": args.width, "height": args.height,
               "seconds": round(dt, 2)}
        print(json.dumps(row), flush=True)
        rows.append(row)
        if args.save_images:
            from PIL import Image
            os.makedirs("/tmp/accuracy", exist_ok=True)
            Image.fromarray((ours * 255).astype(np.uint8)).save(
                f"/tmp/accuracy/ours_{name}.png")
    if args.out:
        write_markdown(rows, args.out)
    if args.update_baseline:
        update_baseline(rows)
    return rows


def write_markdown(rows, path):
    lines = [
        "# ACCURACY — ours vs the reference's shipped goldens",
        "",
        "Rendered with this framework (scenes reconstructed from the golden",
        "images; `scene/procedural.py GOLDEN_GEO`), scored with the in-repo",
        "MSE/FLIP (film/metrics.py) against",
        "`/root/reference/Images/PNGs/{scene}{,PBRT}.png`, as sRGB [0,1].",
        "The 'reference vs PBRT' columns are the reference's own published",
        "numbers (`Images/Diffs.txt`) — the bar for a *pixel-faithful scene",
        "replica*, which these reconstructed scenes approximate.",
        "",
        f"Settings: {rows[0]['width']}x{rows[0]['height']}, "
        f"{rows[0]['spp']} spp.",
        "",
        "| Scene | ours vs PBRT MSE | ours vs PBRT FLIP | ours vs ref MSE "
        "| ours vs ref FLIP | ref vs PBRT MSE | ref vs PBRT FLIP |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(
            f"| {r['scene']} | {r['mse_vs_pbrt']:.3e} | "
            f"{r['flip_vs_pbrt']:.4f} | {r['mse_vs_ref']:.3e} | "
            f"{r['flip_vs_ref']:.4f} | {r['ref_mse_vs_pbrt']:.3e} | "
            f"{r['ref_flip_vs_pbrt']:.4f} |")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {path}", file=sys.stderr)


def update_baseline(rows):
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "..", "BASELINE.json")
    with open(path) as f:
        base = json.load(f)
    base.setdefault("published", {})
    base["published"]["accuracy_vs_reference_goldens"] = {
        r["scene"]: {k: r[k] for k in
                     ("mse_vs_pbrt", "flip_vs_pbrt", "mse_vs_ref",
                      "flip_vs_ref", "spp", "width", "height")}
        for r in rows}
    with open(path, "w") as f:
        json.dump(base, f, indent=2)
    print("updated BASELINE.json published accuracy", file=sys.stderr)


# ---------------------------------------------------------------------------
# Geometry tuning: coordinate descent on GOLDEN_GEO scalars, minimizing
# summed MSE against the diffuse + layered goldens (the two where albedo and
# wall layout dominate) at low res / low spp.
# ---------------------------------------------------------------------------

TUNE_SPECS = [
    # (key, index-or-None, candidate multipliers/values)
    ("back_x", None, [-0.3, -0.5, -0.8, -1.2]),
    ("sphere_rgb", 0, [0.30, 0.36, 0.42, 0.5, 0.58]),
    ("back_rgb", None, [0.06, 0.09, 0.12, 0.16, 0.22]),
    ("green_rgb", 1, [0.18, 0.27, 0.38, 0.5]),
    ("blue_rgb", 2, [0.18, 0.27, 0.38, 0.5]),
    ("dielectric20_light", None, [8.0, 15.0, 20.0, 30.0]),
]
TUNE_SCENES = {"back_x": ["diffuse"], "sphere_rgb": ["diffuse", "layered"],
               "back_rgb": ["diffuse"], "green_rgb": ["diffuse"],
               "blue_rgb": ["diffuse"], "dielectric20_light": ["dielectric20"]}


def run_tune(args):
    from optixpathtracer_tpu.scene.procedural import GOLDEN_GEO
    geo = {k: (list(v) if isinstance(v, tuple) else v)
           for k, v in GOLDEN_GEO.items()}
    w, h, spp = args.width, args.height, args.spp

    def cost(geo, scenes):
        total = 0.0
        for name in scenes:
            ours = render_scene(name, w, h, spp, geo=geo)
            total += score(ours, load_golden(name, w, h, True))[0]
        return total

    for rounds in range(args.rounds):
        for key, idx, cands in TUNE_SPECS:
            scenes = TUNE_SCENES[key]
            best_c, best_v = None, np.inf
            for cand in cands:
                trial = {k: (list(v) if isinstance(v, list) else v)
                         for k, v in geo.items()}
                if idx is None and not isinstance(trial[key], list):
                    trial[key] = cand
                elif idx is None:
                    trial[key] = [cand * x / max(trial[key]) if max(
                        trial[key]) > 0 else cand for x in trial[key]]
                else:
                    trial[key][idx] = cand
                v = cost(trial, scenes)
                print(f"round {rounds} {key}={cand}: mse_sum={v:.6g}",
                      flush=True)
                if v < best_v:
                    best_v, best_c = v, trial
            geo = best_c
        print("tuned geo:", json.dumps(geo), flush=True)
    return geo


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--spp", type=int, default=256)
    ap.add_argument("--width", type=int, default=480)
    ap.add_argument("--height", type=int, default=270)
    ap.add_argument("--scenes", default=None)
    ap.add_argument("--method", default="auto")
    ap.add_argument("--out", default=None)
    ap.add_argument("--update-baseline", action="store_true")
    ap.add_argument("--save-images", action="store_true")
    ap.add_argument("--tune", action="store_true")
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    if args.tune:
        run_tune(args)
    else:
        run_eval(args)


if __name__ == "__main__":
    main()
