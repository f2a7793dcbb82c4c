"""Execute the five BASELINE configs end-to-end through the public CLI and
record the evidence (VERDICT r4 item 5): wall-clock, spp achieved, output
hashes, and MSE/FLIP vs the reference goldens where they exist.

Writes DIR/campaign.json (machine) and prints a markdown table. Each config
renders in a CLI child process that has the device to itself: this parent
pins its own JAX to the CPU, so it never takes a card's memory.

Usage: python benchmarks/run_configs.py [--configs 1,2,3,4,5] [--out DIR]
"""
from __future__ import annotations

import argparse
import glob
import hashlib
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
CHILD_ENV = dict(os.environ)
os.environ["JAX_PLATFORMS"] = "cpu"  # the parent's metrics stay off the card

GOLDEN_SCENES = {"diffuse", "conductor", "dielectric", "dielectric20",
                 "layered"}


def sha256(path):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for blk in iter(lambda: f.read(1 << 20), b""):
            h.update(blk)
    return h.hexdigest()[:16]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", default="1,2,3,4,5")
    ap.add_argument("--out", default=os.path.join(REPO, "out"))
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)

    rows = []
    for n in args.configs.split(","):
        cfgs = glob.glob(os.path.join(REPO, "scenes", f"config{n}_*.json"))
        assert len(cfgs) == 1, cfgs
        cfg_path = cfgs[0]
        with open(cfg_path) as f:
            cfg = json.load(f)
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, "-m", "optixpathtracer_tpu.cli",
             "--config", cfg_path],
            cwd=REPO, env=CHILD_ENV, capture_output=True, text=True)
        dt = time.time() - t0
        ok = proc.returncode == 0
        row = {"config": os.path.basename(cfg_path), "scene": cfg["scene"],
               "res": f'{cfg["width"]}x{cfg["height"]}',
               "spp": cfg["spp"], "bounces": cfg["max_bounces"],
               "wall_s": round(dt, 1), "ok": ok}
        if not ok:
            row["error"] = proc.stderr[-2000:]
            print(json.dumps(row), flush=True)
            rows.append(row)
            continue
        for k in ("out_exr", "out_png"):
            p = os.path.join(REPO, cfg.get(k, ""))
            if cfg.get(k) and os.path.exists(p):
                row[k.replace("out_", "sha_")] = sha256(p)
        # rays/s accounting consistent with bench.py
        rays = (cfg["width"] * cfg["height"] * cfg["spp"]
                * cfg["max_bounces"] * 2)
        row["mrays_s"] = round(rays / dt / 1e6, 3)
        if cfg["scene"] in GOLDEN_SCENES and cfg.get("out_exr"):
            from benchmarks.accuracy import load_golden
            from optixpathtracer_tpu.film import read_exr, to_display
            from optixpathtracer_tpu.film.metrics import flip, mse
            ours = to_display(read_exr(os.path.join(REPO, cfg["out_exr"]))
                              )[::-1].astype("float32") / 255.0
            g = load_golden(cfg["scene"], cfg["width"], cfg["height"],
                            pbrt=True)
            row["mse_vs_pbrt"] = float(mse(ours, g))
            row["flip_vs_pbrt"] = float(flip(g, ours,
                                             inputs_are_linear=False))
        print(json.dumps(row), flush=True)
        rows.append(row)

    with open(os.path.join(args.out, "campaign.json"), "w") as f:
        json.dump({"rows": rows, "note":
                   "BASELINE config campaign via the public CLI "
                   "(benchmarks/run_configs.py)"}, f, indent=1)

    print("\n| config | scene | res | spp | bounces | wall (s) | Mrays/s"
          " | MSE vs PBRT | FLIP |")
    print("|---|---|---|---|---|---|---|---|---|")
    for r in rows:
        print(f'| {r["config"]} | {r["scene"]} | {r["res"]} | {r["spp"]} '
              f'| {r["bounces"]} | {r["wall_s"]} | {r.get("mrays_s", "-")} '
              f'| {r.get("mse_vs_pbrt", "-") if not isinstance(r.get("mse_vs_pbrt"), float) else format(r["mse_vs_pbrt"], ".3e")} '
              f'| {r.get("flip_vs_pbrt", "-") if not isinstance(r.get("flip_vs_pbrt"), float) else format(r["flip_vs_pbrt"], ".4f")} |')


if __name__ == "__main__":
    main()
