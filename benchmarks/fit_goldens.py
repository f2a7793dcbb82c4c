"""Per-scene inverse-rendering fit of the golden scenes - ALL parameters.

Round 4 fitted albedos only (against the diffuse golden, transplanted to
all five scenes). This round fits, per scene against ITS OWN golden
(VERDICT r4 item 2). Two estimator classes, matched to what each
parameter's gradient actually contains:

  * SMOOTH params (grouped albedos, wall roughness, light intensity):
    analytic reverse-mode Adam through the differentiable render path -
    the r4 estimator, correct for shading-only parameters.
  * SILHOUETTE params (sphere radius/spacing, wall positions): the
    detached-hit estimator carries NO visibility gradient (hit ids
    detach; moving a sphere edge changes WHICH triangle is hit, not the
    refined t of the same one), so analytic grads sent the r5-draft fit
    into radius=1.2 divergence. These five scalars use COMMON-RANDOM-
    NUMBERS central differences instead: loss(g+h) - loss(g-h) at the
    SAME sample seeds - the Monte Carlo noise cancels and the silhouette
    term is exactly what survives. Exact affine vertex Jacobians replay
    the geometry (optixpathtracer_tpu/diff/replay.py).

Camera pose and light positions are NOT fitted by default: the reference
publishes them exactly (`main.cpp:10-17`); only the unshipped glTF
asset's geometry/materials are unknown. --unfreeze cam,lights adds them
to the FD set.

Uses intersect method='brute': it reads tri_v0/e1/e2 directly, so
replayed geometry has no stale acceleration structure.

Usage:
    python benchmarks/fit_goldens.py --scene diffuse [--rounds 6]
        [--mat-steps 60] [--fd-steps 10] [--width 480 --height 270]
        [--eval-spp 64]
Prints the fitted GOLDEN_FIT entry to paste into scene/procedural.py.
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


SMOOTH_KEYS = ("alb_logits", "wall_rough_logit", "light_logi")
# FD step sizes in native units per geo coordinate
# (radius, spacing, back_x, floor_y, ceil_y, grid_y, grid_z)
GEO_H = np.array([0.003, 0.004, 0.03, 0.04, 0.04, 0.02, 0.02], np.float32)
GEO_LR = GEO_H  # sign-SGD step ~= one FD step per iteration


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="diffuse")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--mat-steps", type=int, default=60)
    ap.add_argument("--fd-steps", type=int, default=10)
    ap.add_argument("--fd-spp", type=int, default=4)
    ap.add_argument("--width", type=int, default=480)
    ap.add_argument("--height", type=int, default=270)
    ap.add_argument("--spp-per-step", type=int, default=1)
    ap.add_argument("--lr", type=float, default=0.02)
    ap.add_argument("--segments", default="12,24")
    ap.add_argument("--eval-spp", type=int, default=64)
    ap.add_argument("--from-fit", action="store_true",
                    help="start from the committed GOLDEN_FIT entry")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import optax

    from benchmarks.accuracy import load_golden
    from optixpathtracer_tpu.diff.replay import MaterialTestReplay
    from optixpathtracer_tpu.film.color import linear_to_srgb
    from optixpathtracer_tpu.integrate.path import render_chunk
    from optixpathtracer_tpu.scene.flatten import (scene_active_lobes,
                                                   scene_uses_textures)
    from optixpathtracer_tpu.scene import procedural

    if not args.from_fit:
        procedural.GOLDEN_FIT.pop(args.scene, None)

    seg = tuple(int(x) for x in args.segments.split(","))
    replay = MaterialTestReplay(args.scene, segments=seg)
    lobes = scene_active_lobes(replay.scene0)
    use_tex = scene_uses_textures(replay.scene0)
    w, h = args.width, args.height
    golden = jnp.asarray(load_golden(args.scene, w, h, pbrt=True))

    params = replay.init_params()

    def render_with(params, frame0, spp):
        s = replay.scene_with(params)
        pos, iv, ip = replay.raygen_with(params, w, h)
        acc = jnp.zeros((h, w, 3), jnp.float32)
        img = render_chunk(s, pos, iv, ip, w, h, acc, frame0, spp, 2,
                           "brute", False, lobes, use_tex, False,
                           flat_shading=False)
        # undo the running mean's global frame weighting -> plain mean
        return img * (frame0.astype(jnp.float32) + spp) / spp

    def make_loss(spp):
        def loss_fn(params, frame0):
            img = render_with(params, frame0, spp)
            return jnp.mean((linear_to_srgb(jnp.clip(img, 1e-6, None))
                             - golden) ** 2)
        return loss_fn

    loss_mat = make_loss(args.spp_per_step)
    loss_fd = jax.jit(make_loss(args.fd_spp))

    # --- smooth phase: analytic Adam on material/light-intensity params
    opt = optax.adam(args.lr)

    @jax.jit
    def mat_step(params, opt_state, frame0):
        loss, g = jax.value_and_grad(loss_mat)(params, frame0)
        g = {k: (v if k in SMOOTH_KEYS else jnp.zeros_like(v))
             for k, v in g.items()}
        updates, opt_state = opt.update(g, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    # --- silhouette phase: CRN central differences on the 5 geo scalars
    def fd_grad(params, frame0):
        base = params["geo"]
        g = np.zeros(len(GEO_H), np.float32)
        for i in range(len(GEO_H)):
            hp = base.at[i].add(GEO_H[i])
            hm = base.at[i].add(-GEO_H[i])
            lp = loss_fd({**params, "geo": hp}, frame0)
            lm = loss_fd({**params, "geo": hm}, frame0)
            g[i] = (float(lp) - float(lm)) / (2.0 * GEO_H[i])
        return g

    t0 = time.time()
    opt_state = opt.init(params)
    frame = 0
    for rnd in range(args.rounds):
        # geometry: FD Adam steps (skip in round 0: let materials settle)
        if rnd:
            # sign-SGD with geometric decay: bounded, monotone-ish moves
            step_scale = GEO_LR * (0.6 ** (rnd - 1))
            for k in range(args.fd_steps):
                g = fd_grad(params, jnp.uint32(10_000 + frame))
                geo = params["geo"] - jnp.asarray(np.sign(g) * step_scale)
                params = {**params, "geo": geo}
                frame += args.fd_spp
            print(json.dumps({"round": rnd, "geo": np.asarray(
                params["geo"]).round(4).tolist(),
                "sec": round(time.time() - t0, 1)}), flush=True)
        for i in range(args.mat_steps):
            params, opt_state, loss = mat_step(params, opt_state,
                                               jnp.uint32(frame))
            frame += args.spp_per_step
        print(json.dumps({"round": rnd, "loss": float(loss),
                          "sec": round(time.time() - t0, 1)}), flush=True)

    fitted = replay.fitted_geo(params)
    print("GOLDEN_FIT[%r] = %s" % (args.scene, json.dumps(fitted)),
          flush=True)

    # final eval at eval_spp with the fitted parameters
    from optixpathtracer_tpu.film.metrics import flip, mse
    img = render_with(params, jnp.uint32(0), args.eval_spp)
    ours = np.clip(np.asarray(linear_to_srgb(np.asarray(img))), 0, 1)
    g_np = np.asarray(golden)
    print(json.dumps({"eval_mse": float(mse(ours, g_np)),
                      "eval_flip": float(flip(g_np, ours,
                                              inputs_are_linear=False))}),
          flush=True)


if __name__ == "__main__":
    main()
