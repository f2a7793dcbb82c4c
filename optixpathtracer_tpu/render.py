"""High-level rendering API: config -> scene -> progressive render -> files.

The orchestration layer replacing the reference's OptixView/main
(`OptixView.cpp:130-185` run loop, `main.cpp`), with the capabilities the
reference lacks (SURVEY.md section 5): checkpoint/resume of the accumulator,
structured progress logging, and in-repo metrics.
"""
from __future__ import annotations

import os
import time

import jax.numpy as jnp
import numpy as np

from .camera import Camera
from .config import RenderConfig
from .film import write_bmp, write_exr, write_png
from .integrate.path import render_chunk
from .scene import flatten_model
from .scene.flatten import (scene_active_lobes, scene_flat_shading,
    scene_uses_textures)
from .scene.gltf import load_gltf
from .scene.procedural import PRESETS
from .scene.types import PointLight


def load_scene(cfg: RenderConfig):
    """Resolve cfg.scene to (SceneData, Camera)."""
    if cfg.scene in PRESETS:
        model, camera, lights = PRESETS[cfg.scene]()
    elif os.path.exists(cfg.scene):
        model = load_gltf(cfg.scene, reference_compat=cfg.reference_compat)
        camera = Camera.from_blender((3.85382, 0.0, 1.0), (90.0, 0.0, 90.0))
        lights = [PointLight(np.array([0.0, 1.69221, 0.0], np.float32),
                             np.ones(3, np.float32))]
    else:
        raise ValueError(f"unknown scene {cfg.scene!r} "
                         f"(presets: {sorted(PRESETS)})")
    return flatten_model(model, lights), camera


def save_checkpoint(path, accum, next_frame):
    """Accumulator + sample counter: the complete resumable render state
    (deterministic RNG means nothing else is needed - SURVEY.md section 5.4).
    """
    tmp = path + ".tmp.npz"
    with open(tmp, "wb") as f:
        np.savez(f, accum=np.asarray(accum), next_frame=next_frame)
    os.replace(tmp, path)


def load_checkpoint(path):
    data = np.load(path)
    return jnp.asarray(data["accum"]), int(data["next_frame"])


def render_config(cfg: RenderConfig, scene=None, camera=None, mesh=None):
    """Run a full progressive render per the config. Returns the final
    linear [H, W, 3] numpy image. A sharded render uses `mesh`, or one
    over every device when it is None."""
    if scene is None or camera is None:
        scene, camera = load_scene(cfg)

    accum = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)
    start = 0
    if cfg.checkpoint and os.path.exists(cfg.checkpoint):
        accum, start = load_checkpoint(cfg.checkpoint)
        print(f"resumed from {cfg.checkpoint} at sample {start}")

    from .integrate.cutout import scene_uses_alpha_cutout
    lobes = scene_active_lobes(scene)
    use_tex = scene_uses_textures(scene)
    flat = scene_flat_shading(scene)
    use_cutout = scene_uses_alpha_cutout(scene)
    pos, inv_view, inv_proj = camera.raygen_params(cfg.width, cfg.height)

    frame_fn = None
    if cfg.sharded:
        # Production multi-device path: pixel rows sharded over every
        # device there is (and every host under jax.distributed; one device
        # is a valid mesh) - the scaling axis the reference's single-GPU
        # design never had (`OptixRenderer.cpp:69-71`).
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P
        from .dist import make_mesh, render_sample_sharded
        if mesh is None:
            mesh = make_mesh()
        n = mesh.devices.size
        if cfg.height % n:
            raise ValueError(f"sharded render: height {cfg.height} is not "
                             f"divisible by {n} devices")

        @jax.jit
        def frame_fn(scene, s):
            return render_sample_sharded(
                mesh, scene, pos, inv_view, inv_proj,
                cfg.width, cfg.height, s, cfg.max_bounces,
                cfg.intersect, lobes, cfg.reference_compat,
                use_tex, use_cutout, flat)

        # keep the accumulator sharded like the frames: the running-mean
        # update then runs with zero cross-device traffic
        accum = jax.device_put(
            accum, NamedSharding(mesh, P(mesh.axis_names[0])))

    # The spp loop runs ON-DEVICE in chunks of frames_per_launch
    # (lax.fori_loop over 1-spp frames with the running-mean update fused
    # in), so a 1024-spp production render pays ~spp/chunk host dispatches
    # instead of ~spp. Chunks stop at checkpoint boundaries so resume
    # semantics are unchanged; per-frame arithmetic is identical (same frame
    # seeds, same mean recurrence), so images are bit-identical to the
    # per-sample loop. An unsharded render runs integrate.path.render_chunk
    # itself, so a program compiled ahead of time with the same arguments
    # (chip_smoke.py does) is the one this loop runs.
    if frame_fn is not None:
        import jax
        from functools import partial

        @partial(jax.jit, static_argnames=("chunk",))
        def sharded_chunk(scene, accum, s0, chunk: int):
            def body(i, acc):
                s = (s0 + i).astype(jnp.uint32)
                frame = frame_fn(scene, s)
                return acc + (frame - acc) / (s.astype(jnp.float32) + 1.0)
            return jax.lax.fori_loop(0, chunk, body, accum)

    def launch(accum, s0, chunk):
        if frame_fn is not None:
            return sharded_chunk(scene, accum, s0, chunk)
        return render_chunk(scene, pos, inv_view, inv_proj, cfg.width,
                            cfg.height, accum, s0, chunk, cfg.max_bounces,
                            cfg.intersect, cfg.reference_compat, lobes,
                            use_tex, use_cutout, flat_shading=flat)

    per_launch = max(1, cfg.frames_per_launch)
    t0 = time.time()
    s = start
    while s < cfg.spp:
        chunk = min(per_launch, cfg.spp - s)
        if cfg.checkpoint:  # stop at the next checkpoint boundary
            to_ckpt = cfg.checkpoint_every - s % cfg.checkpoint_every
            chunk = min(chunk, to_ckpt)
        accum = launch(accum, jnp.uint32(s), chunk)
        s += chunk
        if cfg.log_every and (s % cfg.log_every < chunk or s == cfg.spp):
            # reference heartbeat "at Sample: N" (`OptixView.cpp:159-161`)
            accum.block_until_ready()
            rate = (s - start) / max(time.time() - t0, 1e-9)
            print(f"at Sample: {s}/{cfg.spp} ({rate:.2f} spp/s)",
                  flush=True)
        if cfg.checkpoint and s % cfg.checkpoint_every == 0 and s < cfg.spp:
            save_checkpoint(cfg.checkpoint, accum, s)

    img = np.asarray(accum)
    if cfg.checkpoint:
        save_checkpoint(cfg.checkpoint, accum, cfg.spp)
    if cfg.out_exr:
        write_exr(cfg.out_exr, img)  # linear, like the reference's EXR
    if cfg.out_png:
        write_png(cfg.out_png, img, cfg.tonemap)
    if cfg.out_bmp:
        write_bmp(cfg.out_bmp, img, cfg.tonemap)
    return img
