"""Multi-chip rendering: pixel-tile sharding over a device mesh.

The reference is strictly single-GPU (device 0 hard-coded,
`OptixRenderer.cpp:68-71`; SURVEY.md section 2.5). This module is the
scaling design it lacks:

* a flat 1-D `Mesh` over all devices with axis "tiles" (every card of a
  host reaches every other over NVLink at one rate, so no device order is
  better than another),
* forward: `shard_map` splits the image into contiguous row blocks, one per
  device; each renders its rows independently (zero communication until
  the film gather, which is just the sharded output layout),
* backward: `shard_map` is differentiable - transposing the replicated
  scene -> sharded image computation automatically inserts the psum that
  all-reduces material-parameter gradients across devices,
* multi-host: the same code runs under `jax.distributed.initialize`; the
  mesh then spans hosts and XLA routes the same collectives between them.

Rendering is embarrassingly parallel over pixels, so scaling efficiency is
bounded by compile-time constants, the gradient psum, and stragglers - the
>85% 1->2 host target (BASELINE.md) is the check on that.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..core import rng
from ..integrate.path import trace_paths
from ..camera.camera import generate_rays


def make_mesh(n_devices: int | None = None, axis: str = "tiles") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    import numpy as np
    return Mesh(np.array(devs), (axis,))


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None) -> bool:
    """Multi-host entry point: wire `jax.distributed.initialize` so the mesh
    spans hosts and the same collectives ride DCN (SURVEY.md section 5.8 -
    the comm backend the reference never had, `OptixRenderer.cpp:69-71`).

    With no arguments, initializes only when the environment indicates a
    multi-process launch (JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES, or a
    SLURM job); single-process runs are a no-op.
    Returns True if distributed mode is active.
    """
    import os
    explicit = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    auto_env = any(os.environ.get(k) for k in
                   ("JAX_NUM_PROCESSES", "SLURM_JOB_NUM_NODES"))
    if not (explicit or auto_env or num_processes):
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id)
    return jax.process_count() > 1


def render_rows(scene, cam_position, cam_inv_view, cam_inv_proj,
                width: int, height: int, frame_id, y0, h_local: int,
                max_bounces: int = 2, intersect_method: str = "auto",
                active_lobes=None, reference_compat: bool = False,
                use_textures: bool = True, use_alpha_cutout: bool = False,
                flat_shading: bool = False):
    """Render pixel rows [y0, y0 + h_local) of the full height x width frame,
    bit-deterministically from (scene, camera, frame_id, y0).

    This is both the per-shard body of `render_sample_sharded` AND the
    lost-shard recovery primitive (SURVEY.md section 5.3): rendering is a
    pure function, so any tile is recomputable from its coordinates alone -
    no state to salvage from a failed worker.
    """
    if active_lobes is None:
        from ..scene.flatten import scene_active_lobes
        active_lobes = scene_active_lobes(scene)
    ys_local = jnp.arange(h_local, dtype=jnp.float32)[:, None]
    xs = jnp.arange(width, dtype=jnp.float32)[None, :]
    py = jnp.broadcast_to(ys_local + jnp.asarray(y0, jnp.float32),
                          (h_local, width))
    px = jnp.broadcast_to(xs, (h_local, width))
    o, d = generate_rays(cam_position, cam_inv_view, cam_inv_proj,
                         width, height, px, py)
    o = o.reshape(-1, 3)
    d = d.reshape(-1, 3)
    seed = rng.pixel_seed(
        width,
        px.astype(jnp.uint32).reshape(-1),
        py.astype(jnp.uint32).reshape(-1),
        frame_id)
    radiance, _ = trace_paths(scene, o, d, seed, max_bounces,
                              intersect_method, reference_compat,
                              active_lobes, use_textures, use_alpha_cutout,
                              flat_shading=flat_shading)
    return radiance.reshape(h_local, width, 3)


def render_sample_sharded(mesh: Mesh, scene, cam_position, cam_inv_view,
                          cam_inv_proj, width: int, height: int, frame_id,
                          max_bounces: int = 2,
                          intersect_method: str = "auto",
                          active_lobes=None,
                          reference_compat: bool = False,
                          use_textures: bool = True,
                          use_alpha_cutout: bool = False,
                          flat_shading: bool = False):
    """Render one 1-spp frame with pixel rows sharded across the mesh.
    Returns [H, W, 3] (sharded over rows). height must divide by mesh size.
    """
    if active_lobes is None:
        from ..scene.flatten import scene_active_lobes
        active_lobes = scene_active_lobes(scene)
    n = mesh.devices.size
    axis = mesh.axis_names[0]
    if height % n != 0:
        raise ValueError(f"height {height} not divisible by {n} devices")
    h_local = height // n

    row_start = (jnp.arange(n, dtype=jnp.uint32) * h_local)[:, None]  # [n,1]

    # check_vma off: the body is embarrassingly parallel (no collectives);
    # the scan carries inside the intersection kernels mix unvarying scene
    # constants with tile-varying ray state, which the VMA checker rejects
    # even though the program is correct.
    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(), P(), P(), P(), P(axis)),
             out_specs=P(axis), check_vma=False)
    def _render_block(scene_rep, pos, inv_view, inv_proj, row0):
        return render_rows(scene_rep, pos, inv_view, inv_proj, width,
                           height, frame_id, row0[0, 0], h_local,
                           max_bounces, intersect_method, active_lobes,
                           reference_compat, use_textures, use_alpha_cutout,
                           flat_shading)

    return _render_block(scene, cam_position, cam_inv_view, cam_inv_proj,
                         row_start)


def material_grad_step(mesh: Mesh, scene, cam_params, target,
                       width: int, height: int, frame_id,
                       lr: float = 0.05, max_bounces: int = 2,
                       intersect_method: str = "auto",
                       active_lobes=None):
    """One inverse-rendering step: render sharded, L2 loss against `target`,
    gradient w.r.t. the material table (albedo/roughness/metallic/ior),
    SGD update. The grads are psum-reduced across chips by shard_map's
    transpose - this is the framework's "training step".

    intersect_method routes the forward intersection ('auto' picks the
    traversal kernel on the GPU for large scenes) - gradients detach
    through hit ids either way (intersect/api.py), so the kernel is safe in
    the training step.

    Returns (new_scene, loss).
    """
    pos, inv_view, inv_proj = cam_params

    diff_fields = ("mat_albedo", "mat_metallic", "mat_roughness", "mat_ior")

    def loss_fn(params):
        s = scene._replace(**params)
        img = render_sample_sharded(mesh, s, pos, inv_view, inv_proj,
                                    width, height, frame_id, max_bounces,
                                    intersect_method,
                                    active_lobes=active_lobes)
        return jnp.mean((img - target) ** 2)

    params = {f: getattr(scene, f) for f in diff_fields}
    loss, grads = jax.value_and_grad(loss_fn)(params)
    new_params = {f: params[f] - lr * grads[f] for f in diff_fields}
    new_params["mat_albedo"] = jnp.clip(new_params["mat_albedo"], 0.0, 1.0)
    new_params["mat_roughness"] = jnp.clip(new_params["mat_roughness"],
                                           0.0, 1.0)
    new_params["mat_metallic"] = jnp.clip(new_params["mat_metallic"],
                                          0.0, 1.0)
    return scene._replace(**new_params), loss
