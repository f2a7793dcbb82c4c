"""Differentiable scene replay for the material-test golden scenes.

The reference never shipped the glTF asset behind its five README scenes
(`main.cpp:7` "assets/Models/TestScenes/1/untitled.gltf"); the repo
reconstructs them procedurally (scene/procedural.py GOLDEN_GEO) and fits
the free parameters against the shipped golden renders. Round 4 fitted
albedos only; this module makes EVERYTHING the golden depends on reachable
by the same differentiable-render Adam loop (VERDICT r4 item 2):

  * geometry - sphere radius / grid spacing, wall positions. Every vertex
    of the scene is an AFFINE function of these five scalars, so the
    per-parameter vertex Jacobians are computed EXACTLY by single-step
    finite differences of the host builder, and `scene_with` rebuilds
    tri_v0/e1/e2 as jnp functions of the parameters (gradients flow
    through intersect/api._refine - hit ids detach, hit params don't).
  * camera - position / Euler rotation / fov, through a jnp twin of the
    lookAt/perspective inverse-matrix raygen (`devicePrograms.cu:601-623`).
  * lights - per-light position deltas + a shared intensity scale
    (`LightMethods.h:21-23` radiometry).
  * materials - grouped albedos (spheres / back+floor+ceiling / green /
    blue, through sigmoid), wall roughness.

Use with intersect method='brute': it reads tri_v0/e1/e2 directly, so
replayed geometry has NO stale acceleration structure (the BVH engines
walk flatten-time boxes and would).
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

GEO_KEYS = ("radius", "spacing", "back_x", "floor_y", "ceil_y",
            "grid_y", "grid_z")

# material-table group of each mesh in scene_material_test order:
# 36 spheres, then [back, green, blue, floor, ceiling] walls
N_SPHERES = 36
GROUPS = ("sphere", "back", "green", "blue")
_WALL_GROUP = [1, 2, 3, 1, 1]


def _concat_world_verts(model):
    """All mesh vertices, world space, concatenated in mesh order."""
    out = []
    for mesh in model.meshes:
        m = mesh.model_matrix()
        out.append(mesh.positions.astype(np.float64) @ m[:3, :3].T
                   + m[:3, 3])
    return np.concatenate(out).astype(np.float32)


class MaterialTestReplay:
    """Replays scene_material_test geometry/camera/lights/materials as jnp
    functions of a parameter pytree (see `init_params`)."""

    def __init__(self, kind: str, segments=(12, 24), geo: dict = None):
        from ..scene import flatten_model
        from ..scene.procedural import (GOLDEN_FIT, GOLDEN_GEO,
                                        scene_material_test)

        self.kind = kind
        self.segments = segments
        self.geo0 = dict(GOLDEN_GEO)
        self.geo0.update(GOLDEN_FIT.get(kind, {}))
        if geo:
            self.geo0.update(geo)

        model, camera, lights = scene_material_test(kind, self.geo0,
                                                    segments)
        self.camera0 = camera
        self.scene0 = flatten_model(model, lights)
        base = _concat_world_verts(model)
        self.base_verts = jnp.asarray(base)

        # exact affine Jacobians: vertex positions are affine in each geo
        # scalar, so a single +1 step recovers d(verts)/d(param) exactly
        jac = []
        for k in GEO_KEYS:
            g2 = dict(self.geo0)
            g2[k] = g2[k] + 1.0
            m2, _, _ = scene_material_test(kind, g2, segments)
            jac.append(_concat_world_verts(m2) - base)
        self.jac = jnp.asarray(np.stack(jac))          # [P, V, 3]

        # triangle corner -> concat vertex index, pre-BVH concat order
        tri_idx, off = [], 0
        for mesh in model.meshes:
            tri_idx.append(mesh.indices.astype(np.int64) + off)
            off += len(mesh.positions)
        self.tri_idx = jnp.asarray(np.concatenate(tri_idx))  # [T_real, 3]
        self.tri_src = self.scene0.tri_src                   # [T_pad]

        # material-table group map (flatten keeps mesh order)
        self.group_map = jnp.asarray(
            np.array([0] * N_SPHERES + _WALL_GROUP, np.int32))
        self.is_wall = jnp.asarray(
            np.array([False] * N_SPHERES + [True] * 5))

    def init_params(self):
        from ..core.math import vec3  # noqa: F401  (doc pointer)
        s = self.scene0
        a0 = np.zeros((len(GROUPS), 3), np.float32)
        alb = np.asarray(s.mat_albedo)
        a0[0] = alb[:N_SPHERES].mean(axis=0)
        a0[1] = alb[[N_SPHERES, N_SPHERES + 3, N_SPHERES + 4]].mean(axis=0)
        a0[2] = alb[N_SPHERES + 1]
        a0[3] = alb[N_SPHERES + 2]
        a0 = np.clip(a0, 1e-3, 1 - 1e-3)
        wr = float(np.clip(self.geo0["wall_rough"], 1e-3, 1 - 1e-3))
        return {
            "alb_logits": jnp.asarray(np.log(a0 / (1 - a0))),
            "wall_rough_logit": jnp.asarray(np.log(wr / (1 - wr))),
            "geo": jnp.asarray([self.geo0[k] for k in GEO_KEYS],
                               jnp.float32),
            "cam_pos": jnp.asarray(self.camera0.position, jnp.float32),
            "cam_rot": jnp.asarray(self.camera0.rotation, jnp.float32),
            "fov": jnp.asarray(self.camera0.fov_degrees, jnp.float32),
            "light_dpos": jnp.zeros((self.scene0.light_pos.shape[0], 3),
                                    jnp.float32),
            "light_logi": jnp.asarray(
                np.log(float(np.asarray(s.light_color)[0, 0])), jnp.float32),
        }

    def scene_with(self, params):
        """scene0 with geometry/material/light leaves replayed from
        params (all differentiable)."""
        s = self.scene0
        geo0 = jnp.asarray([self.geo0[k] for k in GEO_KEYS], jnp.float32)
        delta = params["geo"] - geo0
        # HIGHEST: TF32 on a GPU would round the vertex offsets
        verts = self.base_verts + jnp.einsum(
            "p,pvk->vk", delta, self.jac,
            precision=jax.lax.Precision.HIGHEST)
        tri = verts[self.tri_idx]                       # [T_real, 3, 3]
        src = self.tri_src
        safe = jnp.maximum(src, 0)
        v = tri[safe]                                   # [T_pad, 3, 3]
        padded = (src < 0)[:, None]
        v0 = jnp.where(padded, 1e10, v[:, 0])
        e1 = jnp.where(padded, 0.0, v[:, 1] - v[:, 0])
        e2 = jnp.where(padded, 0.0, v[:, 2] - v[:, 0])

        albedo = jnp.clip(1.0 / (1.0 + jnp.exp(-params["alb_logits"])),
                          1e-4, 1.0)
        mat_albedo = albedo[self.group_map]
        wall_rough = 1.0 / (1.0 + jnp.exp(-params["wall_rough_logit"]))
        mat_rough = jnp.where(self.is_wall, wall_rough, s.mat_roughness)

        light_pos = s.light_pos + params["light_dpos"]
        light_color = (jnp.exp(params["light_logi"])
                       * jnp.ones_like(s.light_color))
        return s._replace(tri_v0=v0, tri_e1=e1, tri_e2=e2,
                          mat_albedo=mat_albedo, mat_roughness=mat_rough,
                          light_pos=light_pos, light_color=light_color)

    def raygen_with(self, params, width: int, height: int):
        """(position, inv_view, inv_proj) as differentiable jnp arrays -
        the jnp twin of Camera.raygen_params (lookAt rows / analytic
        perspective inverse; fovy-as-vertical quirk preserved)."""
        pos = params["cam_pos"]
        r = jnp.radians(params["cam_rot"])
        f = jnp.stack([jnp.sin(r[1]) * jnp.cos(r[0]), -jnp.sin(r[0]),
                       jnp.cos(r[0]) * jnp.cos(r[1])])
        f = f / jnp.linalg.norm(f)
        up = jnp.asarray(self.camera0.world_up, jnp.float32)
        s_ = jnp.cross(f, up)
        s_ = s_ / jnp.linalg.norm(s_)
        u = jnp.cross(s_, f)
        # inverse of the rigid lookAt: columns (s, u, -f), translation eye
        inv_view = jnp.zeros((4, 4), jnp.float32)
        inv_view = inv_view.at[:3, 0].set(s_).at[:3, 1].set(u)
        inv_view = inv_view.at[:3, 2].set(-f).at[:3, 3].set(pos)
        inv_view = inv_view.at[3, 3].set(1.0)

        t = jnp.tan(jnp.radians(params["fov"]) / 2.0)
        aspect = width / height
        near, far = self.camera0.near, self.camera0.far
        m22 = -(far + near) / (far - near)
        m23 = -2.0 * far * near / (far - near)
        inv_proj = jnp.zeros((4, 4), jnp.float32)
        inv_proj = inv_proj.at[0, 0].set(aspect * t).at[1, 1].set(t)
        inv_proj = inv_proj.at[2, 3].set(-1.0)
        inv_proj = inv_proj.at[3, 2].set(1.0 / m23)
        inv_proj = inv_proj.at[3, 3].set(m22 / m23)
        return pos, inv_view, inv_proj

    def fitted_geo(self, params):
        """Host-side dict of fitted values in scene_material_test terms
        (paste into procedural.GOLDEN_FIT)."""
        albedo = np.asarray(
            1.0 / (1.0 + np.exp(-np.asarray(params["alb_logits"]))))
        geo = {k: round(float(v), 5)
               for k, v in zip(GEO_KEYS, np.asarray(params["geo"]))}
        geo.update(
            sphere_rgb=albedo[0].round(4).tolist(),
            back_rgb=albedo[1].round(4).tolist(),
            green_rgb=albedo[2].round(4).tolist(),
            blue_rgb=albedo[3].round(4).tolist(),
            wall_rough=round(float(
                1.0 / (1.0 + np.exp(-float(params["wall_rough_logit"])))),
                4),
            cam_pos=np.asarray(params["cam_pos"]).round(5).tolist(),
            cam_rot=np.asarray(params["cam_rot"]).round(4).tolist(),
            fov=round(float(params["fov"]), 4),
            light_dpos=np.asarray(params["light_dpos"]).round(4).tolist(),
            light_scale=round(float(np.exp(params["light_logi"])), 4),
        )
        return geo
