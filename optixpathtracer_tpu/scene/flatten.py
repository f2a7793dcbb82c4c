"""Flatten a host Model into one device-resident SoA pytree (SceneData).

Replacement for the reference's BuildAccel + BuildSBT design
(`OptixRenderer.cpp:306-374,486-560`): instead of per-mesh device pointers in
SBT records, everything lives in ONE flat index space - concatenated
pre-transformed world-space triangles, a per-triangle material id, a material
table, and a uniform-resolution texture array - so the wavefront kernels index
with plain gathers and XLA sees static shapes.

Triangles are stored in Moller-Trumbore form (v0, e1, e2) plus per-corner
shading normals/uvs. The skip-link BVH (scene/bvh.py) is built over the
*reordered* triangles so leaf ranges are contiguous.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from ..bsdf.dispatch import MATERIAL_NAMES
from . import bvh as bvh_mod
from .types import Model, PointLight

TEXTURE_RES = 256  # uniform texture array resolution (bilinear-resampled)
PAD_MULTIPLE = 8   # pad triangle count so wavefront gathers stay aligned


class SceneData(NamedTuple):
    """Device-side scene: the analog of the reference's LaunchParams +
    GAS + SBT + texture objects, as one jit-able pytree.

    Differentiable leaves: mat_albedo, mat_metallic, mat_roughness, mat_ior
    (and the geometry, through the intersection refinement)."""
    # geometry (world space, padded to PAD_MULTIPLE)
    tri_v0: jnp.ndarray      # [T, 3]
    tri_e1: jnp.ndarray      # [T, 3] v1 - v0
    tri_e2: jnp.ndarray      # [T, 3] v2 - v0
    tri_normals: jnp.ndarray  # [T, 3, 3] per-corner shading normals
    tri_uvs: jnp.ndarray     # [T, 3, 2]
    tri_mat: jnp.ndarray     # [T] int32 material id
    tri_valid: jnp.ndarray   # [T] bool (False for padding)
    # material table
    mat_albedo: jnp.ndarray    # [M, 3]
    mat_metallic: jnp.ndarray  # [M]
    mat_roughness: jnp.ndarray  # [M]
    mat_ior: jnp.ndarray       # [M]
    mat_type: jnp.ndarray      # [M] int32
    mat_albedo_tex: jnp.ndarray  # [M] int32, -1 = none
    mat_mr_tex: jnp.ndarray      # [M] int32
    mat_normal_tex: jnp.ndarray  # [M] int32
    # textures (uniform res, raw [0,1] values - decode after filtering)
    textures: jnp.ndarray    # [K, R, R, 4]
    # lights
    light_pos: jnp.ndarray    # [L, 3]
    light_color: jnp.ndarray  # [L, 3]
    # BVH (skip-link layout, scene/bvh.py)
    bvh_min: jnp.ndarray     # [N, 3]
    bvh_max: jnp.ndarray     # [N, 3]
    bvh_skip: jnp.ndarray    # [N] int32
    bvh_first: jnp.ndarray   # [N] int32
    bvh_count: jnp.ndarray   # [N] int32
    # Opaque/cutout scene split (integrate/cutout.py occlusion fast path):
    # sub-SceneDatas over just the opaque / just the cutout-capable
    # triangles. Shadow queries then run a plain any-hit on the opaque
    # part plus a closest-hit cutout chain on the (small) cutout part,
    # instead of up to 5 closest-hit chains over the full scene. None
    # when the scene has no cutout texels or either side is empty;
    # booleans only - triangle ids from these never reach shading.
    opaque_scene: object = None
    cutout_sub: object = None
    # provenance: output slot -> pre-BVH concatenated-model triangle index
    # (-1 for padding); lets sub-scene hits be mapped back to outer ids
    tri_src: object = None
    # sub-scenes only: output slot -> OUTER scene post-BVH triangle id
    tri_outer_id: object = None

    @property
    def num_triangles(self):
        return self.tri_v0.shape[0]

    @property
    def num_lights(self):
        return self.light_pos.shape[0]


def scene_active_lobes(scene: "SceneData"):
    """The static tuple of BSDF lobe ids actually present in the scene's
    material table (METALLIC_MIX resolves to conductor or layered at
    runtime, so it activates both). Passed as a static arg so the compiled
    wavefront only ever evaluates lobes the scene can reach."""
    from ..bsdf import dispatch as _d
    types = set(int(t) for t in np.asarray(scene.mat_type))
    lobes = set()
    for t in types:
        if t == _d.METALLIC_MIX:
            lobes.update((_d.CONDUCTOR, _d.GLOSSY_DIFFUSE))
        else:
            lobes.add(t)
    return tuple(sorted(lobes))


def scene_uses_textures(scene: "SceneData") -> bool:
    """Static: does any material reference a texture? False lets the
    compiled wavefront drop every texture gather."""
    return bool((np.asarray(scene.mat_albedo_tex) >= 0).any()
                or (np.asarray(scene.mat_mr_tex) >= 0).any()
                or (np.asarray(scene.mat_normal_tex) >= 0).any())


def scene_flat_shading(scene: "SceneData") -> bool:
    """Static: do the vertex normals equal the geometric normal on every
    real triangle (flat-shaded scene)? True lets the wavefront skip the
    9-float/lane corner-normal gather + interpolation."""
    valid = np.asarray(scene.tri_valid)
    e1 = np.asarray(scene.tri_e1)[valid]
    e2 = np.asarray(scene.tri_e2)[valid]
    n = np.asarray(scene.tri_normals)[valid]  # [T, 3 corners, 3]
    g = np.cross(e1, e2)
    g = g / np.maximum(np.linalg.norm(g, axis=-1, keepdims=True), 1e-20)
    return bool(np.all(np.abs(n - g[:, None, :]) < 1e-5))


def _bilinear_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] triangle-filter resampling matrix, widened by the
    scale when shrinking (the antialiased bilinear of common image
    libraries: pixel centres at i + 0.5, rows normalised to 1)."""
    scale = n_in / n_out
    stretch = max(scale, 1.0)
    centre = (np.arange(n_out) + 0.5) * scale
    x = np.arange(n_in) + 0.5
    w = np.maximum(0.0, 1.0 - np.abs(x[None, :] - centre[:, None]) / stretch)
    return w / w.sum(axis=1, keepdims=True)


def _resize_texture(pixels: np.ndarray, res: int) -> np.ndarray:
    """Bilinear resample [H, W, 4] -> [res, res, 4] (rows after columns)."""
    if pixels.shape[0] == res and pixels.shape[1] == res:
        return pixels.astype(np.float32)
    wx = _bilinear_weights(pixels.shape[1], res)
    wy = _bilinear_weights(pixels.shape[0], res)
    cols = np.einsum("xw,hwc->hxc", wx, pixels.astype(np.float64))
    cols = cols.astype(np.float32).astype(np.float64)
    return np.einsum("yh,hxc->yxc", wy, cols).astype(np.float32)


def _mat_is_cutout_capable(mat, textures, texture_res) -> bool:
    """Does this material's albedo texture contain decoded alpha < 0.9?
    (the anyhit-cutout trigger, `devicePrograms.cu:534,543`)."""
    if mat.albedo_texture < 0 or mat.albedo_texture >= len(textures):
        return False
    alpha = np.asarray(textures[mat.albedo_texture].pixels)[..., 3]
    decoded = np.where(alpha <= 0.04045, alpha / 12.92,
                       ((alpha + 0.055) / 1.055) ** 2.4)
    return bool((decoded < 0.9).any())


def flatten_model(model: Model, lights=None, texture_res: int = TEXTURE_RES,
                  build_bvh: bool = True,
                  _split_cutout: bool = True) -> SceneData:
    """Bake a Model + lights into SceneData."""
    v0s, v1s, v2s, n_list, uv_list, mat_ids = [], [], [], [], [], []
    mats = []

    for mesh in model.meshes:
        m = mesh.model_matrix()
        pos = mesh.positions.astype(np.float64) @ m[:3, :3].T + m[:3, 3]
        if mesh.normals is not None:
            # normals transform: rotation*scale part applied then normalized
            # (reference transforms by the model matrix with w=0 and
            # normalizes, `devicePrograms.cu:100`)
            nrm = mesh.normals.astype(np.float64) @ m[:3, :3].T
            nlen = np.linalg.norm(nrm, axis=-1, keepdims=True)
            nrm = nrm / np.maximum(nlen, 1e-20)
        else:
            nrm = None
        idx = mesh.indices.astype(np.int64)
        tv0, tv1, tv2 = pos[idx[:, 0]], pos[idx[:, 1]], pos[idx[:, 2]]
        v0s.append(tv0)
        v1s.append(tv1)
        v2s.append(tv2)
        if nrm is not None:
            n_list.append(np.stack([nrm[idx[:, 0]], nrm[idx[:, 1]],
                                    nrm[idx[:, 2]]], axis=1))
        else:
            # fall back to the geometric normal at every corner
            gn = np.cross(tv1 - tv0, tv2 - tv0)
            gn = gn / np.maximum(np.linalg.norm(gn, axis=-1, keepdims=True),
                                 1e-20)
            n_list.append(np.stack([gn, gn, gn], axis=1))
        if mesh.uvs is not None:
            uv = mesh.uvs.astype(np.float64)
            uv_list.append(np.stack([uv[idx[:, 0]], uv[idx[:, 1]],
                                     uv[idx[:, 2]]], axis=1))
        else:
            uv_list.append(np.zeros((len(idx), 3, 2)))
        mat_ids.append(np.full(len(idx), len(mats), np.int64))
        mats.append(mesh.material)

    v0 = np.concatenate(v0s).astype(np.float32)
    v1 = np.concatenate(v1s).astype(np.float32)
    v2 = np.concatenate(v2s).astype(np.float32)
    normals = np.concatenate(n_list).astype(np.float32)
    uvs = np.concatenate(uv_list).astype(np.float32)
    tri_mat = np.concatenate(mat_ids).astype(np.int32)
    t_real = len(v0)

    # --- BVH over real triangles, then reorder attributes to match leaves
    if build_bvh:
        tree = bvh_mod.build_bvh(v0, v1, v2)
        order = tree.tri_order
        tri_src_np = np.asarray(order, np.int32)
        v0, v1, v2 = v0[order], v1[order], v2[order]
        normals, uvs, tri_mat = normals[order], uvs[order], tri_mat[order]
        bvh_arrays = (tree.node_min, tree.node_max, tree.node_skip,
                      tree.node_first, tree.node_count)
    else:
        bvh_arrays = (np.zeros((1, 3), np.float32), np.zeros((1, 3), np.float32),
                      np.ones(1, np.int32), np.zeros(1, np.int32),
                      np.zeros(1, np.int32))
        tri_src_np = np.arange(t_real, dtype=np.int32)

    # --- pad to multiple (degenerate far-away triangles never hit)
    t_pad = -(-t_real // PAD_MULTIPLE) * PAD_MULTIPLE
    pad = t_pad - t_real

    def _pad(a, fill=0.0):
        return np.concatenate(
            [a, np.full((pad,) + a.shape[1:], fill, a.dtype)]) if pad else a

    e1 = _pad(v1 - v0, 0.0)
    e2 = _pad(v2 - v0, 0.0)
    v0 = _pad(v0, 1e10)
    normals = _pad(normals, 0.0)
    uvs = _pad(uvs, 0.0)
    tri_mat = _pad(tri_mat, 0)
    tri_valid = np.concatenate(
        [np.ones(t_real, bool), np.zeros(pad, bool)])

    # --- material table
    m = len(mats)
    mat_albedo = np.stack([mt.base_color for mt in mats]).astype(np.float32)
    mat_metallic = np.array([mt.metallic for mt in mats], np.float32)
    mat_roughness = np.array([mt.roughness for mt in mats], np.float32)
    mat_ior = np.array([mt.ior for mt in mats], np.float32)
    mat_type = np.array([MATERIAL_NAMES[mt.mat_type] for mt in mats],
                        np.int32)
    mat_albedo_tex = np.array([mt.albedo_texture for mt in mats], np.int32)
    mat_mr_tex = np.array([mt.metal_rough_texture for mt in mats], np.int32)
    mat_normal_tex = np.array([mt.normal_texture for mt in mats], np.int32)

    # --- textures
    if model.textures:
        tex = np.stack([_resize_texture(t.pixels, texture_res)
                        for t in model.textures])
    else:
        tex = np.zeros((1, texture_res, texture_res, 4), np.float32)

    # --- lights
    lights = lights or []
    if lights:
        light_pos = np.stack([np.asarray(l.position, np.float32)
                              for l in lights])
        light_color = np.stack([np.asarray(l.color, np.float32)
                                for l in lights])
    else:
        light_pos = np.zeros((0, 3), np.float32)
        light_color = np.zeros((0, 3), np.float32)

    # --- opaque/cutout scene split for the occlusion + closest fast paths
    opaque_scene = cutout_sub = None
    if _split_cutout and build_bvh and model.textures:
        cut_flags = [_mat_is_cutout_capable(m.material, model.textures,
                                            texture_res)
                     for m in model.meshes]
        cut_meshes = [m for m, f in zip(model.meshes, cut_flags) if f]
        opq_meshes = [m for m, f in zip(model.meshes, cut_flags) if not f]
        if cut_meshes and opq_meshes:
            # pre-BVH triangle index ranges of each mesh in the OUTER
            # concat order, for mapping sub-scene hits to outer ids
            mesh_tris = [len(m.indices) for m in model.meshes]
            starts = np.concatenate([[0], np.cumsum(mesh_tris)[:-1]])
            outer_pre_to_post = np.full(t_real, -1, np.int32)
            outer_pre_to_post[tri_src_np] = np.arange(t_real, dtype=np.int32)

            def _sub(meshes, flags_sel):
                sub = flatten_model(
                    Model(meshes=meshes, textures=model.textures), [],
                    texture_res, build_bvh, _split_cutout=False)
                pre_map = np.concatenate(
                    [np.arange(starts[i], starts[i] + mesh_tris[i],
                               dtype=np.int32)
                     for i, f in enumerate(cut_flags) if f == flags_sel]
                ) if meshes else np.zeros(0, np.int32)
                src = np.asarray(sub.tri_src)
                outer_id = np.full(len(src), -1, np.int32)
                valid = src >= 0
                outer_id[valid] = outer_pre_to_post[pre_map[src[valid]]]
                return sub._replace(tri_outer_id=jnp.asarray(outer_id))

            opaque_scene = _sub(opq_meshes, False)
            cutout_sub = _sub(cut_meshes, True)

    tri_src_pad = np.concatenate(
        [tri_src_np, np.full(pad, -1, np.int32)]) if pad else tri_src_np

    return SceneData(
        opaque_scene=opaque_scene,
        cutout_sub=cutout_sub,
        tri_src=jnp.asarray(tri_src_pad),
        tri_v0=jnp.asarray(v0), tri_e1=jnp.asarray(e1), tri_e2=jnp.asarray(e2),
        tri_normals=jnp.asarray(normals), tri_uvs=jnp.asarray(uvs),
        tri_mat=jnp.asarray(tri_mat), tri_valid=jnp.asarray(tri_valid),
        mat_albedo=jnp.asarray(mat_albedo),
        mat_metallic=jnp.asarray(mat_metallic),
        mat_roughness=jnp.asarray(mat_roughness),
        mat_ior=jnp.asarray(mat_ior),
        mat_type=jnp.asarray(mat_type),
        mat_albedo_tex=jnp.asarray(mat_albedo_tex),
        mat_mr_tex=jnp.asarray(mat_mr_tex),
        mat_normal_tex=jnp.asarray(mat_normal_tex),
        textures=jnp.asarray(tex),
        light_pos=jnp.asarray(light_pos),
        light_color=jnp.asarray(light_color),
        bvh_min=jnp.asarray(bvh_arrays[0]),
        bvh_max=jnp.asarray(bvh_arrays[1]),
        bvh_skip=jnp.asarray(bvh_arrays[2]),
        bvh_first=jnp.asarray(bvh_arrays[3]),
        bvh_count=jnp.asarray(bvh_arrays[4]),
    )
