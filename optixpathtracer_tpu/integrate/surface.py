"""Hit -> shading context: normals, frames, textures, material resolution.

JAX equivalent of the reference closest-hit preamble
(`devicePrograms.cu:343-424`): barycentric attribute interpolation,
face-forwarded geometric/shading normals with the backface outward flip,
texture modulation (albedo sRGB decode, metal/rough channels, normal map),
the stochastic conductor lobe pick, and the shading-space frame.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..bsdf.dispatch import MaterialParams, resolve_stochastic_lobe
from ..core.math import (build_tangent_space, cross, dot, normalize,
                         to_local, to_world)
from ..scene.textures import sample_bilinear, srgb_to_linear


class Surface(NamedTuple):
    """Per-lane hit-point bundle (reference `Surface.h:5-21`), SoA over the
    wavefront. Frames are stored as (tangent, bitangent, normal) triplets."""
    position: jnp.ndarray   # [R, 3] world
    g_normal: jnp.ndarray   # [R, 3] geometric normal (outward convention)
    s_normal: jnp.ndarray   # [R, 3] shading normal
    tangent: jnp.ndarray    # [R, 3]
    bitangent: jnp.ndarray  # [R, 3]
    wo_local: jnp.ndarray   # [R, 3] outgoing dir in shading space
    uv: jnp.ndarray         # [R, 2]
    mat: MaterialParams     # resolved per-lane material

    def to_world(self, v_local):
        return to_world(self.tangent, self.bitangent, self.s_normal, v_local)

    def to_local(self, v_world):
        return to_local(self.tangent, self.bitangent, self.s_normal, v_world)


def make_surface(seed, scene, o, d, hit, reference_compat: bool = False,
                 use_textures: bool = True, flat_shading: bool = False):
    """Build the shading context for every lane (misses produce garbage that
    callers mask with hit.hit). Returns (seed, Surface).

    use_textures=False (static) skips every texture gather - flatten-time
    analysis (scene_uses_textures) sets it so untextured scenes never pay
    the bilinear fetch (4 dynamic gathers x 3 maps per lane). It also skips
    the per-corner UV gather (6 floats/lane).

    flat_shading=True (static, from scene_flat_shading) marks scenes whose
    vertex normals all equal the geometric normal: the 9-float/lane corner
    normal gather and interpolation collapse to the already-computed cross
    product.

    reference_compat=True reproduces two reference bugs (SURVEY.md quirks):
    metallic read from the texture R channel instead of glTF-spec B
    (`devicePrograms.cu:163`), and the metal-rough/normal has-flags populated
    from HasAlbedoTex (`OptixRenderer.cpp:535,540`).
    """
    safe_id = jnp.maximum(hit.tri_id, 0)
    v0 = scene.tri_v0[safe_id]
    e1 = scene.tri_e1[safe_id]
    e2 = scene.tri_e2[safe_id]
    mat_id = scene.tri_mat[safe_id]

    u = hit.u[..., None]
    v = hit.v[..., None]
    w0 = 1.0 - u - v

    wo = normalize(-d)
    position = v0 + u * e1 + v * e2
    if use_textures:
        tri_uv = scene.tri_uvs[safe_id]      # [R, 3, 2]
        uv = w0 * tri_uv[:, 0] + u * tri_uv[:, 1] + v * tri_uv[:, 2]
    else:
        uv = jnp.zeros(position.shape[:-1] + (2,), jnp.float32)

    # Geometric normal, face-forwarded to the outgoing direction
    # (`devicePrograms.cu:92,107-108`).
    ng = normalize(cross(e1, e2))
    ng = jnp.where(dot(wo, ng)[..., None] < 0.0, -ng, ng)

    if flat_shading:
        # Vertex normals == geometric normals everywhere (static scene
        # fact): the interpolation below would reproduce ng exactly.
        ns = ng
    else:
        # Shading normal from interpolated vertex normals, flipped into
        # ng's hemisphere (`devicePrograms.cu:96-113`).
        tri_n = scene.tri_normals[safe_id]   # [R, 3, 3]
        ns = normalize(w0 * tri_n[:, 0] + u * tri_n[:, 1] + v * tri_n[:, 2])
        no_ns = jnp.sum(jnp.abs(ns), axis=-1, keepdims=True) < 1e-12
        ns = jnp.where(no_ns, ng, ns)
        ns = jnp.where(dot(ng, ns)[..., None] < 0.0, -ns, ns)
        ns = normalize(ns)

    # Backface hits flip both normals outward (`devicePrograms.cu:379-382`).
    back = hit.back_face[..., None]
    ng = jnp.where(back, -ng, ng)
    ns = jnp.where(back, -ns, ns)

    # --- material + textures (`devicePrograms.cu:143-166,390-409`)
    albedo = scene.mat_albedo[mat_id]
    metallic = scene.mat_metallic[mat_id]
    roughness = scene.mat_roughness[mat_id]
    ior = scene.mat_ior[mat_id]
    mat_type = scene.mat_type[mat_id]

    albedo_tex = scene.mat_albedo_tex[mat_id]
    if reference_compat:
        # reference SBT bug: all has-flags keyed off the albedo texture
        mr_tex = jnp.where(albedo_tex >= 0, scene.mat_mr_tex[mat_id], -1)
        nrm_tex = jnp.where(albedo_tex >= 0, scene.mat_normal_tex[mat_id], -1)
    else:
        mr_tex = scene.mat_mr_tex[mat_id]
        nrm_tex = scene.mat_normal_tex[mat_id]

    if use_textures:
        has_albedo = albedo_tex >= 0
        tex_a = sample_bilinear(scene.textures, albedo_tex,
                                uv[..., 0], uv[..., 1])
        tex_a = srgb_to_linear(tex_a)
        albedo = jnp.where(has_albedo[..., None], albedo * tex_a[..., :3],
                           albedo)

        has_mr = mr_tex >= 0
        tex_mr = sample_bilinear(scene.textures, mr_tex,
                                 uv[..., 0], uv[..., 1])
        if reference_compat:
            # reference reads metallic from R (`devicePrograms.cu:163`)
            metallic = jnp.where(has_mr, tex_mr[..., 0], metallic)
        else:
            # glTF spec: metallic = B, scaled by the factor
            metallic = jnp.where(has_mr, metallic * tex_mr[..., 2], metallic)
        rough_from_tex = tex_mr[..., 1] if reference_compat \
            else roughness * tex_mr[..., 1]
        roughness = jnp.where(has_mr, rough_from_tex, roughness)

        # Normal mapping via an on-the-fly tangent frame from the shading
        # normal (`devicePrograms.cu:168-212,403-409`; the reference
        # deliberately ignores the mesh tangents).
        has_nrm = nrm_tex >= 0
        tex_n = sample_bilinear(scene.textures, nrm_tex,
                                uv[..., 0], uv[..., 1])
        t0, b0 = build_tangent_space(ns)
        mapped = normalize(to_world(t0, b0, ns, tex_n[..., :3] * 2.0 - 1.0))
        ns = jnp.where(has_nrm[..., None], mapped, ns)

    # Final shading frame (`devicePrograms.cu:412-416`).
    tangent, bitangent = build_tangent_space(ns)
    wo_local = to_local(tangent, bitangent, ns, wo)

    mat = MaterialParams(albedo=albedo, metallic=metallic,
                         roughness=roughness, ior=ior,
                         mat_type=mat_type)
    # Stochastic conductor-vs-layered pick for METALLIC_MIX lanes
    # (`devicePrograms.cu:400`), one draw per hit.
    seed, mat = resolve_stochastic_lobe(seed, mat)

    return seed, Surface(position=position, g_normal=ng, s_normal=ns,
                         tangent=tangent, bitangent=bitangent,
                         wo_local=wo_local, uv=uv, mat=mat)
