"""Wavefront path integrator with next-event estimation.

Wavefront inversion of the reference's one-thread-per-path megakernel
(`devicePrograms.cu:625-664` SamplePath + `__closesthit__radiance`): rays,
throughput, and radiance live as SoA arrays over the whole wavefront; each
bounce is one batched pass (intersect -> shade -> NEE -> BSDF sample), with
per-lane `alive` masks replacing the reference's endPath/break control flow.
The bounce loop is statically unrolled (max_bounces is small and static, so
XLA sees one straight-line graph and fuses across stages).

Reference semantics reproduced deliberately (SURVEY.md quirk list):
  * point-light falloff color/d^2 with no 1/4pi (`LightMethods.h:21-23`)
  * light pick uniform, pdf 1/N (`LightMethods.h:25-41`)
  * NEE not MIS-weighted against BSDF sampling
  * miss -> black background, beta zeroed (`devicePrograms.cu:576-583`)
  * ray tmax = 100 world units (`devicePrograms.cu:652`)
  * kill threshold |beta| > 1e-5 (`devicePrograms.cu:646`)
  * 1e-3 geometric-normal ray offsets (`devicePrograms.cu:226,503-508`)
  * per-(pixel, frame) TEA seeding (`devicePrograms.cu:631`)
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..bsdf import dispatch
from ..camera.camera import generate_rays
from ..core import rng
from ..core.math import abs_cos_theta, dot, length, length_sqr, normalize
from ..intersect import intersect_any, intersect_closest
from ..intersect.types import Hit
from .cutout import intersect_any_cutout, intersect_closest_cutout
from .surface import make_surface

RAY_TMAX = 100.0
SHADOW_OFFSET = 1e-3
BETA_EPS = 1e-5
MORTON_BITS = 4  # per-axis origin quantization for the coherence sort


def _spread3(x):
    """Spread the low MORTON_BITS bits of x so consecutive bits land 3
    apart (for interleaved Morton codes)."""
    out = jnp.zeros_like(x)
    for b in range(MORTON_BITS):
        out = out | (((x >> b) & 1) << (3 * b))
    return out


def _coherence_sort_key(scene, o, d, alive):
    """Sort key grouping rays by direction octant within origin Morton
    cells. Secondary bounces scatter rays incoherently; re-sorting the
    wavefront each bounce puts rays that walk the same BVH nodes into the
    same traversal-kernel block (the ray-sorting stage of wavefront GPU
    path tracers). Dead lanes sort to the end, where whole blocks exit at
    once."""
    root_min, root_max = _scene_bounds(scene)
    root_ext = jnp.maximum(root_max - root_min, 1e-6)
    scale = float(1 << MORTON_BITS)
    q = jnp.clip((o - root_min) / root_ext * scale, 0.0,
                 scale - 1.0).astype(jnp.uint32)
    morton = (_spread3(q[:, 0]) | (_spread3(q[:, 1]) << 1)
              | (_spread3(q[:, 2]) << 2))
    octant = ((d[:, 0] >= 0).astype(jnp.uint32)
              | ((d[:, 1] >= 0).astype(jnp.uint32) << 1)
              | ((d[:, 2] >= 0).astype(jnp.uint32) << 2))
    key = (morton << 3) | octant
    return jnp.where(alive, key, jnp.uint32(0xFFFFFFFF))


N_CELLS = 8    # coarse origin cells (2x2x2 halves of the scene AABB)
N_BUCKETS = N_CELLS * 8 + 1  # x direction octants, +1 for dead lanes


def _scene_bounds(scene):
    if scene.bvh_min.shape[0] > 0:
        return scene.bvh_min[0], scene.bvh_max[0]
    v0 = scene.tri_v0
    v1 = v0 + scene.tri_e1
    v2 = v0 + scene.tri_e2
    ok = scene.tri_valid[:, None]
    root_min = jnp.where(ok, jnp.minimum(jnp.minimum(v0, v1), v2),
                         jnp.inf).min(axis=0)
    root_max = jnp.where(ok, jnp.maximum(jnp.maximum(v0, v1), v2),
                         -jnp.inf).max(axis=0)
    return root_min, root_max


def _perm_from_key(key, n_buckets: int):
    """Stable counting-sort permutation from integer bucket keys: one
    [R, K] one-hot cumsum instead of an O(R log R) comparison sort."""
    onehot = (key[:, None] == jnp.arange(n_buckets)[None, :]).astype(
        jnp.int32)
    inc = jnp.cumsum(onehot, axis=0)           # [R, K] inclusive ranks
    within = jnp.take_along_axis(inc, key[:, None], axis=1)[:, 0] - 1
    counts = inc[-1]
    offsets = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                               jnp.cumsum(counts)[:-1].astype(jnp.int32)])
    rank = offsets[key] + within               # destination of each lane
    r = key.shape[0]
    return jnp.zeros((r,), jnp.int32).at[rank].set(
        jnp.arange(r, dtype=jnp.int32))


def _bucket_permutation(scene, o, d, alive):
    """Counting-sort permutation over N_BUCKETS coherence buckets (origin
    2x2x2 cell x direction octant; dead lanes last): wavefront ray binning,
    so each traversal-kernel block holds spatially tight rays."""
    root_min, root_max = _scene_bounds(scene)
    mid = 0.5 * (root_min + root_max)
    cell = ((o[:, 0] >= mid[0]).astype(jnp.int32)
            | ((o[:, 1] >= mid[1]).astype(jnp.int32) << 1)
            | ((o[:, 2] >= mid[2]).astype(jnp.int32) << 2))
    octant = ((d[:, 0] >= 0).astype(jnp.int32)
              | ((d[:, 1] >= 0).astype(jnp.int32) << 1)
              | ((d[:, 2] >= 0).astype(jnp.int32) << 2))
    key = jnp.where(alive, cell * 8 + octant, N_BUCKETS - 1)
    return _perm_from_key(key, N_BUCKETS)


def _nee(seed, scene, surf, beta, alive, intersect_method, active_lobes,
         use_alpha_cutout=False):
    """Direct lighting from one uniformly-picked point light
    (`devicePrograms.cu:444-472`, `LightMethods.h`). Returns (seed, contrib).
    """
    n_lights = scene.light_pos.shape[0]
    if n_lights == 0:
        return seed, jnp.zeros_like(beta)

    if n_lights == 1:
        light_idx = jnp.zeros(beta.shape[0], jnp.int32)
        p_light = 1.0
    else:
        seed, u = rng.rnd(seed)
        light_idx = jnp.minimum((u * n_lights).astype(jnp.int32),
                                n_lights - 1)
        p_light = 1.0 / n_lights

    lp = scene.light_pos[light_idx]
    lc = scene.light_color[light_idx]

    to_light = lp - surf.position
    dist = length(to_light)
    wl = normalize(to_light)

    # Shadow ray: offset along the geometric normal toward the LIGHT's side
    # (`devicePrograms.cu:216-241` offsets along its ray-facing flipped
    # normal; ours keeps true winding orientation, so orient by the light
    # direction - backface hits would otherwise self-shadow). Dead lanes get
    # tmax=-1 so the intersection kernels cull their blocks instantly.
    toward_light = jnp.where(dot(wl, surf.g_normal) < 0.0, -1.0, 1.0)
    shadow_o = (surf.position
                + (SHADOW_OFFSET * toward_light)[..., None] * surf.g_normal)
    shadow_tmax = jnp.where(alive, dist, -1.0)
    if use_alpha_cutout:
        blocked = intersect_any_cutout(scene, shadow_o, wl, 0.0, shadow_tmax,
                                       method=intersect_method)
    else:
        blocked = intersect_any(scene, shadow_o, wl, 0.0, shadow_tmax,
                                method=intersect_method)
    visible = ~blocked & alive

    wl_local = surf.to_local(wl)
    seed, f_val = dispatch.f(seed, surf.mat, surf.wo_local, wl_local,
                             active_lobes)
    cos_term = jnp.abs(wl_local[..., 2])

    # L = color / d^2, pdf == 1 (`LightMethods.h:17-23`)
    radiance = lc / jnp.maximum(length_sqr(to_light), 1e-12)[..., None]
    contrib = beta * f_val * cos_term[..., None] * radiance / p_light
    return seed, jnp.where(visible[..., None], contrib, 0.0)


def _nee_geom(seed, scene, surf, alive, intersect_method,
              use_alpha_cutout):
    """The material-independent half of _nee: light pick, shadow query,
    local light direction and radiance term. Returns (seed, (wl_local,
    visible, lrad)) or (seed, None) when the scene has no lights."""
    n_lights = scene.light_pos.shape[0]
    if n_lights == 0:
        return seed, None
    if n_lights == 1:
        light_idx = jnp.zeros(alive.shape[0], jnp.int32)
        p_light = 1.0
    else:
        seed, u = rng.rnd(seed)
        light_idx = jnp.minimum((u * n_lights).astype(jnp.int32),
                                n_lights - 1)
        p_light = 1.0 / n_lights
    lp = scene.light_pos[light_idx]
    lc = scene.light_color[light_idx]
    to_light = lp - surf.position
    dist = length(to_light)
    wl = normalize(to_light)
    toward_light = jnp.where(dot(wl, surf.g_normal) < 0.0, -1.0, 1.0)
    shadow_o = (surf.position
                + (SHADOW_OFFSET * toward_light)[..., None] * surf.g_normal)
    shadow_tmax = jnp.where(alive, dist, -1.0)
    if use_alpha_cutout:
        blocked = intersect_any_cutout(scene, shadow_o, wl, 0.0,
                                       shadow_tmax, method=intersect_method)
    else:
        blocked = intersect_any(scene, shadow_o, wl, 0.0, shadow_tmax,
                                method=intersect_method)
    visible = ~blocked & alive
    wl_local = surf.to_local(wl)
    lrad = lc / jnp.maximum(length_sqr(to_light), 1e-12)[..., None] / p_light
    return seed, (wl_local, visible, lrad)


def _shade_mat_segment(seed, surf, o, d, beta, alive, nee, gates,
                       active_lobes):
    """The material-dependent shading tail for one contiguous segment of a
    material-sorted wavefront: NEE f-eval + contribution, BSDF sample,
    throughput/ray update - with per-lobe runtime gates (dispatch._gated).
    Returns (seed, radiance_add, beta, o, d, alive)."""
    radiance_add = jnp.zeros(beta.shape, beta.dtype)
    if nee is not None:
        wl_local, visible, lrad = nee
        seed, f_val = dispatch.f(seed, surf.mat, surf.wo_local, wl_local,
                                 active_lobes, gates)
        cos_term = jnp.abs(wl_local[..., 2])
        contrib = beta * f_val * cos_term[..., None] * lrad
        radiance_add = jnp.where(visible[..., None], contrib, 0.0)

    seed, bs = dispatch.sample(seed, surf.mat, surf.wo_local, active_lobes,
                               gates)
    ok = bs.valid & (bs.pdf > 0.0)
    new_beta = (beta * bs.color * abs_cos_theta(bs.direction)[..., None]
                / jnp.where(bs.pdf == 0.0, 1.0, bs.pdf)[..., None])
    alive = alive & ok
    wi_world = normalize(surf.to_world(bs.direction))
    offset_sign = jnp.where(bs.direction[..., 2] < 0.0, -1.0, 1.0)
    new_o = (surf.position
             + (SHADOW_OFFSET * offset_sign)[..., None] * surf.g_normal)
    beta = jnp.where(alive[..., None], new_beta, beta)
    o = jnp.where(alive[..., None], new_o, o)
    d = jnp.where(alive[..., None], wi_world, d)
    alive = alive & (length(beta) > BETA_EPS)
    return seed, radiance_add, beta, o, d, alive


N_MAT_BUCKETS = 6  # 5 material types + dead lanes


def _shade_wave_material_sorted(scene, o, d, seed, hit, beta, alive,
                                radiance, pix, n_seg,
                                reference_compat, use_textures,
                                flat_shading, intersect_method,
                                active_lobes, use_alpha_cutout):
    """Material-sorted shading (SURVEY.md section 7 hard part (4)): the
    surface context and NEE shadow query run on the full wavefront (one
    engine call each), then lanes are counting-sorted by their RESOLVED
    material type (dead last) and the material-dependent tail - NEE f-eval
    and BSDF sampling - runs per contiguous segment with per-lobe runtime
    gates, so a segment of diffuse wall lanes never executes the layered
    walk. Images are unbiased but not bit-identical to the unsorted path
    (skipped lobes do not advance the RNG streams they would have burnt).
    Returns (seed, radiance, beta, o, d, alive, pix) - all permuted."""
    seed, surf = make_surface(seed, scene, o, d, hit,
                              reference_compat=reference_compat,
                              use_textures=use_textures,
                              flat_shading=flat_shading)
    seed, nee = _nee_geom(seed, scene, surf, alive, intersect_method,
                          use_alpha_cutout)

    key = jnp.where(alive, surf.mat.mat_type, N_MAT_BUCKETS - 1)
    perm = _perm_from_key(key, N_MAT_BUCKETS)
    o, d, seed, beta = o[perm], d[perm], seed[perm], beta[perm]
    radiance, alive, pix = radiance[perm], alive[perm], pix[perm]
    surf = jax.tree.map(lambda a: a[perm], surf)
    if nee is not None:
        nee = jax.tree.map(lambda a: a[perm], nee)

    r = o.shape[0]
    size = r // n_seg
    pieces = []
    for si in range(n_seg):
        sl = slice(si * size, (si + 1) * size)
        surf_sl = jax.tree.map(lambda a: a[sl], surf)
        nee_sl = (None if nee is None
                  else jax.tree.map(lambda a: a[sl], nee))
        live = alive[sl]
        mt = surf_sl.mat.mat_type
        gates = {lobe: jnp.any((mt == lobe) & live)
                 for lobe in active_lobes}
        pieces.append(_shade_mat_segment(
            seed[sl], surf_sl, o[sl], d[sl], beta[sl], live, nee_sl,
            gates, active_lobes))
    seed, radiance_add, beta, o, d, alive = (
        jnp.concatenate([p[k] for p in pieces]) for k in range(6))
    radiance = radiance + radiance_add  # already gated by NEE visibility
    return seed, radiance, beta, o, d, alive, pix


def _shade_wave(scene, o, d, seed, hit, beta, alive, radiance,
                reference_compat, use_textures, flat_shading,
                intersect_method, active_lobes, use_alpha_cutout):
    """The full shading stage for one wavefront slice: surface context,
    NEE, BSDF sample, throughput/ray update. Factored out so
    compact_shading can run it per contiguous segment under lax.cond
    (a segment with zero live lanes skips the whole stage at runtime).
    Returns (seed, radiance, beta, o, d, alive)."""
    seed, surf = make_surface(seed, scene, o, d, hit,
                              reference_compat=reference_compat,
                              use_textures=use_textures,
                              flat_shading=flat_shading)

    seed, nee_contrib = _nee(seed, scene, surf, beta, alive,
                             intersect_method, active_lobes,
                             use_alpha_cutout)
    radiance = radiance + jnp.where(alive[..., None], nee_contrib, 0.0)

    seed, bs = dispatch.sample(seed, surf.mat, surf.wo_local, active_lobes)
    ok = bs.valid & (bs.pdf > 0.0)
    new_beta = (beta * bs.color * abs_cos_theta(bs.direction)[..., None]
                / jnp.where(bs.pdf == 0.0, 1.0, bs.pdf)[..., None])
    alive = alive & ok

    wi_world = normalize(surf.to_world(bs.direction))
    offset_sign = jnp.where(bs.direction[..., 2] < 0.0, -1.0, 1.0)
    new_o = (surf.position
             + (SHADOW_OFFSET * offset_sign)[..., None] * surf.g_normal)

    beta = jnp.where(alive[..., None], new_beta, beta)
    o = jnp.where(alive[..., None], new_o, o)
    d = jnp.where(alive[..., None], wi_world, d)
    alive = alive & (length(beta) > BETA_EPS)
    return seed, radiance, beta, o, d, alive


def trace_paths(scene, o, d, seed, max_bounces: int,
                intersect_method: str = "auto",
                reference_compat: bool = False,
                active_lobes=dispatch.ALL_LOBES,
                use_textures: bool = True,
                use_alpha_cutout: bool = False,
                debug_pixel: int | None = None,
                sort_rays: bool | None = None,
                flat_shading: bool = False,
                compact_shading: int = 0,
                material_sort: int = 0):
    """Trace one path per lane. o, d: [R, 3]; seed: [R] uint32.
    Returns (radiance [R, 3], seed).

    use_alpha_cutout (static): honor albedo-alpha cutout like the
    reference's anyhit programs (integrate/cutout.py).
    debug_pixel (static): flat lane index whose per-bounce surface state is
    printed - the analog of the reference's debug-ray printf facility
    (`RayData.h:19`, `devicePrograms.cu:428-437`).
    sort_rays (static): re-sort the wavefront by spatial coherence each
    secondary bounce. True (the cheap path) uses the counting-sort bucket
    permutation (_bucket_permutation: origin cell x direction octant via
    one-hot cumsum - no comparison sort); "morton" uses the full Morton
    argsort. Per-lane arithmetic is order-invariant, so images are
    bit-identical either way. Default OFF; what it buys the GPU traversal
    kernel on bounce wavefronts is not measured.
    compact_shading (static): split every secondary bounce's SHADING stage
    into this many contiguous segments, each under lax.cond on 'any lane
    alive'. With sort_rays on, dead lanes sort last (COMPACTION.md:
    layered occupancy decays 51/24/10% by bounce 3), so trailing segments
    skip the surface/NEE/BSDF work entirely at runtime. 0 = off. Requires
    sort_rays; implies segment count divides the wavefront.
    material_sort (static): counting-sort each bounce's wavefront by the
    lanes' RESOLVED material type after the hit and run the material-
    dependent shading tail (NEE f + BSDF sample) in this many contiguous
    segments with per-lobe runtime gates - multi-material scenes stop
    paying every lobe on every lane (_shade_wave_material_sorted). 0 =
    off. Mutually exclusive with compact_shading/debug_pixel; images are
    unbiased but not bit-identical to the unsorted path."""
    r = o.shape[0]
    if compact_shading and not sort_rays:
        sort_rays = True  # segments only pay off with dead-lanes-last
    radiance = jnp.zeros((r, 3), jnp.float32)
    beta = jnp.ones((r, 3), jnp.float32)
    alive = jnp.ones((r,), bool)
    if sort_rays is None:
        sort_rays = False
    pix = jnp.arange(r, dtype=jnp.int32)

    for _bounce in range(max_bounces):
        if sort_rays and _bounce and debug_pixel is None:
            if sort_rays == "morton":
                perm = jnp.argsort(_coherence_sort_key(scene, o, d, alive))
            else:
                perm = _bucket_permutation(scene, o, d, alive)
            o, d, seed = o[perm], d[perm], seed[perm]
            beta, radiance = beta[perm], radiance[perm]
            alive, pix = alive[perm], pix[perm]
        # Dead lanes trace with tmax=-1: they can't hit anything, and the
        # traversal engines retire them before the first node.
        ray_tmax = jnp.where(alive, RAY_TMAX, -1.0) if _bounce else RAY_TMAX
        if use_alpha_cutout:
            hit = intersect_closest_cutout(scene, o, d, 0.0, ray_tmax,
                                           method=intersect_method)
        else:
            hit = intersect_closest(scene, o, d, 0.0, ray_tmax,
                                    method=intersect_method)
        # miss -> background is black; path dies with radiance unchanged
        alive = alive & hit.hit

        if debug_pixel is not None:
            seed_dbg, surf = make_surface(seed, scene, o, d, hit,
                                          reference_compat=reference_compat,
                                          use_textures=use_textures,
                                          flat_shading=flat_shading)
            jax.debug.print(
                "debug ray bounce {b}: pos={pos} albedo={alb} "
                "ns={ns} ng={ng} rough={r} metal={m} alive={a}",
                b=_bounce, pos=surf.position[debug_pixel],
                alb=surf.mat.albedo[debug_pixel],
                ns=surf.s_normal[debug_pixel],
                ng=surf.g_normal[debug_pixel],
                r=surf.mat.roughness[debug_pixel],
                m=surf.mat.metallic[debug_pixel],
                a=alive[debug_pixel])

        shade_args = (reference_compat, use_textures, flat_shading,
                      intersect_method, active_lobes, use_alpha_cutout)
        if material_sort and debug_pixel is None \
                and r % material_sort == 0:
            (seed, radiance, beta, o, d, alive,
             pix) = _shade_wave_material_sorted(
                scene, o, d, seed, hit, beta, alive, radiance, pix,
                material_sort, *shade_args)
        elif compact_shading and _bounce and debug_pixel is None \
                and r % compact_shading == 0:
            # Segmented shading: dead lanes sorted last, so trailing
            # segments skip surface+NEE+BSDF entirely (VERDICT r3 item 6;
            # occupancy table in COMPACTION.md).
            size = r // compact_shading
            pieces = []
            for si in range(compact_shading):
                sl = slice(si * size, (si + 1) * size)
                hit_sl = Hit(*[f[sl] for f in hit])
                carry = (seed[sl], radiance[sl], beta[sl], o[sl], d[sl],
                         alive[sl])

                def shade(carry, hit_sl=hit_sl):
                    s, rad, b, oo, dd, al = carry
                    return _shade_wave(scene, oo, dd, s, hit_sl, b, al,
                                       rad, *shade_args)

                pieces.append(jax.lax.cond(
                    jnp.any(alive[sl]), shade, lambda c: c, carry))
            seed, radiance, beta, o, d, alive = (
                jnp.concatenate([p[k] for p in pieces])
                for k in range(6))
        else:
            seed, radiance, beta, o, d, alive = _shade_wave(
                scene, o, d, seed, hit, beta, alive, radiance, *shade_args)

    sorted_any = ((sort_rays and max_bounces > 1)
                  or (material_sort and r % material_sort == 0))
    if sorted_any and debug_pixel is None:
        # Undo the coherence/material sort: scatter per-lane results back
        # to pixel order (pix is a permutation -> .set is collision-free).
        radiance = jnp.zeros_like(radiance).at[pix].set(radiance)
        seed = jnp.zeros_like(seed).at[pix].set(seed)
    return radiance, seed


@partial(jax.jit, static_argnames=("width", "height", "max_bounces",
                                   "intersect_method", "reference_compat",
                                   "active_lobes", "use_textures",
                                   "use_alpha_cutout", "debug_pixel",
                                   "sort_rays", "flat_shading",
                                   "compact_shading", "material_sort"))
def render_sample(scene, cam_position, cam_inv_view, cam_inv_proj,
                  width: int, height: int, frame_id,
                  max_bounces: int = 2,
                  intersect_method: str = "auto",
                  reference_compat: bool = False,
                  active_lobes=dispatch.ALL_LOBES,
                  use_textures: bool = True,
                  use_alpha_cutout: bool = False,
                  debug_pixel: int | None = None,
                  sort_rays: bool | None = None,
                  flat_shading: bool = False,
                  compact_shading: int = 0,
                  material_sort: int = 0):
    """Render one 1-spp frame: [H, W, 3] linear radiance (row 0 = bottom,
    GL convention like the reference framebuffer).

    The per-frame analog of `OptixRenderer::Render` + `__raygen__renderFrame`
    - but the frame stays on-device (no host round-trip; the reference's
    known inefficiency, SURVEY.md section 3.2)."""
    o, d = generate_rays(cam_position, cam_inv_view, cam_inv_proj,
                         width, height)
    o = o.reshape(-1, 3)
    d = d.reshape(-1, 3)

    ys, xs = jnp.meshgrid(jnp.arange(height, dtype=jnp.uint32),
                          jnp.arange(width, dtype=jnp.uint32), indexing="ij")
    seed = rng.pixel_seed(width, xs.reshape(-1), ys.reshape(-1), frame_id)

    radiance, _ = trace_paths(scene, o, d, seed, max_bounces,
                              intersect_method, reference_compat,
                              active_lobes, use_textures,
                              use_alpha_cutout, debug_pixel,
                              sort_rays, flat_shading, compact_shading,
                              material_sort)
    return radiance.reshape(height, width, 3)


@partial(jax.jit, static_argnames=("width", "height", "chunk", "max_bounces",
                                   "intersect_method", "reference_compat",
                                   "active_lobes", "use_textures",
                                   "use_alpha_cutout", "sort_rays",
                                   "flat_shading", "material_sort"))
def render_chunk(scene, cam_position, cam_inv_view, cam_inv_proj,
                 width: int, height: int, accum, start_frame, chunk: int,
                 max_bounces: int = 2, intersect_method: str = "auto",
                 reference_compat: bool = False,
                 active_lobes=dispatch.ALL_LOBES, use_textures: bool = True,
                 use_alpha_cutout: bool = False,
                 sort_rays: bool | None = None, flat_shading: bool = False,
                 material_sort: int = 0):
    """Accumulate `chunk` consecutive 1-spp frames into the running mean
    with a single on-device lax.fori_loop - one host dispatch per chunk
    instead of per sample. Bit-identical to chaining render_sample calls
    (same frame seeds, same mean recurrence)."""
    def body(i, acc):
        s = (start_frame + i).astype(jnp.uint32)
        frame = render_sample(scene, cam_position, cam_inv_view,
                              cam_inv_proj, width, height, s, max_bounces,
                              intersect_method, reference_compat,
                              active_lobes, use_textures, use_alpha_cutout,
                              sort_rays=sort_rays, flat_shading=flat_shading,
                              material_sort=material_sort)
        return acc + (frame - acc) / (s.astype(jnp.float32) + 1.0)
    return jax.lax.fori_loop(0, chunk, body, accum)


def render(scene, camera, width: int, height: int, spp: int,
           max_bounces: int = 2, intersect_method: str = "auto",
           reference_compat: bool = False, start_frame: int = 0,
           accum=None, callback=None, active_lobes=None,
           use_textures=None, use_alpha_cutout=None, flat_shading=None,
           frames_per_launch: int = 32):
    """Progressive render: accumulate `spp` 1-spp frames into a running mean
    (the on-device analog of the reference's GL accumulation shader,
    `AddPathtracedFrame.frag:13-25` endless-mode weight 1/samples).

    The spp loop runs on-device in `frames_per_launch` chunks; with a
    `callback` (preview/heartbeat consumers) it falls back to per-sample
    dispatch so every accumulated frame is observable.

    Supports resume: pass `accum` (the running mean) and `start_frame` from a
    checkpoint. Returns the accumulated [H, W, 3] image (device array).
    """
    if active_lobes is None:
        from ..scene.flatten import scene_active_lobes
        active_lobes = scene_active_lobes(scene)
    if use_textures is None:
        from ..scene.flatten import scene_uses_textures
        use_textures = scene_uses_textures(scene)
    if use_alpha_cutout is None:
        from .cutout import scene_uses_alpha_cutout
        use_alpha_cutout = scene_uses_alpha_cutout(scene)
    if flat_shading is None:
        from ..scene.flatten import scene_flat_shading
        flat_shading = scene_flat_shading(scene)
    pos, inv_view, inv_proj = camera.raygen_params(width, height)
    if accum is None:
        accum = jnp.zeros((height, width, 3), jnp.float32)

    if callback is None and frames_per_launch > 1:
        s = start_frame
        end = start_frame + spp
        while s < end:
            chunk = min(frames_per_launch, end - s)
            accum = render_chunk(scene, pos, inv_view, inv_proj, width,
                                 height, accum, jnp.uint32(s), chunk,
                                 max_bounces, intersect_method,
                                 reference_compat, active_lobes,
                                 use_textures, use_alpha_cutout,
                                 flat_shading=flat_shading)
            s += chunk
        return accum

    for s in range(start_frame, start_frame + spp):
        frame = render_sample(scene, pos, inv_view, inv_proj, width, height,
                              jnp.uint32(s), max_bounces, intersect_method,
                              reference_compat, active_lobes, use_textures,
                              use_alpha_cutout, flat_shading=flat_shading)
        # running mean: mix(prev, new, 1/(s+1))
        weight = 1.0 / (s + 1)
        accum = accum + (frame - accum) * weight
        if callback is not None:
            callback(s, accum)
    return accum
