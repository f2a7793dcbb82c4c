"""Alpha-cutout-aware intersection: the wavefront equivalent of the
reference's anyhit programs (`devicePrograms.cu:518-561` AlphaCutout: hits
whose albedo-texture alpha < 0.9 after sRGB decode are ignored, for both
radiance and shadow rays).

OptiX re-enters traversal on optixIgnoreIntersection; the wavefront analog
is a bounded re-trace: find the closest hit, evaluate the albedo alpha at
the hit point, and for cut-out lanes re-trace with tmin just past the hit.
Each chain is one lax.while_loop that stops when no lane is still open or
after MAX_CUTOUT_LAYERS passes (transparent layers beyond that occlude), so
the compiled program holds one traversal call per chain, not one per
layer. The loops carry only detached values (hit ids decide, they do not
differentiate); the answer is refined differentiably after the loop. Only
compiled in when the scene actually contains cutout texels
(scene_uses_alpha_cutout - a static flatten-time fact), so opaque scenes
pay nothing.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..intersect import intersect_any, intersect_closest
from ..intersect.api import _refine
from ..intersect.types import Hit
from ..scene.textures import sample_bilinear, srgb_to_linear

MAX_CUTOUT_LAYERS = 4
ALPHA_THRESHOLD = 0.9
REENTRY_EPS = 1e-4


def scene_uses_alpha_cutout(scene) -> bool:
    """Static: any material with an albedo texture containing alpha < 0.9?
    (The reference applies cutout whenever hasAlbedoTexture,
    `devicePrograms.cu:534`; we additionally skip the machinery when every
    texel is opaque - identical images, less work.)"""
    tex_ids = np.asarray(scene.mat_albedo_tex)
    if not (tex_ids >= 0).any():
        return False
    textures = np.asarray(scene.textures)
    used = np.unique(tex_ids[tex_ids >= 0])
    # the threshold applies to the sRGB-decoded alpha (reference decodes all
    # 4 channels, `devicePrograms.cu:62-73,543`)
    alpha = textures[used, :, :, 3]
    decoded = np.where(alpha <= 0.04045, alpha / 12.92,
                       ((alpha + 0.055) / 1.055) ** 2.4)
    return bool((decoded < ALPHA_THRESHOLD).any())


def _hit_alpha(scene, hit: Hit):
    """Decoded albedo alpha at the hit point; 1.0 where the material has no
    albedo texture (no cutout, `devicePrograms.cu:534,546`)."""
    safe_id = jnp.maximum(hit.tri_id, 0)
    tri_uv = scene.tri_uvs[safe_id]
    mat_id = scene.tri_mat[safe_id]
    tex_id = scene.mat_albedo_tex[mat_id]
    u = hit.u[..., None]
    v = hit.v[..., None]
    uv = (1.0 - u - v) * tri_uv[:, 0] + u * tri_uv[:, 1] + v * tri_uv[:, 2]
    texel = sample_bilinear(scene.textures, tex_id, uv[..., 0], uv[..., 1])
    alpha = srgb_to_linear(texel[..., 3])
    return jnp.where(tex_id >= 0, alpha, 1.0)


def intersect_closest_cutout(scene, o, d, tmin=0.0, tmax=100.0,
                             method="auto"):
    """Closest hit skipping cutout surfaces (radiance-ray anyhit analog).

    Fast path (flatten-time opaque/cutout split with outer-id maps): ONE
    closest hit over the opaque sub-scene + the cutout chain over the
    (tiny) cutout sub-scene; the winner's triangle id maps back to the
    outer scene through tri_outer_id and the final hit is re-refined
    differentiably against the outer geometry - so no full-scene re-trace
    ever runs (was ~180 ms/frame on the hall preset even gated).

    Legacy path (no split): re-traces with non-cut lanes dead
    (tmax = -1).
    """
    r = o.shape[0]
    tmin = jnp.broadcast_to(jnp.asarray(tmin, jnp.float32), (r,))
    tmax_b = jnp.broadcast_to(jnp.asarray(tmax, jnp.float32), (r,))

    if scene.opaque_scene is not None and scene.cutout_sub is not None:
        opq = scene.opaque_scene
        sub = scene.cutout_sub
        h_o = _detached(intersect_closest(opq, o, d, tmin, tmax,
                                          method=method))
        # cutout chain over the subset, bounded by the opaque hit
        sub_bound = jnp.where(h_o.hit, h_o.t + REENTRY_EPS, tmax_b)

        def step(state):
            best_t, best_id, open_, cur_tmin, last_t, last_id = state
            lane_tmax = jnp.where(open_, sub_bound, -1.0)
            h = _detached(intersect_closest(sub, o, d, cur_tmin, lane_tmax,
                                            method=method))
            solid = h.hit & (_hit_alpha(sub, h) >= ALPHA_THRESHOLD)
            take = open_ & solid
            best_t = jnp.where(take, h.t, best_t)
            best_id = jnp.where(take, h.tri_id, best_id)
            open_ = open_ & h.hit & ~solid
            cur_tmin = jnp.where(open_, h.t + REENTRY_EPS, cur_tmin)
            # layers beyond the bound conservatively occlude: remember the
            # deepest cut hit so exhausting the chain still reports a hit
            last_t = jnp.where(open_ & h.hit, h.t, last_t)
            last_id = jnp.where(open_ & h.hit, h.tri_id, last_id)
            return best_t, best_id, open_, cur_tmin, last_t, last_id

        no_hit = (jnp.full((r,), jnp.inf, jnp.float32),
                  jnp.full((r,), -1, jnp.int32))
        state = _chain(step, no_hit + (jnp.ones((r,), bool),
                                       jax.lax.stop_gradient(tmin))
                       + no_hit, open_index=2)
        best_t, best_id, open_, _, last_cut_t, last_cut_id = state
        # exhausted chains occlude at the deepest cut surface
        best_t = jnp.where(open_ & (last_cut_id >= 0), last_cut_t, best_t)
        best_id = jnp.where(open_ & (last_cut_id >= 0), last_cut_id,
                            best_id)

        sub_hit = best_id >= 0
        n_sub = sub.tri_outer_id.shape[0]
        sub_outer = sub.tri_outer_id[jnp.clip(best_id, 0, n_sub - 1)]
        n_opq = opq.tri_outer_id.shape[0]
        opq_outer = opq.tri_outer_id[jnp.clip(h_o.tri_id, 0, n_opq - 1)]
        # t-ties between an opaque hit and a coincident solid cutout-subset
        # hit break toward the lower OUTER triangle id, matching the legacy
        # full-scene chain (and the brute oracle's lowest-id winner)
        sub_wins = sub_hit & (~h_o.hit | (best_t < h_o.t)
                              | ((best_t == h_o.t) & (sub_outer < opq_outer)))
        final_id = jnp.where(sub_wins, sub_outer,
                             jnp.where(h_o.hit, opq_outer, -1))
        final_hit = sub_wins | h_o.hit
        raw = Hit(t=jnp.where(sub_wins, best_t, h_o.t),
                  tri_id=jax.lax.stop_gradient(final_id),
                  u=jnp.zeros((r,)), v=jnp.zeros((r,)),
                  hit=final_hit, back_face=jnp.zeros((r,), bool))
        # differentiable refinement against the OUTER geometry, exactly
        # like api.intersect_closest's contract
        return _refine(scene, o, d, raw, tmax_b)

    tmin = jax.lax.stop_gradient(tmin)

    def cut_of(best):
        return best.hit & (_hit_alpha(scene, best) < ALPHA_THRESHOLD)

    def retrace(state):
        best, cut = state
        new_tmin = jnp.where(cut, best.t + REENTRY_EPS, tmin)
        lane_tmax = jnp.where(cut, tmax_b, -1.0)
        again = _detached(intersect_closest(scene, o, d, new_tmin, lane_tmax,
                                            method=method))
        best = Hit(*[jnp.where(cut, a, b) for a, b in zip(again, best)])
        return best, cut_of(best)

    best = _detached(intersect_closest(scene, o, d, tmin, tmax,
                                       method=method))
    best, _ = _chain(retrace, (best, cut_of(best)), open_index=1,
                     n_layers=MAX_CUTOUT_LAYERS)
    # the same (t, u, v) the last engine call refined, now differentiable
    return _refine(scene, o, d, best, tmax_b)


def _detached(hit: Hit) -> Hit:
    return jax.tree.map(jax.lax.stop_gradient, hit)


def _chain(step, state, open_index: int,
           n_layers: int = MAX_CUTOUT_LAYERS + 1):
    """Apply `step` while any lane of state[open_index] is open, at most
    n_layers times (a while_loop: one traversal call site per chain)."""
    def cond(c):
        return (c[0] < n_layers) & jnp.any(c[1][open_index])

    def body(c):
        return c[0] + 1, step(c[1])

    return jax.lax.while_loop(cond, body, (jnp.int32(0), state))[1]


def _any_cutout_chain(scene, o, d, tmin, tmax_b, gate0, method):
    """The closest-hit cutout chain over `scene`: a ray is blocked only by
    a hit whose alpha passes the threshold; cutout hits re-enter. gate0
    masks lanes that need the query at all."""
    r = o.shape[0]
    tmax_b = jax.lax.stop_gradient(tmax_b)

    def step(state):
        blocked, open_, cur_tmin = state
        lane_tmax = jnp.where(open_, tmax_b, -1.0)
        hit = _detached(intersect_closest(scene, o, d, cur_tmin, lane_tmax,
                                          method=method))
        opaque = hit.hit & (_hit_alpha(scene, hit) >= ALPHA_THRESHOLD)
        blocked = blocked | (open_ & opaque)
        # keep searching only through cutout hits
        open_ = open_ & hit.hit & ~opaque
        cur_tmin = jnp.where(open_, hit.t + REENTRY_EPS, cur_tmin)
        return blocked, open_, cur_tmin

    blocked, open_, _ = _chain(
        step, (jnp.zeros((r,), bool), gate0, jax.lax.stop_gradient(tmin)),
        open_index=1)
    # layers beyond the bound conservatively occlude
    return blocked | open_


def intersect_any_cutout(scene, o, d, tmin=0.0, tmax=100.0, method="auto"):
    """Occlusion query honoring cutout (shadow-ray anyhit analog,
    `devicePrograms.cu:556-561`): a ray is blocked only by a hit whose
    alpha passes the threshold.

    Fast path (scene.opaque_scene/cutout_sub from the flatten-time split):
    a plain boolean any-hit over the opaque triangles - the early-exit
    query the reference's TERMINATE_ON_FIRST_HIT shadow rays get for free
    - OR'd with the closest-hit cutout chain run only over the (small)
    cutout subset, gated to lanes the opaque pass didn't already block.
    Without the split (untextured subsets or legacy scenes), the chain
    runs over the full scene as before."""
    r = o.shape[0]
    tmin = jnp.broadcast_to(jnp.asarray(tmin, jnp.float32), (r,))
    tmax_b = jnp.broadcast_to(jnp.asarray(tmax, jnp.float32), (r,))

    if scene.opaque_scene is not None and scene.cutout_sub is not None:
        blocked_o = intersect_any(scene.opaque_scene, o, d, tmin, tmax_b,
                                  method=method)
        blocked_c = _any_cutout_chain(scene.cutout_sub, o, d, tmin,
                                      jnp.where(blocked_o, -1.0, tmax_b),
                                      ~blocked_o, method)
        return blocked_o | blocked_c

    return _any_cutout_chain(scene, o, d, tmin, tmax_b,
                             jnp.ones((r,), bool), method)
