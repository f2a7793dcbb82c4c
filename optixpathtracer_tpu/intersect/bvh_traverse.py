"""Stackless skip-link BVH traversal in pure JAX (vmapped while_loop).

The software replacement for the reference's RT-core `optixTrace`
(`devicePrograms.cu:224,248`) over the flattened BVH from scene/bvh.py.
Every ray walks the DFS-ordered node array in lock-step: AABB hit on an
inner node -> descend to node+1 (left child); miss, or after a leaf ->
jump to node_skip. No stack, so the whole wavefront's state is just one
int32 node pointer per ray plus the running best hit.

This is the portable engine (the CPU route for large scenes);
intersect/bvh_kernel.py runs the same algorithm as a GPU kernel with
per-warp instead of per-wavefront lockstep.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..scene.bvh import MAX_LEAF_SIZE
from .types import Hit

EPS_DET = 1e-12


def _slab_test(o, inv_d, nmin, nmax, tmin, tmax):
    t0 = (nmin - o) * inv_d
    t1 = (nmax - o) * inv_d
    t_near = jnp.max(jnp.minimum(t0, t1), axis=-1)
    t_far = jnp.min(jnp.maximum(t0, t1), axis=-1)
    return (t_near <= t_far) & (t_far >= tmin) & (t_near <= tmax)


def _mt_single(o, d, v0, e1, e2, tmin, tmax):
    pvec = jnp.cross(d, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    ok = jnp.abs(det) > EPS_DET
    inv_det = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)
    tvec = o - v0
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(d * qvec, axis=-1) * inv_det
    t = jnp.sum(e2 * qvec, axis=-1) * inv_det
    hit = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > tmin) & (t < tmax)
    return t, u, v, hit, det < 0.0


def _traverse_one(bvh_min, bvh_max, bvh_skip, bvh_first, bvh_count,
                  tri_v0, tri_e1, tri_e2, tri_valid,
                  o, d, tmin, tmax, any_hit):
    """Traverse for a single ray (to be vmapped)."""
    n_nodes = bvh_min.shape[0]
    safe_d = jnp.where(jnp.abs(d) < 1e-20, jnp.where(d >= 0, 1e-20, -1e-20), d)
    inv_d = 1.0 / safe_d

    def cond(state):
        node, best_t, *_ , done = state
        return (node < n_nodes) & ~done

    def body(state):
        node, best_t, best_id, best_u, best_v, best_back, done = state
        nmin = bvh_min[node]
        nmax = bvh_max[node]
        skip = bvh_skip[node]
        first = bvh_first[node]
        count = bvh_count[node]

        box_hit = _slab_test(o, inv_d, nmin, nmax, tmin,
                             jnp.minimum(tmax, best_t))
        is_leaf = count > 0

        # Leaf: test up to MAX_LEAF_SIZE triangles (static unroll).
        def leaf_update(args):
            bt, bi, bu, bv, bb = args
            for k in range(MAX_LEAF_SIZE):
                idx = first + k
                in_range = (k < count) & box_hit & is_leaf
                safe_idx = jnp.minimum(idx, tri_v0.shape[0] - 1)
                t, u, v, h, back = _mt_single(
                    o, d, tri_v0[safe_idx], tri_e1[safe_idx],
                    tri_e2[safe_idx], tmin, jnp.minimum(tmax, bt))
                h = h & in_range & tri_valid[safe_idx]
                better = h & (t < bt)
                bt = jnp.where(better, t, bt)
                bi = jnp.where(better, safe_idx, bi)
                bu = jnp.where(better, u, bu)
                bv = jnp.where(better, v, bv)
                bb = jnp.where(better, back, bb)
            return bt, bi, bu, bv, bb

        best_t, best_id, best_u, best_v, best_back = leaf_update(
            (best_t, best_id, best_u, best_v, best_back))

        descend = box_hit & ~is_leaf
        next_node = jnp.where(descend, node + 1, skip)
        new_done = done | (any_hit & (best_id >= 0))
        return (next_node, best_t, best_id, best_u, best_v, best_back,
                new_done)

    init = (jnp.int32(0), tmax, jnp.int32(-1), jnp.float32(0.0),
            jnp.float32(0.0), False, False)
    node, best_t, best_id, best_u, best_v, best_back, _ = jax.lax.while_loop(
        cond, body, init)
    hit = best_id >= 0
    return Hit(t=best_t, tri_id=best_id, u=best_u, v=best_v, hit=hit,
               back_face=best_back)


def intersect_closest(scene, o, d, tmin=0.0, tmax=100.0):
    """Closest hit via BVH. o, d: [R, 3]. Returns Hit [R]."""
    r = o.shape[0]
    tmin = jnp.broadcast_to(jnp.asarray(tmin, jnp.float32), (r,))
    tmax = jnp.broadcast_to(jnp.asarray(tmax, jnp.float32), (r,))
    fn = jax.vmap(
        lambda oo, dd, lo, hi: _traverse_one(
            scene.bvh_min, scene.bvh_max, scene.bvh_skip, scene.bvh_first,
            scene.bvh_count, scene.tri_v0, scene.tri_e1, scene.tri_e2,
            scene.tri_valid, oo, dd, lo, hi, any_hit=False))
    return fn(o, d, tmin, tmax)


def intersect_any(scene, o, d, tmin=0.0, tmax=100.0):
    """Occlusion query via BVH with first-hit early-out per ray."""
    r = o.shape[0]
    tmin = jnp.broadcast_to(jnp.asarray(tmin, jnp.float32), (r,))
    tmax = jnp.broadcast_to(jnp.asarray(tmax, jnp.float32), (r,))
    fn = jax.vmap(
        lambda oo, dd, lo, hi: _traverse_one(
            scene.bvh_min, scene.bvh_max, scene.bvh_skip, scene.bvh_first,
            scene.bvh_count, scene.tri_v0, scene.tri_e1, scene.tri_e2,
            scene.tri_valid, oo, dd, lo, hi, any_hit=True))
    return fn(o, d, tmin, tmax).hit
