"""Brute-force Moller-Trumbore intersection: the correctness oracle.

O(rays x tris), but expressed as a dense chunked scan that is cheap for
small scenes: each chunk is a [R, C] elementwise slab with zero gathers and
a running min-reduction, which XLA fuses into one pass per chunk (SURVEY.md
section 7 stage 3: "brute-force ships first as the correctness oracle; the
BVH kernel must match it on hit ids").

Back-face orientation follows OptiX convention: a hit is front-facing when
the ray direction opposes the geometric normal cross(e1, e2).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.math import cross, dot
from .types import Hit

EPS_DET = 1e-12
CHUNK = 512


def _mt_chunk(o, d, v0, e1, e2, tmin, tmax):
    """Moller-Trumbore for all (ray, tri-in-chunk) pairs.
    o, d: [R, 3]; v0/e1/e2: [C, 3]. Returns (t, u, v, hit, back) [R, C]."""
    # [R, 1, 3] x [1, C, 3]
    o = o[:, None, :]
    d = d[:, None, :]
    v0 = v0[None, :, :]
    e1 = e1[None, :, :]
    e2 = e2[None, :, :]

    pvec = cross(d, e2)
    det = dot(e1, pvec)
    ok = jnp.abs(det) > EPS_DET
    inv_det = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)
    tvec = o - v0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(d, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    hit = (ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t > tmin[:, None]) & (t < tmax[:, None]))
    back = det < 0.0
    return t, u, v, hit, back


def intersect_closest(scene, o, d, tmin=0.0, tmax=100.0, chunk=CHUNK):
    """Closest hit over all scene triangles. o, d: [R, 3]. Returns Hit.

    tmax defaults to the reference's 100-unit ray cap
    (`devicePrograms.cu:652`).
    """
    r = o.shape[0]
    t_tris = scene.tri_v0.shape[0]
    tmin = jnp.broadcast_to(jnp.asarray(tmin, jnp.float32), (r,))
    tmax_arr = jnp.broadcast_to(jnp.asarray(tmax, jnp.float32), (r,))

    n_chunks = -(-t_tris // chunk)
    pad = n_chunks * chunk - t_tris
    v0 = jnp.pad(scene.tri_v0, ((0, pad), (0, 0)),
                 constant_values=1e10).reshape(n_chunks, chunk, 3)
    e1 = jnp.pad(scene.tri_e1, ((0, pad), (0, 0))).reshape(n_chunks, chunk, 3)
    e2 = jnp.pad(scene.tri_e2, ((0, pad), (0, 0))).reshape(n_chunks, chunk, 3)
    valid = jnp.pad(scene.tri_valid, (0, pad)).reshape(n_chunks, chunk)

    def body(carry, chunk_data):
        best_t, best_id, best_u, best_v, best_back, base = carry
        cv0, ce1, ce2, cvalid = chunk_data
        t, u, v, hit, back = _mt_chunk(o, d, cv0, ce1, ce2, tmin, tmax_arr)
        hit = hit & cvalid[None, :]
        t = jnp.where(hit, t, jnp.inf)
        arg = jnp.argmin(t, axis=1)
        row = jnp.arange(r)
        ct, cu, cv_, cb = t[row, arg], u[row, arg], v[row, arg], back[row, arg]
        better = ct < best_t
        best_t = jnp.where(better, ct, best_t)
        best_id = jnp.where(better, base + arg, best_id)
        best_u = jnp.where(better, cu, best_u)
        best_v = jnp.where(better, cv_, best_v)
        best_back = jnp.where(better, cb, best_back)
        return (best_t, best_id, best_u, best_v, best_back,
                base + chunk), None

    init = (jnp.full((r,), jnp.inf),
            jnp.full((r,), -1, jnp.int32),
            jnp.zeros((r,)), jnp.zeros((r,)), jnp.zeros((r,), bool),
            jnp.int32(0))
    (best_t, best_id, best_u, best_v, best_back, _), _ = jax.lax.scan(
        body, init, (v0, e1, e2, valid))

    hit = jnp.isfinite(best_t)
    return Hit(t=jnp.where(hit, best_t, tmax_arr),
               tri_id=jnp.where(hit, best_id, -1),
               u=best_u, v=best_v, hit=hit, back_face=best_back)


def intersect_any(scene, o, d, tmin=0.0, tmax=100.0, chunk=CHUNK):
    """Occlusion query: True if ANY triangle blocks (o + t d) for
    t in (tmin, tmax). The analog of the reference's shadow rays with
    TERMINATE_ON_FIRST_HIT (`devicePrograms.cu:216-241`).

    (Alpha-cutout-aware shadowing for textured scenes is layered on in the
    integrator by re-testing the closest hit; see integrate/nee.py.)
    """
    r = o.shape[0]
    t_tris = scene.tri_v0.shape[0]
    tmin = jnp.broadcast_to(jnp.asarray(tmin, jnp.float32), (r,))
    tmax_arr = jnp.broadcast_to(jnp.asarray(tmax, jnp.float32), (r,))

    n_chunks = -(-t_tris // chunk)
    pad = n_chunks * chunk - t_tris
    v0 = jnp.pad(scene.tri_v0, ((0, pad), (0, 0)),
                 constant_values=1e10).reshape(n_chunks, chunk, 3)
    e1 = jnp.pad(scene.tri_e1, ((0, pad), (0, 0))).reshape(n_chunks, chunk, 3)
    e2 = jnp.pad(scene.tri_e2, ((0, pad), (0, 0))).reshape(n_chunks, chunk, 3)
    valid = jnp.pad(scene.tri_valid, (0, pad)).reshape(n_chunks, chunk)

    def body(blocked, chunk_data):
        cv0, ce1, ce2, cvalid = chunk_data
        _, _, _, hit, _ = _mt_chunk(o, d, cv0, ce1, ce2, tmin, tmax_arr)
        return blocked | (hit & cvalid[None, :]).any(axis=1), None

    blocked, _ = jax.lax.scan(body, jnp.zeros((r,), bool),
                              (v0, e1, e2, valid))
    return blocked
