"""Unified intersection API with the differentiability contract.

Design (SURVEY.md section 7 stage 6): the *discrete* part of intersection
(which triangle, did it hit) is inherently non-differentiable and runs
detached - whether it came from the brute-force oracle, the JAX BVH walk, or
the GPU traversal kernel. The *continuous* part (t, barycentrics) is then
recomputed in a few differentiable FLOPs from the detached tri_id, so
gradients flow from pixels to ray origins/directions and to the triangle
vertices without any custom_vjp on the traversal engines. Hit parameters are
piecewise-smooth in geometry; material gradients (the BASELINE.md target)
are exact.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.math import cross, dot
from . import brute, bvh_kernel, bvh_traverse
from .types import Hit

# Scenes up to this triangle count use the dense all-pairs sweep (at most 4
# chunks of 512, which XLA fuses with their min-reduction); above it, BVH
# traversal.
BRUTE_FORCE_MAX_TRIS = 2048

_ENGINES = {"brute": brute, "bvh": bvh_traverse, "bvh_kernel": bvh_kernel}
METHODS = ("auto", *_ENGINES)


def _resolve(method: str, scene) -> str:
    """'auto' -> brute for small scenes; above that the traversal kernel on
    the GPU and the vmapped while-loop walk elsewhere."""
    if method not in METHODS:
        raise ValueError(f"unknown intersect method {method!r} "
                         f"(one of {METHODS})")
    if method != "auto":
        return method
    if scene.tri_v0.shape[0] <= BRUTE_FORCE_MAX_TRIS:
        return "brute"
    return "bvh_kernel" if jax.default_backend() == "gpu" else "bvh"


def _engine(method: str):
    return _ENGINES[method]


def _refine(scene, o, d, hit: Hit, tmax):
    """Differentiably recompute (t, u, v) from the detached tri_id."""
    safe_id = jnp.maximum(hit.tri_id, 0)
    v0 = scene.tri_v0[safe_id]
    e1 = scene.tri_e1[safe_id]
    e2 = scene.tri_e2[safe_id]
    pvec = cross(d, e2)
    det = dot(e1, pvec)
    ok = jnp.abs(det) > 1e-12
    inv_det = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)
    tvec = o - v0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(d, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    live = hit.hit & ok
    return Hit(
        t=jnp.where(live, t, tmax),
        tri_id=hit.tri_id,
        u=jnp.where(live, u, 0.0),
        v=jnp.where(live, v, 0.0),
        hit=live,
        # recomputed here so engines only need to report (t, tri_id)
        back_face=live & (det < 0.0),
    )


def intersect_closest(scene, o, d, tmin=0.0, tmax=100.0, method="auto"):
    """Closest-hit query with differentiable refinement. method is one of
    METHODS ('auto' routes per backend and scene size - see _resolve)."""
    engine = _engine(_resolve(method, scene))
    o_det = jax.lax.stop_gradient(o)
    d_det = jax.lax.stop_gradient(d)
    scene_det = jax.lax.stop_gradient(scene)
    # tmin/tmax must be detached too: callers pass values derived from hit
    # positions (which carry material-parameter tangents from bounce 1 on),
    # and pallas_call has no JVP rule for a nonzero tangent.
    tmin = jax.lax.stop_gradient(tmin)
    tmax = jax.lax.stop_gradient(tmax)
    raw = engine.intersect_closest(scene_det, o_det, d_det, tmin, tmax)
    raw = jax.tree.map(jax.lax.stop_gradient, raw)
    tmax_arr = jnp.broadcast_to(jnp.asarray(tmax, jnp.float32),
                                o.shape[:-1])
    return _refine(scene, o, d, raw, tmax_arr)


def intersect_any(scene, o, d, tmin=0.0, tmax=100.0, method="auto"):
    """Occlusion query (boolean, non-differentiable by design - visibility
    is a step function; its gradient contribution is dropped as in standard
    detached-sampling differentiable renderers). method as in
    intersect_closest. Every input is detached, including tmin/tmax: the
    NEE shadow_tmax is derived from surf.position and would otherwise leak
    material tangents into the traversal kernel (pallas_call has no JVP
    rule)."""
    engine = _engine(_resolve(method, scene))
    o = jax.lax.stop_gradient(o)
    d = jax.lax.stop_gradient(d)
    scene = jax.lax.stop_gradient(scene)
    tmin = jax.lax.stop_gradient(tmin)
    tmax = jax.lax.stop_gradient(tmax)
    blocked = engine.intersect_any(scene, o, d, tmin, tmax)
    return jax.lax.stop_gradient(blocked)
