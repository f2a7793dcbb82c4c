"""Stackless skip-link BVH traversal as a Pallas kernel for the GPU (Triton).

The same algorithm as intersect/bvh_traverse.py - the DFS-ordered node array
from scene/bvh.py, AABB hit on an inner node -> node + 1, miss or leaf ->
node_skip - but with its lockstep cut down from the whole wavefront to one
warp: each program owns BLOCK rays (one lane each) and loops until its own
rays are done, so a block of fast rays no longer waits for the slowest ray
of the frame, and the loop predicate never leaves the device.

Closest-hit shrinks the box test by the running best t; any-hit stops a lane
at its first hit. Lanes with an empty [tmin, tmax] interval (dead lanes carry
tmax = -1, integrate/path.py) exit before the first node. The kernel returns
only (t, tri_id); intersect/api.py recomputes u, v and the back face
differentiably, and detaches every input, so the call needs no gradient rule.

On the CPU backend the same kernel runs in Pallas interpret mode (tests).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..scene.bvh import MAX_LEAF_SIZE
from .types import Hit

BLOCK = 32      # rays per program: one warp, one ray per lane
NUM_WARPS = 1
EPS_DET = 1e-12
NODE_F = 8      # floats per node record: min xyz, max xyz, 2 spare
NODE_I = 4      # ints per node record: skip, first, count, spare
TRI_F = 9       # floats per triangle: v0, e1, e2


def _any(mask):
    # reduce_or has no Triton lowering; reduce_max over int32 does
    return jnp.max(mask.astype(jnp.int32)) > 0


def _traverse_kernel(ray_ref, box_ref, link_ref, tri_ref, t_ref, id_ref, *,
                     n_nodes: int, any_hit: bool):
    ox, oy, oz = ray_ref[0, :], ray_ref[1, :], ray_ref[2, :]
    dx, dy, dz = ray_ref[3, :], ray_ref[4, :], ray_ref[5, :]
    tmin, tmax = ray_ref[6, :], ray_ref[7, :]

    def inv(c):
        safe = jnp.where(jnp.abs(c) < 1e-20,
                         jnp.where(c >= 0.0, 1e-20, -1e-20), c)
        return 1.0 / safe
    ix, iy, iz = inv(dx), inv(dy), inv(dz)

    def leaf_tests(first, n_leaf, best_t, best_id):
        """Moller-Trumbore over every lane's leaf, MAX_LEAF_SIZE triangles
        per trip (degenerate leaves from the builder may hold more)."""
        def body(c):
            k0, bt, bi = c
            for k in range(MAX_LEAF_SIZE):
                on = (k0 + k) < n_leaf
                j = jnp.where(on, first + k0 + k, 0)
                b = j * TRI_F
                v0x, v0y, v0z = tri_ref[b], tri_ref[b + 1], tri_ref[b + 2]
                e1x, e1y, e1z = tri_ref[b + 3], tri_ref[b + 4], tri_ref[b + 5]
                e2x, e2y, e2z = tri_ref[b + 6], tri_ref[b + 7], tri_ref[b + 8]
                px = dy * e2z - dz * e2y
                py = dz * e2x - dx * e2z
                pz = dx * e2y - dy * e2x
                det = e1x * px + e1y * py + e1z * pz
                ok = jnp.abs(det) > EPS_DET
                inv_det = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)
                tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
                u = (tx * px + ty * py + tz * pz) * inv_det
                qx = ty * e1z - tz * e1y
                qy = tz * e1x - tx * e1z
                qz = tx * e1y - ty * e1x
                v = (dx * qx + dy * qy + dz * qz) * inv_det
                t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
                take = (on & ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
                        & (t > tmin) & (t < bt))
                bt = jnp.where(take, t, bt)
                bi = jnp.where(take, j, bi)
            return k0 + MAX_LEAF_SIZE, bt, bi

        n_max = jnp.max(n_leaf)
        _, best_t, best_id = jax.lax.while_loop(
            lambda c: c[0] < n_max, body, (jnp.int32(0), best_t, best_id))
        return best_t, best_id

    def cond(s):
        return _any(s[3])

    def body(s):
        node, best_t, best_id, active = s
        nd = jnp.where(active, node, 0)
        b = nd * NODE_F
        t0x = (box_ref[b] - ox) * ix
        t1x = (box_ref[b + 3] - ox) * ix
        t0y = (box_ref[b + 1] - oy) * iy
        t1y = (box_ref[b + 4] - oy) * iy
        t0z = (box_ref[b + 2] - oz) * iz
        t1z = (box_ref[b + 5] - oz) * iz
        t_near = jnp.maximum(jnp.maximum(jnp.minimum(t0x, t1x),
                                         jnp.minimum(t0y, t1y)),
                             jnp.minimum(t0z, t1z))
        t_far = jnp.minimum(jnp.minimum(jnp.maximum(t0x, t1x),
                                        jnp.maximum(t0y, t1y)),
                            jnp.maximum(t0z, t1z))
        box_hit = (active & (t_near <= t_far) & (t_far >= tmin)
                   & (t_near <= best_t))
        li = nd * NODE_I
        skip, first, count = link_ref[li], link_ref[li + 1], link_ref[li + 2]
        n_leaf = jnp.where(box_hit, count, 0)
        best_t, best_id = leaf_tests(first, n_leaf, best_t, best_id)
        nxt = jnp.where(box_hit & (count == 0), nd + 1, skip)
        active = active & (nxt < n_nodes)
        if any_hit:
            active = active & (best_id < 0)
        return nxt, best_t, best_id, active

    init = (jnp.zeros((BLOCK,), jnp.int32), tmax,
            jnp.full((BLOCK,), -1, jnp.int32), tmax > tmin)
    _, best_t, best_id, _ = jax.lax.while_loop(cond, body, init)
    t_ref[...] = best_t
    id_ref[...] = best_id


def pack_scene(scene):
    """The kernel's flat views of the scene: node boxes [N * NODE_F] f32,
    node links [N * NODE_I] i32, triangles [T * TRI_F] f32 (padding
    triangles get zero edges, so their determinant fails the test)."""
    n = scene.bvh_min.shape[0]
    box = jnp.concatenate([scene.bvh_min, scene.bvh_max,
                           jnp.zeros((n, NODE_F - 6), jnp.float32)], axis=1)
    links = jnp.stack([scene.bvh_skip, scene.bvh_first, scene.bvh_count,
                       jnp.zeros((n,), jnp.int32)], axis=1)
    valid = scene.tri_valid[:, None]
    tris = jnp.concatenate([scene.tri_v0,
                            jnp.where(valid, scene.tri_e1, 0.0),
                            jnp.where(valid, scene.tri_e2, 0.0)], axis=1)
    return (box.reshape(-1).astype(jnp.float32),
            links.reshape(-1).astype(jnp.int32),
            tris.reshape(-1).astype(jnp.float32))


def pack_rays(o, d, tmin, tmax):
    """Rays as one [8, R_pad] f32 slab (o xyz, d xyz, tmin, tmax), R padded
    up to a whole number of BLOCKs with dead rays (tmax = -1)."""
    r = o.shape[0]
    tmin = jnp.broadcast_to(jnp.asarray(tmin, jnp.float32), (r,))
    tmax = jnp.broadcast_to(jnp.asarray(tmax, jnp.float32), (r,))
    rays = jnp.concatenate([o.T, d.T, tmin[None], tmax[None]],
                           axis=0).astype(jnp.float32)
    pad = -r % BLOCK
    if pad:
        dead = jnp.zeros((8, pad), jnp.float32).at[7].set(-1.0)
        rays = jnp.concatenate([rays, dead], axis=1)
    return rays


def _interpret() -> bool:
    backend = jax.default_backend()
    if backend == "cpu":
        return True
    if backend != "gpu":
        raise RuntimeError(f"bvh_kernel needs a GPU or the CPU interpreter, "
                           f"not {backend!r}")
    return False


def traverse(scene, o, d, tmin, tmax, any_hit: bool):
    """(t [R] f32, tri_id [R] i32) from the kernel; tri_id = -1 and t = tmax
    on a miss."""
    r = o.shape[0]
    rays = pack_rays(o, d, tmin, tmax)
    box, links, tris = pack_scene(scene)
    r_pad = rays.shape[1]
    n_nodes = scene.bvh_min.shape[0]
    whole = lambda a: pl.BlockSpec(a.shape, lambda i: (0,))
    kernel = functools.partial(_traverse_kernel, n_nodes=n_nodes,
                               any_hit=any_hit)
    t, tri_id = pl.pallas_call(
        kernel,
        grid=(r_pad // BLOCK,),
        in_specs=[pl.BlockSpec((8, BLOCK), lambda i: (0, i)),
                  whole(box), whole(links), whole(tris)],
        out_specs=[pl.BlockSpec((BLOCK,), lambda i: (i,)),
                   pl.BlockSpec((BLOCK,), lambda i: (i,))],
        out_shape=[jax.ShapeDtypeStruct((r_pad,), jnp.float32),
                   jax.ShapeDtypeStruct((r_pad,), jnp.int32)],
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        backend="triton",
        interpret=_interpret(),
        name="bvh_any" if any_hit else "bvh_closest",
    )(rays, box, links, tris)
    return t[:r], tri_id[:r]


def intersect_closest(scene, o, d, tmin=0.0, tmax=100.0):
    """Closest hit via the kernel. o, d: [R, 3]. Returns Hit [R] with
    (t, tri_id, hit) set; u, v and back_face are left to api._refine."""
    t, tri_id = traverse(scene, o, d, tmin, tmax, any_hit=False)
    hit = tri_id >= 0
    zero = jnp.zeros_like(t)
    return Hit(t=t, tri_id=tri_id, u=zero, v=zero, hit=hit,
               back_face=jnp.zeros_like(hit))


def intersect_any(scene, o, d, tmin=0.0, tmax=100.0):
    """Occlusion query via the kernel, first-hit exit per lane."""
    _, tri_id = traverse(scene, o, d, tmin, tmax, any_hit=True)
    return tri_id >= 0
