"""BVH build: binned-SAH BVH2 flattened to a skip-link layout for stackless
traversal.

This replaces the reference's hardware GAS build (`OptixRenderer.cpp:306-456`
`optixAccelBuild` + RT-core traversal) - the one component the reference got
from hardware that this framework must own (SURVEY.md section 7 stage 2/3).

Build is host-side numpy (a native C++ builder is the planned upgrade for
large scenes); the output is four flat arrays in depth-first order:

  node_min/node_max [N, 3]  AABBs
  node_skip [N]             node to jump to when the AABB test misses
                            (the DFS "miss link"); == N means traversal done
  node_first [N]            leaf: first index into the *reordered* triangle
                            array; inner: index of right child (left = i+1)
  node_count [N]            leaf: triangle count; inner: 0

Traversal never needs a stack: hit an inner node -> descend to i+1 (left
child first); miss or finish a leaf -> jump to node_skip[i]. Triangles are
globally reordered so every leaf is a contiguous range; `tri_order` maps new
index -> original index for attribute lookup.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

N_BINS = 16
MAX_LEAF_SIZE = 4
TRAVERSAL_COST = 1.0
INTERSECT_COST = 1.0


class BVHArrays(NamedTuple):
    node_min: np.ndarray   # [N, 3] float32
    node_max: np.ndarray   # [N, 3] float32
    node_skip: np.ndarray  # [N] int32
    node_first: np.ndarray  # [N] int32
    node_count: np.ndarray  # [N] int32
    tri_order: np.ndarray  # [T] int32 new -> old triangle index


class _Node:
    __slots__ = ("bb_min", "bb_max", "left", "right", "first", "count")

    def __init__(self):
        self.left = None
        self.right = None
        self.first = 0
        self.count = 0


def _build_recursive(node, idx, centroids, bb_min_tri, bb_max_tri, order,
                     offset):
    node.bb_min = bb_min_tri[idx].min(axis=0)
    node.bb_max = bb_max_tri[idx].max(axis=0)
    n = len(idx)
    if n <= MAX_LEAF_SIZE:
        node.first = offset
        node.count = n
        order.extend(idx.tolist())
        return

    c = centroids[idx]
    c_min = c.min(axis=0)
    c_max = c.max(axis=0)
    extent = c_max - c_min
    axis = int(np.argmax(extent))
    if extent[axis] <= 1e-12:
        # Degenerate spread: make a leaf (all centroids coincide).
        node.first = offset
        node.count = n
        order.extend(idx.tolist())
        return

    # Binned SAH over the widest centroid axis.
    scale = N_BINS * (1.0 - 1e-6) / extent[axis]
    bins = ((c[:, axis] - c_min[axis]) * scale).astype(np.int32)
    bins = np.clip(bins, 0, N_BINS - 1)

    bin_count = np.zeros(N_BINS, np.int64)
    bin_min = np.full((N_BINS, 3), np.inf)
    bin_max = np.full((N_BINS, 3), -np.inf)
    np.add.at(bin_count, bins, 1)
    for a in range(3):
        np.minimum.at(bin_min[:, a], bins, bb_min_tri[idx, a])
        np.maximum.at(bin_max[:, a], bins, bb_max_tri[idx, a])

    # prefix/suffix surface areas
    def _area(lo, hi):
        d = np.maximum(hi - lo, 0.0)
        return d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0]

    left_min = np.minimum.accumulate(bin_min, axis=0)
    left_max = np.maximum.accumulate(bin_max, axis=0)
    right_min = np.minimum.accumulate(bin_min[::-1], axis=0)[::-1]
    right_max = np.maximum.accumulate(bin_max[::-1], axis=0)[::-1]
    left_count = np.cumsum(bin_count)
    right_count = np.cumsum(bin_count[::-1])[::-1]

    costs = np.full(N_BINS - 1, np.inf)
    for split in range(N_BINS - 1):
        nl = left_count[split]
        nr = right_count[split + 1]
        if nl == 0 or nr == 0:
            continue
        costs[split] = (_area(left_min[split], left_max[split]) * nl
                        + _area(right_min[split + 1], right_max[split + 1]) * nr)

    if not np.isfinite(costs).any():
        # SAH found no useful split: median split.
        med = np.argsort(c[:, axis])
        half = n // 2
        li, ri = idx[med[:half]], idx[med[half:]]
    else:
        split = int(np.argmin(costs))
        go_left = bins <= split
        li, ri = idx[go_left], idx[~go_left]

    node.left = _Node()
    node.right = _Node()
    _build_recursive(node.left, li, centroids, bb_min_tri, bb_max_tri, order,
                     offset)
    _build_recursive(node.right, ri, centroids, bb_min_tri, bb_max_tri, order,
                     offset + len(li))


def _subtree_sizes(node, sizes):
    if node.left is None:
        sizes[id(node)] = 1
    else:
        _subtree_sizes(node.left, sizes)
        _subtree_sizes(node.right, sizes)
        sizes[id(node)] = 1 + sizes[id(node.left)] + sizes[id(node.right)]
    return sizes[id(node)]


def _flatten(node, arrays, i, skip_target, sizes):
    """DFS flatten with miss links: on AABB miss (or after a leaf) jump to
    `skip_target`; on inner-node hit descend to i+1 (left child). Returns
    the next free slot."""
    arrays["min"][i] = node.bb_min
    arrays["max"][i] = node.bb_max
    arrays["skip"][i] = skip_target
    if node.left is None:
        arrays["first"][i] = node.first
        arrays["count"][i] = node.count
        return i + 1
    right_idx = i + 1 + sizes[id(node.left)]
    arrays["first"][i] = right_idx
    arrays["count"][i] = 0
    _flatten(node.left, arrays, i + 1, right_idx, sizes)
    return _flatten(node.right, arrays, right_idx, skip_target, sizes)


def build_bvh(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray,
              use_native: bool = True) -> BVHArrays:
    """Build from world-space triangle vertices [T, 3] each.

    Prefers the native C++ builder (optixpathtracer_tpu/native) - the
    production path for Sponza-class scenes - falling back to this module's
    numpy implementation when the native lib is unavailable.
    """
    t = len(v0)
    if t == 0:
        raise ValueError("empty triangle list")
    if use_native:
        try:
            from ..native import build_bvh_native
            result = build_bvh_native(v0, v1, v2)
            if result is not None:
                return result
        except Exception:
            pass
    bb_min_tri = np.minimum(np.minimum(v0, v1), v2)
    bb_max_tri = np.maximum(np.maximum(v0, v1), v2)
    centroids = (v0 + v1 + v2) / 3.0

    import sys
    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000))
    try:
        root = _Node()
        order: list = []
        _build_recursive(root, np.arange(t), centroids, bb_min_tri,
                         bb_max_tri, order, 0)
        sizes: dict = {}
        n = _subtree_sizes(root, sizes)
        arrays = {
            "min": np.zeros((n, 3), np.float32),
            "max": np.zeros((n, 3), np.float32),
            "skip": np.zeros(n, np.int64),
            "first": np.zeros(n, np.int64),
            "count": np.zeros(n, np.int64),
        }
        used = _flatten(root, arrays, 0, n, sizes)
        assert used == n
    finally:
        sys.setrecursionlimit(old_limit)

    return BVHArrays(
        node_min=arrays["min"],
        node_max=arrays["max"],
        node_skip=arrays["skip"].astype(np.int32),
        node_first=arrays["first"].astype(np.int32),
        node_count=arrays["count"].astype(np.int32),
        tri_order=np.asarray(order, np.int32),
    )
