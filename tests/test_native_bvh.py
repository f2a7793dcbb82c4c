"""Native C++ BVH builder: structural validity + traversal equivalence with
the brute-force oracle, and build-speed sanity vs the numpy builder."""
import time

import numpy as np
import pytest

from optixpathtracer_tpu.native import build_bvh_native, native_available
from optixpathtracer_tpu.scene import bvh as bvh_py

pytestmark = pytest.mark.skipif(not native_available(),
                                reason="native builder unavailable")


def _random_tris(n, seed=0):
    rng = np.random.default_rng(seed)
    v0 = rng.random((n, 3), np.float32) * 10.0
    v1 = v0 + rng.normal(0, 0.3, (n, 3)).astype(np.float32)
    v2 = v0 + rng.normal(0, 0.3, (n, 3)).astype(np.float32)
    return v0, v1, v2


def _check_structure(tree, n_tris):
    n = len(tree.node_min)
    assert (tree.node_skip > np.arange(n)).all()  # miss links go forward
    assert (tree.node_skip <= n).all()
    leaves = tree.node_count > 0
    # leaves cover exactly [0, n_tris) contiguously in DFS order
    firsts = tree.node_first[leaves]
    counts = tree.node_count[leaves]
    order = np.argsort(firsts)
    assert firsts[order][0] == 0
    assert (firsts[order][1:] == (firsts + counts)[order][:-1]).all()
    assert (firsts + counts)[order][-1] == n_tris
    # tri_order is a permutation
    assert sorted(tree.tri_order.tolist()) == list(range(n_tris))
    # children boxes inside parents: walk DFS with a stack of parent boxes
    inner = ~leaves
    rights = tree.node_first[inner]
    assert (rights > np.flatnonzero(inner)).all()


def test_library_built_from_source_into_ignored_dir():
    """The builder is compiled from bvh_builder.cpp into native/build/,
    named by the source's hash; no binary is tracked by git."""
    import os
    from optixpathtracer_tpu import native
    path = native.lib_path()
    assert os.path.exists(path)
    assert os.path.basename(os.path.dirname(path)) == "build"
    repo = os.path.dirname(os.path.dirname(os.path.dirname(path)))
    with open(os.path.join(os.path.dirname(repo), ".gitignore")) as f:
        assert "optixpathtracer_tpu/native/build/" in f.read().split()
    assert path == native.lib_path()


def test_structure_random():
    v0, v1, v2 = _random_tris(5000)
    tree = build_bvh_native(v0, v1, v2)
    _check_structure(tree, 5000)


def test_traversal_matches_oracle():
    import jax.numpy as jnp
    from optixpathtracer_tpu.intersect import brute, bvh_traverse
    from optixpathtracer_tpu.scene import Material, Model, flatten_model
    from optixpathtracer_tpu.scene.procedural import uv_sphere

    mesh = uv_sphere(1.0, (0, 0, 0), 16, 32, Material(mat_type="diffuse"))
    scene = flatten_model(Model(meshes=[mesh]), [])  # uses native builder

    rng = np.random.default_rng(3)
    o = jnp.asarray(rng.normal(0, 3, (512, 3)).astype(np.float32))
    d = rng.normal(0, 1, (512, 3)).astype(np.float32)
    d = jnp.asarray(d / np.linalg.norm(d, axis=-1, keepdims=True))

    h_brute = brute.intersect_closest(scene, o, d, 0.0, 100.0)
    h_bvh = bvh_traverse.intersect_closest(scene, o, d, 0.0, 100.0)
    np.testing.assert_array_equal(np.asarray(h_brute.hit),
                                  np.asarray(h_bvh.hit))
    m = np.asarray(h_brute.hit)
    np.testing.assert_array_equal(np.asarray(h_brute.tri_id)[m],
                                  np.asarray(h_bvh.tri_id)[m])


def test_native_faster_than_numpy_at_scale():
    v0, v1, v2 = _random_tris(60000, seed=7)
    t0 = time.time()
    build_bvh_native(v0, v1, v2)
    t_native = time.time() - t0
    t0 = time.time()
    bvh_py.build_bvh(v0, v1, v2, use_native=False)
    t_numpy = time.time() - t0
    # the native builder should win handily; loose 2x bound to avoid flakes
    assert t_native < t_numpy / 2.0, (t_native, t_numpy)
