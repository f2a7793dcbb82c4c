"""ctypes bindings for the native (C++) host-runtime components.

The native BVH builder is compiled from bvh_builder.cpp on first use, into
build/ beside this file (not tracked by git), under a name keyed by the
source's hash, so a library built from other sources is never loaded. It is
built for the generic x86-64 target: the build directory may travel to
another host. If compilation fails, callers fall back to the pure-numpy
builder in scene/bvh.py - same output layout, just slower on big scenes.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "bvh_builder.cpp")
_lib = None
_load_failed = False


def lib_path() -> str:
    """Where the builder library for the current source lives."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_DIR, "build", f"libbvh_builder-{digest}.so")


def _ensure_lib():
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    try:
        path = lib_path()
        if not os.path.exists(path):
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            subprocess.run(
                ["g++", "-O3", "-fPIC", "-shared", "-std=c++17", "-o", tmp,
                 _SRC], check=True, capture_output=True, cwd=_DIR)
            os.replace(tmp, path)  # atomic: parallel test workers race here
        lib = ctypes.CDLL(path)
        lib.bvh_build.restype = ctypes.c_int64
        lib.bvh_build.argtypes = [
            ctypes.POINTER(ctypes.c_float),   # v0
            ctypes.POINTER(ctypes.c_float),   # v1
            ctypes.POINTER(ctypes.c_float),   # v2
            ctypes.c_int64,                   # n_tris
            ctypes.POINTER(ctypes.c_float),   # node_min
            ctypes.POINTER(ctypes.c_float),   # node_max
            ctypes.POINTER(ctypes.c_int32),   # node_skip
            ctypes.POINTER(ctypes.c_int32),   # node_first
            ctypes.POINTER(ctypes.c_int32),   # node_count
            ctypes.POINTER(ctypes.c_int32),   # tri_order
        ]
        _lib = lib
    except Exception as e:  # compilation or load failure -> numpy fallback
        import warnings
        warnings.warn(f"native BVH builder unavailable ({e}); "
                      "using numpy fallback")
        _load_failed = True
    return _lib


def native_available() -> bool:
    return _ensure_lib() is not None


def build_bvh_native(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray):
    """Build a skip-link BVH with the C++ builder. Returns the same tuple
    layout as scene.bvh.BVHArrays or None if the native lib is missing."""
    lib = _ensure_lib()
    if lib is None:
        return None
    n = len(v0)
    v0 = np.ascontiguousarray(v0, np.float32)
    v1 = np.ascontiguousarray(v1, np.float32)
    v2 = np.ascontiguousarray(v2, np.float32)
    bound = 2 * n + 1
    node_min = np.empty((bound, 3), np.float32)
    node_max = np.empty((bound, 3), np.float32)
    node_skip = np.empty(bound, np.int32)
    node_first = np.empty(bound, np.int32)
    node_count = np.empty(bound, np.int32)
    tri_order = np.empty(n, np.int32)

    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    n_nodes = lib.bvh_build(
        v0.ctypes.data_as(fp), v1.ctypes.data_as(fp), v2.ctypes.data_as(fp),
        n,
        node_min.ctypes.data_as(fp), node_max.ctypes.data_as(fp),
        node_skip.ctypes.data_as(ip), node_first.ctypes.data_as(ip),
        node_count.ctypes.data_as(ip), tri_order.ctypes.data_as(ip))
    if n_nodes <= 0:
        return None
    from ..scene.bvh import BVHArrays
    return BVHArrays(
        node_min=node_min[:n_nodes].copy(),
        node_max=node_max[:n_nodes].copy(),
        node_skip=node_skip[:n_nodes].copy(),
        node_first=node_first[:n_nodes].copy(),
        node_count=node_count[:n_nodes].copy(),
        tri_order=tri_order,
    )
