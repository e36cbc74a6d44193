"""ctypes loader for the native host builder, with no jax in it.

Compiles `tinybvh_tpu/native/builder.c` BY PATH (the JAX package is never
imported) into the port's ignored `_build/` directory, with the same
compiler flags as the JAX package's loader, so both packages build
bit-identical trees from the same triangles. Raises RuntimeError where
no C compiler is found: the numpy fallback builder is not ported yet.
"""

from __future__ import annotations

import ctypes
import os
import shutil

import numpy as np

from tinybvh_tpu_torch._build import compile_once

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tinybvh_tpu", "native", "builder.c")
CC_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]

_lib = None

_F = ctypes.POINTER(ctypes.c_float)
_I = ctypes.POINTER(ctypes.c_int32)
_i32 = ctypes.c_int32


def _load():
    global _lib
    if _lib is None:
        cc = shutil.which("cc") or shutil.which("gcc")
        if cc is None:
            raise RuntimeError("no C compiler found to build builder.c")
        lib = ctypes.CDLL(compile_once([cc], [_SRC], CC_FLAGS,
                                       "libtinybvh_native"))
        lib.tinybvh_build_binned.restype = _i32
        lib.tinybvh_build_binned.argtypes = [
            _F, _i32, _i32, _F, _F, _I, _I, _I, _F, _F, _F]
        lib.tinybvh_collapse_bvh8.restype = _i32
        lib.tinybvh_collapse_bvh8.argtypes = [
            _F, _F, _I, _I, _i32, _I, _F, _i32, _i32, _i32, _F, _I, _F, _I,
            _I]
        _lib = lib
    return _lib


def _pf(a):
    return a.ctypes.data_as(_F)


def _pi(a):
    return a.ctypes.data_as(_I)


def build_binned_native(tris, max_leaf: int = 4, return_host: bool = False,
                        make_device: bool = False):
    """C binned-SAH build (builder.c: tinybvh_build_binned). Returns the
    host dict (node_min, node_max, left_first, count, prim_idx, n_nodes);
    with return_host, (None, host) as the JAX package's
    make_device=False form. Device BVH2 arrays are not ported yet."""
    if make_device:
        raise NotImplementedError(
            "device BVH2 arrays are not ported (ROADMAP queue 1, slice 6)")
    lib = _load()
    tris = np.ascontiguousarray(np.asarray(tris, np.float32).reshape(-1, 9))
    n = tris.shape[0]
    m = 2 * n + 2
    node_min = np.empty((m, 3), np.float32)
    node_max = np.empty((m, 3), np.float32)
    left_first = np.zeros(m, np.int32)
    count = np.zeros(m, np.int32)
    prim_idx = np.empty(n, np.int32)
    fmin = np.empty((n, 3), np.float32)
    fmax = np.empty((n, 3), np.float32)
    cent = np.empty((n, 3), np.float32)
    n_used = lib.tinybvh_build_binned(
        _pf(tris), n, max_leaf or 0, _pf(node_min), _pf(node_max),
        _pi(left_first), _pi(count), _pi(prim_idx),
        _pf(fmin), _pf(fmax), _pf(cent))
    if n_used < 0:
        raise RuntimeError("native BVH build failed (allocation)")
    # unused pool slots: degenerate boxes (traversal never reaches them)
    node_min[n_used:] = 1e30
    node_max[n_used:] = -1e30
    node_min[1] = 1e30
    node_max[1] = -1e30
    host = dict(node_min=node_min, node_max=node_max, left_first=left_first,
                count=count, prim_idx=prim_idx, n_nodes=int(n_used))
    return (None, host) if return_host else host


def collapse_bvh8_native(host: dict, tris, width: int = 8,
                         combine: int = 4) -> dict:
    """C 8-wide collapse with leaf combining (builder.c:
    tinybvh_collapse_bvh8, ≙ CombineLeafs(4) + MBVH<8>::ConvertFrom).
    Returns dict(bounds, child, leaf_tris, leaf_prim) of numpy arrays."""
    lib = _load()
    tris = np.ascontiguousarray(np.asarray(tris, np.float32).reshape(-1, 9))
    n_tris = tris.shape[0]
    n_nodes = int(host["n_nodes"])
    node_min = np.ascontiguousarray(host["node_min"][:n_nodes], np.float32)
    node_max = np.ascontiguousarray(host["node_max"][:n_nodes], np.float32)
    left_first = np.ascontiguousarray(host["left_first"][:n_nodes], np.int32)
    count = np.ascontiguousarray(host["count"][:n_nodes], np.int32)
    prim_idx = np.ascontiguousarray(host["prim_idx"], np.int32)
    cap_n = max(n_nodes, 2)
    cap_l = n_tris + 8
    bounds = np.empty((cap_n, 48), np.float32)
    child = np.empty((cap_n, 8), np.int32)
    leaf_tris = np.empty((cap_l, 36), np.float32)
    leaf_prim = np.empty((cap_l, 4), np.int32)
    n_leaves = np.zeros(1, np.int32)
    n_out = lib.tinybvh_collapse_bvh8(
        _pf(node_min), _pf(node_max), _pi(left_first), _pi(count), n_nodes,
        _pi(prim_idx), _pf(tris), width, 4, combine,
        _pf(bounds), _pi(child), _pf(leaf_tris), _pi(leaf_prim),
        _pi(n_leaves))
    if n_out < 0:
        raise RuntimeError("native BVH8 collapse failed")
    nl = int(n_leaves[0])
    return dict(bounds=bounds[:n_out].copy(), child=child[:n_out].copy(),
                leaf_tris=leaf_tris[:nl].reshape(nl, 4, 3, 3).copy(),
                leaf_prim=leaf_prim[:nl].copy())
