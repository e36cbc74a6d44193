"""BVH serialization and the build cache (≙ tinybvh_tpu/io/serialize.py;
the reference's Save / Load, tiny_bvh.h:1747-1799, per-layout variants at
4779, 5404, 5614, 5786, and the scene layer's disk cache,
Scene::CacheBVHs, tiny_scene.h:2035-2113).

The file format is JAX's, byte for byte: an .npz of the layout's arrays
(each in JAX's dtype) and a version + layout tag (≙
TINY_BVH_CACHE_VERSION + (layout << 24), tiny_bvh.h:97, 1778-1787), so a
file saved by either package loads in the other. A load fails cleanly
(None) on a tag mismatch or a corrupt file. The cache keys on a geometry
hash, so deformed scenes rebuild."""

from __future__ import annotations

import functools
import hashlib
import os

import numpy as np
import torch

from tinybvh_tpu_torch.core.rays import default_device
from tinybvh_tpu_torch.layouts.bvh2 import BVH2
from tinybvh_tpu_torch.layouts.cwbvh import BVH8Q
from tinybvh_tpu_torch.layouts.mbvh import BVH8
from tinybvh_tpu_torch.tlas.instance import TLAS8

CACHE_VERSION = 1

_LAYOUTS = {"BVH2": 0, "BVH8": 1, "TLAS8": 2, "BVH8Q": 3}
_CLASSES = {"BVH2": BVH2, "BVH8": BVH8, "BVH8Q": BVH8Q, "TLAS8": TLAS8}
_FIELDS = {
    "BVH2": ("node_min", "node_max", "left_first", "count", "prim_idx"),
    "BVH8": ("bounds", "child", "leaf_tris", "leaf_prim"),
    "BVH8Q": ("origin", "scale", "qbounds", "child", "leaf_tris",
              "leaf_prim"),
    "TLAS8": ("bounds", "child", "leaf_tris", "leaf_prim", "inst_inv",
              "inst_mask", "inst_root"),
}


def _tag(layout: str) -> int:
    return CACHE_VERSION | (_LAYOUTS[layout] << 24)


def save_bvh(path: str, obj) -> None:
    """Save a BVH2, BVH8, BVH8Q or TLAS8 (tensors on any device)."""
    layout = next((k for k, cls in _CLASSES.items()
                   if isinstance(obj, cls)), None)
    if layout is None:
        raise TypeError(f"cannot serialize {type(obj)}")
    arrays = {k: getattr(obj, k).detach().cpu().numpy()
              for k in _FIELDS[layout]}
    if layout == "BVH2":     # JAX keeps n_nodes as an int32 scalar
        arrays["n_nodes"] = np.asarray(obj.n_nodes, np.int32)
    elif layout == "TLAS8":
        arrays["n_leaf_rows"] = np.asarray(obj.n_leaf_rows)
    np.savez(path, __tag__=np.asarray(_tag(layout), np.int64), **arrays)


def load_bvh(path: str, device=None):
    """The saved structure with its tensors on `device` (default: the
    card), or None on a version / layout mismatch or a corrupt file (≙
    Load returning false, tiny_bvh.h:1778-1787)."""
    try:
        data = np.load(path)
        tag = int(data["__tag__"])
    except Exception:
        return None
    if tag & 0xFFFFFF != CACHE_VERSION:
        return None
    layout = next((k for k, v in _LAYOUTS.items() if v == tag >> 24), None)
    if layout is None:
        return None
    dev = default_device(device)
    kw = {k: torch.from_numpy(data[k]).to(dev) for k in _FIELDS[layout]}
    if layout == "BVH2":
        kw["n_nodes"] = int(data["n_nodes"])
    elif layout == "TLAS8":
        kw["n_leaf_rows"] = int(data["n_leaf_rows"])
    return _CLASSES[layout](**kw)


def geometry_hash(tris) -> str:
    """Stable key of the build cache."""
    if isinstance(tris, torch.Tensor):
        tris = tris.detach().cpu().numpy()
    a = np.ascontiguousarray(np.asarray(tris, np.float32))
    return hashlib.sha1(a.tobytes()).hexdigest()[:16]


def cached_build(tris, builder, cache_dir: str = "./cache", suffix: str = "",
                 device=None):
    """Load-or-build-then-save (≙ the per-mesh ./cache/<file>.bvh pattern,
    tiny_scene.h:2035-2113). The key hashes the geometry and the
    builder's identity (module.qualname and the repr of a
    functools.partial's arguments), so one mesh built by different
    builders or parameters never aliases; `suffix` is for the caller's
    own discrimination. A cached structure loads onto `device`
    (default: the card)."""
    os.makedirs(cache_dir, exist_ok=True)
    key = geometry_hash(tris)
    b = builder
    params = ""
    if isinstance(b, functools.partial):
        params = repr((b.args, sorted(b.keywords.items())))
        b = b.func
    ident = (f"{getattr(b, '__module__', '')}."
             f"{getattr(b, '__qualname__', repr(b))}{params}")
    bkey = hashlib.sha1(ident.encode()).hexdigest()[:8]
    path = os.path.join(cache_dir, f"{key}-{bkey}{suffix}.npz")
    if os.path.exists(path):
        got = load_bvh(path, device)
        if got is not None:
            return got
    built = builder(tris)
    save_bvh(path, built)
    return built
