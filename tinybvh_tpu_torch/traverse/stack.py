"""BVH2 helpers of the stack traversal (≙ tinybvh_tpu/traverse/stack.py).

Ported: `pack_tris` (`BVH.refit` packs the deformed triangles with it)
and the slab test `_slab` (ops/queries.py's custom-primitive traversal).
Not ported: the BVH2 traversal engines of JAX traverse/stack.py
(`intersect_bvh2`, `is_occluded_bvh2`)."""

from __future__ import annotations

import torch

from tinybvh_tpu_torch.core.vecmath import BVH_FAR


def pack_tris(bvh, tris):
    """Triangles reordered into prim_idx order, so that each leaf's prims
    are one contiguous slab (the reference gathers through primIdx per
    leaf prim, tiny_bvh.h:3265). tris: (N, 3, 3), moved to the BVH's
    device."""
    idx = bvh.prim_idx
    tris = torch.as_tensor(tris, dtype=torch.float32, device=idx.device)
    return tris[idx.long()]


def _slab(o, rd, t, bmin, bmax):
    """Entry distance of rays (..., 3) into boxes [bmin, bmax] (..., 3),
    BVH_FAR where the box is missed or lies at or beyond t."""
    t1 = (bmin - o) * rd
    t2 = (bmax - o) * rd
    tmin = torch.minimum(t1, t2).amax(dim=-1)
    tmax = torch.maximum(t1, t2).amin(dim=-1)
    ok = (tmax >= tmin) & (tmin < t) & (tmax >= 0.0)
    return torch.where(ok, tmin, BVH_FAR)
