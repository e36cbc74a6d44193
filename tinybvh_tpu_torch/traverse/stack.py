"""BVH2 helpers of the stack traversal (≙ tinybvh_tpu/traverse/stack.py).

Only `pack_tris` is ported: `BVH.refit` packs the deformed triangles with
it. The BVH2 traversal engines (`intersect_bvh2`, `is_occluded_bvh2`)
are ROADMAP queue 1, item 6."""

from __future__ import annotations

import torch


def pack_tris(bvh, tris):
    """Triangles reordered into prim_idx order, so that each leaf's prims
    are one contiguous slab (the reference gathers through primIdx per
    leaf prim, tiny_bvh.h:3265). tris: (N, 3, 3), moved to the BVH's
    device."""
    idx = bvh.prim_idx
    tris = torch.as_tensor(tris, dtype=torch.float32, device=idx.device)
    return tris[idx.long()]
