"""Bottom-up BVH refit as level-parallel updates
(≙ tinybvh_tpu/builders/refit.py; BVH::Refit, tiny_bvh.h:3055-3093, and
MBVH<M>::Refit, tiny_bvh.h:4925-4961).

The reference sweeps nodes in reverse allocation order. Here the nodes
are bucketed by depth once per topology, on the host (the plan), and each
level is then updated at once with tensor ops on the BVH's device,
deepest level first:

  * `refit`      — the BVH2 (feeds the re-collapse of `BVH.refit`);
  * `refit_bvh8` — the 8-wide layout directly: leaf triangles are
    regathered from the deformed triangles through leaf_prim and every
    node's 8 child boxes are rebuilt, the collapse topology kept (≙
    BVH8_CPU::Refit, tiny_bvh.h:5653). Rebuild the packet tables after it
    with traverse.packet2.build_packet_aux, on the same device.

Each level is written with `index_copy_` in the plan's row order; the
boxes are mins and maxes, so they equal the JAX package's bit for bit."""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from tinybvh_tpu_torch.core.vecmath import BVH_FAR
from tinybvh_tpu_torch.layouts.bvh2 import BVH2, node_depths_host
from tinybvh_tpu_torch.layouts.mbvh import BVH8, EMPTY_SLOT


def refit_plan(bvh: BVH2):
    """Node ids of each depth, deepest level first: a list of int64
    tensors on the BVH's device. Depends on the topology, not on the
    geometry, so it serves every frame while the tree shape holds (the
    reference forbids refit after spatial splits, tiny_bvh.h:3057)."""
    depth = node_depths_host(bvh)
    dev = bvh.left_first.device
    return [torch.from_numpy(np.nonzero(depth == d)[0]).to(dev)
            for d in range(int(depth.max()), -1, -1)
            if (depth == d).any()]


def refit(bvh: BVH2, packed_tris, plan=None, leaf_max: int = 16) -> BVH2:
    """New node AABBs for deformed geometry, topology kept. packed_tris:
    (N, 3, 3) triangles already in prim_idx order (traverse.stack.
    pack_tris); leaf_max bounds the leaves' prim count."""
    if plan is None:
        plan = refit_plan(bvh)
    return _refit_impl(bvh, packed_tris, plan, leaf_max)


def _refit_impl(bvh: BVH2, packed_tris, plan, leaf_max: int) -> BVH2:
    tri_min = packed_tris.amin(dim=1)                     # (N, 3)
    tri_max = packed_tris.amax(dim=1)
    node_min = bvh.node_min.clone()
    node_max = bvh.node_max.clone()
    N = tri_min.shape[0]
    window = torch.arange(leaf_max, device=tri_min.device)
    for ids in plan:
        lf = bvh.left_first[ids].long()
        ct = bvh.count[ids]
        is_leaf = (ct > 0)[:, None]
        # leaf bounds: masked reduce over a window of leaf_max prims
        idx = torch.clamp(lf[:, None] + window, 0, N - 1)
        lane = (window[None, :] < ct[:, None])[..., None]
        lmn = torch.where(lane, tri_min[idx], 1e30).amin(dim=1)
        lmx = torch.where(lane, tri_max[idx], -1e30).amax(dim=1)
        # interior bounds from the children, updated a level before
        left = torch.clamp(lf, 0, node_min.shape[0] - 2)
        imn = torch.minimum(node_min[left], node_min[left + 1])
        imx = torch.maximum(node_max[left], node_max[left + 1])
        node_min.index_copy_(0, ids, torch.where(is_leaf, lmn, imn))
        node_max.index_copy_(0, ids, torch.where(is_leaf, lmx, imx))
    return replace(bvh, node_min=node_min, node_max=node_max)


def bvh8_refit_plan(child_host):
    """Node rows of each depth of a BVH8 child table, deepest first, as
    int64 tensors on the table's device (a numpy table gives CPU
    tensors). child_host: (M, 8) child words (>= 0 node row, < 0 leaf,
    EMPTY_SLOT unused). Compute once per collapse, reuse every frame."""
    dev = child_host.device if isinstance(child_host, torch.Tensor) \
        else torch.device("cpu")
    child = (child_host.cpu().numpy() if isinstance(child_host, torch.Tensor)
             else np.asarray(child_host))
    m = child.shape[0]
    depth = np.full(m, -1, np.int32)
    depth[0] = 0
    frontier = np.array([0], np.int64)
    d = 0
    while frontier.size:
        kids = child[frontier].reshape(-1)
        kids = kids[(kids >= 0) & (kids != EMPTY_SLOT)]
        d += 1
        depth[kids] = d
        frontier = kids
    return tuple(torch.from_numpy(np.nonzero(depth == lv)[0]).to(dev)
                 for lv in range(int(depth.max()), -1, -1)
                 if (depth == lv).any())


def refit_bvh8(bvh8: BVH8, tris, plan=None) -> BVH8:
    """The 8-wide layout refit for deformed (N, 3, 3) triangles (a tensor,
    or numpy, moved to the BVH's device): leaf_tris regathered through
    leaf_prim, every node's 8 child boxes rebuilt level by level. Returns
    a BVH8 with new bounds and leaf_tris; child and leaf_prim (the
    topology) unchanged (≙ tiny_bvh.h:4925-4961). plan:
    bvh8_refit_plan(child), once per collapse."""
    dev = bvh8.bounds.device
    if plan is None:
        plan = bvh8_refit_plan(bvh8.child)
    else:
        # a plan of another collapse would write rows it does not own
        n_plan = sum(int(ids.shape[0]) for ids in plan)
        if n_plan > bvh8.child.shape[0]:
            raise ValueError(
                f"refit plan covers {n_plan} node rows but BVH8 has "
                f"{bvh8.child.shape[0]}: stale plan for a rebuilt tree")
    plan = tuple(ids.to(dev) for ids in plan)
    tris = torch.as_tensor(tris, dtype=torch.float32, device=dev)
    return _refit_bvh8_impl(bvh8, tris, plan)


def _refit_bvh8_impl(bvh8: BVH8, tris, plan) -> BVH8:
    lp = bvh8.leaf_prim                                   # (L, 4)
    n = tris.shape[0]
    valid = (lp >= 0)[..., None, None]
    lt = torch.where(valid, tris[torch.clamp(lp, 0, n - 1).long()], 0.0)
    leaf_lo = torch.where(valid, lt, BVH_FAR).amin(dim=(1, 2))   # (L, 3)
    leaf_hi = torch.where(valid, lt, -BVH_FAR).amax(dim=(1, 2))

    bounds = bvh8.bounds.clone()
    m = bounds.shape[0]
    l_rows = leaf_lo.shape[0]
    node_lo = torch.full((m, 3), BVH_FAR, dtype=torch.float32,
                         device=bounds.device)
    node_hi = -node_lo
    for ids in plan:
        ch = bvh8.child[ids]                              # (B, 8)
        empty = (ch == EMPTY_SLOT)[..., None]
        is_leaf = ((ch < 0)[..., None]) & ~empty
        lrow = torch.clamp(-(ch + 1), 0, l_rows - 1).long()
        crow = torch.clamp(ch, 0, m - 1).long()
        slo = torch.where(is_leaf, leaf_lo[lrow], node_lo[crow])
        shi = torch.where(is_leaf, leaf_hi[lrow], node_hi[crow])
        slo = torch.where(empty, BVH_FAR, slo)            # (B, 8, 3)
        shi = torch.where(empty, -BVH_FAR, shi)
        rows = torch.cat([slo.transpose(1, 2).reshape(-1, 24),
                          shi.transpose(1, 2).reshape(-1, 24)], dim=1)
        bounds.index_copy_(0, ids, rows)
        node_lo.index_copy_(0, ids, slo.amin(dim=1))
        node_hi.index_copy_(0, ids, shi.amax(dim=1))
    return replace(bvh8, bounds=bounds, leaf_tris=lt)
