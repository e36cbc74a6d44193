"""The 2-wide SoA BVH (≙ tinybvh_tpu/layouts/bvh2.py; the reference's
`BVH`, 32-byte Wald nodes, tiny_bvh.h:857-866), as a dataclass of tensors:

  node_min/node_max : (M, 3) f32   child AABBs
  left_first        : (M,)  i32    interior: left child (right = left+1)
                                   leaf: first slot in prim_idx
  count             : (M,)  i32    0 for interior, #prims for leaf
  prim_idx          : (N,)  i32    permutation of primitive ids

Node 0 is the root; node 1 is reserved so children sit in aligned pairs
(tiny_bvh.h:2290). Unused pool slots are degenerate (min=+FAR > max=-FAR)
and unreachable."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tinybvh_tpu_torch.core.vecmath import C_INT, C_TRAV, half_area


@dataclass
class BVH2:
    node_min: torch.Tensor    # (M, 3)
    node_max: torch.Tensor    # (M, 3)
    left_first: torch.Tensor  # (M,)
    count: torch.Tensor       # (M,)
    prim_idx: torch.Tensor    # (N,)
    n_nodes: int              # used slots (the reserved #1 included)

    @property
    def n_prims(self):
        return self.prim_idx.shape[0]

    @property
    def capacity(self):
        return self.left_first.shape[0]

    @classmethod
    def from_host(cls, h: dict, device) -> "BVH2":
        """From a builder's host dict (node_min, node_max, left_first,
        count, prim_idx, n_nodes)."""
        return cls(**{k: torch.as_tensor(np.asarray(h[k])).to(device)
                      for k in ("node_min", "node_max", "left_first",
                                "count", "prim_idx")},
                   n_nodes=int(h["n_nodes"]))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _used(bvh: BVH2):
    ids = torch.arange(bvh.capacity, device=bvh.count.device)
    return (ids < bvh.n_nodes) & (ids != 1)


def sah_cost(bvh: BVH2, c_trav: float = C_TRAV, c_int: float = C_INT):
    """Total SAH cost normalised by the root's area (≙ BVHBase::SAHCost,
    tiny_bvh.h:1889-1897): c_trav*SA over interior nodes plus
    c_int*count*SA over leaves. A 0-d tensor."""
    area = half_area(bvh.node_min, bvh.node_max)
    is_leaf = bvh.count > 0
    node_cost = torch.where(is_leaf, c_int * bvh.count * area, c_trav * area)
    total = torch.where(_used(bvh), node_cost, 0.0).sum()
    return total / torch.clamp(area[0], min=1e-30)


def node_counts(bvh: BVH2):
    """(total_nodes, leaf_nodes, prim_refs) (≙ NodeCount / LeafCount /
    PrimCount, tiny_bvh.h:3698-3731), as 0-d tensors."""
    used = _used(bvh)
    is_leaf = used & (bvh.count > 0)
    return (used.sum(), is_leaf.sum(),
            torch.where(is_leaf, bvh.count, 0).sum())


def validate_host(bvh: BVH2, tris=None, strict_perm: bool = True):
    """Host-side structural check (≙ BVH_Verbose::CheckFit,
    tiny_bvh.h:4264-4289, plus permutation completeness). Raises
    AssertionError on failure, returns True."""
    mn, mx = _np(bvh.node_min), _np(bvh.node_max)
    lf, ct = _np(bvh.left_first), _np(bvh.count)
    pidx = _np(bvh.prim_idx)
    n = int(bvh.n_nodes)

    seen_prims = []
    stack = [0]
    while stack:
        i = stack.pop()
        if not 0 <= i < n:
            raise AssertionError(f"node index {i} out of range")
        if ct[i] > 0:
            s, c = lf[i], ct[i]
            if not (0 <= s and s + c <= pidx.shape[0]):
                raise AssertionError(f"leaf {i} range {s}+{c} out of bounds")
            seen_prims.append(pidx[s:s + c])
        else:
            left = lf[i]
            if not (2 <= left and left + 1 < n):
                raise AssertionError(f"bad child ptr {left} in node {i}")
            for child in (left, left + 1):
                if not (np.all(mn[child] >= mn[i] - 1e-4)
                        and np.all(mx[child] <= mx[i] + 1e-4)):
                    raise AssertionError(f"child {child} outside {i}")
                stack.append(child)
    if strict_perm:
        got = (np.sort(np.concatenate(seen_prims)) if seen_prims
               else np.array([]))
        np.testing.assert_array_equal(got, np.arange(pidx.shape[0]))
    if tris is not None:
        t = _np(tris)
        stack = [0]
        while stack:
            i = stack.pop()
            if ct[i] > 0:
                ids = pidx[lf[i]:lf[i] + ct[i]]
                if not (np.all(t[ids].min(axis=(0, 1)) >= mn[i] - 1e-3)
                        and np.all(t[ids].max(axis=(0, 1)) <= mx[i] + 1e-3)):
                    raise AssertionError(f"leaf {i} does not hold its tris")
            else:
                stack.extend((lf[i], lf[i] + 1))
    return True


def node_depths_host(bvh: BVH2) -> np.ndarray:
    """Per-node depth (root 0), computed on the host; -1 for unused
    slots."""
    lf, ct = _np(bvh.left_first), _np(bvh.count)
    n = int(bvh.n_nodes)
    depth = np.full(lf.shape[0], -1, np.int32)
    depth[0] = 0
    stack = [0]
    while stack:
        i = stack.pop()
        if ct[i] == 0 and i < n:
            left = lf[i]
            depth[left] = depth[left + 1] = depth[i] + 1
            stack.extend((left, left + 1))
    return depth
