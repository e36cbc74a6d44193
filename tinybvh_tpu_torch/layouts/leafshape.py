"""Leaf-shape transforms on the canonical BVH2, on the host in numpy
(≙ tinybvh_tpu/layouts/leafshape.py; BVH_Verbose::CombineLeafs /
BVH::SplitLeafs, tiny_bvh.h:3099-3139, 1988-2018), the preprocessing the
reference runs before a wide-layout conversion (BVH8_CPU does
CombineLeafs(4) + SplitLeafs(4), :5463-5465). The result goes to the
input's device.

`split_leafs` is JAX's. `combine_leafs` is not: JAX's takes a combined
subtree's prims as one range (its least leaf start, its total count),
which holds only where every subtree's prims fill one contiguous
`prim_idx` range. The numpy `build_binned` orders prim_idx by leaf node
id, not by subtree, so on its trees JAX's result points at prims twice
and loses others (`random_tris(300, seed=3)`, `max_leaf=1`: 300
references, 221 distinct prims). Here every leaf of the result gathers
its own prims (a combined leaf: its subtree's leaves, left to right)
into a new `prim_idx`, laid out leaf by leaf in the emission order: the
same leaf prim sets as JAX's where its assumption holds, and a
permutation wherever the input's was one."""

from __future__ import annotations

import numpy as np

from tinybvh_tpu_torch.core.vecmath import BVH_FAR
from tinybvh_tpu_torch.layouts.bvh2 import BVH2, _np


def _host(bvh: BVH2):
    return (_np(bvh.node_min), _np(bvh.node_max), _np(bvh.left_first),
            _np(bvh.count), int(bvh.n_nodes))


def _rebuild(mn, mx, lf, ct, prim_idx, capacity, device, leaf_prims=None):
    """Re-emit the nodes reachable from the root in pre-order into the
    paired-children layout (a node's pair is allocated when it is
    emitted, its left subtree emitted before its right child). With
    leaf_prims (node -> prim ids), each leaf's prims are laid out anew in
    emission order; without, leaves keep their prim_idx ranges."""
    out_mn = np.full((capacity, 3), BVH_FAR, np.float32)
    out_mx = np.full((capacity, 3), -BVH_FAR, np.float32)
    out_lf = np.zeros(capacity, np.int32)
    out_ct = np.zeros(capacity, np.int32)
    nxt = 2
    prims = []
    n_prims = 0
    stack = [(0, 0)]      # (old, new)
    while stack:
        old, new = stack.pop()
        out_mn[new] = mn[old]
        out_mx[new] = mx[old]
        out_ct[new] = ct[old]
        if ct[old] > 0:
            if leaf_prims is None:
                out_lf[new] = lf[old]
            else:
                ids = leaf_prims(old)
                out_lf[new] = n_prims
                prims.append(ids)
                n_prims += len(ids)
            continue
        out_lf[new] = nxt
        stack.append((lf[old] + 1, nxt + 1))
        stack.append((lf[old], nxt))
        nxt += 2
    if leaf_prims is not None:
        prim_idx = np.concatenate(prims).astype(np.int32)
    return BVH2.from_host(dict(node_min=out_mn, node_max=out_mx,
                               left_first=out_lf, count=out_ct,
                               prim_idx=prim_idx, n_nodes=nxt), device)


def combine_leafs(bvh: BVH2, max_prims: int = 4) -> BVH2:
    """Collapse maximal subtrees of <= max_prims primitives into single
    leaves (≙ BVH_Verbose::CombineLeafs, tiny_bvh.h:3099-3139). Boxes
    are unchanged; a combined leaf holds its subtree's prims, gathered
    into a new contiguous range (see the module's docstring)."""
    mn, mx, lf, ct, n = _host(bvh)
    pidx = _np(bvh.prim_idx)

    # bottom-up subtree prim totals (children need not precede parents
    # after an optimization, so iterate in post-order)
    total = np.where(ct > 0, ct, -1).astype(np.int64)
    stack = [(0, False)]
    while stack:
        node, ready = stack.pop()
        if ct[node] > 0:
            continue
        left = lf[node]
        if not ready:
            stack.append((node, True))
            stack.append((left, False))
            stack.append((left + 1, False))
        else:
            total[node] = total[left] + total[left + 1]

    # top-down: the first node on each root path with total <= max_prims
    # becomes a leaf, holding its subtree's leaves' prims left to right
    ct2 = ct.copy()
    combined = {}
    stack = [0]
    while stack:
        node = stack.pop()
        if ct2[node] > 0:
            continue
        if total[node] <= max_prims:
            ct2[node] = total[node]
            ids, walk = [], [node]
            while walk:
                i = walk.pop()
                if ct[i] > 0:
                    ids.append(pidx[lf[i]:lf[i] + ct[i]])
                else:
                    walk.extend((lf[i] + 1, lf[i]))
            combined[node] = np.concatenate(ids)
            continue
        stack.extend((lf[node], lf[node] + 1))

    def leaf_prims(node):
        if node in combined:
            return combined[node]
        return pidx[lf[node]:lf[node] + ct[node]]

    return _rebuild(mn, mx, lf, ct2, None, lf.shape[0],
                    bvh.prim_idx.device, leaf_prims)


def split_leafs(bvh: BVH2, max_prims: int = 4) -> BVH2:
    """Split leaves larger than max_prims into balanced subtrees of
    adjacent prim ranges (≙ BVH::SplitLeafs, tiny_bvh.h:1988-2018). The
    split is by range midpoint; both halves inherit the parent box (kept
    conservative, exactly like the reference, which does not rescan
    either)."""
    mn, mx, lf, ct, n = _host(bvh)
    cap = lf.shape[0]
    mn2, mx2 = list(mn), list(mx)
    lf2, ct2 = list(lf), list(ct)

    stack = [i for i in range(cap)
             if i != 1 and i < max(n, 2) and ct[i] > max_prims]
    # only reachable nodes: walk from root
    reach = set()
    walk = [0]
    while walk:
        i = walk.pop()
        reach.add(i)
        if ct[i] == 0:
            walk.extend((lf[i], lf[i] + 1))
    stack = [i for i in stack if i in reach]

    while stack:
        node = stack.pop()
        if ct2[node] <= max_prims:
            continue
        half = int(ct2[node]) // 2
        l = len(lf2)
        for child_start, child_cnt in (
            (lf2[node], half), (lf2[node] + half, ct2[node] - half)
        ):
            mn2.append(mn2[node])
            mx2.append(mx2[node])
            lf2.append(child_start)
            ct2.append(child_cnt)
        lf2[node] = l
        ct2[node] = 0
        if ct2[l] > max_prims:
            stack.append(l)
        if ct2[l + 1] > max_prims:
            stack.append(l + 1)

    mn2 = np.asarray(mn2, np.float32)
    mx2 = np.asarray(mx2, np.float32)
    lf2 = np.asarray(lf2, np.int32)
    ct2 = np.asarray(ct2, np.int32)
    return _rebuild(mn2, mx2, lf2, ct2, _np(bvh.prim_idx), lf2.shape[0] + 2,
                    bvh.prim_idx.device)
