"""Lockstep BVH2 traversal, closest hit and any hit
(≙ tinybvh_tpu/traverse/stack.py; BVH::Intersect / IsOccluded,
tiny_bvh.h:3247-3453). Plain torch: the JAX package has no kernel here.

Every ray keeps its own stack of STACK_DEPTH (node, entry distance)
entries, and all rays advance one step together: pop, then a leaf test
over up to leaf_max contiguous triangles of the packed soup, or a slab
test of both children that descends into the nearer and pushes the
farther. The stacks are (R, STACK_DEPTH) tensors updated in place by
indexed assignment (JAX gathers, merges and scatters (R,) vectors,
`_scatter_row`). A finished ray is a fixed point of the step, so the
host loop (`lockstep`, which the f64 engines of ops/f64.py share) asks
whether any ray is still running only every _CHECK_EVERY = 8 steps: one
host sync per 8 steps, the same result as checking after each.
LAST_CALL holds the last call's step and sync counts."""

from __future__ import annotations

import torch

from tinybvh_tpu_torch.core.intersect import (
    check_tri_test, leaf_intersect, moller_trumbore,
    precompute_baldwin_weber, slab_test, tri_edges,
)
from tinybvh_tpu_torch.core.rays import Hits, Rays
from tinybvh_tpu_torch.core.vecmath import BVH_FAR

# covers the binned builder's depth bound (builders/binned.py _MAX_LEVELS
# = 128): the ordered descent pushes at most one node a level
STACK_DEPTH = 130
_CHECK_EVERY = 8
LAST_CALL = {"steps": 0, "syncs": 0}


def pack_tris(bvh, tris):
    """Triangles reordered into prim_idx order, so that each leaf's prims
    are one contiguous slab (the reference gathers through primIdx per
    leaf prim, tiny_bvh.h:3265). tris: (N, 3, 3), moved to the BVH's
    device."""
    idx = bvh.prim_idx
    tris = torch.as_tensor(tris, dtype=torch.float32, device=idx.device)
    return tris[idx.long()]


def _tri_test(tri_test):
    if tri_test is None:
        from tinybvh_tpu_torch.config import get_config

        tri_test = get_config().tri_test
    check_tri_test(tri_test)
    return tri_test


class _Leaves:
    """The leaf test over up to leaf_max triangles from `base` on."""

    def __init__(self, packed_tris, leaf_max, tri_test):
        self.tris = packed_tris
        self.tri_test = tri_test
        self.edges = tri_edges(packed_tris) if tri_test == "mt" else None
        self.bw = (precompute_baldwin_weber(packed_tris)
                   if tri_test == "baldwin" else None)
        self.lanes = torch.arange(leaf_max, device=packed_tris.device)

    def __call__(self, o, d, rd, base, ct, t_cur):
        """(hit, t, u, v), each (R, leaf_max); lanes past ct never hit."""
        idx = torch.clamp(base[:, None] + self.lanes[None, :], 0,
                          self.tris.shape[0] - 1)
        if self.tri_test == "mt":
            v0, e1, e2 = self.edges
            hit, th, uh, vh = moller_trumbore(
                o[:, None], d[:, None], v0[idx], e1[idx], e2[idx], t_cur)
        else:
            tri = self.tris[idx]
            hit, th, uh, vh = leaf_intersect(
                self.tri_test, o[:, None], d[:, None], rd[:, None],
                tri[..., 0, :], tri[..., 1, :], tri[..., 2, :], t_cur,
                bw_rows=None if self.bw is None else self.bw[idx])
        return hit & (self.lanes[None, :] < ct[:, None]), th, uh, vh


def lockstep(running, stats, compact=None):
    """Yield once for each step of a lockstep loop, as long as a row
    runs. Before the first step and every _CHECK_EVERY steps after it
    the host reads running(), a bool tensor over the rows (one sync,
    counted in stats["syncs"]), and stops when no row runs. A finished
    row is a fixed point of the step, so this ends with the result of a
    check after each step. compact(live), where given, runs at a check
    that finds at most half of the rows running, and keeps the running
    rows alone (stats["compactions"]). stats["steps"] ends as the
    number of steps taken."""
    step = 0
    while True:
        if step % _CHECK_EVERY == 0:
            live = running()
            stats["syncs"] += 1
            n_live = int(live.sum())
            if n_live == 0:
                break
            if compact is not None and 2 * n_live <= live.shape[0]:
                compact(live)
                stats["compactions"] += 1
        step += 1
        stats["steps"] = step
        yield


def intersect_bvh2(bvh, packed_tris, rays: Rays, t_max=BVH_FAR,
                   leaf_max: int = 16, with_cost: bool = False,
                   tri_test: str | None = None):
    """Closest hit over a BVH2 (layouts.bvh2.BVH2). packed_tris: (N, 3, 3)
    from pack_tris(bvh, tris); leaf_max: an upper bound of the leaf sizes;
    t_max: scalar or (R,). with_cost also returns the per-ray cost, 1 a
    visited node and 1 a tested triangle (tiny_bvh.h:3251-3303).
    tri_test: the leaf test (None: Config.tri_test). Returns Hits (with
    global prim ids), and the cost with with_cost."""
    tri_test = _tri_test(tri_test)
    o, d, rd = rays.o, rays.d, rays.rd
    dev = o.device
    R = o.shape[0]
    rows = torch.arange(R, device=dev)
    leaves = _Leaves(packed_tris, leaf_max, tri_test)
    t = torch.broadcast_to(torch.as_tensor(
        t_max, dtype=torch.float32, device=dev), (R,)).clone()
    cur = torch.zeros(R, dtype=torch.int64, device=dev)
    sp = torch.zeros(R, dtype=torch.int64, device=dev)
    stack_node = torch.zeros((R, STACK_DEPTH), dtype=torch.int64, device=dev)
    stack_dist = torch.zeros((R, STACK_DEPTH), dtype=torch.float32,
                             device=dev)
    u = torch.zeros(R, dtype=torch.float32, device=dev)
    v = torch.zeros(R, dtype=torch.float32, device=dev)
    prim = torch.full((R,), -1, dtype=torch.int64, device=dev)
    done = torch.zeros(R, dtype=torch.bool, device=dev)
    cost = torch.zeros(R, dtype=torch.float32, device=dev)
    lf_all, ct_all = bvh.left_first.long(), bvh.count.long()

    LAST_CALL.update(steps=0, syncs=0)
    for _ in lockstep(lambda: ~done, LAST_CALL):
        # pop: rays without a current node take the top entry if it lies
        # nearer than their best hit
        need_pop = (cur < 0) & ~done
        can_pop = need_pop & (sp > 0)
        nsp = torch.where(can_pop, sp - 1, sp)
        pidx = torch.clamp(nsp, 0, STACK_DEPTH - 1)
        take = can_pop & (stack_dist[rows, pidx] < t)
        cur = torch.where(take, stack_node[rows, pidx], cur)
        done = done | (need_pop & (sp == 0))
        sp = nsp

        proc = (cur >= 0) & ~done
        node = torch.clamp(cur, min=0)
        lf, ct = lf_all[node], ct_all[node]
        is_leaf = proc & (ct > 0)
        is_int = proc & (ct == 0)

        # leaf: the nearest of up to leaf_max contiguous triangles
        base = torch.where(is_leaf, lf, 0)
        hit, th, uh, vh = leaves(o, d, rd, base, ct, t[:, None])
        th = torch.where(hit & is_leaf[:, None], th, BVH_FAR)
        bt, best = th.min(dim=1)                             # first argmin
        improved = bt < t
        t = torch.where(improved, bt, t)
        u = torch.where(improved, uh.gather(1, best[:, None])[:, 0], u)
        v = torch.where(improved, vh.gather(1, best[:, None])[:, 0], v)
        prim = torch.where(improved, base + best, prim)

        # interior: both children, nearer first, the farther pushed
        left = torch.where(is_int, lf, 0)
        right = left + 1
        dl = slab_test(o, rd, t, bvh.node_min[left], bvh.node_max[left])
        dr = slab_test(o, rd, t, bvh.node_min[right], bvh.node_max[right])
        swap = dr < dl
        near_n = torch.where(swap, right, left)
        far_n = torch.where(swap, left, right)
        near_hit = is_int & (torch.minimum(dl, dr) < BVH_FAR)
        far_d = torch.maximum(dl, dr)
        push = near_hit & (far_d < BVH_FAR)
        sidx = torch.clamp(sp, 0, STACK_DEPTH - 1)
        stack_node[rows, sidx] = torch.where(push, far_n,
                                             stack_node[rows, sidx])
        stack_dist[rows, sidx] = torch.where(push, far_d,
                                             stack_dist[rows, sidx])
        sp = sp + push

        cur = torch.where(is_int, torch.where(near_hit, near_n, -1), cur)
        cur = torch.where(is_leaf, -1, cur)
        cost += proc * 1.0 + torch.where(is_leaf, ct, 0)

    ok = prim >= 0
    gprim = bvh.prim_idx[torch.clamp(prim, min=0)]
    hits = Hits(t=torch.where(ok, t, BVH_FAR), u=u, v=v,
                prim=torch.where(ok, gprim, -1).to(torch.int32),
                inst=torch.full((R,), -1, dtype=torch.int32, device=dev))
    if with_cost:
        return hits, cost
    return hits


def is_occluded_bvh2(bvh, packed_tris, rays: Rays, t_max, leaf_max: int = 16,
                     tri_test: str | None = None) -> torch.Tensor:
    """(R,) bool: any hit in (0, t_max) (≙ BVH::IsOccluded,
    tiny_bvh.h:3382-3453): no ordering (the left child first), each ray
    done at its first hit. Arguments as in intersect_bvh2."""
    tri_test = _tri_test(tri_test)
    o, d, rd = rays.o, rays.d, rays.rd
    dev = o.device
    R = o.shape[0]
    rows = torch.arange(R, device=dev)
    leaves = _Leaves(packed_tris, leaf_max, tri_test)
    t0 = torch.broadcast_to(torch.as_tensor(
        t_max, dtype=torch.float32, device=dev), (R,)).clone()
    cur = torch.zeros(R, dtype=torch.int64, device=dev)
    sp = torch.zeros(R, dtype=torch.int64, device=dev)
    stack_node = torch.zeros((R, STACK_DEPTH), dtype=torch.int64, device=dev)
    occ = torch.zeros(R, dtype=torch.bool, device=dev)
    done = torch.zeros(R, dtype=torch.bool, device=dev)
    lf_all, ct_all = bvh.left_first.long(), bvh.count.long()

    LAST_CALL.update(steps=0, syncs=0)
    for _ in lockstep(lambda: ~done, LAST_CALL):
        need_pop = (cur < 0) & ~done
        can_pop = need_pop & (sp > 0)
        nsp = torch.where(can_pop, sp - 1, sp)
        pidx = torch.clamp(nsp, 0, STACK_DEPTH - 1)
        cur = torch.where(can_pop, stack_node[rows, pidx], cur)
        done = done | (need_pop & (sp == 0))
        sp = nsp

        proc = (cur >= 0) & ~done
        node = torch.clamp(cur, min=0)
        lf, ct = lf_all[node], ct_all[node]
        is_leaf = proc & (ct > 0)
        is_int = proc & (ct == 0)

        base = torch.where(is_leaf, lf, 0)
        hit, _, _, _ = leaves(o, d, rd, base, ct, t0[:, None])
        occ = occ | (is_leaf & hit.any(dim=1))
        done = done | occ

        left = torch.where(is_int, lf, 0)
        right = left + 1
        lh = is_int & (slab_test(o, rd, t0, bvh.node_min[left],
                                 bvh.node_max[left]) < BVH_FAR)
        rh = is_int & (slab_test(o, rd, t0, bvh.node_min[right],
                                 bvh.node_max[right]) < BVH_FAR)
        push = lh & rh
        sidx = torch.clamp(sp, 0, STACK_DEPTH - 1)
        stack_node[rows, sidx] = torch.where(push, right,
                                             stack_node[rows, sidx])
        sp = sp + push
        cur = torch.where(is_int, torch.where(
            lh, left, torch.where(rh, right, -1)), cur)
        cur = torch.where(is_leaf, -1, cur)
    return occ
