"""Per-ray-stack lockstep traversal of the 8-wide BVH
(≙ tinybvh_tpu/traverse/wide.py; BVH8_CPU::Intersect / IsOccluded,
tiny_bvh.h:7188-7477). Plain torch: the JAX package has no kernel here.

Every ray keeps its own stack of STACK_DEPTH entries and all rays advance
one step together: pop, an 8-wide slab test that descends into the
nearest child and pushes the others, or a 4-triangle leaf test. The API
falls back to this engine when the wavefront's frontier overflows.

Steps after a ray is done leave it unchanged, so the loop asks the host
whether every ray is done only every _CHECK_EVERY steps (one sync per
check, not per step). The stacks are (STACK_DEPTH + 1, R) and updated in
place; the extra row takes the pushes the JAX engine drops when a stack
is full."""

from __future__ import annotations

import torch

from tinybvh_tpu_torch.core.intersect import (
    moller_trumbore, omap_cells, tri_edges,
)
from tinybvh_tpu_torch.core.rays import Hits, Rays
from tinybvh_tpu_torch.core.vecmath import BVH_FAR
from tinybvh_tpu_torch.layouts.mbvh import BVH8, EMPTY_SLOT
from tinybvh_tpu_torch.traverse.wavefront import _slab8, check_omap

STACK_DEPTH = 32
_EMPTY = -(2**31) + 1       # "no current entry"
_CHECK_EVERY = 8


def _pop(stack, sp, can_pop, fill):
    """stack[sp[r], r] where can_pop, else fill."""
    top = stack.gather(0, sp[None, :])[0]
    return torch.where(can_pop, top, fill)


def _push8(stacks, sp, pushmask):
    """Push up to 8 entries per ray: lane k of each (stack, values (R, 8))
    pair lands at row sp + (exclusive rank of k among pushed lanes).
    Entries past STACK_DEPTH go to the spare row, i.e. are dropped.
    Returns the new sp."""
    S = stacks[0][0].shape[0] - 1
    pm = pushmask.to(torch.int64)
    target = sp[:, None] + torch.cumsum(pm, dim=1) - pm
    pushmask = pushmask & (target < S)
    rows = torch.where(pushmask, target, S).T.contiguous()   # (8, R)
    for stack, vals in stacks:
        stack.scatter_(0, rows, vals.T.contiguous())
    return sp + pushmask.sum(dim=1)


def _init(bvh8: BVH8, rays: Rays, t_max):
    R = rays.o.shape[0]
    dev = rays.o.device
    t0 = torch.broadcast_to(
        torch.as_tensor(t_max, dtype=torch.float32, device=dev),
        (R,)).clone()
    return R, dev, t0, tri_edges(bvh8.leaf_tris)


def intersect_bvh8(bvh8: BVH8, rays: Rays, t_max=BVH_FAR,
                   with_cost: bool = False, omap=None):
    """Closest hit over the 8-wide layout (global prim ids). t_max: scalar
    or (R,). with_cost also returns per-ray cost (1 per node, 4 per
    leaf). omap: optional (L, 4, S, S) bool opacity micromaps aligned with
    the leaf rows (ops.omap.leaf_align); a triangle hit whose cell bit is
    0 is transparent and ignored (≙ JAX wide.py:159-165)."""
    check_omap(bvh8, omap)
    o, d, rd = rays.o, rays.d, rays.rd
    R, dev, t, (v0t, e1t, e2t) = _init(bvh8, rays, t_max)
    rows = torch.arange(R, device=dev)
    lanes8 = torch.arange(8, device=dev)
    lanes4 = torch.arange(4, device=dev)[None, :]
    cur = torch.zeros(R, dtype=torch.int32, device=dev)     # root row 0
    sp = torch.zeros(R, dtype=torch.int64, device=dev)
    stack_e = torch.zeros((STACK_DEPTH + 1, R), dtype=torch.int32,
                          device=dev)
    stack_d = torch.zeros((STACK_DEPTH + 1, R), dtype=torch.float32,
                          device=dev)
    u = torch.zeros(R, dtype=torch.float32, device=dev)
    v = torch.zeros(R, dtype=torch.float32, device=dev)
    prim = torch.full((R,), -1, dtype=torch.int32, device=dev)
    done = torch.zeros(R, dtype=torch.bool, device=dev)
    cost = torch.zeros(R, dtype=torch.float32, device=dev)

    step = 0
    while step % _CHECK_EVERY or not bool(done.all()):
        step += 1
        # pop
        need_pop = (cur == _EMPTY) & ~done
        can_pop = need_pop & (sp > 0)
        nsp = torch.where(can_pop, sp - 1, sp)
        pe = _pop(stack_e, nsp, can_pop, 0)
        pd = _pop(stack_d, nsp, can_pop, 0.0)
        take = can_pop & (pd < t)
        cur = torch.where(take, pe, cur)
        done = done | (need_pop & (sp == 0))
        sp = nsp

        proc = (cur != _EMPTY) & ~done
        is_node = proc & (cur >= 0)
        is_leaf = proc & (cur < 0)

        # interior: 8-wide slab test, descend into the nearest child
        nrow = torch.where(is_node, cur, 0).long()
        dist = _slab8(o, rd, t, bvh8.bounds[nrow])           # (R, 8)
        kids = bvh8.child[nrow]
        valid = (dist < BVH_FAR) & (kids != EMPTY_SLOT) & is_node[:, None]
        dist = torch.where(valid, dist, BVH_FAR)
        near = dist.argmin(dim=1)
        next_node = torch.where(valid.any(dim=1), kids[rows, near], _EMPTY)
        pushmask = valid & (lanes8[None, :] != near[:, None])
        sp = _push8(((stack_e, kids), (stack_d, dist)), sp, pushmask)

        # leaf: 4-triangle Möller–Trumbore
        lrow = torch.where(is_leaf, -cur - 1, 0).long()
        hit, th, uh, vh = moller_trumbore(o[:, None], d[:, None], v0t[lrow],
                                          e1t[lrow], e2t[lrow], t[:, None])
        if omap is not None:
            iu, iv = omap_cells(uh, vh, hit, omap.shape[-1])
            hit = hit & omap[lrow[:, None], lanes4, iu, iv]
        th = torch.where(hit & is_leaf[:, None], th, BVH_FAR)
        bt, best = th.min(dim=1)
        improved = bt < t
        pick = best[:, None]
        t = torch.where(improved, bt, t)
        u = torch.where(improved, uh.gather(1, pick)[:, 0], u)
        v = torch.where(improved, vh.gather(1, pick)[:, 0], v)
        prim = torch.where(improved,
                           bvh8.leaf_prim[lrow].gather(1, pick)[:, 0], prim)

        cur = torch.where(is_node, next_node, _EMPTY)
        cost += is_node * 1.0 + is_leaf * 4.0

    ok = prim >= 0
    hits = Hits(t=torch.where(ok, t, BVH_FAR), u=u, v=v, prim=prim,
                inst=torch.full((R,), -1, dtype=torch.int32, device=dev))
    if with_cost:
        return hits, cost
    return hits


def is_occluded_bvh8(bvh8: BVH8, rays: Rays, t_max):
    """(R,) bool: any hit in (0, t_max). Unordered descent (first valid
    child first), early exit on the first hit."""
    o, d, rd = rays.o, rays.d, rays.rd
    R, dev, t0, (v0t, e1t, e2t) = _init(bvh8, rays, t_max)
    rows = torch.arange(R, device=dev)
    lanes8 = torch.arange(8, device=dev)
    cur = torch.zeros(R, dtype=torch.int32, device=dev)
    sp = torch.zeros(R, dtype=torch.int64, device=dev)
    stack_e = torch.zeros((STACK_DEPTH + 1, R), dtype=torch.int32,
                          device=dev)
    occ = torch.zeros(R, dtype=torch.bool, device=dev)
    done = torch.zeros(R, dtype=torch.bool, device=dev)

    step = 0
    while step % _CHECK_EVERY or not bool(done.all()):
        step += 1
        need_pop = (cur == _EMPTY) & ~done
        can_pop = need_pop & (sp > 0)
        nsp = torch.where(can_pop, sp - 1, sp)
        cur = torch.where(can_pop, _pop(stack_e, nsp, can_pop, 0), cur)
        done = done | (need_pop & (sp == 0))
        sp = nsp

        proc = (cur != _EMPTY) & ~done
        is_node = proc & (cur >= 0)
        is_leaf = proc & (cur < 0)

        nrow = torch.where(is_node, cur, 0).long()
        dist = _slab8(o, rd, t0, bvh8.bounds[nrow])
        kids = bvh8.child[nrow]
        valid = (dist < BVH_FAR) & (kids != EMPTY_SLOT) & is_node[:, None]
        near = valid.to(torch.uint8).argmax(dim=1)           # first valid
        next_node = torch.where(valid.any(dim=1), kids[rows, near], _EMPTY)
        pushmask = valid & (lanes8[None, :] != near[:, None])
        sp = _push8(((stack_e, kids),), sp, pushmask)

        lrow = torch.where(is_leaf, -cur - 1, 0).long()
        hit, _, _, _ = moller_trumbore(o[:, None], d[:, None], v0t[lrow],
                                       e1t[lrow], e2t[lrow], t0[:, None])
        occ = occ | (is_leaf & hit.any(dim=1))
        done = done | occ
        cur = torch.where(is_node, next_node, _EMPTY)
    return occ
