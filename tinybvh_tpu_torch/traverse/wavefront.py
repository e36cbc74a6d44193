"""Wavefront traversal on PyTorch: level-synchronous BFS over (ray, node)
pairs (≙ tinybvh_tpu/traverse/wavefront.py; the query semantics of
BVH8_CPU::Intersect, tiny_bvh.h:7188).

The whole frontier of (ray, node) pairs advances one tree level per
iteration, so the loop runs about tree-depth times with large dense
ops. The JAX package leaves this engine to XLA and has no kernel for
it; here it is plain torch. It is the packet trace's exact retrace and
the API's engine for batches the packet path does not take.

Mirrored level by level, so that hits equal the JAX engine's on every
ray, ties included: the frontier cap of cap_factor*R pairs, the strict
pruning tests (entry < best t before the level, child entry < best t
after it), the any-hit settle rule, the fold (monotone bitcast of t,
scatter-min of the t key, then scatter-min of the packed leafrow*4+lane
among that level's winners, with stale winners reset on improvement),
the order-preserving compaction, the MAX_LEVELS truncation folded into
the overflow flag, and the final re-intersection of the winner for u/v.

Three differences of form, not of result. The frontier holds only live
pairs: torch shapes are dynamic, so a pair the JAX engine masks out is
simply absent. The compaction is `torch.nonzero` over the (pairs, 8)
child mask, which lists the surviving children pair by pair, lane by
lane: the slots the JAX scatter-max/cummax map and its rank-to-lane
lookup produce, in the same order. That `nonzero` is the level loop's
one host sync (about tree depth, 7-15 syncs per call). And a pair
without a candidate folds I32MAX into its own ray instead of ray 0.

The leaf test follows Config.tri_test (≙ JAX wavefront.py:122-131,
191-200). "mt" gathers v0 / e1 / e2; the two others gather one 48-float
row a leaf: the raw vertices padded to 48 ("watertight", which needs
the shared endpoints bit for bit) or the four precompute_baldwin_weber
rows of 12 ("baldwin").

Opacity micromaps (omap, (L, 4, S, S) bool aligned with the leaf rows,
ops.omap.leaf_align) drop a triangle hit whose barycentric cell
(floor(u S), floor(v S)), clamped to the grid, is transparent (≙ JAX
wavefront.py:207-212; tiny_bvh.h:8514-8522)."""

from __future__ import annotations

import torch

from tinybvh_tpu_torch.core.intersect import (
    check_tri_test, leaf_intersect, moller_trumbore, omap_cells,
    precompute_baldwin_weber, tri_edges,
)
from tinybvh_tpu_torch.core.rays import Hits, Rays
from tinybvh_tpu_torch.core.vecmath import BVH_FAR
from tinybvh_tpu_torch.layouts.cwbvh import BVH8Q, dequantize_bounds
from tinybvh_tpu_torch.layouts.mbvh import BVH8, EMPTY_SLOT

MAX_LEVELS = 64
_I32MAX = 2**31 - 1


def _slab8(o, rd, t, bounds):
    """o, rd: (P, 3); t: (P,); bounds: (P, 48) -> entry distances (P, 8),
    BVH_FAR where a child box is missed or lies beyond t."""
    b = bounds.reshape(-1, 6, 8)
    t1x = (b[:, 0] - o[:, 0:1]) * rd[:, 0:1]
    t2x = (b[:, 3] - o[:, 0:1]) * rd[:, 0:1]
    t1y = (b[:, 1] - o[:, 1:2]) * rd[:, 1:2]
    t2y = (b[:, 4] - o[:, 1:2]) * rd[:, 1:2]
    t1z = (b[:, 2] - o[:, 2:3]) * rd[:, 2:3]
    t2z = (b[:, 5] - o[:, 2:3]) * rd[:, 2:3]
    tmin = torch.maximum(
        torch.maximum(torch.minimum(t1x, t2x), torch.minimum(t1y, t2y)),
        torch.minimum(t1z, t2z))
    tmax = torch.minimum(
        torch.minimum(torch.maximum(t1x, t2x), torch.maximum(t1y, t2y)),
        torch.maximum(t1z, t2z))
    hit = (tmax >= tmin) & (tmin < t[:, None]) & (tmax >= 0.0)
    return torch.where(hit, tmin, BVH_FAR)


def _t_key(t):
    """Monotone i32 key of non-negative f32 distances (the bitcast keeps
    their order)."""
    return t.contiguous().view(torch.int32)


def check_omap(bvh8, omap):
    """Raise unless omap is None or (L, 4, S, S) for bvh8's L leaf rows."""
    if omap is None:
        return
    L = bvh8.leaf_tris.shape[0]
    if (omap.dim() != 4 or tuple(omap.shape[:2]) != (L, 4)
            or omap.shape[2] != omap.shape[3]):
        raise ValueError(f"omap must be ({L}, 4, S, S) (ops.omap."
                         f"leaf_align), got {tuple(omap.shape)}")


def _check_inputs(bvh8, omap, tri_test):
    if not isinstance(bvh8, (BVH8, BVH8Q)):
        raise TypeError(f"{type(bvh8).__name__}: the wavefront engine "
                        "takes a BVH8 or a BVH8Q")
    check_omap(bvh8, omap)
    check_tri_test(tri_test)


def intersect_wavefront(bvh8: BVH8 | BVH8Q, rays: Rays, t_max=BVH_FAR,
                        cap_factor: int = 3, any_hit: bool = False,
                        omap=None, tri_test: str | None = None):
    """Closest-hit (or any-hit) wavefront traversal over a BVH8 or its
    quantized BVH8Q (each level's gathered node rows dequantized, ≙ JAX
    wavefront.py:109-116; the bounds are conservative, so the hits are
    the float BVH8's). t_max: scalar or
    (R,). Returns (Hits, overflow) or, with any_hit, (Hits, (R,) occluded,
    overflow); overflow (a bool) says pairs beyond cap_factor*R were
    dropped or the tree is deeper than MAX_LEVELS, so hits may be
    inexact. omap: optional (L, 4, S, S) bool opacity micromaps aligned
    with the leaf rows."""
    if tri_test is None:
        from tinybvh_tpu_torch.config import get_config

        tri_test = get_config().tri_test
    _check_inputs(bvh8, omap, tri_test)
    o_all, d_all, rd_all = rays.o, rays.d, rays.rd
    dev = o_all.device
    R = o_all.shape[0]
    P = cap_factor * R
    t0 = torch.broadcast_to(
        torch.as_tensor(t_max, dtype=torch.float32, device=dev), (R,))
    tkey0 = _t_key(t0)
    tkey = tkey0.clone()
    win = torch.full((R,), _I32MAX, dtype=torch.int32, device=dev)
    v0t, e1t, e2t = tri_edges(bvh8.leaf_tris)                # (L, 4, 3)
    L4 = bvh8.leaf_tris.shape[0]
    bw_t = leaf_geom = None
    if tri_test == "baldwin":
        bw_t = precompute_baldwin_weber(
            bvh8.leaf_tris.reshape(-1, 3, 3)).reshape(L4, 4, 12)
        leaf_geom = bw_t.reshape(L4, 48)
    elif tri_test == "watertight":
        leaf_geom = torch.cat([bvh8.leaf_tris.reshape(L4, 36), torch.zeros(
            (L4, 12), dtype=torch.float32, device=dev)], dim=1)
    # one fused per-pair ray gather: [o | d | rd]
    ray_data = torch.cat([o_all, d_all, rd_all], dim=1)      # (R, 9)

    lanes4 = torch.arange(4, device=dev)[None, :]
    pr = torch.arange(R, device=dev)                         # pair -> ray
    pc = torch.zeros(R, dtype=torch.int32, device=dev)       # root row 0
    pt = torch.zeros(R, dtype=torch.float32, device=dev)     # entry t
    n_pairs, level, overflow = R, 0, False
    while n_pairs > 0 and level < MAX_LEVELS:
        t_best = tkey.view(torch.float32)
        tb = t_best[pr]
        active = pt < tb
        if any_hit:
            # a ray is settled once anything closer than its t_max is found
            active &= ~(tkey < tkey0)[pr]
        is_node = active & (pc >= 0)
        is_leaf = active & (pc < 0)
        rdat = ray_data[pr]
        o, d, rd = rdat[:, 0:3], rdat[:, 3:6], rdat[:, 6:9]

        # expand node pairs
        nrow = torch.where(is_node, pc, 0).long()
        if isinstance(bvh8, BVH8Q):   # the gathered rows dequantized
            dist = _slab8(o, rd, tb, dequantize_bounds(bvh8, nrow))
        else:
            dist = _slab8(o, rd, tb, bvh8.bounds[nrow])      # (n, 8)
        kids = bvh8.child[nrow]
        valid = (dist < BVH_FAR) & (kids != EMPTY_SLOT) & is_node[:, None]

        # leaf pairs: 4-wide Möller–Trumbore
        lrow = torch.where(is_leaf, -pc - 1, 0).long()
        if tri_test == "mt":
            hit, th, uu, vv = moller_trumbore(
                o[:, None], d[:, None], v0t[lrow], e1t[lrow], e2t[lrow],
                tb[:, None])
        else:
            geom = leaf_geom[lrow]                           # (n, 48)
            tri4 = geom[:, 0:36].reshape(-1, 4, 3, 3)
            hit, th, uu, vv = leaf_intersect(
                tri_test, o[:, None], d[:, None], rd[:, None], tri4[:, :, 0],
                tri4[:, :, 1], tri4[:, :, 2], tb[:, None],
                bw_rows=geom.reshape(-1, 4, 12))
        if omap is not None:
            iu, iv = omap_cells(uu, vv, hit, omap.shape[-1])
            hit = hit & omap[lrow[:, None], lanes4, iu, iv]
        th = torch.where(hit & is_leaf[:, None], th, BVH_FAR)
        cand_t, lbest = th.min(dim=1)                        # first argmin
        has_cand = cand_t < BVH_FAR

        # fold candidates into the per-ray best: two scatter-mins. A pair
        # without a candidate sends I32MAX to its own ray, a no-op; sent
        # to ray 0, as in the JAX engine, they serialize the card's
        # atomics on one address
        ckey = torch.where(has_cand, _t_key(cand_t), _I32MAX)
        new_tkey = tkey.scatter_reduce(0, pr, ckey, "amin")
        is_winner = has_cand & (ckey == new_tkey[pr])
        packed = torch.where(is_winner, (lrow * 4 + lbest).to(torch.int32),
                             _I32MAX)
        # reset stale winners of improved rays, then take the new one
        win = torch.where(new_tkey < tkey, _I32MAX, win)
        win = win.scatter_reduce(0, pr, packed, "amin")
        tkey = new_tkey

        # compact the next level's pairs, in pair order then lane order
        valid &= dist < tkey.view(torch.float32)[pr][:, None]
        flat = torch.nonzero(valid.reshape(-1)).squeeze(1)   # host sync
        if flat.shape[0] > P:
            overflow = True
            flat = flat[:P]
        pr = pr[flat // 8]
        pc = kids.reshape(-1)[flat]
        pt = dist.reshape(-1)[flat]
        n_pairs = flat.shape[0]
        level += 1
    # stopping at MAX_LEVELS with pairs pending is silent truncation
    overflow = overflow or n_pairs > 0

    # the full hit record from (tkey, win)
    ok = win != _I32MAX
    wl = torch.where(ok, win >> 2, 0).long()
    wk = torch.where(ok, win & 3, 0).long()
    prim = torch.where(ok, bvh8.leaf_prim[wl, wk], -1)
    # one final leaf test against the winning triangle for u/v
    wtri = bvh8.leaf_tris[wl, wk]                            # (R, 3, 3)
    _, _, uu, vv = leaf_intersect(
        tri_test, o_all, d_all, rd_all, wtri[:, 0], wtri[:, 1], wtri[:, 2],
        torch.full((R,), BVH_FAR, dtype=torch.float32, device=dev),
        bw_rows=None if bw_t is None else bw_t[wl, wk])
    hits = Hits(
        t=torch.where(ok, tkey.view(torch.float32), BVH_FAR),
        u=torch.where(ok, uu, 0.0),
        v=torch.where(ok, vv, 0.0),
        prim=prim,
        inst=torch.full((R,), -1, dtype=torch.int32, device=dev),
    )
    if any_hit:
        return hits, tkey < tkey0, overflow
    return hits, overflow


def is_occluded_wavefront(bvh8: BVH8 | BVH8Q, rays: Rays, t_max,
                          omap=None):
    """(R,) bool: any hit in (0, t_max), over a BVH8 or a BVH8Q."""
    _, occ, _ = intersect_wavefront(bvh8, rays, t_max, any_hit=True,
                                    omap=omap)
    return occ
