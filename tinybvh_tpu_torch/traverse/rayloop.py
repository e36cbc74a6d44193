"""Per-ray ordered BVH8 traversal with round compaction
(≙ tinybvh_tpu/traverse/rayloop.py; the distance-keyed stack of
BVH8_CPU::Intersect, tiny_bvh.h:7188-7363, and the CWBVH kernel,
traverse_cwbvh.cl:124-569). Plain torch: the JAX package has no kernel
here.

Each ray keeps a short distance-keyed stack of S entries and a list of
LQ leaf slots. A round is k steps and one resolve:
  * a step pops, slab-tests the current node's 8 children, appends the
    leaf children that it hits to the ray's leaf list, descends into the
    nearest interior child and pushes the others; a ray whose list has
    no room for 8 more slots pauses until the resolve;
  * the resolve runs Möller–Trumbore over every (ray, slot, lane) at
    once and feeds the closest t back into the next steps' pruning.
Rounds run on a ladder of batch sizes: R, then R / shrink, ... (at most
`levels`, none under min_size). A level runs rounds until its live rays
fit the next size, then the live rays are compacted into a smaller
batch. Nothing is dropped: a leaf the slab test passes is resolved, and
a stack push past S sets the ray's overflow flag (callers escalate).

Differences of form from JAX, none of result:
  * the loops run on the host; each round reads the live count (one host
    sync a round) and a compaction lists the live rays (`nonzero`, one
    more). The compacted batch holds exactly the live rays, where JAX
    pads to the ladder's size with finished rows;
  * the pops and pushes are `gather` / `scatter_` where JAX sums one-hot
    products; each sum has one nonzero term, so the values are the same.
    A push or leaf slot that JAX drops (target -1) goes to a spare
    column, (R, S + 1) and (R, LQ + 1), never to a real slot;
  * a level that runs out of max_rounds with more live rays than the
    next size raises RuntimeError. JAX's compaction keeps the first
    `cap` live rays and silently returns the others' partial hits.

LAST_CALL holds the last call's batch size and rounds per level, its
host syncs and its count of stack-overflowed rays (read in the syncs the
ladder makes anyway).

The quantized tables hold uint8 bounds relative to a per-node origin
and power-of-two scale (≙ the CWBVH quantization, tiny_bvh.h:5947-5967),
decoded in the step."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tinybvh_tpu_torch.core.intersect import moller_trumbore, tri_edges
from tinybvh_tpu_torch.core.rays import Hits, Rays
from tinybvh_tpu_torch.core.vecmath import BVH_FAR
from tinybvh_tpu_torch.layouts.mbvh import BVH8, EMPTY_SLOT
from tinybvh_tpu_torch.traverse.wavefront import _slab8

_EMPTY = -(2**31) + 1          # "needs a pop" marker of cur
LAST_CALL = {"sizes": [], "rounds": [], "syncs": 0, "overflows": 0}


@dataclass
class RayLoopTables:
    """The rayloop engine's tables, each a flat (rows, cols) tensor."""

    bounds: torch.Tensor | None   # (M, 48) f32, None when quantized
    qbounds: torch.Tensor | None  # (M, 48) uint8, quantized only
    qmeta: torch.Tensor | None    # (M, 8) f32 [origin xyz | scale xyz | 0 0]
    child: torch.Tensor           # (M, 8) i32
    leaf_row: torch.Tensor        # (L, 36) f32 [v0 x 4 | e1 x 4 | e2 x 4]
    leaf_prim: torch.Tensor       # (L, 4) i32

    @property
    def quantized(self) -> bool:
        return self.bounds is None


def _leaf_rows(leaf_tris):
    """(L, 4, 3, 3) triangles -> (L, 36) rows [v0 | e1 | e2]."""
    v0, e1, e2 = tri_edges(leaf_tris)
    return torch.cat([v0.reshape(-1, 12), e1.reshape(-1, 12),
                      e2.reshape(-1, 12)], dim=1)


def quantize_bounds(bounds):
    """(M, 48) f32 bounds (any array numpy reads) -> (qbounds (M, 48)
    uint8, qmeta (M, 8) f32), in numpy on the host (≙ JAX
    make_rayloop_tables :93-116): each node's children are stored as
    floor / ceil of their offsets from the node's box origin in units of
    a power-of-two scale, so that decoded boxes contain the true ones;
    an empty slot keeps an inverted box (lo 255, hi 0)."""
    bnp = np.asarray(bounds).reshape(-1, 6, 8)
    lo, hi = bnp[:, :3], bnp[:, 3:]
    node_lo = np.where(lo < BVH_FAR / 2, lo, np.inf).min(axis=2)
    node_hi = np.where(hi > -BVH_FAR / 2, hi, -np.inf).max(axis=2)
    node_lo = np.where(np.isfinite(node_lo), node_lo, 0.0)
    node_hi = np.where(np.isfinite(node_hi), node_hi, 0.0)
    ext = np.maximum(node_hi - node_lo, 1e-20)
    scale = np.exp2(np.ceil(np.log2(ext / 255.0))).astype(np.float32)
    qlo = np.floor((lo - node_lo[:, :, None]) / scale[:, :, None])
    qhi = np.ceil((hi - node_lo[:, :, None]) / scale[:, :, None])
    empty = lo >= BVH_FAR / 2
    qlo = np.where(empty, 255, np.clip(qlo, 0, 255)).astype(np.uint8)
    qhi = np.where(empty, 0, np.clip(qhi, 0, 255)).astype(np.uint8)
    qmeta = np.zeros((bnp.shape[0], 8), np.float32)
    qmeta[:, 0:3] = node_lo
    qmeta[:, 3:6] = scale
    return np.concatenate([qlo, qhi], axis=1).reshape(-1, 48), qmeta


def make_rayloop_tables(bvh8: BVH8, quantized: bool = False,
                        host: dict | None = None) -> RayLoopTables:
    """The flat tables of bvh8, on its device. host: the collapse's dict
    of numpy arrays (bounds, child, leaf_tris, leaf_prim), read instead
    of the device tensors where given. quantized: uint8 bounds (the
    quantization runs on the host either way)."""
    dev = bvh8.bounds.device
    if host is not None:
        lt = host["leaf_tris"]
        v0 = lt[:, :, 0]
        leaf_row = torch.from_numpy(np.concatenate(
            [v0.reshape(-1, 12), (lt[:, :, 1] - v0).reshape(-1, 12),
             (lt[:, :, 2] - v0).reshape(-1, 12)], axis=1).astype(
                 np.float32)).to(dev)
        leaf_prim = torch.as_tensor(host["leaf_prim"]).to(dev)
        child = torch.as_tensor(host["child"]).to(dev)
        bounds_src = host["bounds"]
    else:
        leaf_row = _leaf_rows(bvh8.leaf_tris)
        leaf_prim, child, bounds_src = bvh8.leaf_prim, bvh8.child, bvh8.bounds
    if not quantized:
        return RayLoopTables(
            bounds=torch.as_tensor(bounds_src).to(dev), qbounds=None,
            qmeta=None, child=child, leaf_row=leaf_row, leaf_prim=leaf_prim)
    if isinstance(bounds_src, torch.Tensor):
        bounds_src = bounds_src.cpu().numpy()
    qb, qmeta = quantize_bounds(bounds_src)
    return RayLoopTables(bounds=None, qbounds=torch.from_numpy(qb).to(dev),
                         qmeta=torch.from_numpy(qmeta).to(dev), child=child,
                         leaf_row=leaf_row, leaf_prim=leaf_prim)


def _node_bounds(tb: RayLoopTables, nrow):
    """(R, 48) bounds of rows nrow, decoded where the tables are
    quantized."""
    if not tb.quantized:
        return tb.bounds[nrow]
    qb = tb.qbounds[nrow].to(torch.float32).reshape(-1, 6, 8)
    qm = tb.qmeta[nrow]
    org = qm[:, 0:3, None]
    scl = qm[:, 3:6, None]
    lo = org + qb[:, :3] * scl
    hi = org + qb[:, 3:] * scl
    return torch.cat([lo, hi], dim=1).reshape(-1, 48)


def pop(s):
    """Pop where a ray needs one: the top entry becomes cur unless it lies
    at or beyond the ray's t (then cur stays _EMPTY). Returns (take,
    (R, 1) popped slot)."""
    need = (s["cur"] == _EMPTY) & ~s["done"]
    s["done"] = s["done"] | (need & (s["sp"] == 0))
    can = need & (s["sp"] > 0)
    nsp = torch.where(can, s["sp"] - 1, s["sp"])[:, None]
    take = can & (s["sd"].gather(1, nsp)[:, 0] < s["t"])
    s["cur"] = torch.where(take, s["se"].gather(1, nsp)[:, 0].long(),
                           s["cur"])
    s["sp"] = nsp[:, 0]
    return take, nsp


def emit_and_push(s, kids, dist, leafmask, imask, S, LQ, frame=None):
    """Append the leaf children to the leaf lists, push the interior ones
    but the nearest, and return the nearest (_EMPTY where none). With
    `frame`, each slot and stack entry also records it (lqf, sf)."""
    lane8 = torch.arange(8, device=kids.device)
    lrank = torch.cumsum(leafmask, dim=1) - leafmask.long()
    ltgt = torch.where(leafmask, s["lc"][:, None] + lrank, LQ)
    s["lq"].scatter_(1, ltgt, -kids - 1)
    if frame is not None:
        s["lqf"].scatter_(1, ltgt, frame[:, None].expand(-1, 8))
    s["lc"] = s["lc"] + leafmask.sum(dim=1)

    idist = torch.where(imask, dist, BVH_FAR)
    near = idist.argmin(dim=1)                   # first index on ties
    nxt = torch.where(imask.any(dim=1),
                      kids.gather(1, near[:, None])[:, 0].long(), _EMPTY)
    push = imask & (lane8[None, :] != near[:, None])
    tgt = s["sp"][:, None] + torch.cumsum(push, dim=1) - push.long()
    s["sovf"] = s["sovf"] | (push & (tgt >= S)).any(dim=1)
    push = push & (tgt < S)
    tgt = torch.where(push, tgt, S)
    s["se"].scatter_(1, tgt, kids)
    s["sd"].scatter_(1, tgt, idist)
    if frame is not None:
        s["sf"].scatter_(1, tgt, frame[:, None].expand(-1, 8))
    s["sp"] = s["sp"] + push.sum(dim=1)
    return nxt


def _step(tb: RayLoopTables, s, S: int, LQ: int):
    """One step: pop, slab-test the 8 children, emit the leaf slots,
    descend into the nearest interior child and push the rest."""
    pop(s)
    ready = (s["cur"] >= 0) & ~s["done"] & (s["lc"] + 8 <= LQ)
    nrow = torch.where(ready, s["cur"], 0)
    dist = _slab8(s["o"], s["rd"], s["t"], _node_bounds(tb, nrow))
    kids = tb.child[nrow]
    valid = (dist < BVH_FAR) & (kids != EMPTY_SLOT) & ready[:, None]
    nxt = emit_and_push(s, kids, dist, valid & (kids < 0),
                        valid & (kids >= 0), S, LQ)
    s["cur"] = torch.where(ready, nxt, s["cur"])


def closest(s, hit, th, uh, vh, prim_rows, extra=()):
    """Fold the (R, LQ, 4) resolve into the closest hits: the first
    minimum over the ray's slots and lanes."""
    R = hit.shape[0]
    thv = torch.where(hit, th, BVH_FAR).reshape(R, -1)
    bt, best = thv.min(dim=1)
    improved = bt < s["t"]
    pick = best[:, None]
    s["t"] = torch.where(improved, bt, s["t"])
    s["u"] = torch.where(improved, uh.reshape(R, -1).gather(1, pick)[:, 0],
                         s["u"])
    s["v"] = torch.where(improved, vh.reshape(R, -1).gather(1, pick)[:, 0],
                         s["v"])
    s["prim"] = torch.where(improved, prim_rows.gather(1, pick)[:, 0],
                            s["prim"])
    for key, rows in extra:
        s[key] = torch.where(improved, rows.gather(1, pick)[:, 0], s[key])


def slot_rows(tb, lq):
    """The leaf rows of the (R, LQ) slots: (v0, e1, e2) each
    (R, LQ, 4, 3), the prim rows (R, LQ * 4) and the slots in use."""
    R, LQ = lq.shape
    lidx = torch.clamp(lq, min=0).reshape(-1).long()
    row = tb.leaf_row[lidx]
    v0, e1, e2 = (row[:, a:a + 12].reshape(R, LQ, 4, 3) for a in (0, 12, 24))
    return v0, e1, e2, tb.leaf_prim[lidx].reshape(R, LQ * 4), lq >= 0


def clear_slots(s):
    s["lq"].fill_(-1)
    if "lqf" in s:
        s["lqf"].fill_(-1)
    s["lc"] = torch.zeros_like(s["lc"])


def _resolve(tb: RayLoopTables, s, LQ: int, anyhit: bool):
    """Möller–Trumbore over the (R, LQ) leaf lists; feeds t (or the
    occlusion) back and clears the lists."""
    v0, e1, e2, prim_rows, has = slot_rows(tb, s["lq"][:, :LQ])
    hit, th, uh, vh = moller_trumbore(
        s["o"][:, None, None], s["d"][:, None, None], v0, e1, e2,
        s["t"][:, None, None])
    hit = hit & has[:, :, None]
    if anyhit:
        s["occ"] = s["occ"] | hit.any(dim=2).any(dim=1)
        s["done"] = s["done"] | s["occ"]
    else:
        closest(s, hit, th, uh, vh, prim_rows)
    clear_slots(s)


def _ladder(R: int, shrink: int, min_size: int, levels: int):
    sizes = [R]
    while len(sizes) < levels and sizes[-1] // shrink >= min_size:
        sizes.append(sizes[-1] // shrink)
    return tuple(sizes)


def init_state(rays: Rays, t_max, S: int, LQ: int, anyhit: bool, extra=()):
    """The per-ray state; `extra`: more (name, (R,) or (R, n) fill value
    and dtype) entries of the two-level engine."""
    o = rays.o
    dev = o.device
    R = o.shape[0]

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=dev)

    s = dict(o=o, d=rays.d, rd=rays.rd,
             rid=torch.arange(R, device=dev),
             cur=torch.zeros(R, dtype=torch.int64, device=dev),
             sp=torch.zeros(R, dtype=torch.int64, device=dev),
             se=full((R, S + 1), 0, torch.int32),
             sd=full((R, S + 1), 0.0, torch.float32),
             t=torch.broadcast_to(torch.as_tensor(
                 t_max, dtype=torch.float32, device=dev), (R,)).clone(),
             lq=full((R, LQ + 1), -1, torch.int32),
             lc=torch.zeros(R, dtype=torch.int64, device=dev),
             done=full((R,), False, torch.bool),
             sovf=full((R,), False, torch.bool))
    for name, shape, value, dtype in extra:
        s[name] = full((R,) + shape, value, dtype)
    if anyhit:
        s["occ"] = full((R,), False, torch.bool)
    else:
        s["u"] = full((R,), 0.0, torch.float32)
        s["v"] = full((R,), 0.0, torch.float32)
        s["prim"] = full((R,), -1, torch.int32)
    return s


def run_levels(s, round_fn, out_keys, shrink, min_size, levels, max_rounds,
               stats):
    """The ladder: at each level run round_fn(s) until the live rays fit
    the next size (at the last, until none is live), write the level's
    outputs to the caller's rows, then keep the live rays. Raises
    RuntimeError where a level runs out of max_rounds first. Returns the
    (R0,) outputs of out_keys."""
    R0 = s["done"].shape[0]
    outs = {k: s[k].clone() for k in out_keys}
    sizes = _ladder(R0, shrink, min_size, levels)
    stats.update(sizes=[], rounds=[], syncs=0, overflows=0)
    for li in range(len(sizes)):
        last = li == len(sizes) - 1
        thresh = 0 if last else sizes[li + 1]
        stats["sizes"].append(s["done"].shape[0])
        rounds = 0
        while True:
            done = s["done"]
            alive, ovf = torch.stack(((~done).sum(),
                                      (done & s["sovf"]).sum())).tolist()
            stats["syncs"] += 1
            if alive <= thresh or rounds >= max_rounds:
                break
            round_fn(s)
            rounds += 1
        stats["rounds"].append(rounds)
        stats["overflows"] += ovf
        if alive > thresh:
            raise RuntimeError(
                f"rayloop level {li} ran out of max_rounds={max_rounds} "
                f"with {alive} live rays (over {thresh}); their hits would "
                "not be exact")
        for k in out_keys:
            outs[k][s["rid"]] = s[k]
        if not last:
            keep = torch.nonzero(~s["done"]).squeeze(1)
            stats["syncs"] += 1
            s = {k: v[keep] for k, v in s.items()}
    return outs


def _run(tb, rays, t_max, anyhit, k, S, LQ, shrink, min_size, levels,
         max_rounds):
    s = init_state(rays, t_max, S, LQ, anyhit)

    def round_fn(st):
        for _ in range(k):
            _step(tb, st, S, LQ)
        _resolve(tb, st, LQ, anyhit)

    keys = ("occ", "sovf") if anyhit else ("t", "u", "v", "prim", "sovf")
    return run_levels(s, round_fn, keys, shrink, min_size, levels,
                      max_rounds, LAST_CALL)


def intersect_rayloop(tables: RayLoopTables, rays: Rays, t_max=BVH_FAR,
                      k: int = 8, S: int = 24, LQ: int = 16, shrink: int = 4,
                      min_size: int = 4096, levels: int = 4,
                      max_rounds: int = 512):
    """Exact closest hit of a ray batch. t_max: scalar or (R,). Returns
    (Hits, (R,) stack-overflow flags): a flagged ray dropped a push past S
    entries and may be inexact (escalate it). Raises RuntimeError where a
    level runs out of max_rounds."""
    outs = _run(tables, rays, t_max, False, k, S, LQ, shrink, min_size,
                levels, max_rounds)
    ok = outs["prim"] >= 0
    return Hits(t=torch.where(ok, outs["t"], BVH_FAR), u=outs["u"],
                v=outs["v"], prim=outs["prim"],
                inst=torch.full_like(outs["prim"], -1)), outs["sovf"]


def is_occluded_rayloop(tables: RayLoopTables, rays: Rays, t_max, k: int = 8,
                        S: int = 24, LQ: int = 16, shrink: int = 4,
                        min_size: int = 4096, levels: int = 4,
                        max_rounds: int = 512):
    """Exact any hit in (0, t_max). Returns ((R,) occluded, (R,)
    stack-overflow flags); raises as intersect_rayloop."""
    outs = _run(tables, rays, t_max, True, k, S, LQ, shrink, min_size,
                levels, max_rounds)
    return outs["occ"], outs["sovf"]
