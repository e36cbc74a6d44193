"""Two-level (TLAS -> BLAS) per-ray ordered traversal with round
compaction (≙ tinybvh_tpu/tlas/rayloop.py; the recursive TLAS Intersect,
tiny_bvh.h:3306-3380). Plain torch: the JAX package has no kernel here.

The rayloop engine of traverse/rayloop.py over the merged node table of
tlas.instance.TLAS8, whose child words encode three kinds:

  e >= 0          -> node row (TLAS rows first, then the BLAS rows)
  -L <= e <= -1   -> BLAS leaf row (-e - 1)
  e < -L          -> instance (-e - 1 - L)

Each ray also carries its frame (the instance it is in, -1 for the
world). Entering an instance whose mask meets the ray's jumps to the
BLAS root and sets the frame; stack entries carry the frame they were
pushed under (sf), so a pop across instances restores it, and leaf slots
carry theirs (lqf), so the resolve re-derives each slot's ray in its own
frame from the (I + 1, 16) inverse-transform table (row I: the
identity). The transformed direction is not renormalised, so t is the
same in every frame and one world t prunes them all
(tiny_bvh.h:3329-3333). The transforms are explicit f32 multiply-sums
(core.vecmath.mat3_apply), never a matmul.

The ladder, the spare columns, the host syncs and the max_rounds raise
are those of traverse/rayloop.py; LAST_CALL holds the last call's
batch sizes, rounds per level, host syncs and stack-overflowed rays."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from tinybvh_tpu_torch.core.intersect import moller_trumbore
from tinybvh_tpu_torch.core.rays import Hits, Rays
from tinybvh_tpu_torch.core.vecmath import BVH_FAR, mat3_apply, safe_rcp
from tinybvh_tpu_torch.layouts.mbvh import EMPTY_SLOT
from tinybvh_tpu_torch.tlas.instance import TLAS8
from tinybvh_tpu_torch.traverse.rayloop import (
    _EMPTY, _leaf_rows, clear_slots, closest, emit_and_push, init_state,
    pop, run_levels, slot_rows,
)
from tinybvh_tpu_torch.traverse.wavefront import _slab8

LAST_CALL = {"sizes": [], "rounds": [], "syncs": 0, "overflows": 0}


@dataclass
class TLASRayLoopTables:
    """The two-level rayloop engine's tables, each flat."""

    bounds: torch.Tensor     # (M, 48) f32 merged node table
    child: torch.Tensor      # (M, 8) i32 encoded child words
    leaf_row: torch.Tensor   # (L, 36) f32 [v0 | e1 | e2], BLAS-local
    leaf_prim: torch.Tensor  # (L, 4) i32 BLAS-local prim ids
    inv_flat: torch.Tensor   # (I + 1, 16) f32 world -> BLAS; row I identity
    inst_mask: torch.Tensor  # (I + 1,) i32 visibility; row I all bits
    inst_root: torch.Tensor  # (I + 1,) i32 merged root row; row I 0
    n_leaf_rows: int = 0
    n_inst: int = 0


def make_tlas_rayloop_tables(tlas: TLAS8) -> TLASRayLoopTables:
    """The flat tables of a TLAS8, on its device."""
    dev = tlas.bounds.device
    n_inst = int(tlas.inst_inv.shape[0])
    return TLASRayLoopTables(
        bounds=tlas.bounds, child=tlas.child,
        leaf_row=_leaf_rows(tlas.leaf_tris), leaf_prim=tlas.leaf_prim,
        inv_flat=torch.cat([
            tlas.inst_inv.reshape(n_inst, 16).to(torch.float32),
            torch.eye(4, dtype=torch.float32, device=dev).reshape(1, 16)]),
        inst_mask=torch.cat([
            tlas.inst_mask.to(torch.int32),
            torch.full((1,), 0xFFFF, dtype=torch.int32, device=dev)]),
        inst_root=torch.cat([
            tlas.inst_root.to(torch.int64),
            torch.zeros(1, dtype=torch.int64, device=dev)]),
        n_leaf_rows=int(tlas.n_leaf_rows), n_inst=n_inst)


def _frame_ray(tb: TLASRayLoopTables, frame, o, d):
    """The rays (o, d) in frames `frame` (-1: the world), with the safe
    reciprocal direction."""
    inv = tb.inv_flat[torch.where(frame < 0, tb.n_inst, frame)].reshape(
        -1, 4, 4)
    o2 = mat3_apply(inv[:, :3, :3], o) + inv[:, :3, 3]
    d2 = mat3_apply(inv[:, :3, :3], d)
    return o2, d2, safe_rcp(d2)


def _step(tb: TLASRayLoopTables, s, S: int, LQ: int):
    """One step: pop (restoring the pushed frame), instance entry, the
    8-child slab test in the ray's frame, the leaf slots (with their
    frame), then descend into the nearest node or instance and push the
    rest."""
    L = tb.n_leaf_rows
    take, nsp = pop(s)
    s["frame"] = torch.where(take, s["sf"].gather(1, nsp)[:, 0],
                             s["frame"])

    cur = s["cur"]
    is_inst = ~s["done"] & (cur != _EMPTY) & (cur < -L)
    iid = torch.where(is_inst, -cur - 1 - L, tb.n_inst)
    enter = is_inst & ((tb.inst_mask[iid] & s["mask"]) != 0)
    s["cur"] = torch.where(enter, tb.inst_root[iid],
                           torch.where(is_inst, _EMPTY, cur))
    s["frame"] = torch.where(enter, iid, s["frame"])

    o2, _, rd2 = _frame_ray(tb, s["frame"], s["o"], s["d"])
    ready = (s["cur"] >= 0) & ~s["done"] & (s["lc"] + 8 <= LQ)
    nrow = torch.where(ready, s["cur"], 0)
    dist = _slab8(o2, rd2, s["t"], tb.bounds[nrow])
    kids = tb.child[nrow]
    valid = (dist < BVH_FAR) & (kids != EMPTY_SLOT) & ready[:, None]
    is_leaf = (kids < 0) & (kids >= -L)
    nxt = emit_and_push(s, kids, dist, valid & is_leaf, valid & ~is_leaf,
                        S, LQ, frame=s["frame"])
    s["cur"] = torch.where(ready, nxt, s["cur"])


def _resolve(tb: TLASRayLoopTables, s, LQ: int, anyhit: bool):
    """Möller–Trumbore over the (R, LQ) leaf lists, each slot's ray in
    its own frame; feeds t (or the occlusion) back and clears the
    lists."""
    lqf = s["lqf"][:, :LQ]
    v0, e1, e2, prim_rows, has = slot_rows(tb, s["lq"][:, :LQ])
    R = has.shape[0]
    o2, d2, _ = _frame_ray(
        tb, lqf.reshape(-1), s["o"][:, None].expand(R, LQ, 3).reshape(-1, 3),
        s["d"][:, None].expand(R, LQ, 3).reshape(-1, 3))
    hit, th, uh, vh = moller_trumbore(
        o2.reshape(R, LQ, 1, 3), d2.reshape(R, LQ, 1, 3), v0, e1, e2,
        s["t"][:, None, None])
    hit = hit & has[:, :, None]
    if anyhit:
        s["occ"] = s["occ"] | hit.any(dim=2).any(dim=1)
        s["done"] = s["done"] | s["occ"]
    else:
        inst_rows = lqf[:, :, None].expand(R, LQ, 4).reshape(R, LQ * 4)
        closest(s, hit, th, uh, vh, prim_rows,
                extra=(("inst", inst_rows.to(torch.int32)),))
    clear_slots(s)


def _run(tb, rays, t_max, anyhit, k, S, LQ, shrink, min_size, levels,
         max_rounds):
    extra = [("frame", (), -1, torch.int64),
             ("sf", (S + 1,), -1, torch.int64),
             ("lqf", (LQ + 1,), -1, torch.int64)]
    if not anyhit:
        extra.append(("inst", (), -1, torch.int32))
    s = init_state(rays, t_max, S, LQ, anyhit, extra)
    s["mask"] = rays.mask.to(torch.int32)

    def round_fn(st):
        for _ in range(k):
            _step(tb, st, S, LQ)
        _resolve(tb, st, LQ, anyhit)

    keys = (("occ", "sovf") if anyhit
            else ("t", "u", "v", "prim", "inst", "sovf"))
    return run_levels(s, round_fn, keys, shrink, min_size, levels,
                      max_rounds, LAST_CALL)


def intersect_tlas_rayloop(tables: TLASRayLoopTables, rays: Rays,
                           t_max=BVH_FAR, k: int = 8, S: int = 32,
                           LQ: int = 16, shrink: int = 4,
                           min_size: int = 4096, levels: int = 4,
                           max_rounds: int = 512):
    """Exact closest hit through the instances. Returns (Hits, (R,)
    stack-overflow flags); Hits.inst is the instance, Hits.prim the
    BLAS-local prim (≙ the reference's Intersection, tiny_bvh.h:693-703).
    Raises RuntimeError where a level runs out of max_rounds."""
    outs = _run(tables, rays, t_max, False, k, S, LQ, shrink, min_size,
                levels, max_rounds)
    ok = outs["prim"] >= 0
    return Hits(t=torch.where(ok, outs["t"], BVH_FAR), u=outs["u"],
                v=outs["v"], prim=outs["prim"], inst=outs["inst"]), \
        outs["sovf"]


def is_occluded_tlas_rayloop(tables: TLASRayLoopTables, rays: Rays, t_max,
                             k: int = 8, S: int = 32, LQ: int = 16,
                             shrink: int = 4, min_size: int = 4096,
                             levels: int = 4, max_rounds: int = 512):
    """Exact any hit in (0, t_max) through the instances. Returns ((R,)
    occluded, (R,) stack-overflow flags); raises as
    intersect_tlas_rayloop."""
    outs = _run(tables, rays, t_max, True, k, S, LQ, shrink, min_size,
                levels, max_rounds)
    return outs["occ"], outs["sovf"]
