"""The packet2 engine under a TLAS (≙ tinybvh_tpu/tlas/packet.py).

The reference traces instanced scenes at full speed by handing each TLAS
leaf's BLAS to that layout's fastest Intersect (tiny_bvh.h:3341-3357).
Here, as in the JAX package, whole ray batches run the packet2 pipeline
(traverse/packet2.py: kernel A, the fine cull, and kernel B, the fused
resolve) in the BLAS frame of an instance:

  * rays are moved into the instance's frame with explicit f32
    multiply-sums; directions are not renormalised, so hit t is the same
    in both frames (≙ tiny_bvh.h:3329-3333);
  * hits fold across instances with a running minimum, gated by the
    instance visibility masks (≙ tiny_bvh.h:3326).

Two engines: `intersect_tlas_packets2` runs one packet pass per instance
over the whole batch; `intersect_tlas_packets2_bucketed` culls instance
world boxes against each tile's frustum, orders each tile's candidates
near to far and runs `rounds` packet passes, tile i tracing its r-th
candidate in round r. JAX's scan over rounds is a Python loop here, one
intersect_packets2 call (one launch of A and of B, plus the escalation
pass's when a tile overflows) per round that has a live tile; a round in
which every tile is dead is skipped, as its pass would find nothing.
Tiles whose candidates exceed `rounds`, or that overflow a budget, are
retraced exactly by the two-level wavefront (tlas/instance.py) when
`retrace` asks for it; only an overflow of that wavefront stays flagged.

Instances that share a BLAS share its PacketAux.

Opacity micromaps (build_tlas_packet(omaps=), one leaf-aligned table per
BLAS) make every packet pass run kernel B's micromap test, and the
escalation passes ("packet" mode) with it. The two-level wavefront takes
no micromaps (as JAX's, whose retrace then returns hits through
transparent cells), so with micromaps a retrace by it raises instead:
choose budgets and rounds that leave no tile to it."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tinybvh_tpu_torch.core.rays import Hits, Rays, make_rays
from tinybvh_tpu_torch.core.vecmath import BVH_FAR, mat3_apply, safe_rcp
from tinybvh_tpu_torch.layouts.mbvh import _host
from tinybvh_tpu_torch.tlas.instance import (
    TLAS8, _parse_transforms, _world_boxes, build_tlas,
    intersect_tlas_wavefront,
)
from tinybvh_tpu_torch.traverse.packet import (
    TILE, _sum3, _tile_planes, sort_rays_coherent,
)
from tinybvh_tpu_torch.traverse.packet2 import (
    build_packet_aux, intersect_packets2,
)


@dataclass
class TLASPacket:
    """A TLAS8 and the packet tables of its unique BLASes."""

    tlas: TLAS8
    blases: tuple            # tuple[BVH8], the unique BLASes
    auxes: tuple             # tuple[PacketAux] aligned with blases
    inst_inv: torch.Tensor   # (I, 4, 4) world -> BLAS
    inst_mask: torch.Tensor  # (I,) i32
    # BLAS-space triangle of each (instance, BLAS-local prim) hit:
    # prim_tris[prim_off[inst] + prim], for shaders
    prim_tris: torch.Tensor  # (sum N_b, 3, 3) f32
    prim_off: torch.Tensor   # (I,) i32
    # instance world AABBs (≙ BLASInstance.Update, tiny_bvh.h:8386-8400):
    # the bucketed engine culls tile frusta against them
    inst_wlo: torch.Tensor   # (I, 3) f32
    inst_whi: torch.Tensor   # (I, 3) f32
    blas_of: tuple = ()      # per-instance BLAS id


def build_tlas_packet(blases, transforms, masks=None, omaps=None,
                      device=None) -> TLASPacket:
    """blases: list[BVH8]; transforms: (I, 4, 4) (all instances of
    blases[0]) or (blas_id, matrix) pairs, as tlas.instance.build_tlas.
    The packet tables are built from the BLASes' tensors
    (build_packet_aux); the prim tables read them back. device: default
    the BLASes'. omaps: optional list aligned with blases of (L, 4, S, S)
    bool micromaps (ops.omap.leaf_align), baked into each BLAS's tables.

    As in the JAX package, the instance inverses here have no singular
    guard (build_tlas maps a singular transform to identity with mask 0;
    this one inverts it as it is)."""
    if device is None:
        device = blases[0].bounds.device
    tlas = build_tlas(blases, transforms, masks=masks, device=device)
    mats, blas_ids = _parse_transforms(transforms)
    blas_of = tuple(int(b) for b in blas_ids)
    auxes = tuple(build_packet_aux(b, omap=None if omaps is None
                                   else omaps[i])
                  for i, b in enumerate(blases))
    # prim -> BLAS-space triangle tables (leaves scattered back by prim id)
    tabs, blas_base, roots = [], [], []
    base = 0
    for b in blases:
        lp = _host(b.leaf_prim).reshape(-1)
        lt = _host(b.leaf_tris).reshape(-1, 3, 3)
        roots.append(_host(b.bounds[0]).reshape(6, 8))
        n = int(lp.max()) + 1 if lp.size else 0
        tab = np.zeros((n, 3, 3), np.float32)
        ok = lp >= 0
        tab[lp[ok]] = lt[ok]
        tabs.append(tab)
        blas_base.append(base)
        base += n
    prim_off = np.array([blas_base[b] for b in blas_of], np.int32)
    wlo, whi = _world_boxes(mats,
                            np.stack([roots[b][:3].min(1) for b in blas_of]),
                            np.stack([roots[b][3:].max(1) for b in blas_of]))

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return TLASPacket(
        tlas=tlas, blases=tuple(blases), auxes=auxes,
        # host inverse in f64 for conditioning
        inst_inv=up(np.linalg.inv(mats.astype(np.float64)).astype(
            np.float32)),
        inst_mask=tlas.inst_mask,
        prim_tris=up(np.concatenate(tabs, axis=0)),
        prim_off=up(prim_off),
        inst_wlo=up(wlo.astype(np.float32)),
        inst_whi=up(whi.astype(np.float32)),
        blas_of=blas_of)


def _xform_batch(inv, o, d):
    """Rays (R, 3) moved by one (4, 4) world -> BLAS transform."""
    return (mat3_apply(inv[None, :3, :3], o) + inv[:3, 3],
            mat3_apply(inv[None, :3, :3], d))


def _fold(better, h: Hits, t_best, u, v, prim, inst, inst_id):
    """Take h's hit, with instance inst_id, where `better`."""
    return (torch.where(better, h.t, t_best), torch.where(better, h.u, u),
            torch.where(better, h.v, v), torch.where(better, h.prim, prim),
            torch.where(better, inst_id, inst))


def _no_omap_retrace(tp: TLASPacket):
    """Raise where the two-level wavefront would retrace tables that
    carry micromaps: it has no micromap test."""
    if any(aux.omap_s for aux in tp.auxes):
        raise NotImplementedError(
            "the two-level wavefront retrace with opacity micromaps: JAX "
            "tlas/instance.py intersect_tlas_wavefront takes no micromaps "
            "(raise the rounds or the escalation budget, or pass "
            "retrace=False)")


def _tlas_retrace(tp: TLASPacket, rays: Rays, hits: Hits, need, tmax_r,
                  wf_cap_factor: int):
    """The two-level wavefront on the rays of the tiles in `need` (T,)
    (t_max 0 elsewhere), merged over `hits`. Returns (hits, the
    wavefront's overflow flag); a host sync. Raises for tables with
    micromaps."""
    _no_omap_retrace(tp)
    ov_ray = torch.repeat_interleave(need, TILE)
    wf, wf_ovf = intersect_tlas_wavefront(
        tp.tlas, rays, t_max=torch.where(ov_ray, tmax_r, 0.0),
        cap_factor=wf_cap_factor)
    return Hits(t=torch.where(ov_ray, wf.t, hits.t),
                u=torch.where(ov_ray, wf.u, hits.u),
                v=torch.where(ov_ray, wf.v, hits.v),
                prim=torch.where(ov_ray, wf.prim, hits.prim),
                inst=torch.where(ov_ray, wf.inst, hits.inst)), wf_ovf


def _broadcast_tmax(t_max, R, dev):
    return torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32,
                                              device=dev), (R,))


def intersect_tlas_packets2(tp: TLASPacket, rays: Rays, t_max=BVH_FAR,
                            max_leaves: int = 256, retrace=True,
                            wf_cap_factor: int = 6, max_blocks: int = 128,
                            any_hit: bool = False, retrace_ml: int = 0,
                            retrace_blocks: int = 0):
    """Closest-hit packet trace of an instanced scene, one packet pass per
    instance. Rays in tile order (see traverse.packet2.
    intersect_packets2). Returns (Hits with .inst the instance id and
    .prim the BLAS-local prim id, (T,) overflow mask). retrace=True
    retraces the overflowed tiles with the two-level wavefront;
    retrace="packet" escalates each pass's budget instead (see
    intersect_packets2)."""
    R = rays.o.shape[0]
    T = R // TILE
    dev = rays.o.device
    t_best = torch.full((R,), BVH_FAR, dtype=torch.float32, device=dev)
    u = torch.zeros(R, dtype=torch.float32, device=dev)
    v = torch.zeros(R, dtype=torch.float32, device=dev)
    prim = torch.full((R,), -1, dtype=torch.int32, device=dev)
    inst = torch.full((R,), -1, dtype=torch.int32, device=dev)
    overflow = torch.zeros(T, dtype=torch.bool, device=dev)

    for i, b in enumerate(tp.blas_of):
        o2, d2 = _xform_batch(tp.inst_inv[i], rays.o, rays.d)
        rays2 = Rays(o=o2, d=d2, rd=safe_rcp(d2), mask=rays.mask)
        h, ovf_i = intersect_packets2(
            tp.blases[b], tp.auxes[b], rays2, max_leaves=max_leaves,
            t_max=t_max, retrace="packet" if retrace == "packet" else False,
            max_blocks=max_blocks, any_hit=any_hit, retrace_ml=retrace_ml,
            retrace_blocks=retrace_blocks)
        mask_ok = (tp.inst_mask[i] & rays.mask) != 0
        better = mask_ok & (h.prim >= 0) & (h.t < t_best)
        t_best, u, v, prim, inst = _fold(better, h, t_best, u, v, prim,
                                         inst, i)
        # a tile is a mixed bag: keep the conservative OR
        overflow = overflow | ovf_i

    hits = Hits(t=t_best, u=u, v=v, prim=prim, inst=inst)
    if retrace and retrace != "packet" and bool(overflow.any()):
        hits, wf_ovf = _tlas_retrace(tp, rays, hits, overflow,
                                     _broadcast_tmax(t_max, R, dev),
                                     wf_cap_factor)
        overflow = overflow & wf_ovf
    return hits, overflow


def tile_candidates(tp: TLASPacket, rays: Rays, rounds: int):
    """The bucketed engine's TLAS-level cull: per tile and unique BLAS,
    the ids of the instances whose world box meets the tile frustum (the
    plane test of the leaf cull), nearest first by the origin-box ->
    instance-box gap. Returns (list of (blas id, (T, rounds) candidate
    ids, -1 padded), (T,) candidate count) per unique BLAS. The argsort
    is stable over keys with +inf for non-candidates, so ties keep
    instance order, as JAX's."""
    R = rays.o.shape[0]
    T = R // TILE
    o = rays.o.reshape(T, TILE, 3)
    d = rays.d.reshape(T, TILE, 3)
    olo = o.amin(dim=1)
    ohi = o.amax(dim=1)
    planes = _tile_planes(o[:, 0], d)                       # (T, 4, 3)
    posn = torch.clamp(planes, min=0.0)
    negn = torch.clamp(planes, max=0.0)
    thresh = _sum3(posn * olo[:, None, :]) + _sum3(negn * ohi[:, None, :])
    out = []
    for b in sorted(set(tp.blas_of)):
        ids = torch.tensor([i for i, bb in enumerate(tp.blas_of) if bb == b],
                           dtype=torch.int64, device=o.device)
        wlo = tp.inst_wlo[ids]                              # (Ib, 3)
        whi = tp.inst_whi[ids]
        dist = -thresh[:, :, None]                          # (T, 4, Ib)
        for k in range(3):
            dist = (dist + posn[:, :, k, None] * whi[None, None, :, k]
                    + negn[:, :, k, None] * wlo[None, None, :, k])
        hit_i = ~(dist < 0.0).any(dim=1)                    # (T, Ib)
        g2 = torch.zeros(hit_i.shape, dtype=torch.float32, device=o.device)
        for k in range(3):
            gk = torch.clamp(torch.maximum(olo[:, None, k] - whi[None, :, k],
                                           wlo[None, :, k] - ohi[:, None, k]),
                             min=0.0)
            g2 = g2 + gk * gk
        key = torch.where(hit_i, g2, float("inf"))
        order = torch.argsort(key, dim=1, stable=True)[:, :rounds]
        taken = torch.gather(hit_i, 1, order)
        cand = torch.where(taken, ids[order], -1)
        if cand.shape[1] < rounds:
            cand = torch.cat([cand, torch.full(
                (T, rounds - cand.shape[1]), -1, dtype=cand.dtype,
                device=o.device)], dim=1)
        out.append((b, cand, hit_i.sum(dim=1)))
    return out


def intersect_tlas_packets2_bucketed(tp: TLASPacket, rays: Rays,
                                     t_max=BVH_FAR, rounds: int = 8,
                                     max_leaves: int = 512, retrace=True,
                                     wf_cap_factor: int = 6,
                                     max_blocks: int = 256,
                                     any_hit: bool = False,
                                     retrace_ml: int = 0,
                                     retrace_blocks: int = 0):
    """Instanced packet trace that scales with the instance count (≙ the
    3,375-instance TLAS demo, tiny_bvh_gpu2.cpp:124-136): per-tile
    instance worklists from tile_candidates, then `rounds` packet passes
    in which every tile traces its r-th nearest candidate. A tile without
    an r-th candidate is dead in round r: its rays' t bound is 0, so its
    cull keeps nothing. Each round passes the running best t as its
    t_max, so nearer instances shrink later rounds' cull reach (the
    two-level analog of the distance-keyed TLAS stack, tiny_bvh.h:
    3365-3377); a round's hit is taken only where its t is strictly
    smaller.

    Tiles with more candidates than `rounds`, and in retrace=False or
    True mode tiles that overflow a round's leaf budget, are retraced
    exactly by the two-level wavefront when retrace is set (in "packet"
    mode the budget overflow is escalated in its round). Returns (Hits
    [.inst = instance id, .prim = BLAS-local prim], (T,) residual
    overflow mask)."""
    R = rays.o.shape[0]
    T = R // TILE
    dev = rays.o.device
    o = rays.o.reshape(T, TILE, 3)
    d = rays.d.reshape(T, TILE, 3)
    tmax_r = _broadcast_tmax(t_max, R, dev)

    t_best = torch.minimum(torch.full((R,), BVH_FAR, dtype=torch.float32,
                                      device=dev), tmax_r)
    u = torch.zeros(R, dtype=torch.float32, device=dev)
    v = torch.zeros(R, dtype=torch.float32, device=dev)
    prim = torch.full((R,), -1, dtype=torch.int32, device=dev)
    inst = torch.full((R,), -1, dtype=torch.int32, device=dev)
    overflow = torch.zeros(T, dtype=torch.bool, device=dev)  # leaf budget
    cand_ovf = torch.zeros(T, dtype=torch.bool, device=dev)

    for b, cand, n_cand in tile_candidates(tp, rays, rounds):
        cand_ovf = cand_ovf | (n_cand > rounds)      # more than `rounds`
        blas, aux = tp.blases[b], tp.auxes[b]
        live_rounds = (cand >= 0).any(dim=0).tolist()   # one host sync
        for r in range(rounds):
            if not live_rounds[r]:
                continue
            cand_r = cand[:, r]
            safe = torch.clamp(cand_r, min=0)
            inv_r = tp.inst_inv[safe]                       # (T, 4, 4)
            dead = cand_r < 0
            # exact-f32 per-tile transform
            o2 = (mat3_apply(inv_r[:, None, :3, :3], o)
                  + inv_r[:, None, :3, 3]).reshape(R, 3)
            d2 = mat3_apply(inv_r[:, None, :3, :3], d).reshape(R, 3)
            rays_r = Rays(o=o2, d=d2, rd=safe_rcp(d2), mask=rays.mask)
            dead_r = torch.repeat_interleave(dead, TILE)
            h, ovf_r = intersect_packets2(
                blas, aux, rays_r, max_leaves=max_leaves,
                t_max=torch.where(dead_r, 0.0, t_best),
                retrace="packet" if retrace == "packet" else False,
                max_blocks=max_blocks, any_hit=any_hit,
                retrace_ml=retrace_ml, retrace_blocks=retrace_blocks)
            mask_ok = ((torch.repeat_interleave(tp.inst_mask[safe], TILE)
                        & rays.mask) != 0) & ~dead_r
            better = mask_ok & (h.prim >= 0) & (h.t < t_best)
            t_best, u, v, prim, inst = _fold(
                better, h, t_best, u, v, prim, inst,
                torch.repeat_interleave(cand_r, TILE).to(torch.int32))
            overflow = overflow | (ovf_r & ~dead)

    hits = Hits(t=torch.where(prim >= 0, t_best, BVH_FAR), u=u, v=v,
                prim=prim, inst=inst)
    # whatever survives a round's escalation, and candidate overflow,
    # needs the two-level wavefront
    need_wf = overflow | cand_ovf
    if retrace and bool(need_wf.any()):
        hits, wf_ovf = _tlas_retrace(tp, rays, hits, need_wf, tmax_r,
                                     wf_cap_factor)
        return hits, need_wf if wf_ovf else torch.zeros_like(need_wf)
    return hits, need_wf


def scene_bounds(tp: TLASPacket):
    """World AABB (lo, hi) of the instanced scene from the TLAS root row
    (empty child slots are +-FAR padded)."""
    b0 = tp.tlas.bounds[0].reshape(6, 8)
    lo = torch.where(b0[:3] < BVH_FAR, b0[:3], BVH_FAR).amin(dim=1)
    hi = torch.where(b0[3:] > -BVH_FAR, b0[3:], -BVH_FAR).amax(dim=1)
    return lo, hi


def intersect_tlas_packets2_sorted(tp: TLASPacket, rays: Rays, scene_lo,
                                   scene_hi, max_leaves: int = 256,
                                   retrace=True, wf_cap_factor: int = 6,
                                   any_hit: bool = False,
                                   t_max_static: float = BVH_FAR,
                                   max_blocks: int = 128):
    """The TLAS packet trace for incoherent rays: coherence-sort into
    tiles, trace per instance, scatter back. Returns (Hits in input
    order, (R,) overflow mask)."""
    order, inverse = sort_rays_coherent(rays.o, rays.d, scene_lo, scene_hi)
    hits, overflow = intersect_tlas_packets2(
        tp, rays.take(order), t_max=t_max_static, max_leaves=max_leaves,
        retrace=retrace, wf_cap_factor=wf_cap_factor, any_hit=any_hit,
        max_blocks=max_blocks)
    return (hits.take(inverse),
            torch.repeat_interleave(overflow, TILE)[inverse])


def is_occluded_tlas_packets2(tp: TLASPacket, origin, points,
                              cutoff: float = 1.0 - 1e-3,
                              max_leaves: int = 256, retrace: bool = True,
                              wf_cap_factor: int = 6, max_blocks: int = 128):
    """Any-hit occlusion of the segments origin -> points (one shared
    origin, points in tile order) against an instanced scene. Returns
    ((R,) occluded, (T,) overflow); overflowed tiles are resolved by the
    any-hit two-level wavefront."""
    dev = tp.inst_inv.device
    points = torch.as_tensor(points, dtype=torch.float32, device=dev)
    origin = torch.as_tensor(origin, dtype=torch.float32, device=dev)
    d = points - origin[None, :]
    rays = make_rays(origin[None, :].expand_as(d), d)
    hits, overflow = intersect_tlas_packets2(
        tp, rays, t_max=cutoff, max_leaves=max_leaves, retrace=False,
        max_blocks=max_blocks, any_hit=True)
    occ = (hits.prim >= 0) & (hits.t < cutoff)
    if retrace and bool(overflow.any()):
        _no_omap_retrace(tp)
        ov_ray = torch.repeat_interleave(overflow, TILE)
        _, wf_occ, wf_ovf = intersect_tlas_wavefront(
            tp.tlas, rays, t_max=torch.where(ov_ray, cutoff, 0.0),
            cap_factor=wf_cap_factor, any_hit=True)
        occ = torch.where(ov_ray, wf_occ, occ)
        overflow = overflow & wf_ovf
    return occ, overflow

