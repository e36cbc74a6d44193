"""TLAS / BLAS instancing: merged-table two-level 8-wide traversal
(≙ tinybvh_tpu/tlas/instance.py; BLASInstance and the TLAS build and
traversal, tiny_bvh.h:1443-1475, 2221-2259, 3306-3380).

The reference walks a TLAS whose leaves hold instances and calls each
BLAS's own Intersect on a transformed ray. Here, as in the JAX package,
every table is merged into one:

  * the BLAS BVH8 tables are concatenated (child and leaf words rebased);
  * the TLAS is built 8-wide over the instance world AABBs, and its child
    words encode the instances directly;
  * the traversals keep a frame (instance id) per ray or per pair;
    entering an instance swaps in the transformed ray, whose direction is
    not renormalised, so hit t is the same in both spaces
    (tiny_bvh.h:3329-3333).

child word e (int32):
  e >= 0            -> node row (merged table)
  -L <= e <= -1     -> leaf row (-e - 1), L = total leaf rows
  e < -L            -> instance (-e - 1 - L)

Ray transforms are explicit f32 multiply-sums (core.vecmath.mat3_apply),
never a matmul. Two engines, both plain torch (the JAX package has no
kernel here): the per-ray-stack lockstep `intersect_tlas8`, and the
two-level wavefront `intersect_tlas_wavefront`, whose frontier holds only
live pairs, as traverse/wavefront.py does."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tinybvh_tpu_torch.core.intersect import moller_trumbore, tri_edges
from tinybvh_tpu_torch.core.rays import Hits, Rays, default_device
from tinybvh_tpu_torch.core.vecmath import BVH_FAR, mat3_apply, safe_rcp
from tinybvh_tpu_torch.layouts.mbvh import EMPTY_SLOT, _host, collapse_rows
from tinybvh_tpu_torch.traverse.wavefront import _slab8, _t_key
from tinybvh_tpu_torch.traverse.wide import _pop, _push8

# two-level descent pushes at most one node per level per BVH; 130 covers
# the builder's 128-level depth bound
STACK_DEPTH = 130
_EMPTY = -(2**31) + 1
_I32MAX = 2**31 - 1
MAX_LEVELS = 64
_CHECK_EVERY = 8


@dataclass
class TLAS8:
    bounds: torch.Tensor     # (M, 48) f32 merged node table (TLAS rows first)
    child: torch.Tensor      # (M, 8) i32 encoded child words
    leaf_tris: torch.Tensor  # (L, 4, 3, 3) f32 merged leaf table
    leaf_prim: torch.Tensor  # (L, 4) i32 BLAS-local prim ids
    inst_inv: torch.Tensor   # (I, 4, 4) f32 world -> BLAS transforms
    inst_mask: torch.Tensor  # (I,) i32 visibility masks
    inst_root: torch.Tensor  # (I,) i32 merged-table root row of the BLAS
    n_leaf_rows: int = 0


class MergedBlas:
    """Concatenated BLAS tables, kept across per-frame TLAS rebuilds.

    The reference rebuilds only the TLAS over instance AABBs each frame
    (UpdateSceneGraph, tiny_scene.h:3687-3696). Here the BLAS node and
    leaf tables are merged once: on the host when every BLAS has a host
    copy (host8s), else on the BLASes' device (e.g. after a refit on the
    card); per frame only the TLAS rows are rebuilt on the host and put
    in front (build_tlas_from_merged)."""

    def __init__(self, blases, host8s=None):
        node_off = []
        b_parts, c_parts, lt_parts, lp_parts = [], [], [], []
        blas_root = []
        n_nodes = n_leaves = 0
        self.any_device = False
        for bi, b in enumerate(blases):
            h = host8s[bi] if host8s is not None else None
            node_off.append(n_nodes)
            if h is not None:
                bo = h["bounds"]
                ch = np.where(
                    h["child"] == EMPTY_SLOT, h["child"],
                    np.where(h["child"] >= 0, h["child"] + n_nodes,
                             h["child"] - n_leaves)).astype(np.int32)
                lt, lp = h["leaf_tris"], h["leaf_prim"]
                blas_root.append(bo[0].reshape(6, 8))
            else:
                # a device BLAS: rebase on its device
                self.any_device = True
                bo = b.bounds
                ch = torch.where(
                    b.child == EMPTY_SLOT, b.child,
                    torch.where(b.child >= 0, b.child + n_nodes,
                                b.child - n_leaves))
                lt, lp = b.leaf_tris, b.leaf_prim
                blas_root.append(None)    # read back below
            b_parts.append(bo)
            c_parts.append(ch)
            lt_parts.append(lt)
            lp_parts.append(lp)
            n_nodes += b.n_nodes
            n_leaves += b.n_leaves
        if self.any_device:
            dev = next(p.device for p in b_parts
                       if isinstance(p, torch.Tensor))

            def cat(parts):
                return torch.cat([torch.as_tensor(p).to(dev) for p in parts])
        else:
            cat = np.concatenate
        self.bounds = cat(b_parts)
        self.child = cat(c_parts)
        self.leaf_tris = cat(lt_parts)
        self.leaf_prim = cat(lp_parts)
        # root boxes on the host, for the instance world AABBs of every
        # frame: a device BLAS pays one (48,) readback here
        self.blas_root = [
            r if r is not None else _host(blases[i].bounds[0]).reshape(6, 8)
            for i, r in enumerate(blas_root)]
        self.node_off = node_off
        self.n_nodes = n_nodes
        self.n_leaves = n_leaves

    def to_device(self, device=None) -> "MergedBlas":
        """Move host-merged tables to `device` (default: the card) once;
        later build_tlas_from_merged calls then move only TLAS rows."""
        if isinstance(self.bounds, torch.Tensor):
            return self
        dev = default_device(device)
        self.bounds = torch.from_numpy(
            np.asarray(self.bounds, np.float32)).to(dev)
        self.child = torch.from_numpy(
            np.asarray(self.child, np.int32)).to(dev)
        self.leaf_tris = torch.from_numpy(
            np.asarray(self.leaf_tris, np.float32)).to(dev)
        self.leaf_prim = torch.from_numpy(
            np.asarray(self.leaf_prim, np.int32)).to(dev)
        return self


def merge_blas_tables(blases, host8s=None) -> MergedBlas:
    return MergedBlas(blases, host8s)


def _parse_transforms(transforms):
    """(I, 4, 4) f32 matrices and per-instance BLAS ids from either form:
    (I, 4, 4) (all instances of blases[0]) or (blas_id, matrix) pairs."""
    if isinstance(transforms, (list, tuple)) and transforms and isinstance(
            transforms[0], tuple):
        blas_ids = np.array([b for b, _ in transforms], np.int32)
        mats = np.stack([np.asarray(_host(m), np.float32)
                         for _, m in transforms])
    else:
        mats = np.asarray(_host(transforms), np.float32)
        blas_ids = np.zeros(mats.shape[0], np.int32)
    return mats, blas_ids


def _world_boxes(mats, lo, hi):
    """Instance world AABBs on the host: center' +- |A| extent over the
    BLAS root boxes lo/hi (I, 3) (the numpy twin of transform_aabb, as
    the JAX package writes it)."""
    cc = (lo + hi) * 0.5
    ee = (hi - lo) * 0.5
    a3 = mats[:, :3, :3]
    c2 = np.einsum("ijk,ik->ij", a3, cc) + mats[:, :3, 3]
    e2 = np.einsum("ijk,ik->ij", np.abs(a3), ee)
    return c2 - e2, c2 + e2


def build_tlas(blases, transforms, masks=None, builder=None,
               host8s=None, device=None) -> TLAS8:
    """A TLAS8 from BVH8 BLASes and per-instance 4x4 transforms: (I, 4, 4)
    (all instances of blases[0]) or (blas_id, matrix) pairs.

    host8s: optional host dicts (bounds, child, leaf_tris, leaf_prim)
    aligned with blases; with one for every BLAS the merge runs in numpy.
    device: where the tables go (default: the BLASes' device after a
    device merge, else the card). Per-frame callers keep
    merge_blas_tables(...) and call build_tlas_from_merged."""
    return build_tlas_from_merged(merge_blas_tables(blases, host8s),
                                  transforms, masks=masks, builder=builder,
                                  device=device)


def build_tlas_from_merged(merged: MergedBlas, transforms, masks=None,
                           builder=None, device=None) -> TLAS8:
    """The TLAS rows over the instances of `transforms`, put in front of
    the merged BLAS tables. builder(wlo, whi) -> BVH2 replaces the binned
    SAH build over the instance world boxes."""
    from tinybvh_tpu_torch.builders.binned import build_binned_aabbs

    mats, blas_ids = _parse_transforms(transforms)
    I = mats.shape[0]
    if masks is None:
        masks = np.full(I, 0xFFFF, np.int32)
    masks = np.asarray(_host(masks), np.int32)
    if device is None:
        device = (merged.bounds.device
                  if isinstance(merged.bounds, torch.Tensor)
                  else default_device(None))
    device = torch.device(device)

    # ---- instance world AABBs + the TLAS build on the host --------------
    inst_root_local = np.array([merged.node_off[blas_ids[i]]
                                for i in range(I)], np.int32)
    blas_lo = np.stack([merged.blas_root[blas_ids[i]][:3].min(1)
                        for i in range(I)])
    blas_hi = np.stack([merged.blas_root[blas_ids[i]][3:].max(1)
                        for i in range(I)])
    wlo, whi = _world_boxes(mats, blas_lo, blas_hi)
    if builder is None:
        _, th = build_binned_aabbs(wlo, whi, max_leaf=1, return_host=True,
                                   device="cpu")
    else:
        t2 = builder(wlo, whi)
        th = {k: _host(getattr(t2, k)) for k in (
            "node_min", "node_max", "left_first", "count", "prim_idx")}
    # the TLAS's own 8-wide rows; a TLAS leaf holds one instance, whose
    # code goes in the leaf slot
    lf = th["left_first"]

    def inst_word(b2node):
        return -(int(th["prim_idx"][lf[b2node]]) + 1 + merged.n_leaves)

    tlas_bounds, tlas_child = collapse_rows(
        th["node_min"], th["node_max"], lf, th["count"], inst_word)
    n_tlas = tlas_bounds.shape[0]

    # host inverse in f64. Singular transforms (e.g. a zero scale that
    # hides an instance) get an identity inverse and mask 0, so they are
    # never hit
    m64 = mats.astype(np.float64)
    det = np.linalg.det(m64)
    degenerate = ~np.isfinite(det) | (np.abs(det) < 1e-30)
    if degenerate.any():
        m64 = np.where(degenerate[:, None, None], np.eye(4), m64)
        masks = np.where(degenerate, 0, masks)
    inv = np.linalg.inv(m64).astype(np.float32)

    # TLAS rows first: BLAS node words shift by n_tlas; leaf and instance
    # codes do not depend on the row count
    mb, mc = merged.bounds, merged.child
    if isinstance(mb, torch.Tensor):
        mb = mb.to(device)
        mc = mc.to(device)
        bounds_all = torch.cat([torch.from_numpy(tlas_bounds).to(device),
                                mb.reshape(mb.shape[0], -1)])
        child_all = torch.cat([torch.from_numpy(tlas_child).to(device),
                               torch.where(mc >= 0, mc + n_tlas, mc)])
        lt = merged.leaf_tris.to(device)
        lp = merged.leaf_prim.to(device)
    else:
        bounds_all = torch.from_numpy(np.concatenate(
            [tlas_bounds, mb.reshape(mb.shape[0], -1)]).astype(
                np.float32)).to(device)
        child_all = torch.from_numpy(np.concatenate(
            [tlas_child, np.where(mc >= 0, mc + n_tlas, mc)]).astype(
                np.int32)).to(device)
        lt = torch.from_numpy(np.asarray(merged.leaf_tris,
                                         np.float32)).to(device)
        lp = torch.from_numpy(np.asarray(merged.leaf_prim,
                                         np.int32)).to(device)
    return TLAS8(
        bounds=bounds_all, child=child_all, leaf_tris=lt, leaf_prim=lp,
        inst_inv=torch.from_numpy(inv).to(device),
        inst_mask=torch.from_numpy(masks.astype(np.int32)).to(device),
        inst_root=torch.from_numpy(inst_root_local + n_tlas).to(device),
        n_leaf_rows=int(merged.n_leaves))


def _inv_rows(tlas: TLAS8):
    """(I + 1, 12) rows [A (9, row-major) | b (3)] of the world -> BLAS
    transforms, with the identity appended as the world frame (row I)."""
    inv = torch.cat([tlas.inst_inv,
                     torch.eye(4, dtype=torch.float32,
                               device=tlas.inst_inv.device)[None]])
    return torch.cat([inv[:, :3, :3].reshape(-1, 9), inv[:, :3, 3]], dim=1)


def _xform(rows, o, d):
    """Frame-local rays from gathered transform rows (P, 12): o' = A o + b,
    d' = A d (direction not renormalised)."""
    a = rows[:, :9].reshape(-1, 3, 3)
    return mat3_apply(a, o) + rows[:, 9:], mat3_apply(a, d)


def intersect_tlas8(tlas: TLAS8, rays: Rays, t_max=BVH_FAR,
                    with_steps: bool = False):
    """Closest-hit two-level traversal with a per-ray stack (STACK_DEPTH
    entries, each with its frame): Hits.inst is the instance id and
    Hits.prim the BLAS-local prim id (the reference's Intersection record,
    tiny_bvh.h:693-703). Every ray advances one node or leaf per step;
    the host checks for the end every _CHECK_EVERY steps (a step after a
    ray is done leaves it as it is). with_steps also returns the step
    count."""
    o, d = rays.o, rays.d
    dev = o.device
    R = o.shape[0]
    rows = torch.arange(R, device=dev)
    lanes8 = torch.arange(8, device=dev)
    t = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32,
                                           device=dev), (R,)).clone()
    v0t, e1t, e2t = tri_edges(tlas.leaf_tris)
    L = tlas.n_leaf_rows
    n_inst = tlas.inst_inv.shape[0]
    inv_rows = _inv_rows(tlas)

    cur = torch.zeros(R, dtype=torch.int32, device=dev)
    frame = torch.full((R,), -1, dtype=torch.int32, device=dev)
    o2, d2, rd2 = o, d, rays.rd
    sp = torch.zeros(R, dtype=torch.int64, device=dev)
    stack_e = torch.zeros((STACK_DEPTH + 1, R), dtype=torch.int32,
                          device=dev)
    stack_d = torch.zeros((STACK_DEPTH + 1, R), dtype=torch.float32,
                          device=dev)
    stack_f = torch.full((STACK_DEPTH + 1, R), -1, dtype=torch.int32,
                         device=dev)
    u = torch.zeros(R, dtype=torch.float32, device=dev)
    v = torch.zeros(R, dtype=torch.float32, device=dev)
    prim = torch.full((R,), -1, dtype=torch.int32, device=dev)
    inst = torch.full((R,), -1, dtype=torch.int32, device=dev)
    done = torch.zeros(R, dtype=torch.bool, device=dev)

    def to_frame(f):
        """Rays in frame f (-1: the world, i.e. the identity row)."""
        r_o, r_d = _xform(inv_rows[torch.where(f < 0, n_inst, f).long()],
                          o, d)
        return r_o, r_d, safe_rcp(r_d)

    step = 0
    while step % _CHECK_EVERY or not bool(done.all()):
        step += 1
        # ---- pop, with the frame restored -------------------------------
        need_pop = (cur == _EMPTY) & ~done
        can_pop = need_pop & (sp > 0)
        nsp = torch.where(can_pop, sp - 1, sp)
        pe = _pop(stack_e, nsp, can_pop, 0)
        pd = _pop(stack_d, nsp, can_pop, 0.0)
        pf = _pop(stack_f, nsp, can_pop, -1)
        take = can_pop & (pd < t)
        cur = torch.where(take, pe, cur)
        new_frame = torch.where(take, pf, frame)
        switch = (take & (new_frame != frame))[:, None]
        to2, td2, trd2 = to_frame(new_frame)
        o2 = torch.where(switch, to2, o2)
        d2 = torch.where(switch, td2, d2)
        rd2 = torch.where(switch, trd2, rd2)
        frame = new_frame
        done = done | (need_pop & (sp == 0))
        sp = nsp

        proc = (cur != _EMPTY) & ~done
        is_node = proc & (cur >= 0)
        code = torch.where(proc & (cur < 0), -cur - 1, 0)   # leaf/instance
        is_leaf = proc & (cur < 0) & (code < L)
        is_inst = proc & (cur < 0) & (code >= L)

        # ---- interior node: descend into the nearest, push the others --
        nrow = torch.where(is_node, cur, 0).long()
        dist = _slab8(o2, rd2, t, tlas.bounds[nrow])
        kids = tlas.child[nrow]
        valid = (dist < BVH_FAR) & (kids != EMPTY_SLOT) & is_node[:, None]
        dist = torch.where(valid, dist, BVH_FAR)
        near = dist.argmin(dim=1)
        next_node = torch.where(valid.any(dim=1), kids[rows, near], _EMPTY)
        pushmask = valid & (lanes8[None, :] != near[:, None])
        sp = _push8(((stack_e, kids), (stack_d, dist),
                     (stack_f, frame[:, None].expand(R, 8))), sp, pushmask)

        # ---- leaf: 4-triangle Möller–Trumbore in the current frame ------
        lrow = torch.where(is_leaf, code, 0).long()
        hit, th, uh, vh = moller_trumbore(o2[:, None], d2[:, None],
                                          v0t[lrow], e1t[lrow], e2t[lrow],
                                          t[:, None])
        th = torch.where(hit & is_leaf[:, None], th, BVH_FAR)
        bt, best = th.min(dim=1)
        improved = bt < t
        pick = best[:, None]
        t = torch.where(improved, bt, t)
        u = torch.where(improved, uh.gather(1, pick)[:, 0], u)
        v = torch.where(improved, vh.gather(1, pick)[:, 0], v)
        prim = torch.where(improved,
                           tlas.leaf_prim[lrow].gather(1, pick)[:, 0], prim)
        inst = torch.where(improved, frame, inst)

        # ---- instance entry: switch the frame, jump to the BLAS root ----
        iid = torch.where(is_inst, code - L, 0).long()
        enter = is_inst & ((tlas.inst_mask[iid] & rays.mask) != 0)
        io2, id2, ird2 = to_frame(torch.where(enter, iid, -1))
        ent = enter[:, None]
        o2 = torch.where(ent, io2, o2)
        d2 = torch.where(ent, id2, d2)
        rd2 = torch.where(ent, ird2, rd2)
        frame = torch.where(enter, iid.to(torch.int32), frame)
        cur = torch.where(is_node, next_node,
                          torch.where(enter, tlas.inst_root[iid], _EMPTY))

    ok = prim >= 0
    hits = Hits(t=torch.where(ok, t, BVH_FAR), u=u, v=v, prim=prim,
                inst=inst)
    return (hits, step) if with_steps else hits


def is_occluded_tlas8(tlas: TLAS8, rays: Rays, t_max, cap_factor: int = 4):
    """Any hit in (0, t_max) (≙ IsOccludedTLAS, tiny_bvh.h:3455-3526): the
    any-hit wavefront, which drops a ray's pairs once anything hits, at
    cap_factor and then 3 * cap_factor pairs per ray; on a second
    overflow the exact lockstep traversal."""
    for cap in (cap_factor, 3 * cap_factor):
        _, occ, overflow = intersect_tlas_wavefront(
            tlas, rays, t_max, cap_factor=cap, any_hit=True)
        if not overflow:
            return occ
    return intersect_tlas8(tlas, rays, t_max).prim >= 0


def intersect_tlas_wavefront(tlas: TLAS8, rays: Rays, t_max=BVH_FAR,
                             cap_factor: int = 3, any_hit: bool = False,
                             return_winner: bool = False):
    """Two-level wavefront over the merged table (≙ JAX
    intersect_tlas_wavefront): the level-synchronous frontier of
    traverse/wavefront.py with a frame per pair (instance id; n_inst is
    the world, with the identity appended to the transforms). A pair's
    ray is moved into its frame when the level gathers it, from the
    transform rows gathered once per level; an instance child spawns a
    BLAS-root pair in the instance's frame once its mask passes
    (≙ tiny_bvh.h:3326).

    The fold is the JAX package's, so ties pick the same winner: the
    packed leafrow*4+lane minimum among a level's winners first, then the
    least frame among the pairs that hold that final winner. Returns
    (Hits, overflow), or with any_hit (Hits, (R,) occluded, overflow),
    or with return_winner (Hits, (R,) packed winner or -1, overflow);
    overflow (a bool) says pairs past cap_factor*R were dropped or
    MAX_LEVELS cut the walk, so hits may be inexact."""
    o_all, d_all = rays.o, rays.d
    dev = o_all.device
    R = o_all.shape[0]
    P = cap_factor * R
    L = tlas.n_leaf_rows
    n_inst = tlas.inst_inv.shape[0]
    inv_rows = _inv_rows(tlas)
    v0t, e1t, e2t = tri_edges(tlas.leaf_tris)
    ray_data = torch.cat([o_all, d_all], dim=1)              # (R, 6)

    t0 = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32,
                                            device=dev), (R,))
    tkey0 = _t_key(t0)
    tkey = tkey0.clone()
    win = torch.full((R,), _I32MAX, dtype=torch.int32, device=dev)
    win_inst = torch.full((R,), _I32MAX, dtype=torch.int32, device=dev)

    pr = torch.arange(R, device=dev)                         # pair -> ray
    pc = torch.zeros(R, dtype=torch.int32, device=dev)       # root row 0
    pf = torch.full((R,), n_inst, dtype=torch.int32, device=dev)
    pt = torch.zeros(R, dtype=torch.float32, device=dev)     # entry t
    n_pairs, level, overflow = R, 0, False
    while n_pairs > 0 and level < MAX_LEVELS:
        tb = tkey.view(torch.float32)[pr]
        active = pt < tb
        if any_hit:
            active &= ~(tkey < tkey0)[pr]
        is_node = active & (pc >= 0)
        code = torch.where(active & (pc < 0), -pc - 1, 0)
        is_leaf = active & (pc < 0) & (code < L)

        rdat = ray_data[pr]
        o, d = _xform(inv_rows[pf.long()], rdat[:, 0:3], rdat[:, 3:6])
        rd = safe_rcp(d)

        nrow = torch.where(is_node, pc, 0).long()
        dist = _slab8(o, rd, tb, tlas.bounds[nrow])          # (n, 8)
        kids = tlas.child[nrow]
        valid = (dist < BVH_FAR) & (kids != EMPTY_SLOT) & is_node[:, None]

        # classify the children: instance words enter their frame
        kcode = torch.where(kids < 0, -kids - 1, 0)
        inst_word = (kids < 0) & (kcode >= L)
        iid = torch.clamp(kcode - L, 0, n_inst - 1).long()
        k_is_inst = (valid & inst_word & (kids != EMPTY_SLOT)
                     & ((tlas.inst_mask[iid] & rays.mask[pr][:, None]) != 0))
        k_keep = (valid & ~inst_word) | k_is_inst
        lane_code = torch.where(k_is_inst, tlas.inst_root[iid], kids)
        lane_frame = torch.where(k_is_inst, iid.to(torch.int32),
                                 pf[:, None])

        # ---- leaf fold ----------------------------------------------------
        lrow = torch.where(is_leaf, code, 0).long()
        hit, th, _, _ = moller_trumbore(o[:, None], d[:, None], v0t[lrow],
                                        e1t[lrow], e2t[lrow], tb[:, None])
        th = torch.where(hit & is_leaf[:, None], th, BVH_FAR)
        cand_t, lbest = th.min(dim=1)                        # first argmin
        has_cand = cand_t < BVH_FAR
        ckey = torch.where(has_cand, _t_key(cand_t), _I32MAX)
        new_tkey = tkey.scatter_reduce(0, pr, ckey, "amin")
        is_winner = has_cand & (ckey == new_tkey[pr])
        packed = torch.where(is_winner, (lrow * 4 + lbest).to(torch.int32),
                             _I32MAX)
        improved = new_tkey < tkey
        win = torch.where(improved, _I32MAX, win)
        win = win.scatter_reduce(0, pr, packed, "amin")
        # the winner's frame: a second fold keyed on the final packed
        final_winner = is_winner & (packed == win[pr])
        win_inst = torch.where(improved, _I32MAX, win_inst)
        win_inst = win_inst.scatter_reduce(
            0, pr, torch.where(final_winner, pf, _I32MAX), "amin")
        tkey = new_tkey

        # ---- the next frontier, in pair order then lane order -----------
        k_keep &= dist < tkey.view(torch.float32)[pr][:, None]
        flat = torch.nonzero(k_keep.reshape(-1)).squeeze(1)  # host sync
        if flat.shape[0] > P:
            overflow = True
            flat = flat[:P]
        pr = pr[flat // 8]
        pc = lane_code.reshape(-1)[flat]
        pf = lane_frame.reshape(-1)[flat]
        pt = dist.reshape(-1)[flat]
        n_pairs = flat.shape[0]
        level += 1
    # stopping at MAX_LEVELS with pairs pending is silent truncation
    overflow = overflow or n_pairs > 0

    ok = win != _I32MAX
    wl = torch.where(ok, win >> 2, 0).long()
    wk = torch.where(ok, win & 3, 0).long()
    prim = torch.where(ok, tlas.leaf_prim[wl, wk], -1)
    inst = torch.where(ok & (win_inst < n_inst), win_inst, -1)
    # u / v: the winning triangle again, against the frame-local ray
    wf = torch.where(ok, torch.clamp(win_inst, max=n_inst), n_inst)
    o2, d2 = _xform(inv_rows[wf.long()], o_all, d_all)
    _, _, uu, vv = moller_trumbore(
        o2, d2, v0t[wl, wk], e1t[wl, wk], e2t[wl, wk],
        torch.full((R,), BVH_FAR, dtype=torch.float32, device=dev))
    hits = Hits(t=torch.where(ok, tkey.view(torch.float32), BVH_FAR),
                u=torch.where(ok, uu, 0.0), v=torch.where(ok, vv, 0.0),
                prim=prim, inst=inst)
    if any_hit:
        return hits, tkey < tkey0, overflow
    if return_winner:
        return hits, torch.where(ok, win, -1), overflow
    return hits, overflow


def merge_leaf_attrs(blases, attrs):
    """Per-BLAS per-prim shading attributes -> one merged (L, 4, ...)
    table aligned with TLAS8.leaf_tris (the BLAS order of build_tlas).
    attrs[i] is (N_i, ...), indexed by BLAS-local prim id. Empty leaf
    lanes take prim 0's data; their triangles never hit. On the device of
    blases[0] (≙ the per-instance shading tables of wavefront2.cl)."""
    out = [np.asarray(_host(a))[np.maximum(_host(b.leaf_prim), 0)]
           for b, a in zip(blases, attrs)]
    return torch.from_numpy(np.concatenate(out, axis=0)).to(
        blases[0].leaf_prim.device)
