"""Reinsertion-based BVH optimizer + quality metrics (SAH / EPO), on the
host in numpy (≙ tinybvh_tpu/builders/optimize.py, a copy of its steps:
the same numpy, heap and `np.random.default_rng(12345)`, so every mode
gives JAX's tree; the optimized BVH2 goes to the input's device).

Counterpart of the reference's Bittner-2013-style optimizer
(BVH::Optimize → BVH_Verbose::Optimize, tiny_bvh.h:3043-3053, 4338-4445):
rank interior nodes by an inefficiency measure, remove the worst, and
reinsert their subtrees at the globally best position found by
branch-and-bound (FindBestNewPosition, tiny_bvh.h:8828-8860); keep the
result only if the SAH cost improved.

This is an offline tool; the search runs host-side (numpy + heap) over the
explicit parent-pointer form (≙ BVH_Verbose, tiny_bvh.h:1166-1208). Each
pass evaluates a whole batch of candidates before the accept/rollback
decision — the batched-evaluation structure that maps to device execution
(SURVEY.md §7 step 7).

Also here: EPO (end-point-overlap) cost (≙ EPOCost, tiny_bvh.h:1972-1986):
for every triangle, the surface area of its clipped overlap with each
subtree AABB it does NOT belong to, blended with SAH as
(1-w)·SAH + w·EPO/total_area.
"""

from __future__ import annotations

import heapq

import numpy as np

from tinybvh_tpu_torch.builders.binned import _half_area as _ha
from tinybvh_tpu_torch.core.vecmath import BVH_FAR, C_INT, C_TRAV
from tinybvh_tpu_torch.layouts.bvh2 import BVH2, _np


class _Verbose:
    """Parent-pointer working form (≙ BVH_Verbose)."""

    def __init__(self, bvh: BVH2):
        self.device = bvh.prim_idx.device
        self.mn = _np(bvh.node_min).copy()
        self.mx = _np(bvh.node_max).copy()
        self.left = _np(bvh.left_first).astype(np.int64).copy()
        self.count = _np(bvh.count).astype(np.int64).copy()
        self.prim_idx = _np(bvh.prim_idx)
        self.n = int(bvh.n_nodes)
        self.parent = np.full(self.mn.shape[0], -1, np.int64)
        stack = [0]
        while stack:
            i = stack.pop()
            if self.count[i] == 0:
                l = self.left[i]
                self.parent[l] = self.parent[l + 1] = i
                stack.extend((l, l + 1))
        # free slot pool for re-packing during reinsertion
        self.right = None  # children are (left, left+1) pairs throughout

    def refit_up(self, i):
        """≙ RefitUp (tiny_bvh.h:8796-8811)."""
        while i != -1:
            if self.count[i] == 0:
                l = self.left[i]
                self.mn[i] = np.minimum(self.mn[l], self.mn[l + 1])
                self.mx[i] = np.maximum(self.mx[l], self.mx[l + 1])
            i = self.parent[i]

    def sah(self, c_trav=C_TRAV, c_int=C_INT):
        used = np.zeros(self.mn.shape[0], bool)
        stack = [0]
        while stack:
            i = stack.pop()
            used[i] = True
            if self.count[i] == 0:
                stack.extend((self.left[i], self.left[i] + 1))
        a = _ha(self.mn, self.mx)
        cost = np.where(self.count > 0, c_int * self.count * a, c_trav * a)
        return float(np.sum(cost[used])) / max(float(a[0]), 1e-30)

    def to_bvh2(self) -> BVH2:
        """Renumber into the canonical adjacent-pair layout."""
        M = self.mn.shape[0]
        n_mn = np.full((M, 3), BVH_FAR, np.float32)
        n_mx = np.full((M, 3), -BVH_FAR, np.float32)
        n_lf = np.zeros(M, np.int64)
        n_ct = np.zeros(M, np.int64)
        n_mn[0], n_mx[0] = self.mn[0], self.mx[0]
        n_lf[0], n_ct[0] = self.left[0], self.count[0]
        next_slot = 2
        work = [(0, 0)]  # (old, new)
        while work:
            old, new = work.pop()
            if self.count[old] > 0:
                n_ct[new] = self.count[old]
                n_lf[new] = self.left[old]
                continue
            l = self.left[old]
            nl = next_slot
            next_slot += 2
            n_lf[new] = nl
            n_ct[new] = 0
            for k in range(2):
                n_mn[nl + k], n_mx[nl + k] = self.mn[l + k], self.mx[l + k]
                work.append((l + k, nl + k))
        return BVH2.from_host(dict(
            node_min=n_mn, node_max=n_mx, left_first=n_lf.astype(np.int32),
            count=n_ct.astype(np.int32),
            prim_idx=self.prim_idx.astype(np.int32), n_nodes=next_slot),
            self.device)


def _connected(v: _Verbose, c: int) -> bool:
    """Is slot c still reachable from the root with consistent links?"""
    steps = 0
    while c != 0:
        p = v.parent[c]
        if p < 0 or v.count[p] != 0 or (v.left[p] != c and v.left[p] + 1 != c):
            return False
        c = int(p)
        steps += 1
        if steps > 256:
            return False
    return True


def _find_best_position(v: _Verbose, sub_mn, sub_mx, skip):
    """Branch-and-bound search for the insertion sibling minimizing induced
    surface-area growth (≙ FindBestNewPosition, tiny_bvh.h:8828-8860)."""
    sub_a = _ha(sub_mn, sub_mx)
    best_cost, best_node = np.inf, -1
    heap = [(0.0, 0)]
    while heap:
        induced, n = heapq.heappop(heap)
        if induced + sub_a >= best_cost:
            break
        if n == skip:
            continue
        merged_a = _ha(
            np.minimum(v.mn[n], sub_mn), np.maximum(v.mx[n], sub_mx)
        )
        total = induced + merged_a
        if total < best_cost:
            best_cost, best_node = total, n
        if v.count[n] == 0:
            child_induced = induced + merged_a - _ha(v.mn[n], v.mx[n])
            if child_induced + sub_a < best_cost:
                l = v.left[n]
                if l != skip and l + 1 != skip:
                    heapq.heappush(heap, (child_induced, int(l)))
                    heapq.heappush(heap, (child_induced, int(l + 1)))
    return best_node


def optimize_reinsertion(
    bvh: BVH2, passes: int = 5, batch: int = 32, mode: str = "normal",
) -> BVH2:
    """Optimize a BVH by repeated remove-and-reinsert of costly interior
    nodes (Bittner 2013). Candidates are ranked by the reference's combined
    measure Mcomb = A·Msum·Mmin with Msum = A/(0.5(A_L+A_R)) and
    Mmin = A/min(A_L, A_R) (≙ tiny_bvh.h:4352-4356); a pass is accepted
    only if the global SAH improved (≙ the backup/restore loop,
    tiny_bvh.h:4372-4439).

    mode (≙ Optimize(iterations, extreme, stochastic)):
      "normal"     — top `batch` candidates per pass;
      "extreme"    — candidate count grows each pass (1%→60% of interior),
                     strided so passes stay bounded;
      "stochastic" — random slice of the top half, random stride.

    Not valid for spatial-split (SBVH) trees only in the sense that the
    result remains correct but duplicated fragments keep their leaves.
    """
    v = _Verbose(bvh)
    rng = np.random.default_rng(12345)
    cur_sah = v.sah()
    for _p in range(passes):
        # rank LIVE interior (non-root) nodes by Mcomb; jitter slightly so
        # successive passes explore different candidates. Reinsertions
        # orphan slots, so reachability is recomputed per pass.
        live = np.zeros(v.mn.shape[0], bool)
        stack = [0]
        while stack:
            i = stack.pop()
            live[i] = True
            if v.count[i] == 0:
                stack.extend((int(v.left[i]), int(v.left[i]) + 1))
        interior = np.nonzero((v.count == 0) & (v.parent != -1) & live)[0]
        if interior.size == 0:
            break
        a = _ha(v.mn[interior], v.mx[interior])
        l = v.left[interior]
        al = _ha(v.mn[l], v.mx[l])
        ar = _ha(v.mn[l + 1], v.mx[l + 1])
        m_sum = a / np.maximum(0.5 * (al + ar), 1e-30)
        m_min = a / np.maximum(np.minimum(al, ar), 1e-30)
        score = a * m_sum * m_min
        score = score * rng.uniform(0.9, 1.0, score.shape)
        order = interior[np.argsort(-score)]
        if mode == "extreme":
            portion = 0.01 + 0.6 * _p / max(passes, 1)
            limit = max(batch, int(portion * order.size))
            step = max(1, limit // max(batch, 1))
            cand = order[:limit:step]
        elif mode == "stochastic":
            limit = order.size // 2
            start = int(limit * max(0.0, rng.uniform() * 1.2 - 0.3))
            idx = start
            cand = []
            while idx < limit and len(cand) < batch:
                cand.append(order[idx])
                idx += rng.integers(1, 64)
            cand = np.asarray(cand, np.int64)
        else:
            cand = order[:batch]

        for c in cand:
            c = int(c)
            if not _connected(v, c):
                continue  # slot orphaned by an earlier reinsertion
            p = v.parent[c]
            if p == -1 or v.count[c] != 0:
                continue
            # per-candidate accept/rollback (≙ the reference's sahBefore/
            # sahAfter gate around each reinsertion, tiny_bvh.h:4396-4439):
            # keep a change only if the global SAH improved, so passes are
            # monotone instead of an all-or-nothing gamble
            cand_bk = (v.mn.copy(), v.mx.copy(), v.left.copy(),
                       v.count.copy(), v.parent.copy(), v.n)
            # remove node c: its sibling replaces parent p (works for the
            # root as parent too — the root slot takes the sibling content)
            sib = v.left[p] + 1 if v.left[p] == c else v.left[p]
            # children of c to reinsert
            cl = int(v.left[c])
            # move sibling into p's slot pair position: copy sibling into p
            v.mn[p], v.mx[p] = v.mn[sib], v.mx[sib]
            v.left[p], v.count[p] = v.left[sib], v.count[sib]
            if v.count[p] == 0:
                ll = v.left[p]
                v.parent[ll] = v.parent[ll + 1] = p
            v.refit_up(v.parent[p])

            # reinsert both children of c (they live at cl, cl+1)
            for off in range(2):
                node = cl + off
                best = _find_best_position(v, v.mn[node], v.mx[node], node)
                if best < 0:
                    best = 0  # defensive; root is always a valid sibling
                # split 'best' with a new interior node: reuse slots c (pair
                # anchor) — we need a fresh PAIR; reuse pair (c, sib_slot)?
                # Simplest: allocate a fresh pair at the end of the pool.
                npair = v.n
                if npair + 2 > v.mn.shape[0]:
                    grow = v.mn.shape[0]
                    v.mn = np.concatenate([v.mn, np.full((grow, 3), BVH_FAR, np.float32)])
                    v.mx = np.concatenate([v.mx, np.full((grow, 3), -BVH_FAR, np.float32)])
                    v.left = np.concatenate([v.left, np.zeros(grow, np.int64)])
                    v.count = np.concatenate([v.count, np.zeros(grow, np.int64)])
                    v.parent = np.concatenate([v.parent, np.full(grow, -1, np.int64)])
                v.n = npair + 2
                # new pair holds (old best, node)
                for k, src in ((0, best), (1, node)):
                    dst = npair + k
                    v.mn[dst], v.mx[dst] = v.mn[src], v.mx[src]
                    v.left[dst], v.count[dst] = v.left[src], v.count[src]
                    if v.count[dst] == 0:
                        ll = v.left[dst]
                        v.parent[ll] = v.parent[ll + 1] = dst
                # 'best' becomes the new interior node
                v.left[best] = npair
                v.count[best] = 0
                v.parent[npair] = v.parent[npair + 1] = best
                v.mn[best] = np.minimum(v.mn[npair], v.mn[npair + 1])
                v.mx[best] = np.maximum(v.mx[npair], v.mx[npair + 1])
                v.refit_up(v.parent[best])

            after = v.sah()
            if after >= cur_sah:
                v.mn, v.mx, v.left, v.count, v.parent, v.n = cand_bk
            else:
                cur_sah = after
    return v.to_bvh2()


def _clip_polys(V, n, ax, bound, keep_ge):
    """Batched Sutherland-Hodgman clip of P polygons against one axis
    plane. V: (P, C, 3) vertex slots, n: (P,) live counts. Returns new
    (V, n); capacity C must exceed max(n)+1."""
    P, C, _ = V.shape
    slots = np.arange(C)[None, :]                       # (1, C)
    live = slots < n[:, None]
    nxt_ix = (slots + 1) % np.maximum(n[:, None], 1)
    a = V
    b = np.take_along_axis(V, nxt_ix[:, :, None], axis=1)
    av = a[:, :, ax]
    bv = b[:, :, ax]
    a_in = (av >= bound[:, None]) if keep_ge else (av <= bound[:, None])
    b_in = (bv >= bound[:, None]) if keep_ge else (bv <= bound[:, None])
    a_in &= live
    b_in &= live
    cross = live & (a_in != b_in)
    den = bv - av
    den_ok = np.abs(den) > 1e-20
    tt = np.where(den_ok, (bound[:, None] - av) / np.where(den_ok, den, 1.0),
                  0.0)
    tt = np.clip(tt, 0.0, 1.0)
    inter = a + tt[:, :, None] * (b - a)
    # each edge emits: [a if a_in] then [inter if crossing]
    emit_n = a_in.astype(np.int64) + cross.astype(np.int64)
    offs = np.cumsum(emit_n, axis=1) - emit_n           # (P, C)
    new_n = emit_n.sum(axis=1)
    out = np.zeros_like(V)
    rows = np.broadcast_to(np.arange(P)[:, None], (P, C))
    r1, c1 = rows[a_in], offs[a_in]
    out[r1, c1] = a[a_in]
    r2, c2 = rows[cross], (offs + a_in)[cross]
    out[r2, c2] = inter[cross]
    return out, new_n


def _clipped_areas(tri, lo, hi):
    """Area of each triangle clipped to its AABB [lo, hi]. tri (P, 3, 3);
    lo/hi (P, 3). Vectorized 6-plane Sutherland-Hodgman (capacity 10:
    3 verts + one per plane)."""
    P = tri.shape[0]
    if P == 0:
        return np.zeros(0, np.float64)
    V = np.zeros((P, 10, 3), np.float64)
    V[:, :3] = tri
    n = np.full(P, 3, np.int64)
    for ax in range(3):
        V, n = _clip_polys(V, n, ax, lo[:, ax].astype(np.float64), True)
        V, n = _clip_polys(V, n, ax, hi[:, ax].astype(np.float64), False)
    # fan area over live vertices
    slots = np.arange(10)[None, :]
    e1 = V[:, 1:9] - V[:, 0:1]
    e2 = V[:, 2:10] - V[:, 0:1]
    tri_a = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=2)   # (P, 8)
    fan_live = (slots[:, 2:10] < n[:, None]) & (n[:, None] >= 3)
    return (tri_a * fan_live).sum(axis=1)


def epo_cost(bvh: BVH2, tris, w_epo: float = 0.71,
             chunk: int = 256) -> float:
    """End-point-overlap blended cost (≙ EPOCost, tiny_bvh.h:1972-1986).

    For every subtree, sums the clipped surface area of triangles that
    overlap the subtree's AABB but do not belong to the subtree; final
    metric = (1-w)·SAH + w·EPO/total_tri_area.

    Vectorized: subtree membership reduces to a range test in DFS leaf
    order (one iterative DFS assigns each node a contiguous [start, end)
    span), node×triangle overlap is tested in node chunks, and all clipped
    areas are computed by one batched 6-plane Sutherland–Hodgman — runs on
    69k-tri scenes in seconds instead of the former per-triangle Python
    loops. Host-side; intended for offline quality reporting
    (tiny_bvh_optimizer.cpp stage 3).
    """
    from tinybvh_tpu_torch.layouts.bvh2 import sah_cost

    tris = np.asarray(_np(tris), np.float32)
    mn = _np(bvh.node_min)
    mx = _np(bvh.node_max)
    lf = _np(bvh.left_first)
    ct = _np(bvh.count)
    pidx = _np(bvh.prim_idx)

    # DFS leaf order: every subtree covers a contiguous span of it
    M = mn.shape[0]
    start = np.zeros(M, np.int64)
    end = np.zeros(M, np.int64)
    pos = np.zeros(tris.shape[0], np.int64)   # prim -> DFS position
    nodes = []
    cursor = 0
    stack = [(0, False)]
    post = []
    while stack:
        i, done = stack.pop()
        if done:
            end[i] = cursor
            continue
        nodes.append(i)
        start[i] = cursor
        if ct[i] > 0:
            prims = pidx[lf[i]: lf[i] + ct[i]]
            pos[prims] = np.arange(cursor, cursor + len(prims))
            cursor += len(prims)
            end[i] = cursor
        else:
            stack.append((i, True))
            stack.append((int(lf[i]) + 1, False))
            stack.append((int(lf[i]), False))

    def tri_area(t):
        e1 = t[:, 1] - t[:, 0]
        e2 = t[:, 2] - t[:, 0]
        return 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)

    total_area = float(tri_area(tris).sum())
    tmin = tris.min(axis=1)
    tmax = tris.max(axis=1)

    node_ids = np.array([i for i in nodes if i != 0], np.int64)
    epo = 0.0
    for c0 in range(0, node_ids.size, chunk):
        c = node_ids[c0: c0 + chunk]
        ov = ((tmin[None, :, :] <= mx[c][:, None, :]).all(axis=2)
              & (tmax[None, :, :] >= mn[c][:, None, :]).all(axis=2))
        member = ((pos[None, :] >= start[c][:, None])
                  & (pos[None, :] < end[c][:, None]))
        nix, tix = np.nonzero(ov & ~member)
        if nix.size == 0:
            continue
        areas = _clipped_areas(tris[tix], mn[c][nix], mx[c][nix])
        epo += float(areas.sum())

    sah = float(sah_cost(bvh))
    return (1.0 - w_epo) * sah + w_epo * epo / max(total_area, 1e-30)
