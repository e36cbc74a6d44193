"""SBVH builder: binned object splits + spatial splits with fragment
splitting, the quality tier, on the host in numpy (≙
tinybvh_tpu/builders/sbvh.py, a copy of its steps; the BVH2 goes to
`device`, default the card).

Counterpart of BVH::BuildHQ (tiny_bvh.h:2623-3040): every node evaluates
the best binned object split AND the best spatial split; a spatial split
may cut triangles, in which case the straddling fragment is split into two
clipped fragments (the fragment pool carries the reference's +50% slack,
tiny_bvh.h:2650). Spatial splits make the tree non-refittable and the
prim-index array contains duplicates — exactly as in the reference
(`refittable=false`, tiny_bvh.h:2637).

Level-synchronous like builders.binned. Bin bounds use exact vectorized
Sutherland–Hodgman clipping of the source triangle against the bin slab,
intersected with the fragment's current box (≙ ClipFrag,
tiny_bvh.h:8614-8729, batched over all fragment×bin overlaps at once).
Spatial splits are attempted when the object split's children overlap
significantly (tiny_bvh.h:2810-2812 gates on overlap area > 1e-4 of the
root area).
"""

from __future__ import annotations

import numpy as np

from tinybvh_tpu_torch.builders.binned import _half_area, _seg_reduce
from tinybvh_tpu_torch.core.rays import default_device
from tinybvh_tpu_torch.core.vecmath import BVH_FAR, C_INT, C_TRAV
from tinybvh_tpu_torch.layouts.bvh2 import BVH2

_MAX_LEVELS = 128


def clip_tris_to_slab(tri, axis, lo, hi):
    """Vectorized Sutherland–Hodgman clip of triangles against an axis slab.

    tri: (Q, 3, 3); lo, hi: (Q,) slab bounds on `axis` (per-element).
    Returns (cmin, cmax): AABBs of the clipped polygons (≤5 vertices each);
    empty clips yield inverted boxes. ≙ ClipFrag's exact triangle clipping
    (tiny_bvh.h:8614-8729) without the fast single-axis special case.
    """
    Q = tri.shape[0]
    V = 8  # 3 verts + ≤2 per plane clip

    verts = np.zeros((Q, V, 3), np.float32)
    verts[:, :3] = tri
    valid = np.zeros((Q, V), bool)
    valid[:, :3] = True

    def clip(verts, valid, keep_ge, bound):
        """One half-space clip: keep x[axis] >= bound (or <= if not keep_ge).
        Emits, per input edge (v_i, v_next), v_i if inside plus the crossing
        point if the edge crosses — at most 2V outputs, repacked to V."""
        n = valid.sum(axis=1)  # (Q,)
        out_v = np.zeros((Q, 2 * V, 3), np.float32)
        out_m = np.zeros((Q, 2 * V), bool)
        x = verts[:, :, axis]
        inside = (x >= bound[:, None]) if keep_ge else (x <= bound[:, None])
        inside = inside & valid
        for i in range(V):
            j_idx = (i + 1) % V
            # successor index with wraparound over the VALID prefix
            nxt = np.where(i + 1 < n, (i + 1) % V, 0)
            vi = verts[:, i]
            vj = verts[np.arange(Q), nxt]
            ini = inside[:, i]
            inj = inside[np.arange(Q), nxt]
            edge_valid = valid[:, i] & (n > 1)
            # emit vi when inside
            out_v[:, 2 * i] = vi
            out_m[:, 2 * i] = ini & edge_valid
            # emit crossing when edge crosses the plane
            xi = vi[:, axis]
            xj = vj[:, axis]
            denom = np.where(np.abs(xj - xi) > 1e-20, xj - xi, 1.0)
            tpar = np.clip((bound - xi) / denom, 0.0, 1.0)
            cross = vi + tpar[:, None] * (vj - vi)
            out_v[:, 2 * i + 1] = cross
            out_m[:, 2 * i + 1] = (ini != inj) & edge_valid
        # repack valid outputs to the front (per row)
        order = np.argsort(~out_m, axis=1, kind="stable")
        out_v = np.take_along_axis(out_v, order[:, :, None], axis=1)[:, :V]
        out_m = np.take_along_axis(out_m, order, axis=1)[:, :V]
        return out_v, out_m

    verts, valid = clip(verts, valid, True, lo)
    verts, valid = clip(verts, valid, False, hi)
    big = np.where(valid[:, :, None], verts, np.float32(BVH_FAR))
    small = np.where(valid[:, :, None], verts, np.float32(-BVH_FAR))
    return big.min(axis=1), small.max(axis=1)


def build_sbvh(
    tris,
    bins: int = 8,
    c_trav: float = C_TRAV,
    c_int: float = C_INT,
    max_leaf: int | None = 4,
    slack: float = 0.5,
    overlap_threshold: float = 1e-4,
    unsplitting: bool = True,
    device=None,
) -> BVH2:
    """slack: the fragment pool's headroom over N (≙ the reference's
    +50%, tiny_bvh.h:2650; Config.sbvh_slack is not read, as in JAX)."""
    if hasattr(tris, "detach"):
        tris = tris.detach().cpu().numpy()
    tris = np.asarray(tris, np.float32)
    N = tris.shape[0]
    CAP = int(N * (1.0 + slack)) + 16

    fmin = np.empty((CAP, 3), np.float32)
    fmax = np.empty((CAP, 3), np.float32)
    fprim = np.empty(CAP, np.int64)
    fmin[:N] = tris.min(axis=1)
    fmax[:N] = tris.max(axis=1)
    fprim[:N] = np.arange(N)
    n_frags = N

    M = 2 * CAP + 2
    node_min = np.full((M, 3), BVH_FAR, np.float32)
    node_max = np.full((M, 3), -BVH_FAR, np.float32)
    left_first = np.zeros(M, np.int64)
    count = np.zeros(M, np.int64)
    node_min[0] = fmin[:N].min(axis=0)
    node_max[0] = fmax[:N].max(axis=0)
    root_area = max(_half_area(node_min[0], node_max[0]), 1e-30)

    frag_node = np.zeros(CAP, np.int64)
    frag_active = np.zeros(CAP, bool)
    frag_active[:N] = True
    n_used = 2

    for _level in range(_MAX_LEVELS):
        af = np.nonzero(frag_active[:n_frags])[0]
        if af.size == 0:
            break
        open_nodes = np.unique(frag_node[af])
        S = open_nodes.size
        slot = np.searchsorted(open_nodes, frag_node[af])
        seg_cnt = np.bincount(slot, minlength=S)
        fa_min = fmin[af]
        fa_max = fmax[af]
        cent = (fa_min + fa_max) * 0.5
        force = _level >= _MAX_LEVELS - 2

        # ---------- object split (centroid binning, 3 axes) --------------
        cb_min = _seg_reduce(cent, slot, S, np.minimum, BVH_FAR)
        cb_max = _seg_reduce(cent, slot, S, np.maximum, -BVH_FAR)
        ext = cb_max - cb_min
        scale = np.where(ext > 1e-20, bins * 0.999999 / np.maximum(ext, 1e-20), 0.0)
        binid = np.clip(((cent - cb_min[slot]) * scale[slot]).astype(np.int64),
                        0, bins - 1)

        o_counts = np.empty((S, 3, bins), np.int64)
        o_min = np.empty((S, 3, bins, 3), np.float32)
        o_max = np.empty((S, 3, bins, 3), np.float32)
        for ax in range(3):
            key = slot * bins + binid[:, ax]
            o_counts[:, ax] = np.bincount(key, minlength=S * bins).reshape(S, bins)
            o_min[:, ax] = _seg_reduce(fa_min, key, S * bins, np.minimum, BVH_FAR).reshape(S, bins, 3)
            o_max[:, ax] = _seg_reduce(fa_max, key, S * bins, np.maximum, -BVH_FAR).reshape(S, bins, 3)
        ol_min = np.minimum.accumulate(o_min, axis=2)
        ol_max = np.maximum.accumulate(o_max, axis=2)
        or_min = np.minimum.accumulate(o_min[:, :, ::-1], axis=2)[:, :, ::-1]
        or_max = np.maximum.accumulate(o_max[:, :, ::-1], axis=2)[:, :, ::-1]
        ol_cnt = np.cumsum(o_counts, axis=2)
        or_cnt = np.cumsum(o_counts[:, :, ::-1], axis=2)[:, :, ::-1]
        oa_l = _half_area(ol_min[:, :, :-1], ol_max[:, :, :-1])
        oa_r = _half_area(or_min[:, :, 1:], or_max[:, :, 1:])
        on_l = ol_cnt[:, :, :-1]
        on_r = or_cnt[:, :, 1:]
        o_cost = np.where((on_l == 0) | (on_r == 0), BVH_FAR,
                          oa_l * on_l + oa_r * on_r)
        o_flat = o_cost.reshape(S, -1)
        o_best = np.argmin(o_flat, axis=1)
        o_best_cost = o_flat[np.arange(S), o_best]
        o_axis = o_best // (bins - 1)
        o_bin = o_best % (bins - 1)

        # overlap of the object split's two child boxes → gate spatial try
        obl_min = ol_min[np.arange(S), o_axis, o_bin]
        obl_max = ol_max[np.arange(S), o_axis, o_bin]
        obr_min = or_min[np.arange(S), o_axis, o_bin + 1]
        obr_max = or_max[np.arange(S), o_axis, o_bin + 1]
        ov_min = np.maximum(obl_min, obr_min)
        ov_max = np.minimum(obl_max, obr_max)
        overlap = _half_area(ov_min, ov_max) * (ov_max > ov_min).all(axis=1)
        try_spatial = (overlap > overlap_threshold * root_area) | (
            o_best_cost >= BVH_FAR
        )

        # ---------- spatial split (node-extent binning, 3 axes) ----------
        nmin = node_min[open_nodes]
        nmax = node_max[open_nodes]
        next_ = nmax - nmin
        s_scale = np.where(next_ > 1e-20, bins / np.maximum(next_, 1e-20), 0.0)
        b0 = np.clip(((fa_min - nmin[slot]) * s_scale[slot]).astype(np.int64), 0, bins - 1)
        b1 = np.clip(((fa_max - nmin[slot]) * s_scale[slot]).astype(np.int64), 0, bins - 1)

        s_cost = np.full((S, 3, bins - 1), BVH_FAR)
        s_lmin = np.empty((S, 3, bins - 1, 3), np.float32)
        s_lmax = np.empty((S, 3, bins - 1, 3), np.float32)
        s_rmin = np.empty((S, 3, bins - 1, 3), np.float32)
        s_rmax = np.empty((S, 3, bins - 1, 3), np.float32)
        s_nl = np.zeros((S, 3, bins - 1), np.int64)
        s_nr = np.zeros((S, 3, bins - 1), np.int64)
        fa_prim = fprim[af]
        for ax in range(3):
            # per-bin bounds from exact triangle∩slab clipping (≙ ClipFrag)
            bin_min = np.full((S * bins, 3), BVH_FAR, np.float32)
            bin_max = np.full((S * bins, 3), -BVH_FAR, np.float32)
            single = b0[:, ax] == b1[:, ax]
            key1 = slot[single] * bins + b0[single, ax]
            np.minimum.at(bin_min, key1, fa_min[single])
            np.maximum.at(bin_max, key1, fa_max[single])
            for k in range(bins):
                # only multi-bin fragments need the exact clip
                m = (b0[:, ax] <= k) & (b1[:, ax] >= k) & ~single
                if not m.any():
                    continue
                lo = nmin[slot[m], ax] + k / s_scale[slot[m], ax].clip(1e-20)
                hi = nmin[slot[m], ax] + (k + 1) / s_scale[slot[m], ax].clip(1e-20)
                cmin, cmax = clip_tris_to_slab(tris[fa_prim[m]], ax, lo, hi)
                # intersect with the fragment's own (possibly pre-clipped) box
                cmin = np.maximum(cmin, fa_min[m])
                cmax = np.minimum(cmax, fa_max[m])
                ok = (cmax >= cmin).all(axis=1)
                key = (slot[m] * bins + k)[ok]
                np.minimum.at(bin_min, key, cmin[ok])
                np.maximum.at(bin_max, key, cmax[ok])
            bin_min = bin_min.reshape(S, bins, 3)
            bin_max = bin_max.reshape(S, bins, 3)
            # counts: fragment enters left side at its first bin, right at last
            enter = np.zeros((S, bins), np.int64)
            exit_ = np.zeros((S, bins), np.int64)
            np.add.at(enter, (slot, b0[:, ax]), 1)
            np.add.at(exit_, (slot, b1[:, ax]), 1)
            nl = np.cumsum(enter, axis=1)[:, :-1]
            nr = seg_cnt[:, None] - np.cumsum(exit_, axis=1)[:, :-1]
            lmin = np.minimum.accumulate(bin_min, axis=1)
            lmax = np.maximum.accumulate(bin_max, axis=1)
            rmin = np.minimum.accumulate(bin_min[:, ::-1], axis=1)[:, ::-1]
            rmax = np.maximum.accumulate(bin_max[:, ::-1], axis=1)[:, ::-1]
            a_l = _half_area(lmin[:, :-1], lmax[:, :-1])
            a_r = _half_area(rmin[:, 1:], rmax[:, 1:])
            cost = np.where((nl == 0) | (nr == 0), BVH_FAR, a_l * nl + a_r * nr)
            s_cost[:, ax] = cost
            s_lmin[:, ax] = lmin[:, :-1]
            s_lmax[:, ax] = lmax[:, :-1]
            s_rmin[:, ax] = rmin[:, 1:]
            s_rmax[:, ax] = rmax[:, 1:]
            s_nl[:, ax] = nl
            s_nr[:, ax] = nr

        s_flat = s_cost.reshape(S, -1)
        s_best = np.argmin(s_flat, axis=1)
        s_best_cost = s_flat[np.arange(S), s_best]
        s_axis = s_best // (bins - 1)
        s_bin = s_best % (bins - 1)

        # ---------- decision ---------------------------------------------
        node_area = _half_area(nmin, nmax)
        r_sav = 1.0 / np.maximum(node_area, 1e-30)
        best_cost = np.where(
            try_spatial & (s_best_cost < o_best_cost), s_best_cost, o_best_cost
        )
        use_spatial = try_spatial & (s_best_cost < o_best_cost)
        split_cost = c_trav + c_int * r_sav * best_cost
        no_split = c_int * seg_cnt.astype(np.float64)
        sah_leaf = (seg_cnt <= 1) | (best_cost >= BVH_FAR) | (split_cost >= no_split)
        if max_leaf is not None:
            make_leaf = (sah_leaf & (seg_cnt <= max_leaf)) | (seg_cnt <= 1) | force
        else:
            make_leaf = sah_leaf | force
        do_split = ~make_leaf
        split_slots = np.nonzero(do_split)[0]
        child_base = n_used + 2 * np.arange(split_slots.size)
        lchild = np.zeros(S, np.int64)
        lchild[split_slots] = child_base

        new_frag_chunks = []
        for j, s in enumerate(split_slots):
            sel_idx = af[slot == s]
            cb = child_base[j]
            if use_spatial[s] and s_best_cost[s] < BVH_FAR:
                ax, k = int(s_axis[s]), int(s_bin[s])
                plane = nmin[s, ax] + (k + 1) / max(s_scale[s, ax], 1e-20)
                fl = fmax[sel_idx, ax] <= plane
                fr = fmin[sel_idx, ax] >= plane
                straddle = ~(fl | fr)
                unsplit = sel_idx[:0]
                if unsplitting and straddle.any():
                    # reference unsplitting (≙ tiny_bvh.h:2895-2926): a
                    # straddler may be cheaper kept whole on one side
                    # (growing that child's box, shrinking the other's
                    # count) than split into two fragments. Vectorized
                    # against the chosen split's boxes.
                    sl = np.nonzero(straddle)[0]
                    si = sel_idx[sl]
                    blmin, blmax = s_lmin[s, ax, k], s_lmax[s, ax, k]
                    brmin, brmax = s_rmin[s, ax, k], s_rmax[s, ax, k]
                    a_l = _half_area(blmin, blmax)
                    a_r = _half_area(brmin, brmax)
                    n_l = float(s_nl[s, ax, k])
                    n_r = float(s_nr[s, ax, k])
                    gl = _half_area(np.minimum(blmin, fmin[si]),
                                    np.maximum(blmax, fmax[si]))
                    gr = _half_area(np.minimum(brmin, fmin[si]),
                                    np.maximum(brmax, fmax[si]))
                    c_split = a_l * n_l + a_r * n_r
                    c_uleft = gl * n_l + a_r * (n_r - 1)
                    c_uright = a_l * (n_l - 1) + gr * n_r
                    ul = (c_uleft < c_split) & (c_uleft <= c_uright)
                    ur = (c_uright < c_split) & ~ul
                    fl[sl[ul]] = True
                    fr[sl[ur]] = True
                    straddle[sl[ul | ur]] = False
                    unsplit = si[ul | ur]  # boxes must grow to full frags
                st_idx = sel_idx[straddle]
                room = CAP - n_frags
                demoted = unsplit
                if st_idx.size > room:
                    # not enough slack: demote straddlers to nearest side
                    # (their full boxes must then grow the child AABBs)
                    demoted = np.concatenate([demoted, st_idx])
                    mid = (fmin[st_idx, ax] + fmax[st_idx, ax]) * 0.5
                    fl[straddle] = mid < plane
                    fr[straddle] = ~(mid < plane)
                    st_idx = st_idx[:0]
                # left parts: clip in place
                if st_idx.size:
                    # new fragments take the exact LEFT clip; the originals
                    # become the exact RIGHT clip (≙ SplitFrag,
                    # tiny_bvh.h:8731-8793)
                    newi = np.arange(n_frags, n_frags + st_idx.size)
                    st_tri = tris[fprim[st_idx]]
                    ninf = np.full(st_idx.size, -BVH_FAR, np.float32)
                    pinf = np.full(st_idx.size, BVH_FAR, np.float32)
                    pl = np.full(st_idx.size, plane, np.float32)
                    lmn, lmx = clip_tris_to_slab(st_tri, ax, ninf, pl)
                    rmn, rmx = clip_tris_to_slab(st_tri, ax, pl, pinf)
                    fmin[newi] = np.maximum(lmn, fmin[st_idx])
                    fmax[newi] = np.minimum(lmx, fmax[st_idx])
                    fmax[newi, ax] = np.minimum(fmax[newi, ax], plane)
                    fmin[st_idx] = np.maximum(rmn, fmin[st_idx])
                    fmax[st_idx] = np.minimum(rmx, fmax[st_idx])
                    fmin[st_idx, ax] = np.maximum(fmin[st_idx, ax], plane)
                    fprim[newi] = fprim[st_idx]
                    frag_node[newi] = cb
                    frag_active[newi] = True
                    n_frags += st_idx.size
                frag_node[sel_idx[fl]] = cb
                frag_node[sel_idx[fr]] = cb + 1
                frag_node[st_idx] = cb + 1  # originals became right parts
                node_min[cb] = s_lmin[s, ax, k]
                node_max[cb] = s_lmax[s, ax, k]
                node_min[cb + 1] = s_rmin[s, ax, k]
                node_max[cb + 1] = s_rmax[s, ax, k]
                if demoted.size:
                    for side, cc in ((frag_node[demoted] == cb, cb),
                                     (frag_node[demoted] == cb + 1, cb + 1)):
                        dd = demoted[side]
                        if dd.size:
                            node_min[cc] = np.minimum(
                                node_min[cc], fmin[dd].min(axis=0))
                            node_max[cc] = np.maximum(
                                node_max[cc], fmax[dd].max(axis=0))
            elif o_best_cost[s] < BVH_FAR:
                ax, k = int(o_axis[s]), int(o_bin[s])
                lm = binid[slot == s, ax] <= k
                frag_node[sel_idx[lm]] = cb
                frag_node[sel_idx[~lm]] = cb + 1
                node_min[cb] = ol_min[s, ax, k]
                node_max[cb] = ol_max[s, ax, k]
                node_min[cb + 1] = or_min[s, ax, k + 1]
                node_max[cb + 1] = or_max[s, ax, k + 1]
            else:
                # median fallback
                ax = int(np.argmax(ext[s]))
                vals = cent[slot == s, ax]
                half = vals.size // 2
                lm = np.zeros(vals.size, bool)
                lm[np.argsort(vals, kind="stable")[:half]] = True
                frag_node[sel_idx[lm]] = cb
                frag_node[sel_idx[~lm]] = cb + 1
                node_min[cb] = fmin[sel_idx[lm]].min(axis=0)
                node_max[cb] = fmax[sel_idx[lm]].max(axis=0)
                node_min[cb + 1] = fmin[sel_idx[~lm]].min(axis=0)
                node_max[cb + 1] = fmax[sel_idx[~lm]].max(axis=0)
            left_first[open_nodes[s]] = cb
            count[open_nodes[s]] = 0

        leaf_slots = np.nonzero(make_leaf)[0]
        count[open_nodes[leaf_slots]] = seg_cnt[leaf_slots]
        frag_active[af[make_leaf[slot]]] = False

        n_used += 2 * split_slots.size
        if split_slots.size == 0:
            break

    # finalize: order fragments by leaf node
    fidx = np.arange(n_frags)
    order = fidx[np.argsort(frag_node[:n_frags], kind="stable")]
    leaf_ids, starts = np.unique(frag_node[order], return_index=True)
    left_first[leaf_ids] = starts

    m = 2 * n_frags + 2
    return BVH2.from_host(dict(
        node_min=node_min[:m], node_max=node_max[:m],
        left_first=left_first[:m].astype(np.int32),
        count=count[:m].astype(np.int32),
        prim_idx=fprim[order].astype(np.int32), n_nodes=n_used),
        default_device(device))
