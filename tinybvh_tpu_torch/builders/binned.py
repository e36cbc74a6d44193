"""Binned-SAH BVH builder, level-synchronous, on the host in numpy
(≙ tinybvh_tpu/builders/binned.py; BVH::Build, tiny_bvh.h:2261-2461).

The port's own copy of the JAX package's numpy builder: the same
`argsort(kind="stable")`, `reduceat` and `bincount` steps in the same
order, so both packages build the same arrays from the same boxes. Every
level processes all open nodes at once with segmented reductions over
the fragment array. The TLAS build runs it over instance world AABBs
(tlas/instance.py)."""

from __future__ import annotations

import numpy as np

from tinybvh_tpu_torch.core.rays import default_device
from tinybvh_tpu_torch.core.vecmath import BVH_FAR, C_INT, C_TRAV
from tinybvh_tpu_torch.layouts.bvh2 import BVH2

_MAX_LEVELS = 128


def _half_area(mn, mx):
    e = np.maximum(mx - mn, 0.0)
    return e[..., 0] * e[..., 1] + e[..., 1] * e[..., 2] + e[..., 2] * e[..., 0]


def _seg_reduce(vals, keys, nseg, ufunc, identity):
    """Segmented ufunc-reduce of vals (A, ...) keyed by keys (A,) in
    [0, nseg): argsort + reduceat; empty segments get `identity`."""
    order = np.argsort(keys, kind="stable")
    k = keys[order]
    v = vals[order]
    starts = np.searchsorted(k, np.arange(nseg))
    counts = np.bincount(keys, minlength=nseg)
    if len(v) == 0:
        return np.full((nseg,) + vals.shape[1:], identity, vals.dtype)
    res = ufunc.reduceat(v, np.minimum(starts, len(v) - 1), axis=0)
    res[counts == 0] = identity
    return res


def build_binned(tris, bins: int = 8, c_trav: float = C_TRAV,
                 c_int: float = C_INT, max_leaf: int | None = None,
                 strategy: str = "sah", return_host: bool = False,
                 device=None):
    """BVH2 over (N, 3, 3) triangles (numpy or a tensor).

    strategy='sah'    : binned SAH (≙ BVH::Build, tiny_bvh.h:2332-2461)
    strategy='median' : centroid-median split on the longest axis, leaves
                        of <= 4 prims (≙ BuildQuick, tiny_bvh.h:2030-2122)
    max_leaf          : nodes larger than this split even where SAH wants
                        a leaf (≙ SplitLeafs, tiny_bvh.h:1988-2018).
    The BVH2's tensors go to `device` (default: the card)."""
    if hasattr(tris, "detach"):
        tris = tris.detach().cpu().numpy()
    tris = np.asarray(tris, np.float32)
    return build_binned_aabbs(
        tris.min(axis=1), tris.max(axis=1), bins=bins, c_trav=c_trav,
        c_int=c_int, max_leaf=max_leaf, strategy=strategy,
        return_host=return_host, device=device)


def build_binned_aabbs(fmin, fmax, bins: int = 8, c_trav: float = C_TRAV,
                       c_int: float = C_INT, max_leaf: int | None = None,
                       strategy: str = "sah", return_host: bool = False,
                       device=None):
    """BVH2 over raw (N, 3) AABBs: the custom-AABB and TLAS entry point
    (≙ BVH::Build(aabbs, ...), tiny_bvh.h:2151-2189, and the TLAS build,
    tiny_bvh.h:2221-2259). Returns the BVH2 on `device` (default: the
    card), and with return_host also the host dict (node_min, node_max,
    left_first, count, prim_idx, n_nodes) the builder already holds."""
    fmin = np.asarray(fmin, np.float32)
    fmax = np.asarray(fmax, np.float32)
    N = fmin.shape[0]
    if N < 1:
        raise ValueError("build_binned_aabbs needs at least one box")
    cent = (fmin + fmax) * 0.5

    M = 2 * N + 2
    node_min = np.full((M, 3), BVH_FAR, np.float32)
    node_max = np.full((M, 3), -BVH_FAR, np.float32)
    left_first = np.zeros(M, np.int64)
    count = np.zeros(M, np.int64)

    node_min[0] = fmin.min(axis=0)
    node_max[0] = fmax.max(axis=0)

    frag_node = np.zeros(N, np.int64)
    frag_active = np.ones(N, bool)
    n_used = 2

    for _level in range(_MAX_LEVELS):
        af = np.nonzero(frag_active)[0]
        if af.size == 0:
            break
        open_nodes = np.unique(frag_node[af])
        S = open_nodes.size
        slot = np.searchsorted(open_nodes, frag_node[af])
        seg_cnt = np.bincount(slot, minlength=S)

        c = cent[af]
        cb_min = _seg_reduce(c, slot, S, np.minimum, BVH_FAR)
        cb_max = _seg_reduce(c, slot, S, np.maximum, -BVH_FAR)
        ext = cb_max - cb_min  # (S, 3)

        force = _level >= _MAX_LEVELS - 2  # safety: stop splitting

        if strategy == "median":
            make_leaf = (seg_cnt <= 4) | force
            best_axis = np.argmax(ext, axis=1)
            do_split = ~make_leaf
            left_mask_a = np.zeros(af.size, bool)
            for s in np.nonzero(do_split)[0]:
                sel = slot == s
                vals = c[sel, best_axis[s]]
                lm = vals < np.median(vals)
                if not lm.any() or lm.all():
                    lm = np.zeros(vals.size, bool)
                    lm[np.argsort(vals, kind="stable")[:vals.size // 2]] = True
                left_mask_a[sel] = lm
            _apply_level(node_min, node_max, left_first, count, frag_node,
                         frag_active, af, slot, open_nodes, make_leaf,
                         left_mask_a, fmin, fmax, n_used, seg_cnt)
            n_used += 2 * int(np.count_nonzero(do_split))
            continue

        # --- binned SAH on all 3 axes at once ------------------------------
        scale = np.where(ext > 1e-20,
                         bins * 0.999999 / np.maximum(ext, 1e-20), 0.0)
        binid = np.clip(((c - cb_min[slot]) * scale[slot]).astype(np.int64),
                        0, bins - 1)  # (A, 3)

        # per (slot, axis, bin) counts and fragment-AABB bounds
        bin_counts = np.empty((S, 3, bins), np.int64)
        bin_min = np.empty((S, 3, bins, 3), np.float32)
        bin_max = np.empty((S, 3, bins, 3), np.float32)
        fa_min = fmin[af]
        fa_max = fmax[af]
        for ax in range(3):
            key = slot * bins + binid[:, ax]
            bin_counts[:, ax] = np.bincount(
                key, minlength=S * bins).reshape(S, bins)
            bin_min[:, ax] = _seg_reduce(fa_min, key, S * bins, np.minimum,
                                         BVH_FAR).reshape(S, bins, 3)
            bin_max[:, ax] = _seg_reduce(fa_max, key, S * bins, np.maximum,
                                         -BVH_FAR).reshape(S, bins, 3)

        # left/right sweeps (S, 3, bins, 3)
        lmin = np.minimum.accumulate(bin_min, axis=2)
        lmax = np.maximum.accumulate(bin_max, axis=2)
        rmin = np.minimum.accumulate(bin_min[:, :, ::-1], axis=2)[:, :, ::-1]
        rmax = np.maximum.accumulate(bin_max[:, :, ::-1], axis=2)[:, :, ::-1]
        lcnt = np.cumsum(bin_counts, axis=2)
        rcnt = np.cumsum(bin_counts[:, :, ::-1], axis=2)[:, :, ::-1]

        # split after bin k, k in [0, bins-2]: (S, 3, bins-1)
        a_l = _half_area(lmin[:, :, :-1], lmax[:, :, :-1])
        a_r = _half_area(rmin[:, :, 1:], rmax[:, :, 1:])
        n_l = lcnt[:, :, :-1]
        n_r = rcnt[:, :, 1:]
        cost = a_l * n_l + a_r * n_r
        cost = np.where((n_l == 0) | (n_r == 0), BVH_FAR, cost)

        flat = cost.reshape(S, -1)
        best = np.argmin(flat, axis=1)
        best_cost = flat[np.arange(S), best]
        best_axis = best // (bins - 1)
        best_bin = best % (bins - 1)

        node_area = _half_area(node_min[open_nodes], node_max[open_nodes])
        r_sav = 1.0 / np.maximum(node_area, 1e-30)
        split_cost = c_trav + c_int * r_sav * best_cost
        no_split_cost = c_int * seg_cnt.astype(np.float64)

        sah_leaf = ((seg_cnt <= 1) | (best_cost >= BVH_FAR)
                    | (split_cost >= no_split_cost))
        if max_leaf is not None:
            must_split = seg_cnt > max_leaf
            make_leaf = (sah_leaf & ~must_split) | (seg_cnt <= 1) | force
        else:
            make_leaf = sah_leaf | force

        do_split = ~make_leaf
        sah_ok = best_cost < BVH_FAR

        # fragment side for the SAH split
        left_mask_a = (binid[np.arange(af.size), best_axis[slot]]
                       <= best_bin[slot])

        # forced splits where SAH found nothing valid: median fallback
        forced = do_split & ~sah_ok
        for s in np.nonzero(forced)[0]:
            sel = slot == s
            vals = c[sel, int(np.argmax(ext[s]))]
            lm = np.zeros(vals.size, bool)
            lm[np.argsort(vals, kind="stable")[:vals.size // 2]] = True
            left_mask_a[sel] = lm

        # child AABBs: SAH splits use binned bounds; forced use exact bounds
        child_l_min = lmin[np.arange(S), best_axis, best_bin]
        child_l_max = lmax[np.arange(S), best_axis, best_bin]
        child_r_min = rmin[np.arange(S), best_axis, best_bin + 1]
        child_r_max = rmax[np.arange(S), best_axis, best_bin + 1]

        # allocate children for splitting nodes, in slot order
        split_slots = np.nonzero(do_split)[0]
        n_split = split_slots.size
        child_base = n_used + 2 * np.arange(n_split)
        lchild = np.zeros(S, np.int64)
        lchild[split_slots] = child_base
        sn = open_nodes[split_slots]
        left_first[sn] = child_base
        count[sn] = 0
        node_min[child_base] = child_l_min[split_slots]
        node_max[child_base] = child_l_max[split_slots]
        node_min[child_base + 1] = child_r_min[split_slots]
        node_max[child_base + 1] = child_r_max[split_slots]

        # forced splits: overwrite child AABBs with exact fragment bounds
        for s in np.nonzero(forced)[0]:
            sel = slot == s
            lm = left_mask_a & sel
            rm = (~left_mask_a) & sel
            cb = lchild[s]
            node_min[cb] = fa_min[lm].min(axis=0)
            node_max[cb] = fa_max[lm].max(axis=0)
            node_min[cb + 1] = fa_min[rm].min(axis=0)
            node_max[cb + 1] = fa_max[rm].max(axis=0)

        # leaves
        leaf_slots = np.nonzero(make_leaf)[0]
        count[open_nodes[leaf_slots]] = seg_cnt[leaf_slots]

        # reassign fragments
        frag_is_split = do_split[slot]
        new_node = np.where(left_mask_a, lchild[slot], lchild[slot] + 1)
        frag_node[af] = np.where(frag_is_split, new_node, frag_node[af])
        frag_active[af[~frag_is_split]] = False

        n_used += 2 * n_split
        if n_split == 0:
            break

    # finalize prim ranges: group fragments by leaf node
    order = np.argsort(frag_node, kind="stable")
    leaf_ids, starts = np.unique(frag_node[order], return_index=True)
    left_first[leaf_ids] = starts

    host = dict(node_min=node_min, node_max=node_max,
                left_first=left_first.astype(np.int32),
                count=count.astype(np.int32),
                prim_idx=order.astype(np.int32), n_nodes=int(n_used))
    out = BVH2.from_host(host, default_device(device))
    return (out, host) if return_host else out


def _apply_level(node_min, node_max, left_first, count, frag_node,
                 frag_active, af, slot, open_nodes, make_leaf, left_mask_a,
                 fmin, fmax, n_used, seg_cnt):
    """Child allocation and partition step of the median strategy."""
    do_split = ~make_leaf
    S = open_nodes.size
    split_slots = np.nonzero(do_split)[0]
    child_base = n_used + 2 * np.arange(split_slots.size)
    lchild = np.zeros(S, np.int64)
    lchild[split_slots] = child_base
    sn = open_nodes[split_slots]
    left_first[sn] = child_base
    count[sn] = 0
    fa_min = fmin[af]
    fa_max = fmax[af]
    for j, s in enumerate(split_slots):
        sel = slot == s
        lm = left_mask_a & sel
        rm = (~left_mask_a) & sel
        cb = child_base[j]
        node_min[cb] = fa_min[lm].min(axis=0)
        node_max[cb] = fa_max[lm].max(axis=0)
        node_min[cb + 1] = fa_min[rm].min(axis=0)
        node_max[cb + 1] = fa_max[rm].max(axis=0)
    leaf_slots = np.nonzero(make_leaf)[0]
    count[open_nodes[leaf_slots]] = seg_cnt[leaf_slots]
    frag_is_split = do_split[slot]
    new_node = np.where(left_mask_a, lchild[slot], lchild[slot] + 1)
    frag_node[af] = np.where(frag_is_split, new_node, frag_node[af])
    frag_active[af[~frag_is_split]] = False
