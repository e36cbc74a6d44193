"""Data-parallel binned-SAH builder on the BVH's device, in plain torch
(≙ tinybvh_tpu/builders/binned_jax.py::build_binned_device; BVH::Build,
tiny_bvh.h:2261-2461).

Every level of the tree is built at once:

  per level:  segmented 3-axis x 8-bin reduction over all fragments
              -> the SAH sweep over all open nodes
              -> partition by each fragment's bin
              -> children allocated as one contiguous id range

JAX's `lax.while_loop` is a Python loop here, one host sync a level
(the level's split count and whether a fragment is still open, read
together), at most MAX_LEVELS. `segment_sum` / `segment_min` /
`segment_max` are `index_add_` / `scatter_reduce_` (min and max start
from +inf / -inf, as JAX fills empty segments), and
`dynamic_update_slice` is slice assignment. JAX sizes every level's slot
domain at N for static shapes; torch knows the level's open-node count S
on the host, so the segments span S slots and one dummy slot for the
finished fragments: the slots past S are empty in JAX and change
nothing. The fragment arrays stay (N,), as JAX's.

Topology matches the numpy builder (builders/binned.py) up to
tie-breaking; nodes whose centroids all coincide become leaves (possibly
over max_leaf, as in the reference)."""

from __future__ import annotations

import torch

from tinybvh_tpu_torch.builders.lbvh import _as_tris
from tinybvh_tpu_torch.core.vecmath import BVH_FAR, C_INT, C_TRAV
from tinybvh_tpu_torch.layouts.bvh2 import BVH2

BINS = 8
MAX_LEVELS = 64


def _ha(mn, mx):
    e = torch.clamp(mx - mn, min=0.0)
    return e[..., 0] * e[..., 1] + e[..., 1] * e[..., 2] + e[..., 2] * e[..., 0]


def _cost(a_l, n_l, a_r, n_r):
    """The SAH cost of a split: a_l * n_l + a_r * n_r."""
    return a_l * n_l + a_r * n_r


def _split_cost(r_sav, best_cost):
    return C_TRAV + C_INT * r_sav * best_cost


def _seg(vals, keys, n, reduce):
    """Segmented min / max / sum of vals (A, ...) keyed by keys (A,) into
    n segments; empty segments hold +inf / -inf / 0 (JAX's fill)."""
    fill = {"amin": float("inf"), "amax": float("-inf"), "sum": 0}[reduce]
    out = torch.full((n,) + vals.shape[1:], fill, dtype=vals.dtype,
                     device=vals.device)
    if reduce == "sum":
        return out.index_add_(0, keys, vals)
    k = keys.reshape((-1,) + (1,) * (vals.dim() - 1)).expand_as(vals)
    return out.scatter_reduce_(0, k, vals, reduce, include_self=True)


def build_binned_device(tris, max_leaf: int = 4, device=None) -> BVH2:
    """A BVH2 over (N, 3, 3) triangles, built on `device` (default: a
    tensor's own device, else the card)."""
    tris = _as_tris(tris, device)
    dev = tris.device
    N = tris.shape[0]
    fmin = tris.amin(dim=1)
    fmax = tris.amax(dim=1)
    cent = (fmin + fmax) * 0.5
    M = 4 * N + 4
    node_min = torch.full((M, 3), BVH_FAR, device=dev)
    node_max = torch.full((M, 3), -BVH_FAR, device=dev)
    left_first = torch.zeros(M, dtype=torch.int32, device=dev)
    count = torch.zeros(M, dtype=torch.int32, device=dev)
    node_min[0] = fmin.amin(dim=0)
    node_max[0] = fmax.amax(dim=0)
    frag_node = torch.zeros(N, dtype=torch.int64, device=dev)
    frag_active = torch.ones(N, dtype=torch.bool, device=dev)
    ax3 = torch.arange(3, device=dev)
    fmin3 = fmin.repeat_interleave(3, dim=0)               # (3N, 3)
    fmax3 = fmax.repeat_interleave(3, dim=0)
    far = torch.full((), BVH_FAR, device=dev)
    binw = torch.full((), BINS * 0.999999, device=dev)

    ls, le, level, any_active = 0, 2, 0, True     # slot 1 reserved
    while any_active and level < MAX_LEVELS:
        S = le - ls                                # open nodes this level
        act = frag_active
        slot = torch.where(act, frag_node - ls, S)  # finished -> dummy S
        ns = S + 1

        # ---- per-slot centroid bounds --------------------------------
        cb_min = _seg(torch.where(act[:, None], cent, far), slot, ns, "amin")
        cb_max = _seg(torch.where(act[:, None], cent, -far), slot, ns,
                      "amax")
        seg_cnt = _seg(act.to(torch.int32), slot, ns, "sum")
        ext = cb_max - cb_min

        # ---- binning on all 3 axes (a true division, as JAX's) -------
        scale = torch.where(ext > 1e-20,
                            torch.div(binw, torch.clamp(ext, min=1e-20)),
                            0.0)
        # clamped before the conversion: equal to JAX's clip after it for
        # every finite value, and no float -> int overflow
        binid = torch.clamp((cent - cb_min[slot]) * scale[slot], 0,
                            BINS - 1).to(torch.int64)     # (N, 3)

        # (fragment, axis) -> 3N items, key = slot*24 + axis*8 + bin
        nk = ns * 3 * BINS
        actf = act.repeat_interleave(3)
        keyf = torch.where(
            actf, (slot[:, None] * (3 * BINS) + ax3 * BINS + binid)
            .reshape(-1), nk - 1)
        bin_cnt = _seg(actf.to(torch.int32), keyf, nk, "sum").reshape(
            ns, 3, BINS)
        bin_min = _seg(torch.where(actf[:, None], fmin3, far), keyf, nk,
                       "amin").reshape(ns, 3, BINS, 3)
        bin_max = _seg(torch.where(actf[:, None], fmax3, -far), keyf, nk,
                       "amax").reshape(ns, 3, BINS, 3)

        # ---- SAH sweep -----------------------------------------------
        lmin = torch.cummin(bin_min, dim=2).values
        lmax = torch.cummax(bin_max, dim=2).values
        rmin = torch.cummin(bin_min.flip(2), dim=2).values.flip(2)
        rmax = torch.cummax(bin_max.flip(2), dim=2).values.flip(2)
        lcnt = torch.cumsum(bin_cnt, dim=2)
        rcnt = torch.cumsum(bin_cnt.flip(2), dim=2).flip(2)
        n_l = lcnt[:, :, :-1]
        n_r = rcnt[:, :, 1:]
        cost = torch.where(
            (n_l == 0) | (n_r == 0), BVH_FAR,
            _cost(_ha(lmin[:, :, :-1], lmax[:, :, :-1]), n_l,
                  _ha(rmin[:, :, 1:], rmax[:, :, 1:]), n_r))
        flat = cost.reshape(ns, -1)
        best_cost = flat.amin(dim=1)
        best = flat.argmin(dim=1)                  # the first minimum
        b_axis = best // (BINS - 1)
        b_bin = best % (BINS - 1)

        # per-slot node areas (slot s <-> node ls + s)
        nid = torch.clamp(ls + torch.arange(ns, device=dev), 0, M - 1)
        r_sav = 1.0 / torch.clamp(_ha(node_min[nid], node_max[nid]),
                                  min=1e-30)
        split_cost = _split_cost(r_sav, best_cost)
        no_split = C_INT * seg_cnt.to(torch.float32)
        open_slot = seg_cnt > 0
        sah_leaf = ((seg_cnt <= 1) | (best_cost >= BVH_FAR)
                    | (split_cost >= no_split))
        must_split = seg_cnt > max_leaf
        do_split = (open_slot & ~((sah_leaf & ~must_split) | (seg_cnt <= 1))
                    & (best_cost < BVH_FAR))
        if level >= MAX_LEVELS - 1:
            do_split = torch.zeros_like(do_split)
        # the dummy slot counts no active fragment: never open
        make_leaf = open_slot & ~do_split

        # ---- children: one contiguous range at le, in slot order -----
        split_i = do_split.to(torch.int64)
        split_rank = torch.cumsum(split_i, dim=0) - split_i
        lchild = le + 2 * split_rank

        # ---- this level's nodes: the block at ls ---------------------
        left_first[ls:le] = torch.where(do_split, lchild, 0)[:S].to(
            torch.int32)
        count[ls:le] = torch.where(make_leaf, seg_cnt, 0)[:S]

        # dense child blocks by split rank: the rank -> slot map by a
        # scatter-max of the slot id, then one gather
        src = torch.zeros(ns, dtype=torch.int64, device=dev)
        src.scatter_reduce_(0, torch.where(do_split, split_rank, ns - 1),
                            torch.where(do_split, torch.arange(
                                ns, device=dev), 0), "amax")
        rows = torch.arange(ns, device=dev)
        gl_min = lmin[rows, b_axis, b_bin][src]
        gl_max = lmax[rows, b_axis, b_bin][src]
        gr_min = rmin[rows, b_axis, b_bin + 1][src]
        gr_max = rmax[rows, b_axis, b_bin + 1][src]

        # ---- reassign fragments --------------------------------------
        go_left = binid.gather(1, b_axis[slot][:, None])[:, 0] \
            <= b_bin[slot]
        frag_split = act & do_split[slot]
        new_node = torch.where(go_left, lchild[slot], lchild[slot] + 1)
        frag_node = torch.where(frag_split, new_node, frag_node)
        frag_active = frag_split

        # the level's one host sync: its split count and whether any
        # fragment is still open
        n_split, any_active = torch.stack(
            [split_i.sum(), frag_active.any().long()]).tolist()
        node_min[le:le + 2 * n_split] = torch.stack(
            [gl_min, gr_min], dim=1).reshape(-1, 3)[:2 * n_split]
        node_max[le:le + 2 * n_split] = torch.stack(
            [gl_max, gr_max], dim=1).reshape(-1, 3)[:2 * n_split]
        ls, le, level = le, le + 2 * n_split, level + 1

    # ---- finalize: group fragments by leaf, set the leaf offsets -------
    order = torch.argsort(frag_node, stable=True)
    sorted_node = frag_node[order]
    pos = torch.arange(N, dtype=torch.int32, device=dev)
    # leaves start at N, so the scatter-min leaves their first fragment
    left_first = torch.where(count > 0, N, left_first).scatter_reduce_(
        0, sorted_node, pos, "amin")
    return BVH2(node_min=node_min, node_max=node_max,
                left_first=left_first, count=count,
                prim_idx=order.to(torch.int32), n_nodes=le)
