"""Full-sweep SAH builder, the exact-SAH baseline, on the host in numpy
(≙ tinybvh_tpu/builders/sweep.py; BVH::BuildFullSweep,
tiny_bvh.h:2468-2613).

A copy of the JAX package's numpy builder: the SAH at every split
position on all 3 axes (not 8 bins) from per-axis sorted orders and
prefix / suffix area sweeps, each node re-sorting its slice (the
reference keeps index lists sorted by a stable partition,
tiny_bvh.h:2557-2568). The highest-quality object-split tree: the
quality reference of the tests. The BVH2 goes to `device` (default:
the card)."""

from __future__ import annotations

import numpy as np

from tinybvh_tpu_torch.builders.binned import _half_area as _ha
from tinybvh_tpu_torch.core.rays import default_device
from tinybvh_tpu_torch.core.vecmath import BVH_FAR, C_INT, C_TRAV
from tinybvh_tpu_torch.layouts.bvh2 import BVH2


def build_sweep(tris, max_leaf: int | None = 4,
                c_trav: float = C_TRAV, c_int: float = C_INT,
                device=None) -> BVH2:
    if hasattr(tris, "detach"):
        tris = tris.detach().cpu().numpy()
    tris = np.asarray(tris, np.float32)
    N = tris.shape[0]
    fmin = tris.min(axis=1)
    fmax = tris.max(axis=1)
    cent = (fmin + fmax) * 0.5
    M = 2 * N + 2
    node_min = np.full((M, 3), BVH_FAR, np.float32)
    node_max = np.full((M, 3), -BVH_FAR, np.float32)
    left_first = np.zeros(M, np.int64)
    count = np.zeros(M, np.int64)
    node_min[0] = fmin.min(axis=0)
    node_max[0] = fmax.max(axis=0)
    prim = np.arange(N)
    n_used = 2
    order_out = []

    stack = [(0, 0, N)]
    ids_buf = prim  # in-place permuted

    while stack:
        node, start, cnt = stack.pop()
        ids = ids_buf[start:start + cnt]
        best = (np.inf, -1, -1, None)  # cost, axis, k, order
        if cnt > 1:
            for ax in range(3):
                o = np.argsort(cent[ids, ax], kind="stable")
                sids = ids[o]
                lmin = np.minimum.accumulate(fmin[sids], axis=0)
                lmax = np.maximum.accumulate(fmax[sids], axis=0)
                rmin = np.minimum.accumulate(fmin[sids][::-1], axis=0)[::-1]
                rmax = np.maximum.accumulate(fmax[sids][::-1], axis=0)[::-1]
                nl = np.arange(1, cnt)
                costs = (_ha(lmin[:-1], lmax[:-1]) * nl
                         + _ha(rmin[1:], rmax[1:]) * (cnt - nl))
                k = int(np.argmin(costs))
                if costs[k] < best[0]:
                    best = (float(costs[k]), ax, k, o)
        make_leaf = True
        if best[1] >= 0:
            area = _ha(node_min[node], node_max[node])
            split_cost = c_trav + c_int * best[0] / max(area, 1e-30)
            make_leaf = split_cost >= c_int * cnt
            if make_leaf and max_leaf is not None and cnt > max_leaf:
                make_leaf = False
        if make_leaf or cnt <= 1:
            left_first[node] = len(order_out)
            count[node] = cnt
            order_out.extend(ids.tolist())
            continue
        _, ax, k, o = best
        ids_buf[start:start + cnt] = ids[o]  # sorted in place
        mid = start + k + 1
        l = n_used
        n_used += 2
        left_first[node] = l
        count[node] = 0
        for child, (s, e) in ((l, (start, mid)), (l + 1, (mid, start + cnt))):
            sel = ids_buf[s:e]
            node_min[child] = fmin[sel].min(axis=0)
            node_max[child] = fmax[sel].max(axis=0)
            stack.append((child, s, e - s))

    return BVH2.from_host(dict(
        node_min=node_min, node_max=node_max,
        left_first=left_first.astype(np.int32), count=count.astype(np.int32),
        prim_idx=np.asarray(order_out, np.int64).astype(np.int32),
        n_nodes=n_used), default_device(device))
