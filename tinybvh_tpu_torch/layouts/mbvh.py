"""8-wide BVH container and the host collapse from a BVH2
(≙ tinybvh_tpu/layouts/mbvh.py; MBVH<8>, tiny_bvh.h:4975-5048).

child[i] >= 0 -> child node row; child[i] < 0 -> leaf row -(child[i]+1);
EMPTY_SLOT marks an unused slot."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tinybvh_tpu_torch.core.rays import default_device
from tinybvh_tpu_torch.core.vecmath import BVH_FAR

EMPTY_SLOT = -(2**31) + 1


@dataclass
class BVH8:
    bounds: torch.Tensor     # (M, 48) f32
    child: torch.Tensor      # (M, 8) i32
    leaf_tris: torch.Tensor  # (L, 4, 3, 3) f32
    leaf_prim: torch.Tensor  # (L, 4) i32 global prim ids (-1 padding)

    @property
    def n_nodes(self):
        return self.bounds.shape[0]

    @property
    def n_leaves(self):
        return self.leaf_tris.shape[0]

    @classmethod
    def from_host(cls, h8: dict, device) -> "BVH8":
        """From the dict of numpy arrays that the native collapse returns."""
        return cls(**{k: torch.as_tensor(h8[k]).to(device)
                      for k in ("bounds", "child", "leaf_tris", "leaf_prim")})


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def collapse_rows(mn, mx, lf, ct, leaf_word):
    """The 8-wide node rows of a host BVH2 (≙ MBVH<8>::ConvertFrom,
    tiny_bvh.h:4975-5048): each node adopts the children of its
    largest-area interior child until it has 8 children or only leaves.
    leaf_word(b2node) gives the child word of a BVH2 leaf, called in
    emission order. Returns (bounds (M, 48) f32, child (M, 8) i32)."""

    def area(i):
        e = np.maximum(mx[i] - mn[i], 0)
        return e[0] * e[1] + e[1] * e[2] + e[2] * e[0]

    def empty_row():
        row_b = np.full((6, 8), BVH_FAR, np.float32)
        row_b[3:] = -BVH_FAR
        return row_b, np.full(8, EMPTY_SLOT, np.int64)

    # breadth-first emission; work items are (bvh2_node, my_row)
    if ct[0] > 0:  # root is a leaf: one node with one leaf child
        row_b, row_c = empty_row()
        row_b[:3, 0] = mn[0]
        row_b[3:, 0] = mx[0]
        row_c[0] = leaf_word(0)
        node_bounds, node_child = [row_b], [row_c]
    else:
        node_bounds, node_child = [None], [None]
        work = [(0, 0)]
        while work:
            b2node, row = work.pop()
            kids = [lf[b2node], lf[b2node] + 1]
            # grow: replace the largest-area interior child by its children
            while len(kids) < 8:
                best, best_a = -1, -1.0
                for k, c in enumerate(kids):
                    if ct[c] == 0:
                        a = area(c)
                        if a > best_a:
                            best, best_a = k, a
                if best < 0:
                    break
                c = kids.pop(best)
                kids.extend((lf[c], lf[c] + 1))
            row_b, row_c = empty_row()
            for k, c in enumerate(kids):
                row_b[:3, k] = mn[c]
                row_b[3:, k] = mx[c]
                if ct[c] > 0:
                    row_c[k] = leaf_word(c)
                else:
                    node_bounds.append(None)
                    node_child.append(None)
                    new_row = len(node_bounds) - 1
                    row_c[k] = new_row
                    work.append((c, new_row))
            node_bounds[row] = row_b
            node_child[row] = row_c
    return (np.stack([b.reshape(-1) for b in node_bounds]).astype(np.float32),
            np.stack(node_child).astype(np.int32))


def collapse_bvh2(bvh, tris, host: dict | None = None, tris_dev=None,
                  as_host: bool = False):
    """Collapse a BVH2 whose leaves hold at most 4 prims into the 8-wide
    layout, on the host, without leaf combining (collapse_rows).

    host: the builder's host dict (read instead of the BVH2's tensors).
    tris: (N, 3, 3) host triangles for leaf_tris; or tris_dev, a tensor
    of them, from which leaf_tris is gathered on its device (the refit
    re-collapse, whose triangles live on the device). as_host returns the
    dict of numpy arrays (bounds, child, leaf_tris, leaf_prim) instead of
    a BVH8. The BVH8 goes to tris_dev's device, else the BVH2's, else the
    card."""
    if as_host:
        if tris is None:
            raise ValueError("as_host needs host triangles")
        tris_dev = None
    src = host if host is not None else {
        k: _host(getattr(bvh, k)) for k in ("node_min", "node_max",
                                            "left_first", "count",
                                            "prim_idx")}
    lf, ct, pidx = src["left_first"], src["count"], src["prim_idx"]
    tris_np = None if tris_dev is not None else np.asarray(_host(tris),
                                                           np.float32)
    if int(ct.max()) > 4:
        raise ValueError(f"BVH2 leaves up to {int(ct.max())} prims; rebuild "
                         "with max_leaf=4")

    leaf_tris = []
    leaf_prim = []

    def add_leaf(b2node) -> int:
        first, cnt = lf[b2node], ct[b2node]
        ids = pidx[first:first + cnt]
        p = np.full(4, -1, np.int64)
        p[:cnt] = ids
        leaf_prim.append(p)
        if tris_np is not None:
            t = np.zeros((4, 3, 3), np.float32)
            t[:cnt] = tris_np[ids]
            leaf_tris.append(t)
        return -len(leaf_prim)

    bounds, child = collapse_rows(src["node_min"], src["node_max"], lf, ct,
                                  add_leaf)
    lp_np = np.stack(leaf_prim).astype(np.int32)
    if as_host:
        return dict(bounds=bounds, child=child,
                    leaf_tris=np.stack(leaf_tris).astype(np.float32),
                    leaf_prim=lp_np)
    device = (tris_dev.device if tris_dev is not None
              else bvh.prim_idx.device if bvh is not None
              else default_device(None))
    lp = torch.from_numpy(lp_np).to(device)
    if tris_np is not None:
        lt = torch.from_numpy(np.stack(leaf_tris)).to(device)
    else:
        n = tris_dev.shape[0]
        lt = torch.where((lp >= 0)[..., None, None],
                         tris_dev[torch.clamp(lp, 0, n - 1).long()], 0.0)
    return BVH8(bounds=torch.from_numpy(bounds).to(device),
                child=torch.from_numpy(child).to(device),
                leaf_tris=lt, leaf_prim=lp)
