"""Quantized 8-wide BVH, the compressed-wide-BVH (CWBVH) counterpart
(≙ tinybvh_tpu/layouts/cwbvh.py; BVH8_CWBVH, Ylitie 2017,
tiny_bvh.h:5884-6018), as a dataclass of tensors.

Child boxes are uint8 offsets under a per-node power-of-two step,
conservative (floor / ceil): a traversal visits a superset of the nodes
the float BVH8 visits and returns the same hits. The fields are separate
SoA tensors (the reference's packed float4 words are not kept), and
child / leaf_tris / leaf_prim are the BVH8's own."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tinybvh_tpu_torch.core.vecmath import BVH_FAR
from tinybvh_tpu_torch.layouts.mbvh import BVH8


@dataclass
class BVH8Q:
    origin: torch.Tensor     # (M, 3) f32 node-box origin
    scale: torch.Tensor      # (M, 3) f32 power-of-two quantization step
    qbounds: torch.Tensor    # (M, 48) uint8 [qlox*8|qloy*8|qloz*8|qhix*8|...]
    child: torch.Tensor      # (M, 8) i32, encoded as BVH8's
    leaf_tris: torch.Tensor  # (L, 4, 3, 3) f32
    leaf_prim: torch.Tensor  # (L, 4) i32

    @property
    def n_nodes(self):
        return self.qbounds.shape[0]

    @property
    def n_leaves(self):
        return self.leaf_tris.shape[0]


def quantize_bvh8(bvh8: BVH8) -> BVH8Q:
    """Quantize on the host (the same numpy steps as JAX's) and upload to
    the BVH8's device."""
    b = bvh8.bounds.detach().cpu().numpy().reshape(-1, 6, 8)
    lo = b[:, :3]  # (M, 3, 8)
    hi = b[:, 3:]
    # per-node box over the valid children (empty slots are inverted)
    node_lo = np.where(lo < BVH_FAR / 2, lo, np.inf).min(axis=2)
    node_hi = np.where(hi > -BVH_FAR / 2, hi, -np.inf).max(axis=2)
    node_lo = np.where(np.isfinite(node_lo), node_lo, 0.0)
    node_hi = np.where(np.isfinite(node_hi), node_hi, 0.0)
    ext = np.maximum(node_hi - node_lo, 1e-20)
    # power-of-two step so that 255 steps cover the extent (≙ the
    # exponent quantization at tiny_bvh.h:5947-5967)
    e = np.ceil(np.log2(ext / 255.0))
    scale = np.exp2(e).astype(np.float32)
    qlo = np.floor((lo - node_lo[:, :, None]) / scale[:, :, None])
    qhi = np.ceil((hi - node_lo[:, :, None]) / scale[:, :, None])
    # empty slots clamp to some box: the child sentinel skips them
    qlo = np.clip(qlo, 0, 255).astype(np.uint8)
    qhi = np.clip(qhi, 0, 255).astype(np.uint8)
    qb = np.concatenate([qlo, qhi], axis=1).reshape(-1, 48)
    dev = bvh8.bounds.device
    return BVH8Q(origin=torch.from_numpy(node_lo.astype(np.float32)).to(dev),
                 scale=torch.from_numpy(scale).to(dev),
                 qbounds=torch.from_numpy(qb).to(dev), child=bvh8.child,
                 leaf_tris=bvh8.leaf_tris, leaf_prim=bvh8.leaf_prim)


def dequantize_bounds(q: BVH8Q, rows) -> torch.Tensor:
    """The (R, 48) float bounds rows of node rows `rows`, gathered and
    reconstructed (origin + q * step: the product is exact)."""
    qb = q.qbounds[rows].to(torch.float32).reshape(-1, 6, 8)
    o = q.origin[rows][:, :, None]    # (R, 3, 1)
    s = q.scale[rows][:, :, None]
    return torch.cat([o + qb[:, :3] * s, o + qb[:, 3:] * s],
                     dim=1).reshape(-1, 48)


def to_bvh8(q: BVH8Q) -> BVH8:
    """Full-precision reconstruction (conservative superset bounds)."""
    rows = torch.arange(q.n_nodes, device=q.qbounds.device)
    return BVH8(bounds=dequantize_bounds(q, rows), child=q.child,
                leaf_tris=q.leaf_tris, leaf_prim=q.leaf_prim)
