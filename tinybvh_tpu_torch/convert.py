"""Carry the JAX package's packet state into the port, so that both trace
the exact same tables.

`from_numpy_tables(bvh8_np, aux_np, device)` takes objects with the
fields of the JAX `BVH8` and `PacketAux` (any array type numpy can read,
e.g. jax arrays read back to the host) and returns the port's BVH8 and
PacketAux on `device`. It imports nothing of JAX."""

from __future__ import annotations

import numpy as np
import torch

from tinybvh_tpu_torch.layouts.mbvh import BVH8
from tinybvh_tpu_torch.traverse.packet2 import PacketAux


def _t(a, device):
    return torch.from_numpy(np.array(a)).to(device)


def from_numpy_tables(bvh8_np, aux_np, device="cpu"):
    bvh8 = BVH8(**{k: _t(getattr(bvh8_np, k), device)
                   for k in ("bounds", "child", "leaf_tris", "leaf_prim")})
    aux = PacketAux(
        **{k: _t(getattr(aux_np, k), device)
           for k in ("leaf_lo", "leaf_hi", "blk_lo", "blk_hi", "gtab_pad",
                     "center")},
        n_leaf_rows=int(aux_np.n_leaf_rows), pack=int(aux_np.pack),
        omap_s=int(aux_np.omap_s))
    return bvh8, aux
