"""Carry the JAX package's packet state into the port, so that both trace
the exact same tables.

`from_numpy_tables(bvh8_np, aux_np, device)` takes objects with the
fields of the JAX `BVH8` and `PacketAux` (any array type numpy can read,
e.g. jax arrays read back to the host) and returns the port's BVH8 and
PacketAux on `device`; `from_numpy_bvh8` carries the BVH8 alone,
`from_numpy_bvh8q` a quantized BVH8Q, `from_numpy_bvh2` a BVH2,
`from_numpy_tlas8` a TLAS8,
`from_numpy_tlas_packet` a TLASPacket with its BLASes and packet tables,
`from_numpy_omap` an opacity micromap table, `from_numpy_voxels` a
frozen VoxelSet (a dict of arrays), and `from_numpy_rayloop_tables` /
`from_numpy_tlas_rayloop_tables` the rayloop engines' tables. A
PacketAux brings its micromaps (`omap`) along. Like the rest of the
port, every function puts its tensors on the card unless `device` says
otherwise, and raises without one (core/rays.py default_device): pass
`device="cpu"` to carry the tables to the CPU. It imports nothing of
JAX."""

from __future__ import annotations

import numpy as np
import torch

from tinybvh_tpu_torch.core.rays import default_device
from tinybvh_tpu_torch.layouts.bvh2 import BVH2
from tinybvh_tpu_torch.layouts.cwbvh import BVH8Q
from tinybvh_tpu_torch.layouts.mbvh import BVH8
from tinybvh_tpu_torch.tlas.instance import TLAS8
from tinybvh_tpu_torch.tlas.packet import TLASPacket
from tinybvh_tpu_torch.tlas.rayloop import TLASRayLoopTables
from tinybvh_tpu_torch.traverse.packet2 import PacketAux
from tinybvh_tpu_torch.traverse.rayloop import RayLoopTables


def _t(a, device):
    return torch.from_numpy(np.array(a)).to(default_device(device))


def from_numpy_bvh8(bvh8_np, device=None) -> BVH8:
    return BVH8(**{k: _t(getattr(bvh8_np, k), device)
                   for k in ("bounds", "child", "leaf_tris", "leaf_prim")})


def from_numpy_bvh8q(q_np, device=None) -> BVH8Q:
    return BVH8Q(**{k: _t(getattr(q_np, k), device)
                    for k in ("origin", "scale", "qbounds", "child",
                              "leaf_tris", "leaf_prim")})


def from_numpy_bvh2(bvh2_np, device=None) -> BVH2:
    return BVH2(**{k: _t(getattr(bvh2_np, k), device)
                   for k in ("node_min", "node_max", "left_first", "count",
                             "prim_idx")},
                n_nodes=int(np.asarray(bvh2_np.n_nodes)))


def from_numpy_omap(omap_np, device=None):
    """A bool micromap table ((N, S, S) or (L, 4, S, S)), or None (which
    needs a device all the same)."""
    device = default_device(device)
    return None if omap_np is None else _t(omap_np, device).to(torch.bool)


def from_numpy_aux(aux_np, device=None) -> PacketAux:
    return PacketAux(
        **{k: _t(getattr(aux_np, k), device)
           for k in ("leaf_lo", "leaf_hi", "blk_lo", "blk_hi", "gtab_pad",
                     "center")},
        n_leaf_rows=int(aux_np.n_leaf_rows), pack=int(aux_np.pack),
        omap_s=int(aux_np.omap_s),
        omap=from_numpy_omap(getattr(aux_np, "omap", None), device))


def from_numpy_voxels(vox_np: dict, device=None) -> dict:
    """A frozen VoxelSet's arrays (grid, bricks, top where present,
    aabb_min, aabb_max) as the port's tensors."""
    return {k: _t(a, device) for k, a in vox_np.items()}


def from_numpy_tables(bvh8_np, aux_np, device=None):
    return from_numpy_bvh8(bvh8_np, device), from_numpy_aux(aux_np, device)


def from_numpy_tlas8(tlas_np, device=None) -> TLAS8:
    return TLAS8(**{k: _t(getattr(tlas_np, k), device)
                    for k in ("bounds", "child", "leaf_tris", "leaf_prim",
                              "inst_inv", "inst_mask", "inst_root")},
                 n_leaf_rows=int(tlas_np.n_leaf_rows))


def from_numpy_tlas_packet(tp_np, device=None) -> TLASPacket:
    return TLASPacket(
        tlas=from_numpy_tlas8(tp_np.tlas, device),
        blases=tuple(from_numpy_bvh8(b, device) for b in tp_np.blases),
        auxes=tuple(from_numpy_aux(a, device) for a in tp_np.auxes),
        **{k: _t(getattr(tp_np, k), device)
           for k in ("inst_inv", "inst_mask", "prim_tris", "prim_off",
                     "inst_wlo", "inst_whi")},
        blas_of=tuple(int(b) for b in tp_np.blas_of))


def from_numpy_rayloop_tables(tb_np, device=None) -> RayLoopTables:
    """A RayLoopTables, float (bounds) or quantized (qbounds, qmeta)."""
    return RayLoopTables(**{
        k: None if getattr(tb_np, k) is None else _t(getattr(tb_np, k),
                                                     device)
        for k in ("bounds", "qbounds", "qmeta", "child", "leaf_row",
                  "leaf_prim")})


def from_numpy_tlas_rayloop_tables(tb_np, device=None) -> TLASRayLoopTables:
    return TLASRayLoopTables(
        **{k: _t(getattr(tb_np, k), device)
           for k in ("bounds", "child", "leaf_row", "leaf_prim", "inv_flat",
                     "inst_mask")},
        inst_root=_t(tb_np.inst_root, device).long(),
        n_leaf_rows=int(tb_np.n_leaf_rows), n_inst=int(tb_np.n_inst))
