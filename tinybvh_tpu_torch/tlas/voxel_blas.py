"""Voxel BLAS instances in a TLAS (≙ tinybvh_tpu/tlas/voxel_blas.py; the
VoxelSet leaf dispatch inside IntersectTLAS / IsOccludedTLAS,
tiny_bvh.h:3357 and :3500).

As in the JAX package, voxel instances run as a post-pass:
  1. trace the triangle TLAS with the two-level wavefront;
  2. for each voxel instance, move the whole ray batch into its frame
     (directions not renormalized, so hit t is the same in both frames,
     tiny_bvh.h:3329-3333) and run the DDA (ops/voxel.py) with the
     current best t as its cutoff;
  3. min-fold the results into the hit records.

Voxel hits share the Hits record:
  inst = number of triangle instances + voxel instance index
  prim = packed voxel coordinate x * 65536 + y * 256 + z
  u    = hit-normal axis (0/1/2), v = its sign (+-1), the DDA exit axis
         (≙ the reference's normal from the step, tiny_bvh.h:3860-3869)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tinybvh_tpu_torch.core.rays import Hits, Rays, make_rays
from tinybvh_tpu_torch.core.vecmath import BVH_FAR, mat3_apply, mat4_inverse
from tinybvh_tpu_torch.ops.voxel import intersect_voxels
from tinybvh_tpu_torch.tlas.instance import TLAS8, intersect_tlas_wavefront

RAY_MASK_ALL = 0xFFFF


@dataclass
class VoxelInstance:
    """One placed VoxelSet (≙ a BLASInstance whose blas is a VoxelSet)."""

    vox: dict            # frozen VoxelSet tensors (ops.voxel VoxelSet.freeze)
    inv: torch.Tensor    # (4, 4) world -> voxel-local transform
    mask: int            # visibility mask


def voxel_instance(vox: dict, transform=None,
                   mask: int = RAY_MASK_ALL) -> VoxelInstance:
    """Place a frozen VoxelSet in the world with a 4x4 transform; the
    inverse lives on the voxel tensors' device."""
    m = (np.eye(4, dtype=np.float32) if transform is None
         else np.asarray(transform, np.float32))
    inv = mat4_inverse(torch.from_numpy(m)[None])[0]
    return VoxelInstance(vox=vox, inv=inv.to(vox["grid"].device),
                         mask=int(mask))


def _to_local(inv, o, d):
    """Batched rays into the instance frame (no renormalization), with
    explicit f32 multiply-sums (vecmath.mat3_apply)."""
    rot = inv[None, :3, :3]
    return mat3_apply(rot, o) + inv[:3, 3], mat3_apply(rot, d)


def _fold_voxels(voxel_insts, rays: Rays, base: int, t, u, v, prim, inst):
    for j, vi in enumerate(voxel_insts):
        o2, d2 = _to_local(vi.inv, rays.o, rays.d)
        tv, nv, cv = intersect_voxels(vi.vox, make_rays(o2, d2), t_max=t)
        visible = (rays.mask & vi.mask) != 0
        ok = (tv < t) & visible
        axis = nv.abs().argmax(dim=-1)
        sign = nv.sum(dim=-1)
        code = (cv[:, 0] * 65536 + cv[:, 1] * 256 + cv[:, 2]).to(torch.int32)
        t = torch.where(ok, tv, t)
        u = torch.where(ok, axis.to(torch.float32), u)
        v = torch.where(ok, sign, v)
        prim = torch.where(ok, code, prim)
        inst = torch.where(ok, base + j, inst)
    return t, u, v, prim, inst


def intersect_tlas_voxels(tlas: TLAS8, voxel_insts, rays: Rays,
                          t_max=BVH_FAR, cap_factor: int = 3):
    """Closest hit over a triangle TLAS and voxel instances. Returns
    (Hits, overflow of the triangle traversal). ≙ IntersectTLAS's
    VoxelSet leaf case, tiny_bvh.h:3357."""
    hits, ovf = intersect_tlas_wavefront(tlas, rays, t_max,
                                         cap_factor=cap_factor)
    base = tlas.inst_inv.shape[0]
    t, u, v, prim, inst = _fold_voxels(
        voxel_insts, rays, base, hits.t, hits.u, hits.v, hits.prim,
        hits.inst)
    return Hits(t=t, u=u, v=v, prim=prim, inst=inst), ovf


def is_occluded_tlas_voxels(tlas: TLAS8, voxel_insts, rays: Rays, t_max,
                            cap_factor: int = 3):
    """Any hit over a triangle TLAS and voxel instances (≙ IsOccludedTLAS's
    VoxelSet case, tiny_bvh.h:3500). Returns (occluded, overflow)."""
    _, occ, ovf = intersect_tlas_wavefront(tlas, rays, t_max,
                                           cap_factor=cap_factor,
                                           any_hit=True)
    tm = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32,
                                            device=occ.device), occ.shape)
    for vi in voxel_insts:
        o2, d2 = _to_local(vi.inv, rays.o, rays.d)
        tv, _, _ = intersect_voxels(vi.vox, make_rays(o2, d2), t_max=tm)
        visible = (rays.mask & vi.mask) != 0
        occ = occ | ((tv < tm) & visible)
    return occ, ovf
