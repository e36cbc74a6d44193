"""Ray and hit records as dataclasses of tensors
(≙ tinybvh_tpu/core/rays.py; Ray / Intersection, tiny_bvh.h:656-709)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tinybvh_tpu_torch.core.vecmath import BVH_FAR, safe_rcp

# ≙ RAY_MASK_INTERSECT_ALL (tiny_bvh.h:654)
RAY_MASK_ALL = 0xFFFF


@dataclass
class Rays:
    """o, d, rd: (R, 3) origins, directions, safe reciprocal directions;
    mask: (R,) int32 visibility mask."""

    o: torch.Tensor
    d: torch.Tensor
    rd: torch.Tensor
    mask: torch.Tensor

    def take(self, idx: torch.Tensor) -> "Rays":
        return Rays(o=self.o[idx], d=self.d[idx], rd=self.rd[idx],
                    mask=self.mask[idx])


@dataclass
class Hits:
    """t: BVH_FAR on miss; u, v barycentrics; prim -1 on miss; inst -1
    when tracing a BLAS directly."""

    t: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    prim: torch.Tensor
    inst: torch.Tensor

    def take(self, idx: torch.Tensor) -> "Hits":
        return Hits(t=self.t[idx], u=self.u[idx], v=self.v[idx],
                    prim=self.prim[idx], inst=self.inst[idx])


def default_device(device=None) -> torch.device:
    """`device`, or the card when it is None. The port runs on the CPU
    only when asked: with no CUDA device and no `device`, this raises
    instead of carrying on there."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError('no CUDA device found; pass device="cpu" to run '
                           "the kernels' plain versions on the CPU")
    return torch.device("cuda")


def make_rays(o, d, mask=None, device=None) -> Rays:
    """Build a ray batch on `device`, precomputing reciprocal directions.
    Without `device`, tensor inputs keep o's device and other inputs go
    to the card (default_device). With config.validate_rays, non-finite
    or zero-length rays raise here."""
    from tinybvh_tpu_torch.config import get_config

    if device is None:
        device = (o.device if isinstance(o, torch.Tensor)
                  else default_device())
    o, d = (x.to(device=device, dtype=torch.float32)
            if isinstance(x, torch.Tensor)
            else torch.tensor(np.asarray(x, np.float32), device=device)
            for x in (o, d))
    if get_config().validate_rays:
        if not (bool(torch.isfinite(o).all()) and bool(torch.isfinite(d).all())):
            raise ValueError("make_rays: non-finite ray origin/direction")
        if bool((torch.linalg.vector_norm(d, dim=-1) < 1e-30).any()):
            raise ValueError("make_rays: zero-length ray direction")
    if mask is None:
        mask = torch.full(o.shape[:-1], RAY_MASK_ALL, dtype=torch.int32,
                          device=device)
    else:
        mask = torch.as_tensor(mask, dtype=torch.int32, device=device)
    return Rays(o=o.contiguous(), d=d.contiguous(), rd=safe_rcp(d), mask=mask)


def no_hits(batch_shape, device=None) -> Hits:
    """Misses for every ray of `batch_shape`, on `device` (default_device:
    the card unless asked)."""
    device = default_device(device)
    return Hits(
        t=torch.full(batch_shape, BVH_FAR, dtype=torch.float32, device=device),
        u=torch.zeros(batch_shape, dtype=torch.float32, device=device),
        v=torch.zeros(batch_shape, dtype=torch.float32, device=device),
        prim=torch.full(batch_shape, -1, dtype=torch.int32, device=device),
        inst=torch.full(batch_shape, -1, dtype=torch.int32, device=device),
    )
