"""Math substrate (≙ tinybvh_tpu/core/vecmath.py, tiny_bvh.h:322-599).

Batched tensors with the last axis = xyz. Cross products and dots are
written as explicit multiply-sums: no `@`/einsum on ray math, so a TF32
matmul setting can never reach it."""

from __future__ import annotations

import torch

# Miss distance, mirrors BVH_FAR (tiny_bvh.h:653).
BVH_FAR = 1e30


def safe_rcp(x: torch.Tensor) -> torch.Tensor:
    """1/x where |x| > 1e-20, else a signed huge value
    (≙ tinybvh_safercp, tiny_bvh.h:442-444)."""
    big = torch.where(x < 0, -BVH_FAR, BVH_FAR).to(x.dtype)
    inv = 1.0 / torch.where(x == 0, torch.ones_like(x), x)
    return torch.where(x.abs() > 1e-20, inv, big)


def cross(a: torch.Tensor, b: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Cross product along `dim` as explicit multiply-subtracts."""
    ax, ay, az = a.unbind(dim)
    bx, by, bz = b.unbind(dim)
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=dim)


def norm(v: torch.Tensor, dim: int = -1, keepdim: bool = False):
    return torch.sqrt((v * v).sum(dim, keepdim=keepdim))
