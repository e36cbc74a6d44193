"""Math substrate (≙ tinybvh_tpu/core/vecmath.py, tiny_bvh.h:322-599).

Batched tensors with the last axis = xyz. Cross products and dots are
written as explicit multiply-sums: no `@`/einsum on ray math, so a TF32
matmul setting can never reach it."""

from __future__ import annotations

import torch

# Miss distance, mirrors BVH_FAR (tiny_bvh.h:653).
BVH_FAR = 1e30
# Default SAH constants, mirrors C_TRAV / C_INT (tiny_bvh.h:141-146).
C_TRAV = 1.0
C_INT = 1.0


def half_area(bmin: torch.Tensor, bmax: torch.Tensor) -> torch.Tensor:
    """Half the surface area of AABBs, (..., 3) -> (...); empty boxes give
    0 (≙ tinybvh_half_area, tiny_bvh.h:460)."""
    e = torch.clamp(bmax - bmin, min=0.0)
    return e[..., 0] * e[..., 1] + e[..., 1] * e[..., 2] + e[..., 2] * e[..., 0]


def aabb_union(amin, amax, bmin, bmax):
    """The union of boxes [amin, amax] and [bmin, bmax], (..., 3) each."""
    return torch.minimum(amin, bmin), torch.maximum(amax, bmax)


def aabb_empty(shape=(), dtype=torch.float32, device=None):
    """(min = +FAR, max = -FAR) boxes of `shape`: the union's identity.
    device: where they go (core/rays.py default_device: the card unless
    asked)."""
    from tinybvh_tpu_torch.core.rays import default_device

    device = default_device(device)
    shape = tuple(shape) + (3,)
    return (torch.full(shape, BVH_FAR, dtype=dtype, device=device),
            torch.full(shape, -BVH_FAR, dtype=dtype, device=device))


def mat3_apply(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) applied to (..., 3): products summed left to right over
    the last axis, in f32. Never `@`, einsum or matmul on ray transforms:
    those may run as TF32 on the card (≙ JAX mat3_apply, where the TPU's
    dot_general multiplied in bf16)."""
    p = a * v[..., None, :]
    return p[..., 0] + p[..., 1] + p[..., 2]


def transform_point(m: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Row-major 4x4 transform(s) (..., 4, 4) applied to points (..., 3)
    (≙ tinybvh_transform_point, tiny_bvh.h:565-573)."""
    return mat3_apply(m[..., :3, :3], p) + m[..., :3, 3]


def transform_vector(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The rotation / scale part only (tiny_bvh.h:575-581)."""
    return mat3_apply(m[..., :3, :3], v)


def transform_aabb(m: torch.Tensor, bmin: torch.Tensor, bmax: torch.Tensor):
    """World box enclosing transformed AABB(s): center' +- |A| extent
    (≙ BLASInstance::Update's 8-corner transform, tiny_bvh.h:8386-8400)."""
    c = (bmin + bmax) * 0.5
    e = (bmax - bmin) * 0.5
    a = m[..., :3, :3]
    c2 = mat3_apply(a, c) + m[..., :3, 3]
    e2 = mat3_apply(a.abs(), e)
    return c2 - e2, c2 + e2


def mat4_inverse(m: torch.Tensor) -> torch.Tensor:
    """General batched 4x4 inverse (≙ BLASInstance::InvertTransform,
    tiny_bvh.h:8402-8430)."""
    return torch.linalg.inv(m)


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


def normalize(v: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """v / max(|v|, 1e-20) along `dim` (≙ JAX vecmath.normalize)."""
    return v / torch.clamp(norm(v, dim=dim, keepdim=True), min=1e-20)


def morton_encode_3d(q: torch.Tensor) -> torch.Tensor:
    """Interleave 10-bit integer coordinates (..., 3) into 30-bit Morton
    codes, uint32 as in JAX (the LBVH builder's keys). Torch has no shift
    for uint32, so the bit spread runs in int64 and is masked at each
    step: the same bits as JAX's uint32 arithmetic."""

    def spread(x):
        x = x.to(torch.int64) & 0x3FF
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    code = (spread(q[..., 0]) << 2) | (spread(q[..., 1]) << 1) \
        | spread(q[..., 2])
    return code.to(torch.uint32)
