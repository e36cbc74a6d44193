"""Hash RNG and sampling utilities (≙ tinybvh_tpu/core/rng.py).

The reference-parity integer hashes (WangHash / xor32, tools.cl:6-13) and
the cosine-weighted hemisphere sampler of the path tracers. torch has no
full uint32 arithmetic, so the hashes compute in int64 masked to 32 bits:
each product of a masked value and a 32-bit constant stays below 2^62,
and every result is bit-equal to the uint32 arithmetic. The path tracers
draw their random numbers through render.pathtracer.Sampler."""

from __future__ import annotations

import math

import torch

from tinybvh_tpu_torch.core.vecmath import cross, norm

_M32 = 0xFFFFFFFF


def _u32(x) -> torch.Tensor:
    """x as int64 holding uint32 values (masked to the low 32 bits)."""
    return torch.as_tensor(x).to(torch.int64) & _M32


def wang_hash(x) -> torch.Tensor:
    """WangHash (≙ tools.cl:6-9); x: uint32 values, returned as int64."""
    x = _u32(x)
    x = (x ^ 61) ^ (x >> 16)
    x = (x * 9) & _M32
    x = x ^ (x >> 4)
    x = (x * 0x27D4EB2D) & _M32
    return x ^ (x >> 15)


def xor32(state):
    """xorshift32 step (≙ tools.cl:10-13). Returns (new_state, u32), both
    int64 holding uint32 values."""
    s = _u32(state)
    s = s ^ ((s << 13) & _M32)
    s = s ^ (s >> 17)
    s = s ^ ((s << 5) & _M32)
    return s, s


def u32_to_unit_float(x) -> torch.Tensor:
    """uint32 -> [0, 1) float32 from the top 24 bits."""
    return (_u32(x) >> 8).to(torch.float32) * (1.0 / 16777216.0)


def cosine_hemisphere(n, r1, r2):
    """Cosine-weighted hemisphere sample around normals n (..., 3)
    (≙ tools.cl CosWeightedRandomHemisphereDirection)."""
    phi = 2.0 * math.pi * r1
    sr = torch.sqrt(r2)
    # tangent frame
    a = torch.where(n[..., 0:1].abs() > 0.9,
                    n.new_tensor([0.0, 1.0, 0.0]),
                    n.new_tensor([1.0, 0.0, 0.0]))
    t = cross(n, torch.broadcast_to(a, n.shape))
    t = t / torch.clamp(norm(t, keepdim=True), min=1e-20)
    b = cross(n, t)
    x = torch.cos(phi) * sr
    y = torch.sin(phi) * sr
    z = torch.sqrt(torch.clamp(1.0 - r2, min=0.0))
    return x[..., None] * t + y[..., None] * b + z[..., None] * n
