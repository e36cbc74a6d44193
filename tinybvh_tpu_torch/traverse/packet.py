"""Packet helpers shared by the packet2 pipeline
(≙ tinybvh_tpu/traverse/packet.py: tile frustum planes and the
coherence sort). Explicit multiply-sums on all ray math: no `@`/einsum."""

from __future__ import annotations

import torch

from tinybvh_tpu_torch.core.vecmath import cross, norm

TILE = 256


def _tile_planes(o, d):
    """Per-tile frustum: 4 conservative planes bounding ALL tile
    directions, in gnomonic coordinates around the mean direction
    (≙ tiny_bvh.h:3545-3560, valid for any shared-origin bundle).

    o: (T, 3) shared origins (unused: planes pass through the origin);
    d: (T, 256, 3). Returns (T, 4, 3) inward normals n with
    dot(d_i, n) >= 0 for every ray of the tile; a bundle spanning >= 90
    degrees from its mean gets all-pass (zero) planes."""
    del o
    m = d.mean(dim=1)
    m = m / torch.clamp(norm(m, keepdim=True), min=1e-20)
    up = torch.tensor([0.0, 1.0, 0.0], device=d.device)
    side = torch.tensor([1.0, 0.0, 0.0], device=d.device)
    ref = torch.where((m[:, 1].abs() < 0.9)[:, None], up, side)
    u = cross(ref, m)
    u = u / torch.clamp(norm(u, keepdim=True), min=1e-20)
    v = cross(m, u)
    dm = (d * m[:, None, :]).sum(-1)
    da = (d * u[:, None, :]).sum(-1)
    db = (d * v[:, None, :]).sum(-1)
    wide = (dm <= 1e-9).any(dim=1)
    safe = torch.where(dm <= 1e-9, torch.ones_like(dm), dm)
    a = da / safe
    b = db / safe
    amin = a.amin(dim=1)[:, None]
    amax = a.amax(dim=1)[:, None]
    bmin = b.amin(dim=1)[:, None]
    bmax = b.amax(dim=1)[:, None]
    n = torch.stack([u - amin * m, amax * m - u,
                     v - bmin * m, bmax * m - v], dim=1)      # (T, 4, 3)
    return torch.where(wide[:, None, None], torch.zeros_like(n), n)


def _spread10(x):
    """Spread 10 bits to every 3rd position (morton helper)."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _morton3(q):
    """(R, 3) int32 10-bit cells -> (R,) 30-bit morton codes."""
    return (_spread10(q[:, 0]) | (_spread10(q[:, 1]) << 1)
            | (_spread10(q[:, 2]) << 2))


def inverse_permutation(order):
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(order.shape[0], dtype=order.dtype,
                                  device=order.device)
    return inverse


def sort_rays_coherent(o, d, scene_lo, scene_hi):
    """Coherence sort for incoherent rays: key = direction octant (3 bits)
    | origin morton (27 bits), stable. Returns (order, inverse); each
    consecutive 256 rays of `order` form one packet tile."""
    lo = torch.as_tensor(scene_lo, dtype=torch.float32, device=o.device)
    hi = torch.as_tensor(scene_hi, dtype=torch.float32, device=o.device)
    ext = torch.clamp(hi - lo, min=1e-20)
    q = torch.clamp(((o - lo) / ext * 1024.0).to(torch.int32), 0, 1023)
    octant = ((d[:, 0] < 0).to(torch.int32) * 4
              + (d[:, 1] < 0).to(torch.int32) * 2
              + (d[:, 2] < 0).to(torch.int32))
    key = (octant << 27) | (_morton3(q) >> 3)
    order = torch.argsort(key, stable=True)
    return order, inverse_permutation(order)
