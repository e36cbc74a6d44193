"""Diffuse bounce rays: from the visible surface points, lifted off the
surface along the normal on the side the camera saw, cosine-weighted
about that normal (the upstream speedtest's diffuse batch, made from
its reference's primary hits, tiny_bvh_speedtest.cpp:557-587).

Parameters: rays_per_call, pool, offset (the lift, as a share of the
scene's extent), primary (the camera mix whose hits, found by the plain
reference, are the points: harness/hits.py). The batches take the hits
in the camera batches' order."""

from __future__ import annotations

import math

import numpy as np
import torch

from harness.hits import primary_hits


def count(p):
    return int(p["rays_per_call"])


def cosine_about(n, gen):
    """Unit directions cosine-weighted about the unit normals n (R, 3)."""
    R, dev = n.shape[0], n.device
    u = torch.rand((R, 2), generator=gen, device=dev)
    phi = 2.0 * math.pi * u[:, :1]
    r = torch.sqrt(u[:, 1:])
    a = torch.where(n[:, :1].abs() < 0.9,
                    torch.tensor([1.0, 0.0, 0.0], device=dev),
                    torch.tensor([0.0, 1.0, 0.0], device=dev))
    b1 = torch.linalg.cross(n, a)
    b1 = b1 / torch.linalg.vector_norm(b1, dim=1, keepdim=True)
    b2 = torch.linalg.cross(n, b1)
    d = (b1 * (r * torch.cos(phi)) + b2 * (r * torch.sin(phi))
         + n * torch.sqrt(torch.clamp(1.0 - u[:, 1:], min=0.0)))
    return d / torch.linalg.vector_norm(d, dim=1, keepdim=True)


def make_pool(tris, lo, hi, p, gen, base):
    R, P = count(p), int(p["pool"])
    extent = float(np.max(hi - lo))
    h = primary_hits(tris, lo, hi, base, p["primary"], gen, R * P)
    o = h.point + h.normal * (float(p["offset"]) * extent)
    d = cosine_about(h.normal, gen)
    return o.view(P, R, 3), d.view(P, R, 3), h.reference_s
