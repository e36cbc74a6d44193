"""Shadow rays: from one point light to the visible surface points,
unnormalised, so that t = 1 is the point (the port's smoke test places
the light so, and aims at the primary hits).

Parameters: rays_per_call, pool, light_offset (the light is the centre
+ light_offset * the scene's extent), primary (the camera mix whose
hits, found by the plain reference, are the points: harness/hits.py).
The batches take the hits in the camera batches' order."""

from __future__ import annotations

import numpy as np
import torch

from harness.hits import primary_hits


def count(p):
    return int(p["rays_per_call"])


def make_pool(scene, p, gen, base):
    R, P = count(p), int(p["pool"])
    center = (scene.lo + scene.hi) * 0.5
    extent = float(np.max(scene.hi - scene.lo))
    light = torch.tensor(
        center + np.asarray(p["light_offset"], np.float64) * extent,
        dtype=torch.float32, device=scene.device)
    h = primary_hits(scene, base, p["primary"], gen, R * P)
    pts = h.point.view(P, R, 3)
    return (light.expand_as(pts).contiguous(), pts - light,
            h.reference_s)
