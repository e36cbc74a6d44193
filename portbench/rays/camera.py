"""Camera rays: one eye a batch, `spp` jittered samples of every pixel of
a width x height image, each sample in tile x tile pixel order (the
JAX package's bench.py `_camera_rays` recipe, with jitter).

Parameters: width, height, spp, tile, views_deg (batch i looks from the
eye turned views_deg[i % len] degrees about the vertical axis through
the scene's centre), eye_offset and eye_scale (the first eye is the
centre + eye_offset * eye_scale * the scene's extent), fov (the image
plane's width at unit distance)."""

from __future__ import annotations

import math

import numpy as np
import torch


def _unit(v):
    return v / np.linalg.norm(v)


def count(p):
    return int(p["width"]) * int(p["height"]) * int(p["spp"])


def make(scene, p, gen, index):
    W, H, S, T = (int(p[k]) for k in ("width", "height", "spp", "tile"))
    if W % T or H % T:
        raise ValueError("width and height must be multiples of the tile")
    lo, hi = scene.lo, scene.hi
    center = (lo + hi) * 0.5
    extent = float(np.max(hi - lo))
    a = math.radians(p["views_deg"][index % len(p["views_deg"])])
    off = np.asarray(p["eye_offset"], np.float64) * p["eye_scale"] * extent
    off = np.array([off[0] * math.cos(a) + off[2] * math.sin(a), off[1],
                    -off[0] * math.sin(a) + off[2] * math.cos(a)])
    eye = center + off
    fwd = _unit(center - eye)
    right = _unit(np.cross(fwd, [0.0, 1.0, 0.0]))
    up = np.cross(right, fwd)
    dev = scene.device
    basis = torch.tensor(np.stack([fwd, right, up]), dtype=torch.float32,
                         device=dev)
    jit = torch.rand((S, H, W, 2), generator=gen, device=dev)
    x = ((torch.arange(W, device=dev) + jit[..., 0]) / W - 0.5) * p["fov"]
    y = (((torch.arange(H, device=dev)[:, None] + jit[..., 1]) / H - 0.5)
         * p["fov"] * H / W)
    d = basis[0] + x[..., None] * basis[1] + y[..., None] * basis[2]
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    d = d.reshape(S, H // T, T, W // T, T, 3).permute(0, 1, 3, 2, 4, 5)
    d = d.reshape(-1, 3).contiguous()
    o = torch.tensor(eye, dtype=torch.float32, device=dev).expand_as(d)
    return o.contiguous(), d
