"""Pinhole camera -> primary ray generation
(≙ tinybvh_tpu/render/camera.py)."""

from __future__ import annotations

import numpy as np
import torch

from tinybvh_tpu_torch.core.rays import Rays, default_device, make_rays
from tinybvh_tpu_torch.core.vecmath import normalize


def look_at(eye, target, up=(0.0, 1.0, 0.0)):
    """(eye, fwd, right, up) float32 numpy vectors of a camera at `eye`
    looking at `target`."""
    eye = np.asarray(eye, np.float32)
    fwd = np.asarray(target, np.float32) - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float32))
    right = right / np.linalg.norm(right)
    upv = np.cross(right, fwd)
    return eye, fwd, right, upv


def primary_rays(eye, fwd, right, up, width, height, fov_scale=0.9,
                 jitter=None, device=None) -> Rays:
    """width x height primary rays in row-major order. jitter: optional
    (H, W, 2) subpixel offsets in [0, 1) for antialiasing and path
    tracing. The rays go to jitter's device when it is a tensor, else to
    `device` (default: the card, core.rays.default_device)."""
    if isinstance(jitter, torch.Tensor):
        dev = jitter.device
    else:
        dev = default_device(device)
    xs = (np.arange(width) + 0.5) / width - 0.5
    ys = (np.arange(height) + 0.5) / height - 0.5
    gx, gy = np.meshgrid(xs, ys)
    gx = torch.from_numpy(gx.astype(np.float32)).to(dev)
    gy = torch.from_numpy(gy.astype(np.float32)).to(dev)
    if jitter is not None:
        jitter = torch.as_tensor(jitter, dtype=torch.float32, device=dev)
        gx = gx + (jitter[..., 0] - 0.5) / width
        gy = gy + (jitter[..., 1] - 0.5) / height

    def vec(v):
        return torch.as_tensor(np.asarray(v, np.float32), device=dev)

    d = (vec(fwd)[None, None]
         + fov_scale * gx[..., None] * vec(right)[None, None]
         + fov_scale * gy[..., None] * vec(up)[None, None]).reshape(-1, 3)
    d = normalize(d)
    o = torch.broadcast_to(vec(eye), d.shape)
    return make_rays(o, d)


def auto_camera(scene_min, scene_max, offset=(0.6, 0.35, 1.1), dist=1.2):
    """Frame a scene AABB the way the reference demos do."""
    lo = np.asarray(scene_min, np.float32)
    hi = np.asarray(scene_max, np.float32)
    center = (lo + hi) * 0.5
    ext = float(np.max(hi - lo))
    eye = center + np.asarray(offset, np.float32) * ext * dist
    return look_at(eye, center)
