"""Texture atlas and bilinear sampling for the path tracers
(≙ tinybvh_tpu/render/textures.py; tiny_scene.h's Texture objects,
tiny_scene.h:660-695, 2688-2911, sampled in raytracer.cl's material
shading).

All textures are packed into ONE (H, W, 3) atlas tensor on the device; a
(T, 4) rect table maps texture id -> pixel region. Sampling is
wrap-addressed bilinear through four row gathers. The image helpers
(sRGB, MIP chain, bump -> normal) run once per asset in numpy, as in the
JAX package."""

from __future__ import annotations

import math

import numpy as np
import torch

from tinybvh_tpu_torch.core.rays import default_device


def build_atlas(images, device=None):
    """Pack a list of (H, W, 3) float32 images into one atlas on `device`
    (default: the card). Returns dict(atlas=(AH, AW, 3) float32,
    rects=(T, 4) float32 rows of [x0, y0, w, h] in pixels). Packing is a
    vertical shelf (textures are few and pre-mipped in the reference too,
    tiny_scene.h:2726-2753); atlas width = max width. No images give a
    1x1 white atlas."""
    dev = default_device(device)
    if not images:
        atlas = np.ones((1, 1, 3), np.float32)
        rects = np.array([[0, 0, 1, 1]], np.float32)
    else:
        imgs = []
        for im in images:
            a = np.asarray(im, np.float32)
            if a.ndim == 2:
                a = a[..., None].repeat(3, axis=-1)
            if a.shape[-1] == 4:
                a = a[..., :3]
            imgs.append(a)
        aw = max(i.shape[1] for i in imgs)
        ah = sum(i.shape[0] for i in imgs)
        atlas = np.zeros((ah, aw, 3), np.float32)
        rects = np.zeros((len(imgs), 4), np.float32)
        y = 0
        for t, im in enumerate(imgs):
            h, w = im.shape[:2]
            atlas[y:y + h, :w] = im
            rects[t] = [0, y, w, h]
            y += h
    return dict(atlas=torch.from_numpy(atlas).to(dev),
                rects=torch.from_numpy(rects).to(dev))


def sample_atlas(tex, tex_id, uv):
    """Bilinear-sample the atlas. tex_id (R,) int32 (< 0 -> white), uv
    (R, 2) float32, wrap-addressed. Returns (R, 3) float32."""
    atlas, rects = tex["atlas"], tex["rects"]
    r = rects[torch.clamp(tex_id, min=0).long()]          # (R, 4)
    x0, y0, w, h = r[:, 0], r[:, 1], r[:, 2], r[:, 3]
    u = torch.remainder(uv[:, 0], 1.0)
    v = torch.remainder(uv[:, 1], 1.0)
    # texel-center addressing within the rect
    fx = u * w - 0.5
    fy = v * h - 0.5
    ix = torch.floor(fx)
    iy = torch.floor(fy)
    ax = (fx - ix)[:, None]
    ay = (fy - iy)[:, None]

    def fetch(px, py):
        # wrap within this texture's rect, then offset into the atlas
        qx = (x0 + torch.remainder(px, w)).to(torch.int64)
        qy = (y0 + torch.remainder(py, h)).to(torch.int64)
        return atlas[qy, qx]

    c00 = fetch(ix, iy)
    c10 = fetch(ix + 1, iy)
    c01 = fetch(ix, iy + 1)
    c11 = fetch(ix + 1, iy + 1)
    col = ((1 - ax) * (1 - ay) * c00 + ax * (1 - ay) * c10
           + (1 - ax) * ay * c01 + ax * ay * c11)
    return torch.where((tex_id >= 0)[:, None], col, 1.0)


def srgb_to_linear(img):
    """sRGB -> linear transfer (≙ the reference's sRGB conversion on
    texture load, tiny_scene.h:2688-2760), any (..., C) array in [0, 1]."""
    img = np.asarray(img, np.float32)
    lo = img / 12.92
    hi = ((img + 0.055) / 1.055) ** 2.4
    return np.where(img <= 0.04045, lo, hi).astype(np.float32)


def build_mip_chain(img, max_levels: int = 16):
    """Box-filtered MIP chain (≙ Texture::ConstructMIPmaps,
    tiny_scene.h:2726-2753): [level0, level1, ...] down to 1x1; odd
    dimensions are truncated like the reference's >>1."""
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    chain = [img]
    while len(chain) < max_levels and min(img.shape[0], img.shape[1]) > 1:
        h2, w2 = max(img.shape[0] // 2, 1), max(img.shape[1] // 2, 1)
        img = img[: h2 * 2, : w2 * 2]
        img = img.reshape(h2, 2, w2, 2, img.shape[-1]).mean(axis=(1, 3))
        chain.append(img.astype(np.float32))
    return chain


def bump_to_normal(height, strength: float = 1.0):
    """Height map -> tangent-space normal map (≙ tiny_scene.h:2862-2911):
    central differences with wrap addressing, normals encoded in [0, 1]."""
    h = np.asarray(height, np.float32)
    if h.ndim == 3:
        h = h.mean(axis=-1)
    dx = (np.roll(h, -1, axis=1) - np.roll(h, 1, axis=1)) * 0.5 * strength
    dy = (np.roll(h, -1, axis=0) - np.roll(h, 1, axis=0)) * 0.5 * strength
    n = np.stack([-dx, -dy, np.ones_like(h)], axis=-1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return (n * 0.5 + 0.5).astype(np.float32)


def build_atlas_mipped(images, max_levels: int = 8, device=None):
    """Atlas whose rect table carries a full MIP pyramid per texture:
    rects (T, L, 4), and `sample_atlas_mip` selects the level per ray.
    Missing levels repeat the last one so the table is dense."""
    if not images:
        base = build_atlas(images, device=device)
        return dict(atlas=base["atlas"],
                    rects=base["rects"][:, None, :].repeat(1, max_levels, 1))
    chains = [build_mip_chain(im, max_levels) for im in images]
    flat, index = [], []
    for ch in chains:
        index.append((len(flat), len(ch)))
        flat.extend(ch)
    packed = build_atlas(flat, device=device)
    pr = packed["rects"].cpu().numpy()
    rects = np.zeros((len(images), max_levels, 4), np.float32)
    for t, (off, n) in enumerate(index):
        for lv in range(max_levels):
            rects[t, lv] = pr[off + min(lv, n - 1)]
    return dict(atlas=packed["atlas"],
                rects=torch.from_numpy(rects).to(packed["atlas"].device))


def sample_atlas_mip(tex, tex_id, uv, level):
    """Bilinear sample at an integer MIP level per ray. tex from
    build_atlas_mipped; level (R,) int, clamped to the table."""
    rects = tex["rects"]                                  # (T, L, 4)
    L = rects.shape[1]
    lvl = torch.clamp(level, 0, L - 1)
    tid = torch.clamp(tex_id, min=0)
    flat = dict(atlas=tex["atlas"], rects=rects.reshape(-1, 4))
    return sample_atlas(flat, torch.where(tex_id >= 0, tid * L + lvl, -1),
                        uv)


def sample_sky(sky, d):
    """Equirectangular sky lookup (≙ SkyDome sampling,
    tiny_scene.h:1024-1079). sky (H, W, 3); d (R, 3) unit directions."""
    h, w = sky.shape[:2]
    u = torch.remainder(torch.atan2(d[:, 2], d[:, 0]) / (2 * math.pi), 1.0)
    v = torch.arccos(torch.clamp(d[:, 1], -1, 1)) / math.pi
    x = torch.clamp((u * w).to(torch.int64), 0, w - 1)
    y = torch.clamp((v * h).to(torch.int64), 0, h - 1)
    return sky[y, x]
