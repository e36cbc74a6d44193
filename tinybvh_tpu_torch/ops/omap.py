"""Opacity micromaps: per-triangle S x S alpha bit grids
(≙ tinybvh_tpu/ops/omap.py).

Counterpart of the reference's opacity micromaps (SetOpacityMicroMaps,
tiny_bvh.h:822-826, consulted after the triangle hit at 8514-8522) and
the scene-side baker (tiny_scene.h:1682-1750, which rasterizes the alpha
texture over each triangle's barycentric grid).

The grid is indexed by floor(u S), floor(v S) over the barycentric domain
(cells with iu + iv >= S lie outside the triangle and are never queried).
The bakers run once per scene on the host (numpy, as in JAX) and return
bool tensors on the device the caller names."""

from __future__ import annotations

import numpy as np
import torch

from tinybvh_tpu_torch.core.rays import default_device


def bake_omap(n_tris: int, alpha_fn, S: int = 8, device=None):
    """Bake (N, S, S) bool maps. alpha_fn(prim, u, v) -> bool opacity,
    where prim (K,) int and u, v (K,) f32 are numpy arrays of cell-center
    barycentrics; it must be vectorized. device: default the card."""
    prim = np.repeat(np.arange(n_tris), S * S)
    iu, iv = np.meshgrid(np.arange(S), np.arange(S), indexing="ij")
    u = np.tile(((iu.reshape(-1) + 0.5) / S).astype(np.float32), n_tris)
    v = np.tile(((iv.reshape(-1) + 0.5) / S).astype(np.float32), n_tris)
    bits = np.asarray(alpha_fn(prim, u, v), bool).reshape(n_tris, S, S)
    return torch.from_numpy(bits).to(default_device(device))


def bake_omap_texture(uv_tri, alpha, S: int = 8, thresh: float = 0.5,
                      device=None):
    """Bake (N, S, S) opacity maps from an alpha texture threaded over
    each triangle's UVs (≙ tiny_scene.h:1682-1750). uv_tri: (N, 3, 2)
    per-corner texture coordinates (wrap addressing); alpha: (H, W) in
    [0, 1]; a cell is opaque when the texel at its barycentric center has
    alpha >= thresh."""
    uv_tri = np.asarray(uv_tri, np.float32)
    a = np.asarray(alpha, np.float32)
    H, W = a.shape

    def alpha_fn(prim, u, v):
        uvs = uv_tri[prim]                                   # (K, 3, 2)
        w = 1.0 - u - v
        uv = (w[:, None] * uvs[:, 0] + u[:, None] * uvs[:, 1]
              + v[:, None] * uvs[:, 2])
        x = np.clip(((uv[:, 0] % 1.0) * W).astype(np.int64), 0, W - 1)
        y = np.clip(((uv[:, 1] % 1.0) * H).astype(np.int64), 0, H - 1)
        return a[y, x] >= thresh

    return bake_omap(uv_tri.shape[0], alpha_fn, S, device=device)


def leaf_align(omap, bvh8, leaf_prim_host=None):
    """Reindex (N, S, S) per-primitive maps into the (L, 4, S, S) layout
    of the BVH8 leaf rows; padding lanes (prim -1) are transparent (they
    never hit anyway). The result lies on omap's device.

    leaf_prim_host: optional numpy copy of bvh8.leaf_prim (api.BVH's
    _bvh8_host["leaf_prim"]); without it leaf_prim is moved to omap's
    device once."""
    om = torch.as_tensor(omap).to(torch.bool)
    lp = (torch.from_numpy(np.array(leaf_prim_host))
          if leaf_prim_host is not None else bvh8.leaf_prim)
    lp = lp.to(om.device).long()
    valid = (lp >= 0)[..., None, None]
    return om[lp.clamp(min=0)] & valid
