"""Geometry loaders and procedural scenes, as numpy
(≙ tinybvh_tpu/io/loaders.py; the port carries its own copy because the
JAX package's __init__ imports jax)."""

from __future__ import annotations

import struct

import numpy as np


def load_bin(path: str) -> np.ndarray:
    """Read a .bin triangle soup (int32 count + 3*count float4 vertices,
    ≙ tiny_bvh_anim.cpp:70-82) -> (N, 3, 3) float32."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<i", f.read(4))
        data = np.frombuffer(f.read(n * 3 * 16), dtype=np.float32)
    return data.reshape(n, 3, 4)[:, :, :3].copy()


def random_tris(n: int, seed: int = 0, extent: float = 10.0,
                size: float = 0.3) -> np.ndarray:
    """N random small triangles in a cube (tiny_bvh_minimal.cpp:24-35)."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, extent, (n, 1, 3)).astype(np.float32)
    offs = rng.uniform(-size, size, (n, 3, 3)).astype(np.float32)
    return base + offs


def sphere_tris(n_lat: int = 16, n_lon: int = 32, radius: float = 1.0,
                center=(0.0, 0.0, 0.0)) -> np.ndarray:
    """Triangulated UV sphere."""
    c = np.asarray(center, np.float32)
    lats = np.linspace(0, np.pi, n_lat + 1)
    lons = np.linspace(0, 2 * np.pi, n_lon + 1)
    grid = np.zeros((n_lat + 1, n_lon + 1, 3), np.float32)
    grid[..., 0] = radius * np.sin(lats)[:, None] * np.cos(lons)[None, :]
    grid[..., 1] = radius * np.cos(lats)[:, None]
    grid[..., 2] = radius * np.sin(lats)[:, None] * np.sin(lons)[None, :]
    grid += c
    tris = []
    for i in range(n_lat):
        for j in range(n_lon):
            a, b = grid[i, j], grid[i, j + 1]
            d, e = grid[i + 1, j], grid[i + 1, j + 1]
            if i > 0:
                tris.append([a, b, d])
            if i < n_lat - 1:
                tris.append([b, e, d])
    return np.asarray(tris, np.float32)
