"""The scene of upstream tinybvh's `tiny_bvh_minimal.cpp`: TRIANGLE_COUNT
(8,192) triangles, each with its first vertex uniform in the unit cube
and its other two at that vertex plus 0.1 times a uniform vector of
[0, 1)^3. A configuration gives the count, the side of the cube and
that 0.1 as `triangle_count`, `cube_side` and `vertex_offset`; one that
holds more triangles than the source widens the cube so that the
triangles per unit of volume stay the source's.

The triangles are made from the seed on the host and copied to the
run's device. The program is handed `tb.BVH(triangles, **build)`; the
plain reference is harness/reference.py's brute force over the same
triangle tensor, and a hit's id is the triangle's index."""

from __future__ import annotations

import numpy as np
import torch

from harness import reference


def minimal_soup(n: int, seed: int, cube_side: float = 1.0,
                 vertex_offset: float = 0.1) -> np.ndarray:
    """(N, 3, 3) float32: tiny_bvh_minimal.cpp's random small triangles,
    v0 uniform in [0, cube_side)^3 and v1, v2 at v0 + vertex_offset *
    U[0, 1)^3."""
    rng = np.random.default_rng(seed)
    v0 = rng.random((n, 1, 3), dtype=np.float32) * np.float32(cube_side)
    offs = rng.random((n, 2, 3), dtype=np.float32) * np.float32(
        vertex_offset)
    return np.concatenate([v0, v0 + offs], axis=1)


class Soup:
    """The benchmark's own copy of a triangle soup: `host` (N, 3, 3)
    float32 numpy, `tris` the same on `device`, and (lo, hi) float64
    corners of its bounding box."""

    def __init__(self, tris_np: np.ndarray, device, build: dict):
        self.host = tris_np
        self.tris = torch.from_numpy(tris_np).to(device)
        self.device = self.tris.device
        flat = tris_np.reshape(-1, 3).astype(np.float64)
        self.lo, self.hi = flat.min(0), flat.max(0)
        self.build = build
        self.summary = f"{tris_np.shape[0]} triangles"

    def program(self):
        """What the program is handed, built as a user builds it."""
        import tinybvh_tpu_torch as tb

        return tb.BVH(self.host, device=self.device, **self.build)

    def closest(self, o, d, t_max=1e30, precision="fp32"):
        """(t, hit) of each ray's closest hit: t = 1e30 and hit = -1 on
        a miss; hit is the triangle's index."""
        return reference.closest(self.tris, o, d, t_max, precision)

    def occluded(self, o, d, t_max, precision="fp32"):
        """(R,) bool: any hit with 0 < t < t_max."""
        return reference.occluded(self.tris, o, d, t_max, precision)

    def normals(self, hit, d):
        """(N, 3) unit normals of the triangles `hit` (all >= 0), turned
        towards the rays of direction d that found them."""
        tri = self.tris[hit]
        nrm = torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
        nrm = nrm / torch.linalg.vector_norm(nrm, dim=1,
                                             keepdim=True).clamp_min(1e-30)
        return torch.where((nrm * d).sum(1, keepdim=True) > 0.0, -nrm, nrm)


def make(config: dict, seed: int, device) -> Soup:
    """The configuration's soup, from the seed, on `device`."""
    return Soup(minimal_soup(int(config["triangle_count"]), seed,
                             float(config["cube_side"]),
                             float(config["vertex_offset"])),
                device, config.get("build", {}))
