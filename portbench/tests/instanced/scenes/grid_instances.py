"""A scene kind of instances, for the harness's tests: one BLAS, a minimal
soup of `blas_triangles` triangles (scenes/minimal_soup.py), instanced
grid^3 times, each instance turned about an axis drawn from the seed and
put on a grid whose pitch is `pitch` times the BLAS's extent.

The program is handed `tb.TLAS([tb.BVH(blas, **build)], transforms)`.
The plain reference knows instances: each ray is tested against every
instance's world box, and harness/reference.py's brute force runs on the
ray taken into the frame of each instance it enters. A hit's id is
inst * blas_triangles + prim."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from harness import reference
from harness.spec import load_module

SOUP = load_module(Path(__file__).resolve().parents[1], "scenes",
                   "minimal_soup")


def _turn(axis, angle):
    """3x3 float64 rotation by `angle` about the unit `axis` (Rodrigues)."""
    x, y, z = axis
    k = np.array([[0.0, -z, y], [z, 0.0, -x], [-y, x, 0.0]])
    return np.eye(3) + np.sin(angle) * k + (1.0 - np.cos(angle)) * k @ k


def grid_transforms(grid: int, pitch: float, centre, seed: int):
    """(grid^3, 4, 4) float32 object-to-world matrices: instance i turns
    the BLAS about its centre and moves it to cell i of the grid."""
    rng = np.random.default_rng(seed)
    mats = []
    for i in range(grid ** 3):
        cell = np.array([i % grid, (i // grid) % grid, i // grid ** 2])
        axis = rng.normal(size=3)
        a = _turn(axis / np.linalg.norm(axis), rng.uniform(0, 2 * np.pi))
        m = np.eye(4)
        m[:3, :3] = a
        m[:3, 3] = cell * pitch - a @ centre
        mats.append(m)
    return np.asarray(mats, np.float32)


class Instances:
    """The benchmark's own copy of an instanced scene: the BLAS's
    triangles on `device`, the transforms and their float64 inverses,
    and each instance's world box."""

    def __init__(self, blas_np: np.ndarray, mats: np.ndarray, device,
                 build: dict):
        self.blas_host, self.mats, self.build = blas_np, mats, build
        self.blas = torch.from_numpy(blas_np).to(device)
        self.device = self.blas.device
        self.n = blas_np.shape[0]
        m64 = mats.astype(np.float64)
        inv = np.linalg.inv(m64)
        self.inv = torch.from_numpy(inv.astype(np.float32)).to(self.device)
        verts = blas_np.reshape(-1, 3).astype(np.float64)
        world = np.einsum("ijk,nk->inj", m64[:, :3, :3], verts) + m64[
            :, None, :3, 3]
        lo, hi = world.min(1), world.max(1)                      # (I, 3)
        self.lo, self.hi = lo.min(0), hi.max(0)
        pad = 1e-5 * float(np.max(self.hi - self.lo))   # boxes only filter
        self.box_lo = torch.tensor(lo - pad, dtype=torch.float32,
                                   device=self.device)
        self.box_hi = torch.tensor(hi + pad, dtype=torch.float32,
                                   device=self.device)
        self.summary = (f"{mats.shape[0]} instances of {self.n} "
                        f"triangles")

    def program(self):
        """What the program is handed, built as a user builds it."""
        import tinybvh_tpu_torch as tb

        blas = tb.BVH(self.blas_host, device=self.device, **self.build)
        return tb.TLAS([blas], self.mats)

    def split(self, hit):
        """(inst, prim) of hit ids, -1 both on a miss."""
        inst = torch.where(hit >= 0, hit // self.n, -1)
        return inst, torch.where(hit >= 0, hit % self.n, -1)

    def _entered(self, o, d, t_max):
        """(R, I) bool: the ray's segment (0, t_max) meets the instance's
        world box (slab test)."""
        inv_d = 1.0 / torch.where(d == 0.0, torch.full_like(d, 1e-30), d)
        t0 = (self.box_lo[None] - o[:, None]) * inv_d[:, None]
        t1 = (self.box_hi[None] - o[:, None]) * inv_d[:, None]
        near = torch.minimum(t0, t1).amax(2).clamp_min(0.0)
        far = torch.maximum(t0, t1).amin(2)
        return (near <= far) & (near < t_max[:, None])

    def _frames(self, o, d, t_max):
        """For each instance i with rays in its box: (i, rows, o', d'),
        the rays taken into the instance's frame."""
        enter = self._entered(o, d, t_max)
        for i in range(self.inv.shape[0]):
            rows = torch.nonzero(enter[:, i]).squeeze(1)
            if rows.numel():
                a, b = self.inv[i, :3, :3], self.inv[i, :3, 3]
                yield i, rows, o[rows] @ a.T + b, d[rows] @ a.T

    def closest(self, o, d, t_max=1e30, precision="fp32"):
        """(t, hit) of each ray's closest hit over every instance: t =
        1e30 and hit = -1 on a miss."""
        R = o.shape[0]
        tm = torch.as_tensor(t_max, dtype=torch.float32,
                             device=o.device).expand(R)
        best_t = torch.full((R,), 1e30, device=o.device)
        best = torch.full((R,), -1, dtype=torch.int64, device=o.device)
        for i, rows, oi, di in self._frames(o, d, tm):
            t, prim = reference.closest(self.blas, oi, di, tm[rows],
                                        precision)
            better = (prim >= 0) & (t < best_t[rows])
            best_t[rows[better]] = t[better]
            best[rows[better]] = i * self.n + prim[better]
        return best_t, best

    def occluded(self, o, d, t_max, precision="fp32"):
        """(R,) bool: any hit with 0 < t < t_max in any instance."""
        R = o.shape[0]
        tm = torch.as_tensor(t_max, dtype=torch.float32,
                             device=o.device).expand(R)
        occ = torch.zeros((R,), dtype=torch.bool, device=o.device)
        for _, rows, oi, di in self._frames(o, d, tm):
            occ[rows] |= reference.occluded(self.blas, oi, di, tm[rows],
                                            precision)
        return occ

    def normals(self, hit, d):
        """World-space unit normals of the hits (all >= 0), turned
        towards the rays of direction d: the BLAS triangle's normal
        under the inverse transpose of its instance's transform."""
        inst, prim = self.split(hit)
        tri = self.blas[prim]
        n = torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
        n = (n[:, None, :] @ self.inv[inst, :3, :3]).squeeze(1)
        n = n / torch.linalg.vector_norm(n, dim=1,
                                         keepdim=True).clamp_min(1e-30)
        return torch.where((n * d).sum(1, keepdim=True) > 0.0, -n, n)


def make(config: dict, seed: int, device) -> Instances:
    """The configuration's instances, from the seed, on `device`."""
    side = float(config["cube_side"])
    blas = SOUP.minimal_soup(int(config["blas_triangles"]), seed, side,
                             float(config["vertex_offset"]))
    centre = blas.reshape(-1, 3).astype(np.float64).mean(0)
    mats = grid_transforms(int(config["grid"]),
                           float(config["pitch"]) * side, centre, seed + 1)
    return Instances(blas, mats, device, config.get("build", {}))
