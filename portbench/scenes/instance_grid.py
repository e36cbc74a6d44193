"""The instanced scene of upstream tinybvh's GPU instancing demo,
`tiny_bvh_gpu2.cpp` with `wavefront2.cl`: one mesh, the BLAS, instanced
grid^3 times under a TLAS (15^3 = 3,375 there). A configuration gives
the BLAS as a minimal soup (scenes/minimal_soup.py: `blas_triangles`,
`cube_side`, `vertex_offset`), `grid`, and `pitch`, the grid's spacing
in units of `cube_side`, and `scene_seed`. Each instance is turned about
the soup's centre by an angle about an axis and moved to its cell of the
grid. The BLAS, the axes and the angles are drawn from `scene_seed`, not
the run's seed: one scene for every run, as a deployment's mesh and
layout are one asset.

The program is handed `tb.TLAS([tb.BVH(blas, **build)], transforms)`,
built as a user builds it. A hit's id is inst * blas_triangles + prim.

The plain reference knows instances and imports nothing of the program.
Each ray is tested against every instance's world box (the BLAS's box
under the instance's transform, padded); the instances it enters are
visited near to far, the ray taken into each one's frame, and
harness/reference.py's brute force runs there over the BLAS. An
instance whose box the ray enters strictly past its best t so far holds
no nearer hit and is skipped; ties in t go to the lower instance, so the
answers equal those of a visit of every entered instance. The ray's
move into a frame is float32 multiply-sums, whatever `precision` says;
`precision` is the brute force's. Each transform is inverted in float64
and stored in float32, as the program does."""

from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np
import torch

from harness import reference
from harness.spec import load_module

SOUP = load_module(Path(__file__).resolve().parents[1], "scenes",
                   "minimal_soup")

CHUNK = 8192        # rays the reference takes through the boxes at once


def _turn(axis, angle):
    """3x3 float64 rotation by `angle` about the unit `axis` (Rodrigues)."""
    x, y, z = axis
    k = np.array([[0.0, -z, y], [z, 0.0, -x], [-y, x, 0.0]])
    return np.eye(3) + np.sin(angle) * k + (1.0 - np.cos(angle)) * k @ k


def grid_transforms(grid: int, pitch: float, centre, seed: int):
    """(grid^3, 4, 4) float32 object-to-world matrices: instance i turns
    the BLAS about its centre and moves it to cell i of the grid, x
    fastest."""
    rng = np.random.default_rng(seed)
    mats = np.zeros((grid ** 3, 4, 4))
    for i in range(grid ** 3):
        cell = np.array([i % grid, (i // grid) % grid, i // grid ** 2])
        axis = rng.normal(size=3)
        a = _turn(axis / np.linalg.norm(axis), rng.uniform(0, 2 * np.pi))
        mats[i, :3, :3] = a
        mats[i, :3, 3] = cell * pitch - a @ centre
        mats[i, 3, 3] = 1.0
    return mats.astype(np.float32)


def _apply(a, v):
    """(N, 3, 3) applied to (N, 3), float32 products summed left to
    right: never a matrix product, which may run in TF32."""
    p = a * v[:, None, :]
    return p[..., 0] + p[..., 1] + p[..., 2]


def _say(*a):
    print(*a, file=sys.stderr, flush=True)


class Instances:
    """The benchmark's own copy of an instanced scene: the BLAS's
    triangles on `device`, the transforms' float32 inverses, and each
    instance's world box."""

    def __init__(self, blas_np: np.ndarray, mats: np.ndarray, device,
                 build: dict):
        self.blas_host, self.mats, self.build = blas_np, mats, build
        self.blas = torch.from_numpy(blas_np).to(device)
        self.device = self.blas.device
        self.n = blas_np.shape[0]
        m64 = mats.astype(np.float64)
        self.inv = torch.from_numpy(np.linalg.inv(m64).astype(
            np.float32)).to(self.device)
        # world boxes: the BLAS's box under each transform, in float64
        verts = blas_np.reshape(-1, 3).astype(np.float64)
        c = (verts.min(0) + verts.max(0)) * 0.5
        e = (verts.max(0) - verts.min(0)) * 0.5
        wc = m64[:, :3, :3] @ c + m64[:, :3, 3]
        we = np.abs(m64[:, :3, :3]) @ e
        lo, hi = wc - we, wc + we                                 # (I, 3)
        self.lo, self.hi = lo.min(0), hi.max(0)
        pad = 1e-4 * float(np.max(self.hi - self.lo))   # boxes only filter
        self.box_lo = torch.tensor(lo - pad, dtype=torch.float32,
                                   device=self.device)
        self.box_hi = torch.tensor(hi + pad, dtype=torch.float32,
                                   device=self.device)
        self.summary = f"{mats.shape[0]} instances of {self.n} triangles"

    def program(self):
        """What the program is handed, built as a user builds it."""
        import tinybvh_tpu_torch as tb

        blas = tb.BVH(self.blas_host, device=self.device, **self.build)
        return tb.TLAS([blas], self.mats)

    def split(self, hit):
        """(inst, prim) of hit ids, -1 both on a miss."""
        inst = torch.where(hit >= 0, hit // self.n, -1)
        return inst, torch.where(hit >= 0, hit % self.n, -1)

    def _entry(self, o, d, t_max):
        """(R, I) float32: where each ray's segment (0, t_max) enters each
        instance's world box (slab test, clamped at 0), inf where it
        misses the box."""
        inv_d = 1.0 / torch.where(d == 0.0, torch.full_like(d, 1e-30), d)
        near = torch.zeros((o.shape[0], self.box_lo.shape[0]),
                           device=o.device)
        far = torch.full_like(near, float("inf"))
        for k in range(3):
            t0 = (self.box_lo[None, :, k] - o[:, None, k]) * inv_d[:, None, k]
            t1 = (self.box_hi[None, :, k] - o[:, None, k]) * inv_d[:, None, k]
            near = torch.maximum(near, torch.minimum(t0, t1))
            far = torch.minimum(far, torch.maximum(t0, t1))
        hit = (near <= far) & (near < t_max[:, None])
        return torch.where(hit, near, float("inf"))

    def _visits(self, o, d, tm, wanted):
        """The visits of a chunk of rays, near to far: round k yields
        (rows, inst, o', d') of the rays whose k-th nearest entered
        instance `wanted(entry)` accepts, the rays taken into that
        instance's frame; counts visits and rounds into self._stats."""
        ent = self._entry(o, d, tm)
        k_max = int((ent < float("inf")).sum(1).max()) if o.shape[0] else 0
        if k_max == 0:
            return
        ent, order = torch.sort(ent, dim=1)
        ent, order = ent[:, :k_max], order[:, :k_max]
        for k in range(k_max):
            rows = torch.nonzero((ent[:, k] < float("inf"))
                                 & wanted(ent[:, k])).squeeze(1)
            if rows.numel() == 0:
                continue
            inst = order[rows, k]
            a = self.inv[inst, :3, :3]
            o2 = _apply(a, o[rows]) + self.inv[inst, :3, 3]
            self._stats[0] += rows.numel()
            self._stats[1] += 1
            yield rows, inst, o2, _apply(a, d[rows])

    def _chunks(self, o, d, t_max, what):
        """(slice, o, d, t_max) of each chunk of CHUNK rays; once they are
        done, the reference's rays, visits, rounds and seconds on standard
        error."""
        R = o.shape[0]
        tm = torch.as_tensor(t_max, dtype=torch.float32,
                             device=o.device).expand(R)
        self._stats = [0, 0]
        t0 = time.perf_counter()
        for r0 in range(0, R, CHUNK):
            s = slice(r0, min(r0 + CHUNK, R))
            yield s, o[s], d[s], tm[s]
        if o.device.type == "cuda":
            torch.cuda.synchronize(o.device)
        _say(f"instance reference ({what}): {R} rays, {self._stats[0]} "
             f"(ray, instance) visits in {self._stats[1]} rounds, "
             f"{time.perf_counter() - t0:.3f} s")

    @torch.no_grad()
    def closest(self, o, d, t_max=1e30, precision="fp32",
                near_first=True):
        """(t, hit) of each ray's closest hit over every instance: t =
        1e30 and hit = -1 on a miss. near_first False visits every
        entered instance (the same answers, at more cost)."""
        R = o.shape[0]
        best_t = torch.full((R,), float("inf"), device=o.device)
        best = torch.full((R,), -1, dtype=torch.int64, device=o.device)
        for s, oc, dc, tc in self._chunks(o, d, t_max, "closest"):
            bt, bh = best_t[s], best[s]
            want = ((lambda e: e <= bt) if near_first
                    else (lambda e: torch.ones_like(e, dtype=torch.bool)))
            for rows, inst, o2, d2 in self._visits(oc, dc, tc, want):
                t, prim = reference.closest(self.blas, o2, d2, tc[rows],
                                            precision)
                hid = inst * self.n + prim
                cur_t, cur = bt[rows], bh[rows]
                better = (prim >= 0) & ((t < cur_t) | ((t == cur_t)
                                                       & (hid < cur)))
                bt[rows] = torch.where(better, t, cur_t)
                bh[rows] = torch.where(better, hid, cur)
            best_t[s], best[s] = bt, bh
        return torch.where(best >= 0, best_t, 1e30), best

    @torch.no_grad()
    def occluded(self, o, d, t_max, precision="fp32"):
        """(R,) bool: any hit with 0 < t < t_max in any instance; an
        occluded ray visits no further instance."""
        occ = torch.zeros((o.shape[0],), dtype=torch.bool, device=o.device)
        for s, oc, dc, tc in self._chunks(o, d, t_max, "occluded"):
            oo = occ[s]
            for rows, _, o2, d2 in self._visits(oc, dc, tc,
                                                lambda e: ~oo):
                oo[rows] |= reference.occluded(self.blas, o2, d2, tc[rows],
                                               precision)
            occ[s] = oo
        return occ

    def normals(self, hit, d):
        """World-space unit normals of the hits (all >= 0), turned
        towards the rays of direction d: the BLAS triangle's normal under
        the inverse transpose of its instance's transform."""
        inst, prim = self.split(hit)
        tri = self.blas[prim]
        n = torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
        n = _apply(self.inv[inst, :3, :3].transpose(1, 2), n)
        n = n / torch.linalg.vector_norm(n, dim=1,
                                         keepdim=True).clamp_min(1e-30)
        return torch.where((n * d).sum(1, keepdim=True) > 0.0, -n, n)


def make(config: dict, seed: int, device) -> Instances:
    """The configuration's instances on `device`, made from its
    `scene_seed`, not the run's seed: one scene for every run, as a
    deployment's mesh and layout are one asset."""
    seed = int(config["scene_seed"])
    side = float(config["cube_side"])
    blas = SOUP.minimal_soup(int(config["blas_triangles"]), seed, side,
                             float(config["vertex_offset"]))
    centre = blas.reshape(-1, 3).astype(np.float64).mean(0)
    mats = grid_transforms(int(config["grid"]),
                           float(config["pitch"]) * side, centre, seed + 1)
    return Instances(blas, mats, device, config.get("build", {}))
