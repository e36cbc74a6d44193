"""Sparse voxel set and batched hierarchical DDA traversal
(≙ tinybvh_tpu/ops/voxel.py).

Counterpart of the reference's VoxelSet (tiny_bvh.h:3786-4160): a 256^3
voxel space stored as a 32^3 grid of 8^3 bricks with on-demand brick
allocation and a topgrid of one bit per 4^3 bricks, traversed by a
three-level Amanatides-Woo 3DDDA (Setup3DDDA tiny_bvh.h:3829-3858,
Intersect :3871-4020). The hit normal derives from the DDA step axis
(:3860-3869).

The grid is a dense (32, 32, 32) int32 brick index (-1 = empty), the
bricks a (B, 8, 8, 8) bool pool. A whole ray batch advances in lockstep,
each ray with its own level (topgrid, grid or brick), as the JAX
while_loop does; here the loop runs on the host over active masks, and
asks whether every ray is done only every _CHECK_EVERY steps (a step
leaves a finished ray unchanged). Plain torch: the JAX package has no
kernel here.

`VoxelSet.set` takes whole arrays at once: bricks are allocated in the
order the voxels first reach them, as the JAX loop over voxels does, so
both give the same grid and pool."""

from __future__ import annotations

import numpy as np
import torch

from tinybvh_tpu_torch.core.rays import Rays, default_device
from tinybvh_tpu_torch.core.vecmath import BVH_FAR

GRID = 32
BRICK = 8
WORLD = GRID * BRICK   # 256
TOPG = 8               # topgrid: one bit per 4^3 group of bricks
GROUP = WORLD // TOPG  # 32 world units per top cell
_CHECK_EVERY = 8


class VoxelSet:
    """Host-side container; build with set(), then freeze() for traversal.

    Voxel coordinates are integers in [0, 256)^3; aabb_min / aabb_max
    place the 256^3 cube in world space (identity: [0, 1)^3, the
    reference's unit-cube convention, tiny_bvh.h:988)."""

    def __init__(self, aabb_min=(0.0, 0.0, 0.0), aabb_max=(1.0, 1.0, 1.0)):
        self.grid = np.full((GRID, GRID, GRID), -1, np.int32)
        # slot 0 unused, as in the reference
        self.bricks = np.zeros((1, BRICK, BRICK, BRICK), bool)
        self.aabb_min = np.asarray(aabb_min, np.float32)
        self.aabb_max = np.asarray(aabb_max, np.float32)

    def set(self, x, y, z, value=True):
        """Set voxels; x/y/z arrays of ints in [0, 256) (≙ VoxelSet::Set,
        tiny_bvh.h:3786-3807, with on-demand brick allocation)."""
        x, y, z = (np.atleast_1d(np.asarray(v, np.int64)) for v in (x, y, z))
        gx, gy, gz = x // BRICK, y // BRICK, z // BRICK
        cell = (gx * GRID + gy) * GRID + gz
        uniq, first = np.unique(cell, return_index=True)
        uniq = uniq[np.argsort(first)]             # order of first touch
        flat = self.grid.reshape(-1)
        new = uniq[flat[uniq] < 0]
        if new.size:
            b0 = self.bricks.shape[0]
            flat[new] = np.arange(b0, b0 + new.size, dtype=np.int32)
            self.bricks = np.concatenate(
                [self.bricks, np.zeros((new.size, BRICK, BRICK, BRICK),
                                       bool)])
        self.bricks[flat[cell], x % BRICK, y % BRICK, z % BRICK] = value

    def freeze(self, device=None) -> dict:
        """The traversal's tensors on `device` (default: the card). The
        topgrid (≙ UpdateTopGrid, tiny_bvh.h:3809-3827) lets the DDA cross
        empty 32-unit cells in one step instead of four 8-unit ones."""
        dev = default_device(device)
        occ = self.grid >= 0
        top = occ.reshape(TOPG, 4, TOPG, 4, TOPG, 4).any(axis=(1, 3, 5))
        return {k: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for k, a in (("grid", self.grid), ("bricks", self.bricks),
                             ("top", top), ("aabb_min", self.aabb_min),
                             ("aabb_max", self.aabb_max))}


def _one_hot3(axis):
    return torch.nn.functional.one_hot(axis, 3).to(torch.int32)


def intersect_voxels(vox: dict, rays: Rays, t_max=BVH_FAR):
    """Batched DDA (three levels with vox["top"], two without). Returns
    (t, normal, voxel_idx) per ray: t = BVH_FAR on a miss, normal the
    +-axis unit vector of the entered face, voxel_idx the (3,) integer
    coordinate of the hit voxel. t_max: scalar or (R,)."""
    o_w, d_w = rays.o, rays.d
    dev = o_w.device
    R = o_w.shape[0]
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=dev)
    # into voxel space [0, 256)^3; t keeps its parametrization
    scale = WORLD / (vox["aabb_max"] - vox["aabb_min"])
    o = (o_w - vox["aabb_min"]) * scale
    d = d_w * scale
    inv = torch.where(d.abs() > 1e-20,
                      1.0 / torch.where(d == 0, 1.0, d),
                      torch.where(d < 0, -1e30, 1e30))

    # clip to the volume
    t1 = (0.0 - o) * inv
    t2 = (WORLD - o) * inv
    tmin = torch.minimum(t1, t2).amax(dim=1)
    tmax_box = torch.maximum(t1, t2).amin(dim=1)
    enter = torch.clamp(tmin, min=0.0) + 1e-4
    inside = (tmax_box >= tmin) & (tmax_box > 0)
    t_stop = torch.minimum(t_max, tmax_box)
    step = torch.where(d >= 0, 1, -1).to(torch.int32)       # (R, 3)
    absinv = inv.abs()

    def cell_setup(t_at, size):
        """The cell at t_at and the t of its next boundary per axis, at
        cell size `size` (the float clamp first keeps the int conversion
        defined; in range it truncates as the JAX astype does)."""
        p = o + t_at[:, None] * d
        n = WORLD // size
        cell = torch.clamp(torch.clamp(p / size, -1.0, float(n)).to(
            torch.int32), 0, n - 1)
        nxt = (cell + (step > 0)) * size
        return cell, (nxt - o) * inv

    def in_bounds(cell, hi):
        return ((cell >= 0) & (cell < hi)).all(dim=1)

    def at(table, c):
        c = c.long()
        return table[c[:, 0], c[:, 1], c[:, 2]]

    gcell, gtside = cell_setup(enter, BRICK)
    has_top = "top" in vox
    tcell, ttside = cell_setup(enter, GROUP)
    # levels: 0 = grid, 1 = brick, 2 = topgrid
    level = torch.full((R,), 2 if has_top else 0, dtype=torch.int32,
                       device=dev)
    bcell = torch.zeros((R, 3), dtype=torch.int32, device=dev)
    btside = torch.zeros((R, 3), dtype=torch.float32, device=dev)
    brick = torch.zeros(R, dtype=torch.int64, device=dev)
    t_cur = enter
    axis = d.abs().argmax(dim=1)                     # entry axis approx
    t_hit = torch.full((R,), BVH_FAR, dtype=torch.float32, device=dev)
    vhit = torch.zeros((R, 3), dtype=torch.int32, device=dev)
    nhit = torch.zeros((R, 3), dtype=torch.float32, device=dev)
    done = ~inside

    n_step = 0
    while n_step % _CHECK_EVERY or not bool(done.all()):
        n_step += 1
        # topgrid level: step 32-unit cells across empty space
        if has_top:
            at_top = (level == 2) & ~done
            tocc = at(vox["top"], torch.clamp(tcell, 0, TOPG - 1))
            t_desc = at_top & tocc & in_bounds(tcell, TOPG)
            ng_cell, ng_tside = cell_setup(t_cur + 1e-5, BRICK)
            gcell = torch.where(t_desc[:, None], ng_cell, gcell)
            gtside = torch.where(t_desc[:, None], ng_tside, gtside)
            level = torch.where(t_desc, 0, level)
            tstep = at_top & ~t_desc
            tt, taxis = ttside.min(dim=1)
            onehot_t = _one_hot3(taxis)
            tcell = torch.where(tstep[:, None], tcell + onehot_t * step,
                                tcell)
            ttside = torch.where(tstep[:, None] & (onehot_t > 0),
                                 ttside + absinv * GROUP, ttside)
            t_cur = torch.where(tstep, tt, t_cur)
            axis = torch.where(tstep, taxis, axis)
            done = done | (tstep & (~in_bounds(tcell, TOPG)
                                    | (t_cur > t_stop)))

        at_grid = (level == 0) & ~done
        at_brick = (level == 1) & ~done

        # a grid cell in an empty topgrid group goes back up, so the DDA
        # crosses it at 32-unit strides
        if has_top:
            gocc = at(vox["top"], torch.clamp(gcell >> 2, 0, TOPG - 1))
            to_top = at_grid & ~gocc & in_bounds(gcell, GRID)
            ntc, ntts = cell_setup(t_cur + 1e-5, GROUP)
            tcell = torch.where(to_top[:, None], ntc, tcell)
            ttside = torch.where(to_top[:, None], ntts, ttside)
            level = torch.where(to_top, 2, level)
            at_grid = at_grid & ~to_top

        # grid level: does the current cell hold a brick?
        gc = torch.clamp(gcell, 0, GRID - 1)
        bidx = at(vox["grid"], gc)
        occupied = at_grid & (bidx >= 0) & in_bounds(gcell, GRID)
        nb_cell, nb_tside = cell_setup(t_cur + 1e-5, 1)
        bcell_new = torch.where(occupied[:, None], nb_cell, bcell)
        btside = torch.where(occupied[:, None], nb_tside, btside)
        brick_new = torch.where(occupied, bidx.long(), brick)
        level = torch.where(occupied, 1, level)

        # grid step for cells without a brick
        gstep = at_grid & ~occupied
        gt, gaxis = gtside.min(dim=1)
        onehot = _one_hot3(gaxis)
        gcell = torch.where(gstep[:, None], gcell + onehot * step, gcell)
        gtside = torch.where(gstep[:, None] & (onehot > 0),
                             gtside + absinv * BRICK, gtside)
        t_cur = torch.where(gstep, gt, t_cur)
        axis = torch.where(gstep, gaxis, axis)
        done = done | (gstep & (~in_bounds(gcell, GRID) | (t_cur > t_stop)))

        # brick level: test the voxel (with the brick before this step's
        # descent, as JAX), else step
        bcell = bcell_new
        local = bcell - gc * BRICK
        bc_local = torch.clamp(local, 0, BRICK - 1).long()
        vbit = vox["bricks"][brick, bc_local[:, 0], bc_local[:, 1],
                             bc_local[:, 2]]
        brick = brick_new
        hit = at_brick & vbit & in_bounds(local, BRICK)
        t_hit = torch.where(hit, t_cur, t_hit)
        vhit = torch.where(hit[:, None], bcell, vhit)
        naxis = torch.nn.functional.one_hot(axis, 3).to(torch.float32)
        nhit = torch.where(hit[:, None], -naxis * step.to(torch.float32),
                           nhit)
        done = done | hit

        bstep = at_brick & ~hit
        bt, baxis = btside.min(dim=1)
        onehot_b = _one_hot3(baxis)
        bcell = torch.where(bstep[:, None], bcell + onehot_b * step, bcell)
        btside = torch.where(bstep[:, None] & (onehot_b > 0),
                             btside + absinv, btside)
        t_cur = torch.where(bstep, bt, t_cur)
        axis = torch.where(bstep, baxis, axis)
        # leaving the brick: back to grid level, and step the grid cell
        left = bstep & ~in_bounds(bcell - gc * BRICK, BRICK)
        level = torch.where(left, 0, level)
        gt2, gaxis2 = gtside.min(dim=1)
        onehot2 = _one_hot3(gaxis2)
        gcell = torch.where(left[:, None], gcell + onehot2 * step, gcell)
        gtside = torch.where(left[:, None] & (onehot2 > 0),
                             gtside + absinv * BRICK, gtside)
        t_cur = torch.where(left, gt2, t_cur)
        axis = torch.where(left, gaxis2, axis)
        done = done | (left & (~in_bounds(gcell, GRID) | (t_cur > t_stop)))
    return t_hit, nhit, vhit


def is_occluded_voxels(vox: dict, rays: Rays, t_max):
    """(R,) bool: a voxel hit below t_max."""
    t, _, _ = intersect_voxels(vox, rays, t_max)
    return t < t_max
