"""Non-ray BVH queries: sphere overlap (collision detection) and custom
user primitives (≙ tinybvh_tpu/ops/queries.py).

Counterparts of BVH::IntersectSphere (tiny_bvh.h:3140-3200) and the
customIntersect / customIsOccluded callbacks (tiny_bvh.h:966-967,
3270-3280). Batched: every query advances one step together over a BVH2,
each with its own stack, as the JAX functions' while_loops do. Here the
loop runs on the host over active masks; a step leaves a finished query
unchanged, so the host asks whether all are done only every _CHECK_EVERY
steps (one sync per check). Plain torch: the JAX package has no kernel
here."""

from __future__ import annotations

import torch

from tinybvh_tpu_torch.core.intersect import slab_test, sphere_tri_overlap
from tinybvh_tpu_torch.core.rays import Hits, Rays
from tinybvh_tpu_torch.core.vecmath import BVH_FAR

STACK_DEPTH = 64
_CHECK_EVERY = 8


def _sphere_aabb_overlap(c, r, bmin, bmax):
    """Squared distance from centers to boxes <= r^2."""
    q = torch.clamp(bmin - c, min=0.0) + torch.clamp(c - bmax, min=0.0)
    return (q * q).sum(-1) <= r * r


def _steps(done):
    """Yield until every query is done, checked every _CHECK_EVERY steps."""
    step = 0
    while step % _CHECK_EVERY or not bool(done().all()):
        step += 1
        yield


def _push(stack, sp, push, vals):
    """Write vals where push at column clip(sp, 0, depth - 1), as the JAX
    stacks do (a full stack overwrites its top), and return the new sp."""
    col = torch.clamp(sp, 0, stack.shape[1] - 1)[:, None]
    old = stack.gather(1, col)[:, 0]
    stack.scatter_(1, col, torch.where(push, vals, old)[:, None])
    return torch.where(push, sp + 1, sp)


def _pop(stack, sp, can_pop):
    """(new sp, the entry at clip(new sp)) where can_pop."""
    nsp = torch.where(can_pop, sp - 1, sp)
    col = torch.clamp(nsp, 0, stack.shape[1] - 1)[:, None]
    return nsp, stack.gather(1, col)[:, 0]


def intersect_sphere(bvh, packed_tris, centers, radii, leaf_max: int = 16):
    """True per sphere where any triangle overlaps it (exact triangle-
    sphere test). bvh: a BVH2; packed_tris (N, 3, 3) in prim_idx order
    (traverse.stack.pack_tris); centers (Q, 3); radii (Q,) or a scalar;
    leaf_max: at least the largest leaf. ≙ BVH::IntersectSphere."""
    dev = bvh.left_first.device
    c = torch.as_tensor(centers, dtype=torch.float32, device=dev)
    Q = c.shape[0]
    r = torch.broadcast_to(torch.as_tensor(radii, dtype=torch.float32,
                                           device=dev), (Q,))
    tris = packed_tris
    cur = torch.zeros(Q, dtype=torch.int64, device=dev)
    sp = torch.zeros(Q, dtype=torch.int64, device=dev)
    stack = torch.zeros((Q, STACK_DEPTH), dtype=torch.int64, device=dev)
    hit = torch.zeros(Q, dtype=torch.bool, device=dev)
    done = torch.zeros(Q, dtype=torch.bool, device=dev)
    lanes = torch.arange(leaf_max, device=dev)
    for _ in _steps(lambda: done):
        need_pop = (cur < 0) & ~done
        can_pop = need_pop & (sp > 0)
        sp0 = sp
        sp, top = _pop(stack, sp, can_pop)
        cur = torch.where(can_pop, top, cur)
        done = done | (need_pop & (sp0 == 0))

        proc = (cur >= 0) & ~done
        node = torch.clamp(cur, min=0)
        lf = bvh.left_first[node].long()
        ct = bvh.count[node].long()
        is_leaf = proc & (ct > 0)
        is_int = proc & (ct == 0)

        base = torch.where(is_leaf, lf, 0)
        idx = torch.clamp(base[:, None] + lanes, 0, tris.shape[0] - 1)
        t = tris[idx]                                       # (Q, L, 3, 3)
        ov = sphere_tri_overlap(c[:, None, :], r[:, None], t[:, :, 0],
                                t[:, :, 1], t[:, :, 2])
        lane_ok = lanes[None, :] < ct[:, None]
        hit = hit | (is_leaf & (ov & lane_ok).any(dim=1))
        done = done | hit

        lc = torch.where(is_int, lf, 0)
        ol = _sphere_aabb_overlap(c, r, bvh.node_min[lc],
                                  bvh.node_max[lc]) & is_int
        orr = _sphere_aabb_overlap(c, r, bvh.node_min[lc + 1],
                                   bvh.node_max[lc + 1]) & is_int
        sp = _push(stack, sp, ol & orr, lc + 1)
        cur = torch.where(is_int, torch.where(
            ol, lc, torch.where(orr, lc + 1, -1)), cur)
        cur = torch.where(is_leaf, -1, cur)
    return hit


def intersect_custom(bvh, rays: Rays, custom_intersect, t_max=BVH_FAR,
                     leaf_max: int = 4):
    """Closest hit over a BVH2 built on user AABBs with a user primitive
    test (≙ customIntersect, tiny_bvh.h:3270-3280).

    custom_intersect(o, d, prim_ids, t_cur) -> (hit_mask, t, u, v): o, d
    (R, 3), prim_ids (R, L) indexing the user's primitives, t_cur (R,);
    the returns (R, L) tensors."""
    o, d, rd = rays.o, rays.d, rays.rd
    dev = o.device
    R = o.shape[0]
    t = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32,
                                           device=dev), (R,)).clone()
    cur = torch.zeros(R, dtype=torch.int64, device=dev)
    sp = torch.zeros(R, dtype=torch.int64, device=dev)
    stack_node = torch.zeros((R, 64), dtype=torch.int64, device=dev)
    stack_dist = torch.zeros((R, 64), dtype=torch.float32, device=dev)
    u = torch.zeros(R, dtype=torch.float32, device=dev)
    v = torch.zeros(R, dtype=torch.float32, device=dev)
    prim = torch.full((R,), -1, dtype=torch.int64, device=dev)
    done = torch.zeros(R, dtype=torch.bool, device=dev)
    lanes = torch.arange(leaf_max, device=dev)
    n_prim = bvh.prim_idx.shape[0]
    for _ in _steps(lambda: done):
        need_pop = (cur < 0) & ~done
        can_pop = need_pop & (sp > 0)
        sp0 = sp
        _, pd = _pop(stack_dist, sp, can_pop)
        sp, pe = _pop(stack_node, sp, can_pop)
        take = can_pop & (pd < t)
        cur = torch.where(take, pe, cur)
        done = done | (need_pop & (sp0 == 0))

        proc = (cur >= 0) & ~done
        node = torch.clamp(cur, min=0)
        lf = bvh.left_first[node].long()
        ct = bvh.count[node].long()
        is_leaf = proc & (ct > 0)
        is_int = proc & (ct == 0)

        base = torch.where(is_leaf, lf, 0)
        pid = bvh.prim_idx[torch.clamp(base[:, None] + lanes, 0,
                                       n_prim - 1)].long()
        hitm, th, uh, vh = custom_intersect(o, d, pid, t)
        lane_ok = lanes[None, :] < ct[:, None]
        th = torch.where(hitm & lane_ok & is_leaf[:, None], th, BVH_FAR)
        bt, best = th.min(dim=1)                            # first argmin
        improved = bt < t
        pick = best[:, None]
        t = torch.where(improved, bt, t)
        u = torch.where(improved, uh.gather(1, pick)[:, 0], u)
        v = torch.where(improved, vh.gather(1, pick)[:, 0], v)
        prim = torch.where(improved, pid.gather(1, pick)[:, 0], prim)

        lc = torch.where(is_int, lf, 0)
        dl = slab_test(o, rd, t, bvh.node_min[lc], bvh.node_max[lc])
        dr = slab_test(o, rd, t, bvh.node_min[lc + 1], bvh.node_max[lc + 1])
        swap = dr < dl
        near_n = torch.where(swap, lc + 1, lc)
        far_n = torch.where(swap, lc, lc + 1)
        near_d = torch.minimum(dl, dr)
        far_d = torch.maximum(dl, dr)
        near_hit = is_int & (near_d < BVH_FAR)
        far_hit = is_int & (far_d < BVH_FAR)
        push = near_hit & far_hit
        _push(stack_dist, sp, push, far_d)
        sp = _push(stack_node, sp, push, far_n)
        cur = torch.where(is_int, torch.where(near_hit, near_n, -1), cur)
        cur = torch.where(is_leaf, -1, cur)
    ok = prim >= 0
    return Hits(t=torch.where(ok, t, BVH_FAR), u=u, v=v,
                prim=prim.to(torch.int32),
                inst=torch.full((R,), -1, dtype=torch.int32, device=dev))
