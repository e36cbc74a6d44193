"""Double-precision BVH and TLAS (≙ tinybvh_tpu/ops/f64.py; BVH_Double,
tiny_bvh.h:7898-8378, BLASInstanceEx 8432-8474).

The build is the JAX package's serial binned-SAH build in float64 numpy
on the host (this module's own copy, `_sah_build_f64`), array for array;
its tables go to the device once. The queries run on the device in torch
float64 (the H100 has f64 units, a TPU has none, so JAX loops over rays
in numpy): lockstep engines that advance every ray one stack entry a
step, in the JAX loop's order, so that ties resolve as there:

  * closest hit pops (node, entry distance), skips it when the distance
    is not below t, tests a leaf's triangles in order (|det| < 1e-12
    rejected, 1e-12 < t' < t accepted, the first of equal t' kept), and
    pushes an interior node's hit children far first, so that the near
    one pops first, the left one on equal entry distance; the root's box
    is never tested;
  * any hit tests every popped box, the root's too, pushes the left
    child then the right, and stops a ray at its first hit.

Each ray has a stack of (tree depth + 3) entries, the depth found at
build time. The loop is traverse/stack.py's `lockstep`: the host reads
whether any ray is still running every few steps (one sync), and then
compacts the running rays when at most half of the batch is left.
`last_call` on each structure holds its last query's steps, host syncs
and compactions. Rounding: the products and sums are the JAX loop's,
written as separate tensor ops (no `@`, no fused multiply-add between
ops), so t, u and v agree with numpy's to an ulp of its dot products."""

from __future__ import annotations

import sys

import numpy as np
import torch

from tinybvh_tpu_torch.core.rays import default_device
from tinybvh_tpu_torch.core.vecmath import C_INT, C_TRAV, cross
from tinybvh_tpu_torch.traverse.stack import lockstep

FAR = 1e300
_F64 = torch.float64
_I64 = torch.int64


def _sah_build_f64(fmin, fmax, max_leaf=4, bins=8):
    """Serial binned-SAH build in f64 over per-primitive AABBs (the JAX
    package's, line for line).

    Shared by BVHDouble (triangles) and TLASDouble (instance world AABBs,
    like the reference building its double TLAS with the same builder,
    tiny_bvh.h:7943-7979). Returns SoA arrays
    (node_min, node_max, left_first, count, prim_idx, n_nodes).
    """
    N = fmin.shape[0]
    cent = (fmin + fmax) / 2
    M = 2 * N + 2
    node_min = np.full((M, 3), FAR)
    node_max = np.full((M, 3), -FAR)
    left_first = np.zeros(M, np.int64)
    count = np.zeros(M, np.int64)
    idx = np.arange(N)
    node_min[0] = fmin.min(axis=0)
    node_max[0] = fmax.max(axis=0)
    n_used = [2]
    order = []

    def ha(mn, mx):
        e = np.maximum(mx - mn, 0)
        return e[..., 0] * e[..., 1] + e[..., 1] * e[..., 2] + e[..., 2] * e[..., 0]

    def build(node, ids):
        if len(ids) <= 1:
            count[node] = len(ids)
            left_first[node] = len(order)
            order.extend(ids.tolist())
            return
        c = cent[ids]
        cmin, cmax = c.min(axis=0), c.max(axis=0)
        ext = cmax - cmin
        best = (FAR, -1, -1)
        for ax in range(3):
            if ext[ax] < 1e-300:
                continue
            b = np.clip(((c[:, ax] - cmin[ax]) * bins * 0.999999
                         / ext[ax]).astype(int), 0, bins - 1)
            cnt = np.bincount(b, minlength=bins)
            bmn = np.full((bins, 3), FAR)
            bmx = np.full((bins, 3), -FAR)
            np.minimum.at(bmn, b, fmin[ids])
            np.maximum.at(bmx, b, fmax[ids])
            lmin = np.minimum.accumulate(bmn, 0)
            lmax = np.maximum.accumulate(bmx, 0)
            rmin = np.minimum.accumulate(bmn[::-1], 0)[::-1]
            rmax = np.maximum.accumulate(bmx[::-1], 0)[::-1]
            nl = np.cumsum(cnt)[:-1]
            nr = cnt.sum() - nl
            cost = np.where(
                (nl == 0) | (nr == 0), FAR,
                ha(lmin[:-1], lmax[:-1]) * nl + ha(rmin[1:], rmax[1:]) * nr,
            )
            k = int(np.argmin(cost))
            if cost[k] < best[0]:
                best = (cost[k], ax, k, b)
        area = ha(node_min[node], node_max[node])
        no_split = C_INT * len(ids)
        if best[1] >= 0:
            split = C_TRAV + C_INT * best[0] / max(area, 1e-300)
        else:
            split = FAR
        if (split >= no_split and len(ids) <= (max_leaf or len(ids))) or \
           best[1] < 0:
            count[node] = len(ids)
            left_first[node] = len(order)
            order.extend(ids.tolist())
            return
        _, ax, k, b = best
        lm = b <= k
        lids, rids = ids[lm], ids[~lm]
        if not len(lids) or not len(rids):
            half = len(ids) // 2
            o2 = np.argsort(c[:, ax], kind="stable")
            lm = np.zeros(len(ids), bool)
            lm[o2[:half]] = True
            lids, rids = ids[lm], ids[~lm]
        l = n_used[0]
        n_used[0] += 2
        left_first[node] = l
        count[node] = 0
        for child, cids in ((l, lids), (l + 1, rids)):
            node_min[child] = fmin[cids].min(axis=0)
            node_max[child] = fmax[cids].max(axis=0)
            build(child, cids)

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(100000)
    try:
        build(0, idx)
    finally:
        sys.setrecursionlimit(old)
    return (node_min, node_max, left_first, count,
            np.asarray(order, np.int64), n_used[0])


def _depth(left_first, count):
    """The tree's depth (the root's is 0), a level at a time on the host."""
    level = np.zeros(1, np.int64)
    depth = 0
    while True:
        inner = level[count[level] == 0]
        if not len(inner):
            return depth
        level = np.concatenate([left_first[inner], left_first[inner] + 1])
        depth += 1


def _host64(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def _rays(o, d, device):
    """Ray origins and directions (numpy or tensors) as (R, 3) float64
    tensors on `device`."""
    return tuple(torch.as_tensor(x if isinstance(x, torch.Tensor)
                                 else _host64(x), dtype=_F64,
                                 device=device).reshape(-1, 3)
                 for x in (o, d))


def _rcp(d):
    """The JAX loop's safe reciprocal (:146-147): 1/d where |d| > 1e-300,
    else +-FAR by the sign of d."""
    inv = 1.0 / torch.where(d == 0, torch.ones_like(d), d)
    far = torch.full_like(d, FAR)
    return torch.where(d.abs() > 1e-300, inv, torch.where(d < 0, -far, far))


def _dot(a, b):
    """Three products summed left to right (a sum over the last axis may
    pair them otherwise)."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _slab(o, rd, mn, mx):
    """(tmin, tmax) of boxes (W, ..., 3) for rays (W, 3), as the JAX loop
    computes them (NaN propagates through min and max, as in numpy)."""
    shape = (o.shape[0],) + (1,) * (mn.dim() - 2) + (3,)
    o = o.reshape(shape)
    rd = rd.reshape(shape)
    t1 = (mn - o) * rd
    t2 = (mx - o) * rd
    return (torch.minimum(t1, t2).amax(dim=-1),
            torch.maximum(t1, t2).amin(dim=-1))


class _Nodes:
    """BVH nodes on a device: boxes, left_first and count."""

    def __init__(self, node_min, node_max, left, count, device):
        def put(x, dtype):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

        self.node_min = put(node_min, _F64)
        self.node_max = put(node_max, _F64)
        self.left = put(left, _I64)
        self.count = put(count, _I64)

    def push_ordered(self, node, o, rd, t, stk_n, stk_d, sp, mask):
        """Both children of interior `node` against (o, rd): those with
        tmax >= tmin, tmin < t and tmax >= 0 are pushed, the far one
        first, so that the near one pops first (the JAX loop's
        `hits.sort(reverse=True)` over (tmin, ch): on equal tmin the
        right one is pushed first and the left one pops first). Returns
        the new sp."""
        l = self.left[node]
        ch = torch.stack([l, l + 1], dim=1)
        tmin, tmax = _slab(o, rd, self.node_min[ch], self.node_max[ch])
        hit = ((tmax >= tmin) & (tmin < t[:, None]) & (tmax >= 0)
               & mask[:, None])
        hl, hr = hit[:, 0], hit[:, 1]
        # bottom entry: the far child of two (the right one on equal
        # tmin, so that the left one pops first), else the one that hit
        first = torch.where(hl & hr, tmin[:, 0] <= tmin[:, 1], ~hl).long()
        rows = torch.arange(node.shape[0], device=node.device)
        for at, col in ((sp, first), (sp + 1, 1 - first)):
            stk_n[rows, at] = ch[rows, col]
            stk_d[rows, at] = tmin[rows, col]
        return sp + hl.long() + hr.long()

    def push_both(self, node, stk_n, sp, mask):
        """Push l then l + 1 (l + 1 pops first) for interior `node`."""
        l = self.left[node]
        rows = torch.arange(node.shape[0], device=node.device)
        stk_n[rows, sp] = l
        stk_n[rows, sp + 1] = l + 1
        return sp + 2 * mask.long()

    def box_ok(self, node, o, rd, t_max):
        """The any-hit loop's box test of the popped `node`."""
        tmin, tmax = _slab(o, rd, self.node_min[node], self.node_max[node])
        return ~((tmax < tmin) | (tmin >= t_max) | (tmax < 0))


class _Tables(_Nodes):
    """One or more f64 BVHs on a device, merged: their nodes (node
    offsets folded into the interior nodes' left_first, triangle offsets
    into the leaves'), the triangles in leaf order as (v0, e1, e2) and
    their prim ids (each within its own BVH). roots: each BVH's root."""

    def __init__(self, trees, device):
        lfs, tris, self.roots = [], [], []
        n_node = n_tri = 0
        for tree in trees:
            lf = tree.left_first.copy()
            inner = tree.count == 0
            lf[inner] += n_node
            lf[~inner] += n_tri
            lfs.append(lf)
            tris.append(tree.tris[tree.prim_idx])
            self.roots.append(n_node)
            n_node += len(lf)
            n_tri += len(tree.prim_idx)
        count = np.concatenate([t.count for t in trees])
        super().__init__(np.concatenate([t.node_min for t in trees]),
                         np.concatenate([t.node_max for t in trees]),
                         np.concatenate(lfs), count, device)
        tris = torch.as_tensor(np.concatenate(tris), dtype=_F64,
                               device=device)
        self.v0 = tris[:, 0]
        self.e1 = tris[:, 1] - tris[:, 0]
        self.e2 = tris[:, 2] - tris[:, 0]
        self.prim = torch.as_tensor(
            np.concatenate([t.prim_idx for t in trees]), dtype=_I64,
            device=device)
        # a leaf holds more than max_leaf prims where every centroid
        # coincides: the lanes cover the largest leaf
        self.lanes = torch.arange(max(int(count.max()), 1), device=device)
        self.stack = max(t.depth for t in trees) + 3

    def leaf_hits(self, node, o, d, t):
        """The leaf test of each ray's leaf `node` (W,): ok (W, lanes),
        t', u', v' (W, lanes), in the JAX loop's order of operations. ok
        needs |det| >= 1e-12, the barycentric tests as written there and
        1e-12 < t' < t; lanes past the leaf's count never hit."""
        k = torch.clamp(self.left[node][:, None] + self.lanes[None, :],
                        max=self.v0.shape[0] - 1)
        v0, e1, e2 = self.v0[k], self.e1[k], self.e2[k]
        o, d = o[:, None, :], d[:, None, :]
        h = cross(d, e2)
        det = _dot(e1, h)
        inv = 1.0 / det
        sv = o - v0
        uu = _dot(sv, h) * inv
        q = cross(sv, e1)
        vv = _dot(d, q) * inv
        tt = _dot(e2, q) * inv
        ok = (~(det.abs() < 1e-12) & ~((uu < 0) | (uu > 1))
              & ~((vv < 0) | (uu + vv > 1)) & (tt > 1e-12)
              & (tt < t[:, None])
              & (self.lanes[None, :] < self.count[node][:, None]))
        return ok, tt, uu, vv

    def closest_leaf(self, node, o, d, s, mask, inst=None):
        """The leaf test of rays `mask` at leaf `node`, applied to the
        state's t, u, v and prim (and inst, set to `inst` where a hit
        lands): the least t', the first lane of equal ones, as the JAX
        loop's strict t' < t keeps it."""
        ok, tt, uu, vv = self.leaf_hits(node, o, d, s["t"])
        ok &= mask[:, None]
        best = torch.argmin(torch.where(ok, tt, torch.inf), dim=1,
                            keepdim=True)
        got = ok.any(dim=1)
        for key, x in (("t", tt), ("u", uu), ("v", vv)):
            s[key] = torch.where(got, torch.gather(x, 1, best)[:, 0], s[key])
        k = torch.clamp(self.left[node] + best[:, 0],
                        max=self.prim.shape[0] - 1)
        s["prim"] = torch.where(got, self.prim[k], s["prim"])
        if inst is not None:
            s["inst"] = torch.where(got, inst, s["inst"])


def _pop(stk, sp, active):
    """The top entry of every row (row 0's entry where the stack is
    empty), and sp lowered for the active rows."""
    rows = torch.arange(sp.shape[0], device=sp.device)
    top = torch.clamp(sp - 1, min=0)
    return [x[rows, top] for x in stk], sp - active.long()


def _lockstep(state, step, running, out, stats):
    """Run step(state) until running(state) holds nowhere (stack.lockstep).
    A compaction writes every row's results to `out` and keeps the
    running rows alone in the state. Writes the results of every row to
    `out` (keys of out, indexed by the state's "ids")."""
    def compact(live):
        for k, v in out.items():
            v[state["ids"]] = state[k]
        keep = torch.nonzero(live).squeeze(1)
        for k in state:
            state[k] = state[k][keep]

    for _ in lockstep(lambda: running(state), stats, compact):
        step(state)
    for k, v in out.items():
        v[state["ids"]] = state[k]


def _t_init(t_max, R, dev):
    t = torch.as_tensor(t_max, dtype=_F64, device=dev)
    return torch.clamp(torch.broadcast_to(t, (R,)), max=FAR).clone()


def _results(R, dev, inst=False):
    out = dict(t=torch.zeros(R, dtype=_F64, device=dev),
               u=torch.zeros(R, dtype=_F64, device=dev),
               v=torch.zeros(R, dtype=_F64, device=dev),
               prim=torch.full((R,), -1, dtype=_I64, device=dev))
    if inst:
        out["inst"] = torch.full((R,), -1, dtype=_I64, device=dev)
    return out


def _new_stats():
    return dict(steps=0, syncs=0, compactions=0)


class BVHDouble:
    """Build + traverse in float64. API mirrors api.BVH. The build runs on
    the host; the tables and the queries on `device` (default: the card,
    core.rays.default_device)."""

    def __init__(self, tris, max_leaf: int = 4, device=None):
        self.device = default_device(device)
        tris = _host64(tris)
        if tris.ndim != 3 or tris.shape[1:] != (3, 3) or not len(tris):
            raise ValueError(f"triangles must be (N, 3, 3), got {tris.shape}")
        self.tris = tris
        self._build(max_leaf)
        self.last_call = _new_stats()

    # -- build: serial binned SAH, f64 throughout, on the host -----------
    def _build(self, max_leaf, bins=8):
        tris = self.tris
        fmin = tris.min(axis=1)
        fmax = tris.max(axis=1)
        (self.node_min, self.node_max, self.left_first, self.count,
         self.prim_idx, self.n_nodes) = _sah_build_f64(
            fmin, fmax, max_leaf, bins)
        self.depth = _depth(self.left_first, self.count)
        self._tables = _Tables([self], self.device)

    # -- traversal: lockstep over every ray, f64, on the device ----------
    def intersect(self, o, d, t_max=FAR):
        """o, d: (R, 3) → dict(t, u, v, prim): float64 and int64 tensors on
        the structure's device. t_max: scalar or (R,)."""
        o, d = _rays(o, d, self.device)
        R = o.shape[0]
        dev = self.device
        tb = self._tables
        s = dict(ids=torch.arange(R, device=dev), o=o, d=d, rd=_rcp(d),
                 t=_t_init(t_max, R, dev),
                 u=torch.zeros(R, dtype=_F64, device=dev),
                 v=torch.zeros(R, dtype=_F64, device=dev),
                 prim=torch.full((R,), -1, dtype=_I64, device=dev),
                 sn=torch.zeros((R, tb.stack), dtype=_I64, device=dev),
                 sd=torch.zeros((R, tb.stack), dtype=_F64, device=dev),
                 sp=torch.ones(R, dtype=_I64, device=dev))

        def step(s):
            active = s["sp"] > 0
            (node, dist), s["sp"] = _pop((s["sn"], s["sd"]), s["sp"], active)
            live = active & ~(dist >= s["t"])
            leaf = tb.count[node] > 0
            tb.closest_leaf(node, s["o"], s["d"], s, live & leaf)
            s["sp"] = tb.push_ordered(node, s["o"], s["rd"], s["t"], s["sn"],
                                      s["sd"], s["sp"], live & ~leaf)

        out = _results(R, dev)
        self.last_call = _new_stats()
        _lockstep(s, step, lambda s: s["sp"] > 0, out, self.last_call)
        return out

    def is_occluded(self, o, d, t_max=FAR):
        """(R,) bool tensor: any hit with 1e-12 < t < t_max, early exit per
        ray (≙ the reference's BVH_Double::IsOccluded,
        tiny_bvh.h:8270-8361)."""
        o, d = _rays(o, d, self.device)
        R = o.shape[0]
        dev = self.device
        tb = self._tables
        s = dict(ids=torch.arange(R, device=dev), o=o, d=d, rd=_rcp(d),
                 tmax=torch.broadcast_to(torch.as_tensor(
                     t_max, dtype=_F64, device=dev), (R,)).clone(),
                 occ=torch.zeros(R, dtype=torch.bool, device=dev),
                 sn=torch.zeros((R, tb.stack), dtype=_I64, device=dev),
                 sp=torch.ones(R, dtype=_I64, device=dev))

        def step(s):
            active = (s["sp"] > 0) & ~s["occ"]
            (node,), s["sp"] = _pop((s["sn"],), s["sp"], active)
            live = active & tb.box_ok(node, s["o"], s["rd"], s["tmax"])
            leaf = tb.count[node] > 0
            ok, *_ = tb.leaf_hits(node, s["o"], s["d"], s["tmax"])
            s["occ"] = s["occ"] | (live & leaf & ok.any(dim=1))
            s["sp"] = tb.push_both(node, s["sn"], s["sp"], live & ~leaf)

        out = dict(occ=torch.zeros(R, dtype=torch.bool, device=dev))
        self.last_call = _new_stats()
        _lockstep(s, step, lambda s: (s["sp"] > 0) & ~s["occ"], out,
                  self.last_call)
        return out["occ"]

    def sah_cost(self):
        def ha(mn, mx):
            e = np.maximum(mx - mn, 0)
            return e[0] * e[1] + e[1] * e[2] + e[2] * e[0]

        total = 0.0
        stack = [0]
        while stack:
            n = stack.pop()
            a = ha(self.node_min[n], self.node_max[n])
            if self.count[n] > 0:
                total += C_INT * self.count[n] * a
            else:
                total += C_TRAV * a
                stack.extend((self.left_first[n], self.left_first[n] + 1))
        return total / max(ha(self.node_min[0], self.node_max[0]), 1e-300)


class BLASInstanceEx:
    """Double-precision BLAS instance (≙ BLASInstanceEx,
    tiny_bvh.h:8432-8474): 4x4 f64 transform + inverse (host numpy; a
    singular transform raises numpy's LinAlgError) + world-space AABB of
    the referenced BLAS root, plus the 16-bit visibility mask."""

    def __init__(self, blas_id: int, transform=None, mask: int = 0xFFFF):
        self.blas_id = int(blas_id)
        self.mask = int(mask)
        t = np.eye(4) if transform is None else _host64(
            transform).reshape(4, 4)
        self.transform = t
        self.inv = np.linalg.inv(t)
        self.aabb_min = None  # world AABB, set by TLASDouble from the BLAS
        self.aabb_max = None

    def update(self, blas: BVHDouble):
        """Transform the BLAS root AABB into world space: the box of its 8
        transformed corners (≙ BLASInstanceEx::Update,
        tiny_bvh.h:8442-8456)."""
        mn, mx = blas.node_min[0], blas.node_max[0]
        cs = np.array([[x, y, z, 1.0]
                       for x in (mn[0], mx[0])
                       for y in (mn[1], mx[1])
                       for z in (mn[2], mx[2])], np.float64)
        wc = cs @ self.transform.T
        self.aabb_min = wc[:, :3].min(axis=0)
        self.aabb_max = wc[:, :3].max(axis=0)


class TLASDouble:
    """Double-precision two-level structure: a SAH BVH over instance world
    AABBs whose leaves dispatch into per-instance BVHDouble BLASes
    (≙ BVH_Double::Build(BLASInstanceEx*,...) + IntersectTLAS,
    tiny_bvh.h:7943-7979, 8203-8268). The TLAS nodes, the instances'
    inverses and masks and every BLAS's tables (merged into one set) go
    to `device` (default: the card) once.

    The queries are two-level lockstep engines: a ray in a TLAS leaf runs
    the leaf's instances in order, one BLAS traversal at a time in that
    instance's space, before it pops its TLAS stack again."""

    def __init__(self, instances: list, blasses: list, device=None):
        self.device = default_device(device)
        self.instances = instances
        self.blasses = blasses
        for inst in instances:
            inst.update(blasses[inst.blas_id])
        fmin = np.stack([i.aabb_min for i in instances])
        fmax = np.stack([i.aabb_max for i in instances])
        (self.node_min, self.node_max, self.left_first, self.count,
         self.inst_idx, self.n_nodes) = _sah_build_f64(
            fmin, fmax, max_leaf=2)
        self.depth = _depth(self.left_first, self.count)
        self.last_call = _new_stats()
        dev = self.device
        self._top = _Nodes(self.node_min, self.node_max, self.left_first,
                           self.count, dev)
        self._blas = _Tables(blasses, dev)
        self._stack = self.depth + 3

        def put(x):
            return torch.as_tensor(np.asarray(x), device=dev)

        self._inst_idx = put(self.inst_idx)
        self._inv = put(np.stack([i.inv for i in instances]))
        self._mask = put(np.asarray([i.mask for i in instances], np.int64))
        self._root = put(np.asarray([self._blas.roots[i.blas_id]
                                     for i in instances], np.int64))

    def _state(self, o, d, mask, dists):
        """The per-ray state: the rays (world space), their masks, the
        TLAS stack, and the instance in flight: `leaf` and `slot` (the
        TLAS leaf and the place in its instance list), `cur` (the
        instance), the ray in its space (ol, dl, rdl) and its BLAS stack.
        in_blas: the ray is in a TLAS leaf. dists: the stacks carry entry
        distances (closest hit)."""
        o, d = _rays(o, d, self.device)
        R = o.shape[0]
        dev = self.device

        def zeros(*shape, dtype=_I64):
            return torch.zeros((R,) + shape, dtype=dtype, device=dev)

        s = dict(ids=torch.arange(R, device=dev), o=o, d=d, rd=_rcp(d),
                 mask=torch.broadcast_to(torch.as_tensor(
                     mask, dtype=_I64, device=dev), (R,)).clone(),
                 tn=zeros(self._stack), tsp=torch.ones(R, dtype=_I64,
                                                       device=dev),
                 bn=zeros(self._blas.stack), bsp=zeros(),
                 in_blas=zeros(dtype=torch.bool), leaf=zeros(),
                 slot=zeros(), cur=zeros(), ol=zeros(3, dtype=_F64),
                 dl=zeros(3, dtype=_F64), rdl=zeros(3, dtype=_F64))
        if dists:
            s.update(td=zeros(self._stack, dtype=_F64),
                     bd=zeros(self._blas.stack, dtype=_F64))
        return s

    def _next_instance(self, s, go):
        """Rays `go` (in a TLAS leaf, their BLAS stack empty) move to the
        leaf's next slot. Those past the leaf's last instance leave it;
        those whose instance shares a mask bit with the ray enter it: the
        ray mapped into its space (inv @ (o, 1) and inv[:3, :3] @ d, the
        direction not renormalised, tiny_bvh.h:8232) and the BLAS root on
        the BLAS stack at entry distance 0."""
        s["slot"] = s["slot"] + go.long()
        within = s["slot"] < self._top.count[s["leaf"]]
        k = torch.clamp(self._top.left[s["leaf"]] + s["slot"],
                        max=self._inst_idx.shape[0] - 1)
        ii = self._inst_idx[k]
        enter = go & within & ((self._mask[ii] & s["mask"]) != 0)
        s["in_blas"] = s["in_blas"] & ~(go & ~within)
        m = self._inv[ii]

        def apply(x, w):
            return (m[:, :3, 0] * x[:, None, 0] + m[:, :3, 1] * x[:, None, 1]
                    + m[:, :3, 2] * x[:, None, 2] + w)

        dl = apply(s["d"], 0.0)
        e = enter[:, None]
        s["ol"] = torch.where(e, apply(s["o"], m[:, :3, 3]), s["ol"])
        s["dl"] = torch.where(e, dl, s["dl"])
        s["rdl"] = torch.where(e, _rcp(dl), s["rdl"])
        s["cur"] = torch.where(enter, ii, s["cur"])
        s["bn"][:, 0] = torch.where(enter, self._root[ii], s["bn"][:, 0])
        if "bd" in s:
            s["bd"][:, 0] = torch.where(enter, 0.0, s["bd"][:, 0])
        s["bsp"] = torch.where(enter, 1, s["bsp"])

    def _enter_leaf(self, s, tnode, into):
        s["in_blas"] = s["in_blas"] | into
        s["leaf"] = torch.where(into, tnode, s["leaf"])
        s["slot"] = torch.where(into, -1, s["slot"])

    def intersect(self, o, d, t_max=FAR, mask=0xFFFF):
        """Closest hit over all instances. Returns dict with world-space t,
        barycentric u/v (float64), prim id within the BLAS and instance
        id (int64), tensors on the structure's device. t_max and mask:
        scalars or (R,). A BLAS hit is kept only below the ray's t, so
        the first instance in the JAX loop's order wins a tie."""
        s = self._state(o, d, mask, True)
        R = s["o"].shape[0]
        dev = self.device
        s.update(t=_t_init(t_max, R, dev),
                 u=torch.zeros(R, dtype=_F64, device=dev),
                 v=torch.zeros(R, dtype=_F64, device=dev),
                 prim=torch.full((R,), -1, dtype=_I64, device=dev),
                 inst=torch.full((R,), -1, dtype=_I64, device=dev))
        blas, top = self._blas, self._top

        def step(s):
            in_blas = s["in_blas"]
            # a step of the instance in flight: its own closest-hit loop
            # at the ray's current t
            b_act = in_blas & (s["bsp"] > 0)
            (bnode, bdist), s["bsp"] = _pop((s["bn"], s["bd"]), s["bsp"],
                                            b_act)
            b_live = b_act & ~(bdist >= s["t"])
            b_leaf = blas.count[bnode] > 0
            blas.closest_leaf(bnode, s["ol"], s["dl"], s, b_live & b_leaf,
                              inst=s["cur"])
            s["bsp"] = blas.push_ordered(bnode, s["ol"], s["rdl"], s["t"],
                                         s["bn"], s["bd"], s["bsp"],
                                         b_live & ~b_leaf)
            self._next_instance(s, in_blas & ~b_act)
            # a TLAS step
            t_act = ~in_blas & (s["tsp"] > 0)
            (tnode, tdist), s["tsp"] = _pop((s["tn"], s["td"]), s["tsp"],
                                            t_act)
            t_live = t_act & ~(tdist >= s["t"])
            t_leaf = top.count[tnode] > 0
            self._enter_leaf(s, tnode, t_live & t_leaf)
            s["tsp"] = top.push_ordered(tnode, s["o"], s["rd"], s["t"],
                                        s["tn"], s["td"], s["tsp"],
                                        t_live & ~t_leaf)

        out = _results(R, dev, inst=True)
        self.last_call = _new_stats()
        _lockstep(s, step, lambda s: s["in_blas"] | (s["tsp"] > 0), out,
                  self.last_call)
        return out

    def is_occluded(self, o, d, t_max=FAR, mask=0xFFFF):
        """(R,) bool tensor: any hit with 1e-12 < t < t_max over all
        instances, early exit (≙ IsOccludedTLAS, tiny_bvh.h:8300-8361).
        t_max and mask: scalars or (R,)."""
        s = self._state(o, d, mask, False)
        R = s["o"].shape[0]
        dev = self.device
        s.update(tmax=torch.broadcast_to(torch.as_tensor(
                     t_max, dtype=_F64, device=dev), (R,)).clone(),
                 occ=torch.zeros(R, dtype=torch.bool, device=dev))
        blas, top = self._blas, self._top

        def step(s):
            run = ~s["occ"]
            in_blas = s["in_blas"] & run
            b_act = in_blas & (s["bsp"] > 0)
            (bnode,), s["bsp"] = _pop((s["bn"],), s["bsp"], b_act)
            b_live = b_act & blas.box_ok(bnode, s["ol"], s["rdl"],
                                         s["tmax"])
            b_leaf = blas.count[bnode] > 0
            ok, *_ = blas.leaf_hits(bnode, s["ol"], s["dl"], s["tmax"])
            s["occ"] = s["occ"] | (b_live & b_leaf & ok.any(dim=1))
            s["bsp"] = blas.push_both(bnode, s["bn"], s["bsp"],
                                      b_live & ~b_leaf)
            self._next_instance(s, in_blas & ~b_act)
            t_act = run & ~in_blas & (s["tsp"] > 0)
            (tnode,), s["tsp"] = _pop((s["tn"],), s["tsp"], t_act)
            t_live = t_act & top.box_ok(tnode, s["o"], s["rd"], s["tmax"])
            t_leaf = top.count[tnode] > 0
            self._enter_leaf(s, tnode, t_live & t_leaf)
            s["tsp"] = top.push_both(tnode, s["tn"], s["tsp"],
                                     t_live & ~t_leaf)

        out = dict(occ=torch.zeros(R, dtype=torch.bool, device=dev))
        self.last_call = _new_stats()
        _lockstep(s, step,
                  lambda s: ~s["occ"] & (s["in_blas"] | (s["tsp"] > 0)),
                  out, self.last_call)
        return out["occ"]
