"""Ray / box and ray / triangle tests and the brute-force oracles
(≙ tinybvh_tpu/core/intersect.py):
  * slab test        — tinybvh_intersect_aabb (tiny_bvh.h:711-723)
  * Möller–Trumbore  — MOLLER_TRUMBORE (tiny_bvh.h:1644-1656)
  * watertight       — the WATERTIGHT_TRITEST path of IntersectTri
                       (Woop, Benthin & Wald 2013; tiny_bvh.h:8486-8507)
  * Baldwin–Weber    — PrecomputeTriangle and its transformed-coordinate
                       test (tiny_bvh.h:8577-8604)

Every test is batched over broadcast leading axes and written as eager
elementwise ops: each product is rounded on its own, never contracted
into an FMA (the watertight test relies on that). The oracles are the
ground truth of the port's tests and of chip_smoke.py. They run chunked
over triangles on whichever device the rays live on."""

from __future__ import annotations

import torch

from tinybvh_tpu_torch.core.rays import Hits, no_hits
from tinybvh_tpu_torch.core.vecmath import BVH_FAR, cross


def slab_test(o, rd, t_cur, bmin, bmax):
    """Entry distance of rays (..., 3) into boxes [bmin, bmax] (..., 3),
    BVH_FAR on a miss: a hit needs tmax >= tmin, tmin < t_cur and
    tmax >= 0 (≙ tinybvh_intersect_aabb, tiny_bvh.h:711-723)."""
    t1 = (bmin - o) * rd
    t2 = (bmax - o) * rd
    tmin = torch.minimum(t1, t2).amax(dim=-1)
    tmax = torch.maximum(t1, t2).amin(dim=-1)
    hit = (tmax >= tmin) & (tmin < t_cur) & (tmax >= 0.0)
    return torch.where(hit, tmin, BVH_FAR)


def tri_edges(tri):
    """(..., 3, 3) triangles -> (v0, e1, e2) each (..., 3)."""
    v0 = tri[..., 0, :]
    return v0, tri[..., 1, :] - v0, tri[..., 2, :] - v0


def moller_trumbore(o, d, v0, e1, e2, t_cur, backface_cull: bool = False):
    """Batched Möller–Trumbore; all args broadcast. A hit needs
    0 < t < t_cur and valid barycentrics; with backface_cull also a
    positive determinant. Returns (hit, t, u, v) with t = BVH_FAR where
    there is no hit."""
    h = cross(d, e2)
    det = (e1 * h).sum(-1)
    valid_det = det > 1e-9 if backface_cull else det.abs() > 1e-9
    inv_det = 1.0 / torch.where(valid_det, det, torch.ones_like(det))
    s = o - v0
    u = (s * h).sum(-1) * inv_det
    q = cross(s, e1)
    v = (d * q).sum(-1) * inv_det
    t = (e2 * q).sum(-1) * inv_det
    hit = (valid_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t > 0.0) & (t < t_cur))
    return hit, torch.where(hit, t, torch.full_like(t, BVH_FAR)), u, v


def _pick(x, k):
    """x[..., k] for a per-element index k broadcast against x[..., 0]."""
    shape = torch.broadcast_shapes(x.shape[:-1], k.shape)
    x = x.expand(shape + x.shape[-1:])
    return x.gather(-1, k.expand(shape)[..., None])[..., 0]


def moller_trumbore_watertight(o, d, rd, v0, v1, v2, t_cur):
    """Batched watertight ray / triangle test (≙ JAX
    moller_trumbore_watertight; the WATERTIGHT_TRITEST path,
    tiny_bvh.h:8486-8507). A ray through an edge or vertex shared by two
    triangles hits at least one of them: the edge functions are computed
    in a frame sheared along the ray, where a shared edge gives both
    triangles exactly negated values.

    Two rules keep that guarantee. The three vertices go through one
    subtraction over a stacked (..., 3, 3) tensor, so an input point
    gives bit-identical shear coordinates in every triangle. And each
    edge function is round(a b) - round(c d) with both products rounded
    apart: eager ops, never addcmul or a fused kernel, which could
    contract one product into an FMA. As in JAX, an edge value within a
    few ulps of its products counts as on the edge (both neighbours hit)
    and the determinant must clear that noise floor (degenerate
    triangles miss).

    o, d, rd: (..., 3) origin, direction, reciprocal direction; v0, v1,
    v2: (..., 3) raw vertices; t_cur: (...,). Returns (hit, t, u, v)."""
    kz = d.abs().argmax(dim=-1)                  # first index on ties
    kx0 = (kz + 1) % 3
    ky0 = (kz + 2) % 3
    neg = _pick(d, kz) < 0.0
    kx = torch.where(neg, ky0, kx0)
    ky = torch.where(neg, kx0, ky0)
    Sz = _pick(rd, kz)
    Sx = _pick(d, kx) * Sz
    Sy = _pick(d, ky) * Sz
    # reference naming: C = v0 - O, A = v1 - O, B = v2 - O, in one op
    P = torch.stack(torch.broadcast_tensors(v0, v1, v2), dim=-2) \
        - o[..., None, :]                        # (..., 3 points, xyz)

    def coord(k):                                # (..., 3 points)
        k = k.expand(torch.broadcast_shapes(k.shape, P.shape[:-2]))
        return P.gather(-1, k[..., None, None].expand(
            P.shape[:-1] + (1,)))[..., 0]

    Pz = coord(kz)
    Px = coord(kx) - Sx[..., None] * Pz
    Py = coord(ky) - Sy[..., None] * Pz
    Cx, Ax, Bx = Px.unbind(-1)
    Cy, Ay, By = Py.unbind(-1)
    pUa, pUb = Cx * By, Cy * Bx
    pVa, pVb = Ax * Cy, Ay * Cx
    pWa, pWb = Bx * Ay, By * Ax
    U = pUa - pUb
    V = pVa - pVb
    W = pWa - pWb
    eps = 4.0 * 2.0 ** -24
    tU = eps * (pUa.abs() + pUb.abs())
    tV = eps * (pVa.abs() + pVb.abs())
    tW = eps * (pWa.abs() + pWb.abs())
    same_sign = (((U >= -tU) & (V >= -tV) & (W >= -tW))
                 | ((U <= tU) & (V <= tV) & (W <= tW)))
    det = U + V + W
    det_ok = det.abs() > tU + tV + tW
    inv_det = 1.0 / torch.where(det != 0.0, det, torch.ones_like(det))
    T = (U * Sz * Pz[..., 1] + V * Sz * Pz[..., 2]
         + W * Sz * Pz[..., 0])
    t = T * inv_det
    hit = same_sign & det_ok & (t >= 0.0) & (t < t_cur)
    return (hit, torch.where(hit, t, torch.full_like(t, BVH_FAR)),
            U * inv_det, V * inv_det)


def precompute_baldwin_weber(tris):
    """(N, 3, 3) triangles -> (N, 12) Baldwin–Weber rows, a world to
    barycentric affine map per triangle (≙ JAX precompute_baldwin_weber;
    BVHBase::PrecomputeTriangle, tiny_bvh.h:8577-8604). The reference's
    three layouts, one per dominant normal axis, are all computed and
    the dominant one selected; a triangle with a zero normal gets a zero
    row."""
    tris = torch.as_tensor(tris, dtype=torch.float32)
    v0, v1, v2 = tris[:, 0], tris[:, 1], tris[:, 2]
    e1 = v1 - v0
    e2 = v2 - v0
    n = cross(e1, e2)
    nd = (v0 * n).sum(-1)
    dom = n.abs().argmax(dim=-1)

    def rows_for(ax):
        a1, a2 = (ax + 1) % 3, (ax + 2) % 3
        x1 = v1[:, a1] * v0[:, a2] - v1[:, a2] * v0[:, a1]
        x2 = v2[:, a1] * v0[:, a2] - v2[:, a2] * v0[:, a1]
        rn = 1.0 / torch.where(n[:, ax] != 0, n[:, ax], 1.0)
        T = torch.zeros((tris.shape[0], 12), dtype=torch.float32,
                        device=tris.device)
        T[:, a1] = e2[:, a2] * rn
        T[:, a2] = -e2[:, a1] * rn
        T[:, 3] = x2 * rn
        T[:, 4 + a1] = -e1[:, a2] * rn
        T[:, 4 + a2] = e1[:, a1] * rn
        T[:, 7] = -x1 * rn
        T[:, 8 + ax] = 1.0
        T[:, 8 + a1] = n[:, a1] * rn
        T[:, 8 + a2] = n[:, a2] * rn
        T[:, 11] = -nd * rn
        return T

    T = torch.where((dom == 0)[:, None], rows_for(0),
                    torch.where((dom == 1)[:, None], rows_for(1),
                                rows_for(2)))
    return torch.where((n.abs() > 0).any(-1)[:, None], T, 0.0)


def intersect_baldwin_weber(o, d, T, t_cur):
    """Batched Baldwin–Weber test over precomputed (..., 12) rows (≙ JAX
    intersect_baldwin_weber; the format the reference feeds its CWBVH
    triangles, tiny_bvh.h:6004-6009). Returns (hit, t, u, v)."""
    tr = T[..., 8:11]
    num = (tr * o).sum(-1) + T[..., 11]
    den = (tr * d).sum(-1)
    ok = den.abs() > 1e-20
    t = -num / torch.where(ok, den, torch.ones_like(den))
    p = o + t[..., None] * d
    u = (T[..., 0:3] * p).sum(-1) + T[..., 3]
    v = (T[..., 4:7] * p).sum(-1) + T[..., 7]
    hit = (ok & (t > 0.0) & (t < t_cur)
           & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0))
    return hit, torch.where(hit, t, torch.full_like(t, BVH_FAR)), u, v


def omap_cells(u, v, hit, S: int):
    """Micromap cells (iu, iv) of barycentrics u, v: floor(u S) and
    floor(v S) clamped to [0, S - 1] (≙ the engines' omap test, JAX
    wavefront.py:207-212 and wide.py:159-165). Only pairs that hit are
    converted; the others' u and v may be out of any range and get cell
    (0, 0)."""
    iu = torch.clamp(torch.where(hit, u * S, 0.0).to(torch.int64), 0, S - 1)
    iv = torch.clamp(torch.where(hit, v * S, 0.0).to(torch.int64), 0, S - 1)
    return iu, iv


TRI_TESTS = ("mt", "watertight", "baldwin")


def check_tri_test(tri_test: str) -> None:
    """Raise ValueError unless `tri_test` names one of TRI_TESTS."""
    if tri_test not in TRI_TESTS:
        raise ValueError(
            f"tri_test must be one of {TRI_TESTS}, got {tri_test!r}")


def leaf_intersect(tri_test, o, d, rd, v0, v1, v2, t_cur, bw_rows=None):
    """The engines' leaf triangle test, chosen by Config.tri_test (≙ JAX
    leaf_intersect; WATERTIGHT_TRITEST, tiny_bvh.h:131). v0/v1/v2 are
    the raw vertices: the watertight test needs bit-identical shared
    endpoints, which v0 + e1 would not give. bw_rows: (..., 12)
    precompute_baldwin_weber rows, needed for "baldwin" (which reads no
    vertex). Returns (hit, t, u, v)."""
    check_tri_test(tri_test)
    if tri_test == "mt":
        return moller_trumbore(o, d, v0, v1 - v0, v2 - v0, t_cur)
    if tri_test == "watertight":
        return moller_trumbore_watertight(o, d, rd, v0, v1, v2, t_cur)
    if bw_rows is None:
        raise ValueError("tri_test='baldwin' needs bw_rows "
                         "(precompute_baldwin_weber)")
    return intersect_baldwin_weber(o, d, bw_rows, t_cur)


def tri_aabb(tri):
    """Per-triangle AABB; (..., 3, 3) -> ((..., 3), (..., 3))."""
    return tri.amin(dim=-2), tri.amax(dim=-2)


def _dot(a, b):
    return (a * b).sum(-1)


def sphere_tri_overlap(center, r, v0, v1, v2):
    """Exact sphere-vs-triangle overlap (≙ JAX core/intersect.py; the
    closest point on the triangle of BVH::IntersectSphere,
    tiny_bvh.h:3153-3199, Ericson's Real-Time Collision Detection
    §5.1.5). center: (..., 3); r: (...,) or a scalar; vertices (..., 3).
    Returns (...,) bool."""
    ab = v1 - v0
    ac = v2 - v0
    ap = center - v0
    d1 = _dot(ab, ap)
    d2 = _dot(ac, ap)
    bp = center - v1
    d3 = _dot(ab, bp)
    d4 = _dot(ac, bp)
    cp = center - v2
    d5 = _dot(ab, cp)
    d6 = _dot(ac, cp)

    vc = d1 * d4 - d3 * d2
    vb = d5 * d2 - d1 * d6
    va = d3 * d6 - d5 * d4
    denom = torch.where(va + vb + vc == 0, 1.0, va + vb + vc)
    vv = vb / denom
    ww = vc / denom
    p = v0 + vv[..., None] * ab + ww[..., None] * ac

    def safe(x):
        return torch.where(x == 0, 1.0, x)

    # region tests, in the JAX order (the last true one wins)
    p = torch.where(((vc <= 0) & (d1 >= 0) & (d3 <= 0))[..., None],
                    v0 + (d1 / safe(d1 - d3))[..., None] * ab, p)
    p = torch.where(((vb <= 0) & (d2 >= 0) & (d6 <= 0))[..., None],
                    v0 + (d2 / safe(d2 - d6))[..., None] * ac, p)
    w2 = (d4 - d3) / safe((d4 - d3) + (d5 - d6))
    p = torch.where(((va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0))[..., None],
                    v1 + w2[..., None] * (v2 - v1), p)
    p = torch.where(((d1 <= 0) & (d2 <= 0))[..., None], v0, p)
    p = torch.where(((d3 >= 0) & (d4 <= d3))[..., None], v1, p)
    p = torch.where(((d6 >= 0) & (d5 <= d6))[..., None], v2, p)
    return _dot(center - p, center - p) <= r * r


def _chunks(tris, chunk):
    for base in range(0, tris.shape[0], chunk):
        yield base, tris[base:base + chunk]


def brute_force_closest(rays, tris, t_max=BVH_FAR, chunk: int = 4096) -> Hits:
    """O(R*N) closest hit in (0, t_max), chunked over triangles (tris
    (N, 3, 3) on the rays' device; t_max scalar or (R,))."""
    o, d = rays.o[:, None, :], rays.d[:, None, :]
    R = o.shape[0]
    hits = no_hits((R,), device=o.device)
    best_t = torch.broadcast_to(torch.as_tensor(
        t_max, dtype=torch.float32, device=o.device), (R,)).clone()
    for base, tc in _chunks(tris, chunk):
        v0, e1, e2 = tri_edges(tc)
        _, t, u, v = moller_trumbore(o, d, v0[None], e1[None], e2[None],
                                     best_t[:, None])
        bt, best = t.min(dim=1)
        better = bt < best_t
        best_t = torch.where(better, bt, best_t)
        bu = u.gather(1, best[:, None])[:, 0]
        bv = v.gather(1, best[:, None])[:, 0]
        hits.u = torch.where(better, bu, hits.u)
        hits.v = torch.where(better, bv, hits.v)
        hits.prim = torch.where(better, (best + base).to(torch.int32),
                                hits.prim)
    hits.t = torch.where(hits.prim >= 0, best_t,
                         torch.full_like(best_t, BVH_FAR))
    return hits


def brute_force_any(rays, tris, t_max, chunk: int = 4096) -> torch.Tensor:
    """O(R*N) any hit: True where something lies in (0, t_max)."""
    o, d = rays.o[:, None, :], rays.d[:, None, :]
    tm = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32,
                                            device=o.device), (o.shape[0],))
    occ = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    for _, tc in _chunks(tris, chunk):
        v0, e1, e2 = tri_edges(tc)
        hit, _, _, _ = moller_trumbore(o, d, v0[None], e1[None], e2[None],
                                       tm[:, None])
        occ |= hit.any(dim=1)
    return occ
