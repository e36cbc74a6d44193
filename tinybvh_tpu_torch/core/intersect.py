"""Möller–Trumbore and the brute-force oracles
(≙ tinybvh_tpu/core/intersect.py; MOLLER_TRUMBORE, tiny_bvh.h:1644-1656).

The oracles are the ground truth of the port's tests and of
chip_smoke.py. They run chunked over triangles on whichever device the
rays live on."""

from __future__ import annotations

import torch

from tinybvh_tpu_torch.core.rays import Hits, no_hits
from tinybvh_tpu_torch.core.vecmath import BVH_FAR, cross


def tri_edges(tri):
    """(..., 3, 3) triangles -> (v0, e1, e2) each (..., 3)."""
    v0 = tri[..., 0, :]
    return v0, tri[..., 1, :] - v0, tri[..., 2, :] - v0


def moller_trumbore(o, d, v0, e1, e2, t_cur):
    """Batched Möller–Trumbore; all args broadcast. A hit needs
    0 < t < t_cur and valid barycentrics. Returns (hit, t, u, v) with
    t = BVH_FAR where there is no hit."""
    h = cross(d, e2)
    det = (e1 * h).sum(-1)
    valid_det = det.abs() > 1e-9
    inv_det = 1.0 / torch.where(valid_det, det, torch.ones_like(det))
    s = o - v0
    u = (s * h).sum(-1) * inv_det
    q = cross(s, e1)
    v = (d * q).sum(-1) * inv_det
    t = (e2 * q).sum(-1) * inv_det
    hit = (valid_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t > 0.0) & (t < t_cur))
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
    """Raise unless the port has the leaf test `tri_test`."""
    if tri_test in ("watertight", "baldwin"):
        raise NotImplementedError(
            f"tri_test={tri_test!r} is not ported yet (JAX core/"
            "intersect.py moller_trumbore_watertight, "
            "intersect_baldwin_weber)")
    if tri_test not in TRI_TESTS:
        raise ValueError(
            f"tri_test must be one of {TRI_TESTS}, got {tri_test!r}")


def leaf_intersect(tri_test, o, d, rd, v0, v1, v2, t_cur):
    """The engines' leaf triangle test, chosen by Config.tri_test
    (≙ JAX leaf_intersect; WATERTIGHT_TRITEST, tiny_bvh.h:131). v0/v1/v2
    are the raw vertices; rd is read by the watertight test. Returns
    (hit, t, u, v)."""
    del rd
    check_tri_test(tri_test)
    return moller_trumbore(o, d, v0, v1 - v0, v2 - v0, t_cur)


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
