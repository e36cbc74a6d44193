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


TRI_TESTS = ("mt", "watertight", "baldwin")


def check_tri_test(tri_test: str) -> None:
    """Raise unless the port has the leaf test `tri_test`."""
    if tri_test in ("watertight", "baldwin"):
        raise NotImplementedError(
            f"tri_test={tri_test!r} is not ported yet (ROADMAP queue 1, "
            "item 2)")
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
