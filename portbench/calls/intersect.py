"""Closest hit: `BVH.intersect(rays, t_max)`.

Kept from each call: t and prim of the sampled rays. Judged against the
scene's plain reference on the same rays (prim: its hit id):
  prim_mismatch_pct  share of the sampled rays, in %, whose prim is not
                     the reference's (a hit where it misses, a miss where
                     it hits, or another triangle);
  t_err_max          the largest |t - t_ref| / t_ref over the rays where
                     both hit the same triangle;
  t_gap_max          the largest |t - t_ref| / t_scale over those rays,
                     t_scale = max(|o|, |o + t_ref d|) / |d|: the gap in
                     the hit point over the size of the coordinates that
                     float32 rounds, steady where t_ref is near 0 (a
                     bounce ray that meets a triangle crossing its
                     origin's).
A cell compares the numbers its check file gives limits for; judge also
gives t_ref_at_t_err_max, the reference's t of the ray that sets
t_err_max, to see what sets it."""

from __future__ import annotations

from types import SimpleNamespace

import torch

NUMBERS = ("prim_mismatch_pct", "t_err_max", "t_gap_max")


def call(bvh, rays, t_max):
    if t_max is None:
        return bvh.intersect(rays)
    return bvh.intersect(rays, t_max)


def keep(out, idx):
    return torch.stack([out.t[idx], out.prim[idx].to(torch.float32)], 1)


def reference_answers(scene, o, d, t_max, precision):
    t, prim = scene.closest(o, d, 1e30 if t_max is None else t_max,
                            precision)
    dn = torch.linalg.vector_norm(d, dim=1)
    far = torch.linalg.vector_norm(o + torch.where(prim >= 0, t, 0.0)[:, None]
                                   * d, dim=1)
    scale = torch.maximum(torch.linalg.vector_norm(o, dim=1), far) / dn
    return torch.stack([t, prim.to(torch.float32), scale], 1)


def from_answers(ans):
    """Answers of reference_answers as the call returns them, for the
    control in the program's place."""
    return SimpleNamespace(t=ans[:, 0].contiguous(),
                           prim=ans[:, 1].to(torch.int32))


def judge(got, ref):
    t, prim = got[:, 0], got[:, 1]
    rt, rprim, scale = ref[:, 0], ref[:, 1], ref[:, 2]
    same = (prim == rprim) & (rprim >= 0)
    err = ((t - rt).abs() / rt)[same]
    gap = ((t - rt).abs() / scale)[same]
    worst = int(err.argmax()) if err.numel() else None
    return {"prim_mismatch_pct":
            100.0 * float((prim != rprim).double().mean()),
            "t_err_max": float(err[worst]) if err.numel() else 0.0,
            "t_gap_max": float(gap.max()) if gap.numel() else 0.0,
            "t_ref_at_t_err_max": (float(rt[same][worst]) if err.numel()
                                   else None)}
