"""Closest hit on an instanced scene: `TLAS.intersect(rays[, t_max])`.

Kept from each call: t, inst and prim of the sampled rays. Judged
against the scene's plain reference on the same rays, its hit id split
into (inst, prim) by the scene:
  hit_mismatch_pct  share of the sampled rays, in %, whose (inst, prim)
                    is not the reference's (a hit where it misses, a miss
                    where it hits, or another triangle or instance);
  t_err_max         the largest |t - t_ref| / t_ref over the rays where
                    both hit the same triangle of the same instance."""

from __future__ import annotations

from types import SimpleNamespace

import torch

NUMBERS = ("hit_mismatch_pct", "t_err_max")


def call(tlas, rays, t_max):
    if t_max is None:
        return tlas.intersect(rays)
    return tlas.intersect(rays, t_max)


def keep(out, idx):
    return torch.stack([out.t[idx], out.inst[idx].to(torch.float32),
                        out.prim[idx].to(torch.float32)], 1)


def reference_answers(scene, o, d, t_max, precision):
    t, hit = scene.closest(o, d, 1e30 if t_max is None else t_max,
                           precision)
    inst, prim = scene.split(hit)
    return torch.stack([t, inst.to(torch.float32), prim.to(torch.float32)],
                       1)


def from_answers(ans):
    """Answers of reference_answers as the call returns them, for the
    control in the program's place."""
    return SimpleNamespace(t=ans[:, 0].contiguous(),
                           inst=ans[:, 1].to(torch.int32),
                           prim=ans[:, 2].to(torch.int32))


def judge(got, ref):
    same = (got[:, 1] == ref[:, 1]) & (got[:, 2] == ref[:, 2])
    both = same & (ref[:, 2] >= 0)
    err = ((got[:, 0] - ref[:, 0]).abs() / ref[:, 0])[both]
    return {"hit_mismatch_pct": 100.0 * float((~same).double().mean()),
            "t_err_max": float(err.max()) if err.numel() else 0.0}
