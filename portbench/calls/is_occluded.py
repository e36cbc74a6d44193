"""Any hit: `BVH.is_occluded(rays, t_max)`.

Kept from each call: the occlusion flag of the sampled rays. Judged
against the brute-force reference on the same rays:
  occ_mismatch_pct  share of the sampled rays, in %, whose flag is not
                    the reference's."""

from __future__ import annotations

import torch

from harness import reference

NUMBERS = ("occ_mismatch_pct",)


def call(bvh, rays, t_max):
    return bvh.is_occluded(rays, t_max)


def keep(out, idx):
    return out[idx].to(torch.float32)[:, None]


def reference_answers(tris, o, d, t_max, precision):
    return reference.occluded(tris, o, d, t_max,
                              precision).to(torch.float32)[:, None]


def from_answers(ans):
    """Answers of reference_answers as the call returns them, for the
    control in the program's place."""
    return ans[:, 0] > 0.5


def judge(got, ref):
    return {"occ_mismatch_pct":
            100.0 * float((got[:, 0] != ref[:, 0]).double().mean())}
