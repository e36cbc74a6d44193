"""The program's counter records of TLAS calls (tinybvh_tpu_torch/
_trace.py): rays, passes, discarded, syncs, visits, discarded_visits and
entries of each traced `TLAS.intersect` / `is_occluded`, stamped inside
the first traced stretch's device window. The program leaves some counts
on the device as 0-dim tensors; they are read here, after the window,
where waiting for them costs the calls nothing. None where there are
none: a program without them (an older commit), or a trace without TLAS
calls."""

from __future__ import annotations

import torch

from harness.spans import records


def tlas_records(trace):
    recs = records(trace)
    out = [{k: int(v) if isinstance(v, torch.Tensor) else v
            for k, v in r.items()}
           for r in recs or () if str(r.get("api", "")).startswith("tlas_")]
    return out or None


def total(recs, key) -> float:
    return float(sum(r.get(key, 0) for r in recs))
