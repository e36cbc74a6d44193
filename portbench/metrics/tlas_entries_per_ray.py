"""tlas_entries_per_ray (entries/ray): the instance entries (a ray moved
into an instance's frame to walk its BLAS) of the pass that answered each
TLAS call, per ray, over the TLAS calls of the first traced stretch: the
program's counter records' `entries` over `rays`
(tinybvh_tpu_torch/tlas/instance.py)."""

from harness.tlas_records import tlas_records, total


def read(trace):
    recs = tlas_records(trace)
    if recs is None:
        return None
    return total(recs, "entries") / total(recs, "rays")
