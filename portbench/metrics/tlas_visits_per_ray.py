"""tlas_visits_per_ray (visits/ray): the node and leaf visits, TLAS and
BLAS, of the pass that answered each TLAS call, per ray, over the TLAS
calls of the first traced stretch: the program's counter records'
`visits` over `rays` (tinybvh_tpu_torch/tlas/instance.py: a wavefront's
pairs summed over its levels, the lockstep's nodes and leaves taken)."""

from harness.tlas_records import tlas_records, total


def read(trace):
    recs = tlas_records(trace)
    if recs is None:
        return None
    return total(recs, "visits") / total(recs, "rays")
