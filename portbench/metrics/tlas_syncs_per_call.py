"""tlas_syncs_per_call (syncs): the host syncs a TLAS call's traversal
makes, over the TLAS calls of the first traced stretch: the program's
counter records' `syncs`, one a wavefront level (its `nonzero`) and one
a lockstep check of its rays' end, over every pass the call ran, thrown
away or not (tinybvh_tpu_torch/tlas/instance.py). 0 for a traversal
with no host-paced loop."""

from harness.tlas_records import tlas_records, total


def read(trace):
    recs = tlas_records(trace)
    if recs is None:
        return None
    return total(recs, "syncs") / len(recs)
