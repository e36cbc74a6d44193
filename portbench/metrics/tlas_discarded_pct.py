"""tlas_discarded_pct (%): the share of a TLAS call's node and leaf
visits spent in passes whose answers were thrown away, over the TLAS
calls of the first traced stretch: the program's counter records'
`discarded_visits` over `visits` + `discarded_visits` (a capped
wavefront pass whose frontier overflowed, tinybvh_tpu_torch/api.py::
TLAS). 0 where every call's first pass answers."""

from harness.tlas_records import tlas_records, total


def read(trace):
    recs = tlas_records(trace)
    if recs is None:
        return None
    thrown = total(recs, "discarded_visits")
    every = total(recs, "visits") + thrown
    return 100.0 * thrown / every if every else 0.0
