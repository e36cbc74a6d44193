"""retrace_ray_pct (%): the share of the rays traced by the packet path
that it sends to the exact retrace, the rays of tiles whose cull
survivors overflow the leaf budget, over the calls of the first traced
stretch: the program's counter records `sent` over `rays` (written by
`_any_overflow`, tinybvh_tpu_torch/traverse/packet2.py)."""

from harness.spans import records


def read(trace):
    recs = records(trace)
    if recs is None:
        return None
    return 100.0 * sum(r["sent"] for r in recs) / sum(r["rays"] for r in recs)
