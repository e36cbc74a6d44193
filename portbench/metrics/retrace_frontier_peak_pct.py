"""retrace_frontier_peak_pct (%): the largest level frontier of the
exact retrace over its cap (wf_cap_factor x the rays of the call, in
(ray, node) pairs), over the calls of the first traced stretch, before
the cap clips it: the program's counter records `peak` over `cap`
(written by `intersect_wavefront`, tinybvh_tpu_torch/traverse/
wavefront.py). 0 where no call retraced; over 100 where a frontier
overflowed and the call raised."""

from harness.spans import records


def read(trace):
    recs = records(trace)
    if recs is None:
        return None
    return 100.0 * max((r["peak"] / r["cap"] for r in recs if r["retrace"]),
                       default=0.0)
