"""retrace_pairs_per_ray (pairs/ray): the (ray, node) pairs the exact
retrace tests, summed over its levels, per ray sent to it, over the
calls of the first traced stretch: the program's counter records `pairs`
over `sent` where `retrace` is true (written by `intersect_wavefront`,
tinybvh_tpu_torch/traverse/wavefront.py, and `_any_overflow`,
traverse/packet2.py). The retrace's gathers and leaf tests follow the
pairs; its first level also holds the root pair of each ray not sent
(t_max 0 there). 0 where no call retraced."""

from harness.spans import records


def read(trace):
    recs = records(trace)
    if recs is None:
        return None
    sent = [r for r in recs if r["retrace"]]
    if not sent:
        return 0.0
    return sum(r["pairs"] for r in sent) / sum(r["sent"] for r in sent)
