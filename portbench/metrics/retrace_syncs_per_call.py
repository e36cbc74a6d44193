"""retrace_syncs_per_call (syncs): the host syncs a packet-path call
makes in the exact retrace's level loop, one `nonzero` a level, over the
calls of the first traced stretch, 0 on a call that retraced nothing:
the program's counter records `levels` where `retrace` is true (written
by `intersect_wavefront`, tinybvh_tpu_torch/traverse/wavefront.py), over
the packet-path records. It says how many of host_syncs_per_call's
syncs the retrace makes."""

from harness.spans import records


def read(trace):
    recs = records(trace)
    if recs is None:
        return None
    return sum(r["levels"] for r in recs if r["retrace"]) / len(recs)
