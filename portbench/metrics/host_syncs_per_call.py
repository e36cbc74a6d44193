"""host_syncs_per_call (syncs): the times a call makes the host wait for
the device, from the traced calls that also record the host: the CUDA
runtime's stream and event synchronizations inside the benchmark's span
of each call (a tensor read on the host, as `bool(x.any())`, is one).
The benchmark's own synchronize that ends each call is a device-wide
one and is not counted."""

from harness.trace import CALL_SPAN

SYNCS = ("cudaStreamSynchronize", "cudaEventSynchronize")


def read(trace):
    spans = [(s, e, th) for n, d, s, e, _, th in trace.naming
             if not d and n == CALL_SPAN]
    if not spans:
        return None
    n = sum(1 for name, d, s, e, _, th in trace.naming
            if not d and name in SYNCS
            and any(s0 <= s and e <= e1 and th == t1
                    for s0, e1, t1 in spans))
    return n / len(spans)
