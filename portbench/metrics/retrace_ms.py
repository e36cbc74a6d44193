"""retrace_ms (ms/call): device time a call of the exact retrace, from
the traced calls that also record the host: the kernels, copies and
memsets inside the program's `tbvh.retrace` device-side annotations
(the overflow read, the wavefront retrace and the merge of its hits;
tinybvh_tpu_torch/traverse/packet2.py, `intersect_packets2` and
`_occluded`)."""

from harness.spans import PREFIX, device_ms


def read(trace):
    return device_ms(trace, {PREFIX + "retrace"})
