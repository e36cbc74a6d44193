"""torch_kernel_ms (ms/call): device time a traced call of every other
kernel, copy and memset: torch's own (the exact retrace, the sorts, the
gathers of the packet glue)."""


def read(trace):
    ms = [e - s for n, s, e in trace.device_ops if not trace.is_port(n)]
    if not ms:
        return None
    return sum(ms) / 1e3 / trace.calls
