"""launches_per_call (launches): kernels, copies and memsets a traced
call puts on the device."""


def read(trace):
    if not trace.device_ops:
        return None
    return len(trace.device_ops) / trace.calls
