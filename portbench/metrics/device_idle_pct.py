"""device_idle_pct (%): the share of the traced window in which no
kernel, copy or memset runs on the device."""


def read(trace):
    if not trace.device_ops or trace.window_us <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_us() / trace.window_us)
