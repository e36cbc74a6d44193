"""device_mrays (MRays/s): all rays of the calls completed in the window
over the seconds in which the device ran their kernels, copies and
memsets, read from a profile of the device alone over the whole window
(harness/trace.py DeviceBusy): the card's rate on the cell's work, as a
GPU ray tracer's throughput is reported, and what the card sustains once
its callers keep it fed. The host's time between the device's
operations is not in it; `mrays_window`, per layer, has it."""


def read(window):
    if window.device_busy_s <= 0 or window.completed == 0:
        return None
    return window.work / window.device_busy_s / 1e6
