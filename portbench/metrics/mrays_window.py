"""mrays_window (MRays/s): all rays of the calls completed in the traced
run's window over the window's seconds, on the host's clock. The window
runs from its start to the end of the last call begun before its
deadline, each call ending in torch.cuda.synchronize(). The profiler's
stretches are inside it, so it reads a little under an untraced run."""


def read_window(window):
    if window.seconds <= 0 or window.completed == 0:
        return None
    return window.work / window.seconds / 1e6
