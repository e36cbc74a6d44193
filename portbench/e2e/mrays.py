"""mrays (MRays/s): all rays of the calls completed in the window over
the window's seconds, on the host's clock. The window runs from its
start to the end of the last call begun before its deadline, each call
ending in torch.cuda.synchronize()."""


def read(window):
    if window.seconds <= 0 or window.completed == 0:
        return None
    return window.work / window.seconds / 1e6
