"""port_kernel_ms (ms/call): device time a traced call of the kernels
that the program's own sources define (each __global__ of its csrc/ and
each @triton.jit function of the package, read from its files at run
time)."""


def read(trace):
    ms = [e - s for n, s, e in trace.device_ops if trace.is_port(n)]
    if not ms:
        return None
    return sum(ms) / 1e3 / trace.calls
