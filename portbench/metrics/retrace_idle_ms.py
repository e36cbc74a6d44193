"""retrace_idle_ms (ms/call): host time a call inside the program's
`tbvh.retrace` span while no device op runs, from the traced calls that
also record the host: the host-paced level loop of the wavefront
retrace (its host sync a level, tinybvh_tpu_torch/traverse/
wavefront.py) and the Python between its ops."""

from harness.spans import PREFIX, host_idle_ms


def read(trace):
    return host_idle_ms(trace, PREFIX + "retrace")
