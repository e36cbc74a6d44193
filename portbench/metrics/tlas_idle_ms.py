"""tlas_idle_ms (ms/call): host time a call inside the program's TLAS
call span (`tbvh.tlas_intersect`, or `tbvh.tlas_is_occluded`) while no
device op runs, from the traced calls that also record the host: the
host-paced level loop of the two-level wavefront (a `nonzero` sync a
level), the lockstep's checks of its rays' end, and the Python
between their ops (tinybvh_tpu_torch/tlas/instance.py)."""

from harness.spans import PREFIX, host_idle_ms


def read(trace):
    got = [host_idle_ms(trace, PREFIX + n)
           for n in ("tlas_intersect", "tlas_is_occluded")]
    got = [v for v in got if v is not None]
    return sum(got) if got else None
