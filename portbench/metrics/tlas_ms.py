"""tlas_ms (ms/call): device time a call of the TLAS traversal, from the
traced calls that also record the host: the kernels, copies and memsets
inside the program's `tbvh.tlas_*` device-side annotations (the API call
`tbvh.tlas_intersect` / `tbvh.tlas_is_occluded`, each capped wavefront
pass `tbvh.tlas_wavefront` and the lockstep `tbvh.tlas_lockstep`;
tinybvh_tpu_torch/api.py::TLAS, tlas/instance.py)."""

from harness.spans import PREFIX, device_ms

SPANS = {PREFIX + n for n in ("tlas_intersect", "tlas_is_occluded",
                              "tlas_wavefront", "tlas_lockstep")}


def read(trace):
    return device_ms(trace, SPANS)
