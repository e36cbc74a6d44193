"""packet_glue_ms (ms/call): device time a call of torch's ops in the
packet path's host glue, from the traced calls that also record the
host: the kernels, copies and memsets other than the program's own
inside the program's `tbvh.sort` (the coherence sort or the direction
bundling, and the scatter back), `tbvh.cull` (the tile frusta, the
cull's coarse tier, the block order, the key decode) and
`tbvh.resolve` (kernel B's inputs and the hit assembly) device-side
annotations (tinybvh_tpu_torch/traverse/packet2.py)."""

from harness.spans import PREFIX, device_ms


def read(trace):
    return device_ms(trace, {PREFIX + n for n in ("sort", "cull", "resolve")},
                     port=False)
