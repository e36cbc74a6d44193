"""Spans and counters of the packet path, and the tables of kernel
launches.

The traced path: `api.py::BVH.intersect` / `is_occluded` ->
`_packet_trace` -> `traverse/packet2.py` -> `traverse/retrace.py`, whose
exact retrace runs kernel R (`csrc/retrace.cu`) on the card, and the
wavefront (`traverse/wavefront.py`) as its plain twin elsewhere.
Spans and counters are recorded only while a torch profiler runs, which
`api_call` checks once per API call. A span is then a
`torch.profiler.record_function("tbvh.<name>")` range, so it lands in
the profiler's trace on its clock; otherwise `span` hands back one
shared null context. Spans, nested:

    tbvh.intersect / tbvh.is_occluded  the API call: the engine choice,
                                       the shared-origin test
      tbvh.sort     the coherence sort or the direction bundling, and
                    the scatter back into input order
      tbvh.cull     the tile frusta, kernel A, the block order and the
                    key decode
      tbvh.resolve  kernel B's launcher and the hit assembly
      tbvh.retrace  the overflow read and the exact retrace with the
                    merge of its hits

Each traced API call appends one record (a dict) to `RECORDS`:

    api       "intersect" or "is_occluded"
    stamp_ns  time.time_ns() when the record was last written: Kineto's
              clock (Unix-epoch ns), inside the span named by `span`
    span      the innermost tbvh.* span open at `stamp_ns`
    rays      rays traced by the packet path (absent on other engines)
    sent      of them, rays of overflowed tiles, sent to the retrace
    retrace   True where the exact retrace ran (else the wavefront ran
              as the API's engine)
    levels, pairs, peak, cap
              kernel R: 0 (no level loop), its node and leaf visits over
              the rays sent, the deepest stack a ray reached and the
              stack's capacity (and leaf_pairs, the leaf visits of its
              pairs); the wavefront: its levels (a host sync
              each), its pairs summed over levels, its largest level
              frontier before the cap clips it, and that cap in pairs
              (cap_factor, wf_cap_factor on the packet path, x rays)

Without a profiler no record is kept, and neither spans nor counters
add a host sync, an allocation or a launch. With one, neither adds a
sync or a launch: the counters are host integers the traced code holds
anyway (packet2.py::_any_overflow counts the tile mask it copies to the
host in either case), or a device's counters that the code copies to the
host asynchronously in either case, read when the call returns
(`note_later`).

`LAUNCHES` maps a module's name to its table of kernel launches (the
module's own `LAUNCHES`, registered by `launch_table`), which
`count_launch` increments."""

from __future__ import annotations

import collections
import contextlib
import functools
import threading
import time

import torch

PREFIX = "tbvh."
RECORDS: collections.deque = collections.deque(maxlen=4096)
LAUNCHES: dict[str, dict[str, int]] = {}

_NULL = contextlib.nullcontext()
_local = threading.local()      # .rec: the traced API call's record


def launch_table(module: str, names) -> dict[str, int]:
    """A zeroed table of launches of the kernels `names`, registered as
    `module`'s."""
    table = dict.fromkeys(names, 0)
    LAUNCHES[module] = table
    return table


def count_launch(table: dict[str, int], name: str) -> None:
    """One more launch of `name` in `table`, unless a CUDA graph captures
    the call (recorded there, not run: the graph's replays run it)."""
    if not torch.cuda.is_current_stream_capturing():
        table[name] += 1


def record() -> dict | None:
    """The record of the traced API call in progress, or None."""
    return getattr(_local, "rec", None)


class _Span:
    __slots__ = ("name", "rf", "outer")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        rec = _local.rec
        self.outer = rec["_open"]
        rec["_open"] = self.name
        self.rf = torch.profiler.record_function(PREFIX + self.name)
        self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        self.rf.__exit__(*exc)
        _local.rec["_open"] = self.outer
        return False


class _Call(_Span):
    __slots__ = ()

    def __enter__(self):
        _local.rec = {"api": self.name, "retrace": False, "_open": None}
        return super().__enter__()

    def __exit__(self, *exc):
        rec = _local.rec
        if "stamp_ns" not in rec:
            rec.update(stamp_ns=time.time_ns(), span=PREFIX + self.name)
        super().__exit__(*exc)
        _local.rec = None
        del rec["_open"]
        for names, host, done in rec.pop("_later", ()):
            if not done.query():    # the API's own read waited for it
                done.synchronize()
            rec.update(zip(names, host.tolist()))
        RECORDS.append(rec)
        return False


def _profiling() -> bool:
    """Whether a torch profiler runs in this process: torch's own flag,
    set at a profiler's start whatever it records (the host, the device
    or both)."""
    return torch.autograd.profiler._is_profiler_enabled


def api_call(api: str):
    """Decorate the API method `api` (BVH.intersect, BVH.is_occluded):
    while a torch profiler runs (checked here, once a call) the call gets
    its span tbvh.<api> and its record; a call inside a traced call adds
    neither."""
    def wrap(fn):
        @functools.wraps(fn)
        def traced(*args, **kwargs):
            if record() is not None or not _profiling():
                return fn(*args, **kwargs)
            with _Call(api):
                return fn(*args, **kwargs)
        return traced
    return wrap


def span(name: str):
    """The span tbvh.<name> inside a traced API call, else the shared
    null context."""
    return _NULL if record() is None else _Span(name)


def note_later(host: torch.Tensor, names) -> None:
    """Counters that the current stream is copying into the pinned host
    tensor `host`: written into the traced API call's record under
    `names` when the call returns; nothing outside a traced call. A
    packet-path call ends on a host read of its overflow mask, which waits
    for the copy, so reading them adds no host sync."""
    rec = record()
    if rec is not None:
        done = torch.cuda.Event()
        done.record()
        rec.setdefault("_later", []).append((names, host, done))


def note(**counters) -> None:
    """Write counters into the traced API call's record, stamped now
    inside the innermost open span; nothing outside a traced call."""
    rec = record()
    if rec is not None:
        rec.update(counters, stamp_ns=time.time_ns(),
                   span=PREFIX + (rec["_open"] or rec["api"]))
