"""What the program's own spans and counters say beside the device trace.

The program (tinybvh_tpu_torch/_trace.py) opens `tbvh.*` ranges of
`torch.profiler.record_function` inside each traced API call, and keeps
one counter record a call, stamped with `time.time_ns()` on the
profiler's clock. In the second stretch (`Trace.naming`) each range
appears twice: on the host, and on the device as an annotation that
spans the device ops launched inside it while it was the innermost range
open. Counter records are read from the program's module and chosen by
the first stretch's device window.

Every function returns None where there is nothing to read: a program
without these spans or records (an older commit), or a trace without
them."""

from __future__ import annotations

import importlib

from harness.trace import CALL_SPAN, merged

PREFIX = "tbvh."


def calls(trace) -> list:
    """(start_us, end_us, thread) of the benchmark's call spans of the
    second stretch."""
    return [(s, e, th) for n, d, s, e, _, th in trace.naming
            if not d and n == CALL_SPAN]


def _ops(trace, port):
    """The second stretch's device ops as (name, start, end): kernels,
    copies and memsets, no annotation; port True / False keeps only the
    program's own kernels / only torch's."""
    return [(n, s, e) for n, d, s, e, ua, _ in trace.naming
            if d and not ua and not n.startswith(("portbench.", PREFIX))
            and (port is None or trace.is_port(n) == port)]


def _overlap(ops, spans) -> float:
    """Microseconds of the ops' intervals inside the sorted disjoint
    spans, an op counted once however the spans cut it."""
    total = 0.0
    for _, s, e in ops:
        for a, b in spans:
            if a >= e:
                break
            total += max(0.0, min(e, b) - max(s, a))
    return total


def device_ms(trace, names, port=None):
    """Device ms a call of the second stretch's ops inside the device-side
    annotations `names` (full span names) that lie within its calls;
    port as `_ops`. None without calls or without such annotations."""
    cs = calls(trace)
    if not cs:
        return None
    marks = [(n, s, e) for n, d, s, e, _, _ in trace.naming
             if d and n in names
             and any(c0 <= s and e <= c1 for c0, c1, _ in cs)]
    if not marks:
        return None
    return _overlap(_ops(trace, port), merged(marks)) / 1e3 / len(cs)


def host_idle_ms(trace, name):
    """Host ms a call inside the host-side span `name`, on the calling
    thread and within the calls, while no device op runs. None without
    calls or without such spans."""
    cs = calls(trace)
    if not cs:
        return None
    spans = [(n, s, e) for n, d, s, e, _, th in trace.naming
             if not d and n == name
             and any(c0 <= s and e <= c1 and th == t
                     for c0, c1, t in cs)]
    if not spans:
        return None
    inside = merged(spans)
    busy = _overlap([("", s, e) for s, e in merged(_ops(trace, None))],
                    inside)
    return (sum(e - s for s, e in inside) - busy) / 1e3 / len(cs)


def records(trace):
    """The program's counter records of packet-path calls stamped inside
    the first stretch's device window (first op's start to last op's
    end, on the profiler's clock), or None."""
    try:
        _trace = importlib.import_module("tinybvh_tpu_torch._trace")
    except ImportError:
        return None
    recs = getattr(_trace, "RECORDS", None)
    if not recs or not trace.device_ops:
        return None
    w0 = min(s for _, s, _ in trace.device_ops)
    w1 = max(e for _, _, e in trace.device_ops)
    out = [r for r in list(recs)
           if "rays" in r and w0 <= r["stamp_ns"] / 1e3 <= w1]
    return out or None
