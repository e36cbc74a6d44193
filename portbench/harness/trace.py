"""The traced part of a run: `torch.profiler` over whole calls of a steady
stretch of the window, and what the per-layer readers read from it.

Two stretches follow each other. The first records the device alone
(kernels, copies, memsets), so that the profiler adds nothing to the
host's work: its window is the host's clock from before its first call
to the return of its last call's synchronize, and every device op in it
was put there by those calls. The second, of a few calls, also records
the host's torch ops and the benchmark's spans ("portbench.call" around
each call, ending in its synchronize), to name each idle gap of the
device by what the host was doing then; the host ops it records cost
time of their own, so its gaps are a little longer than the first
stretch's."""

from __future__ import annotations

import contextlib
import importlib.util
import re
import time
from dataclasses import dataclass, field
from pathlib import Path

CALL_SPAN = "portbench.call"


@dataclass
class Trace:
    """What a per-layer reader reads. calls: the calls of the first
    stretch; window_us: its length on the host's clock; device_ops:
    (name, start_us, end_us) of every kernel, copy and memset it
    recorded. naming: the second stretch's events, for the breakdown."""

    calls: int
    window_us: float
    device_ops: list = field(default_factory=list)
    port_kernels: frozenset = frozenset()
    naming: list = field(default_factory=list)

    def is_port(self, name: str) -> bool:
        return kernel_base(name) in self.port_kernels

    def busy_us(self) -> float:
        return sum(e - s for s, e in merged(self.device_ops))


def _get(ev, attr):
    v = getattr(ev, attr)
    return v() if callable(v) else v


def events(prof):
    """[(name, on_device, start_us, end_us, user_annotation, thread)] of
    a stopped profiler, from its Kineto results."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        dev = "CUDA" in str(_get(ev, "device_type"))
        s = _get(ev, "start_ns") / 1e3
        e = s + _get(ev, "duration_ns") / 1e3
        out.append((_get(ev, "name"), dev, s, e,
                    bool(_get(ev, "is_user_annotation")),
                    _get(ev, "start_thread_id")))
    return out


def _plain(name: str) -> str:
    """A demangled name without '(anonymous namespace)' and without its
    parameter list."""
    name = name.replace("(anonymous namespace)::", "")
    return name.split("(")[0]


def kernel_base(name: str) -> str:
    """A kernel's own name without return type, namespaces, template or
    parameters: 'void ns::k<1, false>(int const*)' -> 'k'."""
    depth, base = 0, []
    for ch in _plain(name):      # drop template arguments, nested or not
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif depth == 0:
            base.append(ch)
    words = "".join(base).split()
    return words[-1].split("::")[-1] if words else ""


def port_kernel_names(package: str = "tinybvh_tpu_torch") -> frozenset:
    """The kernels the program's own sources define, read from its files
    without importing it: every `__global__` function of csrc/ and every
    `@triton.jit` function of the package."""
    spec = importlib.util.find_spec(package)
    if spec is None or not spec.submodule_search_locations:
        return frozenset()
    root = Path(list(spec.submodule_search_locations)[0])
    names = set()
    bounds_re = re.compile(r"__launch_bounds__\s*\([^)]*\)")
    glob_re = re.compile(r"__global__\s+[\w\s:<>,*&]*?(\w+)\s*\(")
    for src in sorted((root / "csrc").glob("*.cu*")):
        names.update(glob_re.findall(bounds_re.sub("", src.read_text())))
    jit_re = re.compile(r"@triton\.jit[^\n]*\n(?:\s*@[^\n]*\n)*\s*def\s+(\w+)")
    for py in sorted(root.rglob("*.py")):
        names.update(jit_re.findall(py.read_text()))
    return frozenset(names)


def merged(ops, window=None):
    """The union of the ops' intervals, clipped to the window if given,
    as sorted disjoint (start, end) pairs."""
    w0, w1 = window or (float("-inf"), float("inf"))
    spans = sorted((max(s, w0), min(e, w1)) for _, s, e in ops
                   if e > w0 and s < w1)
    out = []
    for s, e in spans:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def start(device_type: str, host: bool):
    """A started profiler: of the device's ops on the card, and with
    `host` also of the host's ops and spans."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] if host or device_type != "cuda" else []
    if device_type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


class Tracer:
    """Drives the two traced stretches from the window's loop: call
    before() ahead of each call, span() around it, after() once it has
    synchronized, and finish() when the window closes."""

    MIN_CALLS, MIN_SECONDS = 3, 1.0   # the first stretch: at least both
    NAMING_CALLS = 2                  # the second stretch

    def __init__(self, device_type: str, start_after: float):
        self.dev = device_type
        self.start_after = start_after
        self.phase = "wait"
        self.calls = self.n = 0
        self.prof = self.naming = None
        self.window_us = 0.0

    @property
    def active(self) -> bool:
        return self.phase in ("device", "naming")

    def before(self, elapsed: float) -> None:
        if self.phase == "wait" and elapsed >= self.start_after:
            self.prof = start(self.dev, host=False)
            self.phase, self.n = "device", 0
            self.h0 = time.perf_counter()

    def span(self):
        if self.phase == "naming":
            import torch

            return torch.profiler.record_function(CALL_SPAN)
        return contextlib.nullcontext()

    def after(self) -> None:
        if not self.active:
            return
        self.n += 1
        if self.phase == "device":
            if (self.n >= self.MIN_CALLS and
                    time.perf_counter() - self.h0 >= self.MIN_SECONDS):
                self._end_device()
                self.naming = start(self.dev, host=True)
                self.phase, self.n = "naming", 0
        elif self.n >= self.NAMING_CALLS:
            self.naming.stop()
            self.phase = "done"

    def _end_device(self):
        self.window_us = (time.perf_counter() - self.h0) * 1e6
        self.calls = self.n
        self.prof.stop()

    def finish(self) -> None:
        if self.phase == "device":
            self._end_device()
        elif self.phase == "naming":
            self.naming.stop()
        self.phase = "done"

    def trace(self) -> Trace | None:
        """The Trace, or None where the window closed before a traced
        call."""
        if self.prof is None or self.calls == 0:
            return None
        return build(self.prof, self.calls, self.window_us, self.naming)


def device_ops(evs):
    return [(n, s, e) for n, d, s, e, ua, _ in evs
            if d and not ua and not n.startswith("portbench.")]


def build(prof, calls: int, window_us: float, naming_prof=None) -> Trace:
    """The Trace of the first stretch's stopped profiler, with the events
    of the second's for naming the idle gaps."""
    return Trace(calls=calls, window_us=window_us,
                 device_ops=device_ops(events(prof)),
                 port_kernels=port_kernel_names(),
                 naming=events(naming_prof) if naming_prof else [])


def _open_at(ops, times):
    """For each of the sorted times, the host ops open then, outermost
    first (host ops nest, so one sweep with a stack finds them)."""
    ops = sorted(ops, key=lambda x: (x[1], -x[2]))
    stack, i, out = [], 0, []
    for t in times:
        while i < len(ops) and ops[i][1] <= t:
            while stack and stack[-1][2] <= ops[i][1]:
                stack.pop()
            stack.append(ops[i])
            i += 1
        while stack and stack[-1][2] <= t:
            stack.pop()
        out.append(list(stack))
    return out


def short(name: str, n: int = 96) -> str:
    """An op's name without its parameter list, at most n chars."""
    if name.startswith(("Memcpy", "Memset")):
        return name[:n]
    return (_plain(name) or name)[:n]


def idle_gaps(evs) -> dict:
    """Seconds of device idle time in the calls of a host-and-device
    profile, summed by what the host was doing when each gap began: the
    benchmark's span and the innermost host op open then."""
    spans = [(s, e, th) for n, d, s, e, _, th in evs
             if not d and n == CALL_SPAN]
    if not spans:
        return {}
    window = (min(s for s, _, _ in spans), max(e for _, e, _ in spans))
    busy = merged(device_ops(evs), window)
    gaps, prev = [], window[0]
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = e
    if window[1] > prev:
        gaps.append((prev, window[1]))
    host = [(n, s, e) for n, d, s, e, _, th in evs
            if not d and th == spans[0][2]]     # the calling thread's
    by_gap = {}
    for (g0, g1), stack in zip(gaps, _open_at(host, [g for g, _ in gaps])):
        named = [n for n, _, _ in stack if n.startswith("portbench.")]
        inner = short(stack[-1][0]) if stack else "host idle"
        k = (named[0] if named else "outside a call") + " > " + inner
        by_gap[k] = by_gap.get(k, 0.0) + (g1 - g0) / 1e6
    return by_gap


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device ops that took most time in the first stretch, summed by
    name, and the second stretch's idle gaps (idle_gaps), in seconds."""
    by_op = {}
    for n, s, e in tr.device_ops:
        k = short(n)
        by_op[k] = by_op.get(k, 0.0) + (e - s) / 1e6
    order = sorted(by_op.items(), key=lambda x: -x[1])[:top]
    gaps = sorted(idle_gaps(tr.naming).items(), key=lambda x: -x[1])[:top]
    return {"device_ops": [[k, v] for k, v in order],
            "idle_gaps": [[k, v] for k, v in gaps]}
