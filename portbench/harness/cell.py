"""One run of one cell: set-up, the measured window, the output check.

Set-up makes the scene and the ray batches from the seed (shadow and
bounce batches from the plain reference's primary hits, whose time
set-up leaves out), builds the program's BVH, and calls it once on every
batch. The window is a closed
loop of one caller: each call is issued when the last has returned, on
the batches in turn, until `seconds` have passed; the call begun before
the deadline ends the window. After each call the answers of a few rays
drawn from the seed are kept. Once the window has closed and the peak
memory is read, the program's state is freed and the plain reference
judges a sample of the kept answers, drawn from the seed."""

from __future__ import annotations

import contextlib
import gc
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from harness import guard
from harness import trace as trace_mod
from harness.scene import make_scene
from harness.spec import Cell, load_module
from harness.traffic import derive, make_batches, scene_box


ROWS = 4096     # rows of the table of kept positions


@dataclass
class Window:
    latencies: list = field(default_factory=list)    # seconds, every call
    work: int = 0            # rays of the completed calls
    completed: int = 0
    attempted: int = 0
    failed: int = 0
    seconds: float = 0.0
    setup_s: float = 0.0
    error: str = ""


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def say(*a):
    print(*a, file=sys.stderr, flush=True)


def forbidden_exit(when: str) -> None:
    bad = guard.forbidden_loaded()
    if bad:
        say(f"import check failed {when}: " + ", ".join(bad))
        raise SystemExit(3)


def control(calls, tris, raw_o, raw_d, t_max, precision="tf32"):
    """The control of the output check, as a fault: the plain reference
    computed in `precision` put in the program's place. Each batch's
    answers are worked out once, at its first call, and handed back at
    every call of that batch."""
    memo = {}

    def wrap(timed):
        def f(b):
            if b not in memo:
                memo[b] = calls.from_answers(calls.reference_answers(
                    tris, raw_o[b], raw_d[b], t_max, precision))
            return memo[b]
        return f
    return wrap


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, control_precision: str | None = None,
        fault=None) -> dict:
    """The result object of one run. fault: a function wrapping the timed
    call (a function of the batch's index), to break it for the
    harness's own tests. control_precision ("tf32"): the control, the
    plain reference in that precision put in the program's place."""
    import tinybvh_tpu_torch as tb

    forbidden_exit("before the window")
    dev = torch.device(device)
    trf, chk = cell.traffic, cell.check
    calls = load_module(cell.base, "calls", trf["call"])
    t_max = trf.get("t_max")

    tris_np = make_scene(cell.config, seed)
    lo, hi = scene_box(tris_np)
    tris = torch.from_numpy(tris_np).to(dev)     # the benchmark's own copy
    raw_o, raw_d, ref_s = make_batches(trf, cell.base, tris, lo, hi, seed)
    P, R = raw_o.shape[:2]
    if dev.type == "cuda":     # the reference's blocks are not the program's
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    bvh = tb.BVH(tris_np, device=dev, **cell.config.get("build", {}))
    pool = [tb.make_rays(o.clone(), d.clone(), device=dev)
            for o, d in zip(raw_o, raw_d)]
    # the rays whose answers call k keeps: row k % ROWS of the table
    gen = torch.Generator(device=dev)
    gen.manual_seed(derive(seed, 3))
    positions = torch.randint(R, (ROWS, int(chk["kept_per_call"])),
                              generator=gen, device=dev)

    def timed(b):
        return calls.call(bvh, pool[b], t_max)

    if control_precision:
        fault = control(calls, tris, raw_o, raw_d, t_max, control_precision)
    fn = fault(timed) if fault else timed
    for b in range(P):                         # warm-up: every batch once
        fn(b)
    _sync(dev)
    if trace:    # the profiler's first start loads its tracer: not in the window
        trace_mod.start(dev.type, host=True).stop()
    # set-up leaves out the plain reference's part in making the traffic
    win = Window(setup_s=time.perf_counter() - t_start - ref_s)
    say(f"setup {win.setup_s:.3f} s (and {ref_s:.3f} s of the plain "
        f"reference making the traffic): {tris_np.shape[0]} triangles, "
        f"{P} batches of {R} rays")

    kept, held, out = [], [], None   # held: (batch, row, answer) to keep
    tracer = trace_mod.Tracer(dev.type, seconds / 3.0) if trace else None
    mem0 = _alloc_counts(dev)
    gc0 = [g["collections"] for g in gc.get_stats()]
    w0 = time.perf_counter()
    deadline = w0 + seconds
    k = 0
    while time.perf_counter() < deadline:
        if tracer:
            tracer.before(time.perf_counter() - w0)
        b = k % P
        t0 = time.perf_counter()
        try:
            with tracer.span() if tracer else contextlib.nullcontext():
                out = fn(b)
                _sync(dev)
        except RuntimeError as e:       # the API's overflow, out of memory
            out = None
            win.failed += 1
            win.error = win.error or repr(e)[:400]
        win.latencies.append(time.perf_counter() - t0)
        win.attempted += 1
        if out is not None:
            win.completed += 1
            win.work += R
            held.append((b, k % ROWS, out))
        if tracer:
            tracer.after()
        if not (tracer and tracer.active):   # kept outside a traced stretch
            kept += [(hb, hr, calls.keep(o, positions[hr]))
                     for hb, hr, o in held]
            held = []
        k += 1
    if tracer:
        tracer.finish()
    kept += [(hb, hr, calls.keep(o, positions[hr])) for hb, hr, o in held]
    del held
    _sync(dev)
    win.seconds = time.perf_counter() - w0
    report_window(win, P, dev, mem0, gc0)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    forbidden_exit("after the window")

    # the program's state goes before the reference runs
    del bvh, pool, out, fn, timed, fault
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    result = {"correct": False, "attempted": win.attempted,
              "failed": win.failed, "metrics": {},
              "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                         "kind": (torch.cuda.get_device_name(dev)
                                  if dev.type == "cuda" else "cpu"),
                         "count": cell.chips, "memory_peak_bytes": int(peak)}}
    if win.error:
        say(f"{win.failed} of {win.attempted} calls failed; first: "
            f"{win.error}")

    if trace:
        tr = tracer.trace()
        if tr is not None:
            for m in cell.per_layer:
                v = load_module(cell.base, "metrics", m["name"]).read(tr)
                if v is not None:
                    result["metrics"][m["name"]] = {"value": v,
                                                    "unit": m["unit"]}
            result["device"]["busy_s"] = tr.busy_us() / 1e6
            result["device"]["window_s"] = tr.window_us / 1e6
            result["breakdown"] = trace_mod.breakdown(tr)
        del tracer, tr
    else:
        for m in cell.end_to_end:
            v = load_module(cell.base, "e2e", m["name"]).read(win)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v,
                                                "unit": m["unit"]}

    numbers = judge(calls, tris, raw_o, raw_d, positions, kept, t_max,
                    int(chk["sample"]), derive(seed, 2))
    limits = chk["limits"]        # the numbers this cell compares
    compared = [n for n in calls.NUMBERS if n in limits]
    ok = (win.failed == 0 and win.completed > 0 and numbers is not None
          and bool(compared) and all(numbers[n] <= limits[n]
                                     for n in compared))
    result["correct"] = bool(ok)
    if numbers is not None:
        result["judged"] = numbers        # every number, compared or not
        say(f"judged {numbers}")
    checks = {}
    for n in compared:
        v = numbers[n] if numbers is not None else None
        checks[n] = {"value": v, "limit": limits[n]}
        say(f"check {n} {v} limit {limits[n]}")
    say(f"check failed_calls {win.failed} limit 0")
    checks["failed_calls"] = {"value": win.failed, "limit": 0}
    result["check"] = checks
    return result


def _alloc_counts(dev):
    if dev.type != "cuda":
        return {}
    st = torch.cuda.memory_stats(dev)
    return {k: st.get(k, 0) for k in ("num_device_alloc", "num_device_free",
                                      "num_alloc_retries")}


def report_window(win, P, dev, mem0, gc0):
    """Standard error: each batch's median and longest call, the calls
    that took over 1.5 times their batch's median, and what the caching
    allocator and the garbage collector did in the window."""
    lat = win.latencies
    med = [sorted(lat[i::P])[len(lat[i::P]) // 2] if lat[i::P] else 0.0
           for i in range(P)]
    say("call ms by batch (median/max): " + ", ".join(
        f"{1e3 * med[i]:.1f}/{1e3 * max(lat[i::P]):.1f}"
        for i in range(P) if lat[i::P]))
    slow = [(k, round(1e3 * x, 1)) for k, x in enumerate(lat)
            if x > 1.5 * med[k % P]]
    say(f"slow calls {len(slow)} of {len(lat)}: {slow[:40]}")
    mem1 = _alloc_counts(dev)
    gc1 = [g["collections"] for g in gc.get_stats()]
    say("in the window: allocator " + str({k: mem1[k] - mem0[k]
                                           for k in mem1})
        + f", gc collections {[b - a for a, b in zip(gc0, gc1)]}")


def judge(calls, tris, raw_o, raw_d, positions, kept, t_max, sample,
          seed):
    """The call's numbers over a sample, drawn from the seed, of the kept
    answers, against the plain reference in float32; None where none was
    kept."""
    if not kept:
        return None
    per_call = positions.shape[1]
    b = torch.tensor([kb for kb, _, _ in kept], device=raw_o.device)
    row = torch.tensor([kr for _, kr, _ in kept], device=raw_o.device)
    got = torch.cat([a for _, _, a in kept])
    rows = np.random.default_rng(seed).permutation(got.shape[0])[:sample]
    rows = torch.from_numpy(np.sort(rows)).to(raw_o.device)
    call = rows // per_call
    pos = positions[row[call], rows % per_call]
    o, d = raw_o[b[call], pos], raw_d[b[call], pos]
    ref = calls.reference_answers(tris, o, d, t_max, "fp32")
    return calls.judge(got[rows], ref)
