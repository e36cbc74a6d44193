"""The readers of the program's spans and counters (harness/spans.py and
the metrics retrace_ms, packet_glue_ms, retrace_idle_ms,
retrace_ray_pct, retrace_frontier_peak_pct, retrace_syncs_per_call and
retrace_pairs_per_ray), on traces and records made by hand."""

import collections
import sys

import pytest

from harness.spec import BASE, load_module
from harness.trace import Trace

SPAN_METRICS = ("retrace_ms", "packet_glue_ms", "retrace_idle_ms")
COUNTER_METRICS = ("retrace_ray_pct", "retrace_frontier_peak_pct",
                   "retrace_syncs_per_call", "retrace_pairs_per_ray")
PORT = frozenset({"cull_kernel", "mt_fused_kernel"})


def layer(name):
    return load_module(BASE, "metrics", name)


def _call(t0):
    """One call's events, shifted by t0 us: (name, on_device, start, end,
    user_annotation, thread). Host spans on thread 1, device-side
    annotations and ops on the device."""
    host = [("portbench.call", 0, 1000), ("tbvh.intersect", 10, 990),
            ("tbvh.sort", 20, 50), ("tbvh.cull", 50, 100),
            ("tbvh.resolve", 100, 200), ("tbvh.retrace", 200, 900),
            ("tbvh.sort", 900, 950), ("aten::nonzero", 450, 620)]
    marks = [("tbvh.sort", 30, 60), ("tbvh.cull", 60, 120),
             ("tbvh.resolve", 120, 260), ("tbvh.retrace", 300, 880),
             ("tbvh.sort", 920, 960), ("portbench.call", 970, 980)]
    ops = [("void at::native::vectorized_gather_kernel<4>(x)", 30, 60),
           ("void tbvh::cull_kernel(int const*)", 60, 70),
           ("void at::native::elementwise_kernel<128>(x)", 70, 120),
           ("void tbvh::mt_fused_kernel<2, false>(int const*)", 120, 200),
           ("void at::native::where_kernel(x)", 200, 260),
           ("void at::native::vectorized_gather_kernel<4>(x)", 300, 400),
           ("void at::native::nonzero_kernel(x)", 500, 600),
           ("Memcpy DtoH (Device -> Pinned)", 700, 880),
           ("void at::native::index_kernel(x)", 920, 960),
           ("void at::native::reduce_kernel(x)", 970, 980)]
    ev = [(n, False, t0 + s, t0 + e, not n.startswith("aten::"), 1)
          for n, s, e in host]
    ev += [(n, True, t0 + s, t0 + e, True, 7) for n, s, e in marks]
    ev += [(n, True, t0 + s, t0 + e, False, 7) for n, s, e in ops]
    return ev


def _trace(naming, device_ops=(("k", 100.0, 200.0),)):
    return Trace(calls=3, window_us=500.0, device_ops=list(device_ops),
                 port_kernels=PORT, naming=naming)


def test_span_readers_split_a_calls_device_time():
    tr = _trace(_call(0.0) + _call(5000.0))          # two calls
    # the retrace's annotation [300, 880] holds 100 + 100 + 180 us
    assert layer("retrace_ms").read(tr) == pytest.approx(380 / 1e3)
    # torch's ops in sort, cull, resolve: 30 + 50 + 60 + 40; the port's
    # kernels (10, 80) and the op outside every tbvh span are not counted
    assert layer("packet_glue_ms").read(tr) == pytest.approx(180 / 1e3)
    # the host's retrace span [200, 900] less the device's busy time in
    # it: 60 (where) + 100 + 100 + 180 = 440 of 700
    assert layer("retrace_idle_ms").read(tr) == pytest.approx(260 / 1e3)


def test_spans_and_port_kernels_cover_the_calls_device_time():
    from harness.spans import PREFIX, device_ms

    tr = _trace(_call(0.0))
    inside = sum(e - s for n, d, s, e, ua, _ in tr.naming if d and not ua)
    parts = (layer("retrace_ms").read(tr) + layer("packet_glue_ms").read(tr)
             + device_ms(tr, {PREFIX + "cull", PREFIX + "resolve"},
                         port=True))
    assert parts == pytest.approx((inside - 10) / 1e3)   # all but 970-980


def test_span_readers_leave_out_annotations_outside_the_calls():
    ev = _call(0.0)
    stray = [("tbvh.retrace", True, 2000.0, 2100.0, True, 7),
             ("void at::native::nonzero_kernel(x)", True, 2000.0, 2100.0,
              False, 7)]
    assert layer("retrace_ms").read(_trace(ev + stray)) == pytest.approx(
        layer("retrace_ms").read(_trace(ev)))


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_span_readers_find_nothing_without_the_programs_spans(name):
    ev = [e for e in _call(0.0) if not e[0].startswith("tbvh.")]
    assert layer(name).read(_trace(ev)) is None       # an older program
    assert layer(name).read(_trace([])) is None       # no second stretch


def _records(monkeypatch, recs):
    from tinybvh_tpu_torch import _trace

    monkeypatch.setattr(_trace, "RECORDS", collections.deque(recs))


def _rec(stamp_us, rays, sent, peak=0, cap=None, retrace=True):
    return {"api": "intersect", "stamp_ns": int(stamp_us * 1000),
            "span": "tbvh.retrace", "rays": rays, "sent": sent,
            "cap": cap or 64 * rays, "retrace": retrace, "levels": 9,
            "pairs": 10 * rays, "peak": peak}


def test_counter_readers_take_the_first_stretchs_records(monkeypatch):
    # the first stretch's device window is [100, 200] us
    _records(monkeypatch, [
        _rec(50, 1024, 1024, peak=60000),           # before the stretch
        _rec(120, 1024, 512, peak=16384),
        _rec(150, 2048, 0, retrace=False),
        _rec(190, 1024, 256, peak=32768),
        _rec(400, 1024, 1024, peak=60000),          # the second stretch
        {"api": "intersect", "stamp_ns": 160_000, "span": "tbvh.intersect",
         "retrace": False, "levels": 3, "pairs": 9, "peak": 8, "cap": 8},
    ])
    tr = _trace([])
    assert layer("retrace_ray_pct").read(tr) == pytest.approx(
        100.0 * (512 + 0 + 256) / (1024 + 2048 + 1024))
    assert layer("retrace_frontier_peak_pct").read(tr) == pytest.approx(
        100.0 * 32768 / (64 * 1024))
    # 9 levels on each of the two calls that retraced, 0 on the third
    assert layer("retrace_syncs_per_call").read(tr) == pytest.approx(
        (9 + 9) / 3)
    assert layer("retrace_pairs_per_ray").read(tr) == pytest.approx(
        (10 * 1024 + 10 * 1024) / (512 + 256))


@pytest.mark.parametrize("name", COUNTER_METRICS)
def test_counter_readers_read_zero_where_no_call_retraced(monkeypatch,
                                                           name):
    _records(monkeypatch, [_rec(150, 1024, 0, retrace=False)])
    assert layer(name).read(_trace([])) == 0.0


def test_frontier_peak_passes_100_where_the_frontier_overflowed(monkeypatch):
    _records(monkeypatch, [_rec(150, 1024, 1024, peak=80000)])
    assert layer("retrace_frontier_peak_pct").read(_trace([])) > 100.0


@pytest.mark.parametrize("name", COUNTER_METRICS)
def test_counter_readers_find_nothing_without_records(monkeypatch, name):
    _records(monkeypatch, [_rec(400, 1024, 512)])      # outside the window
    assert layer(name).read(_trace([])) is None
    _records(monkeypatch, [])
    assert layer(name).read(_trace([])) is None
    _records(monkeypatch, [_rec(150, 1024, 512)])
    assert layer(name).read(_trace([], device_ops=[])) is None
    # a program without the module: an older commit
    monkeypatch.setitem(sys.modules, "tinybvh_tpu_torch._trace", None)
    assert layer(name).read(_trace([])) is None
