"""The metrics' arithmetic, on windows and traces made by hand."""

import statistics

import pytest

from harness import trace as trace_mod
from harness.cell import Window
from harness.spec import BASE, load_module
from harness.stats import spread
from harness.trace import (Trace, breakdown, idle_gaps, kernel_base,
                           port_kernel_names)


def e2e(name):
    return load_module(BASE, "e2e", name)


def layer(name):
    return load_module(BASE, "metrics", name)


def test_mrays_is_all_the_work_over_all_the_window():
    # three calls of 1,000 rays, one slow: the rate is 3,000 rays over
    # the whole window, not a mean or median of per-call rates
    w = Window(latencies=[0.1, 0.1, 0.8], work=3000, completed=3,
               attempted=3, seconds=1.0)
    assert layer("mrays_window").read_window(w) == pytest.approx(
        3000 / 1.0 / 1e6)
    assert layer("mrays_window").read_window(Window()) is None


def test_device_mrays_is_all_the_work_over_the_devices_busy_time():
    # 3,000 rays over 0.25 s of the device's time, whatever the window's
    w = Window(latencies=[0.1, 0.1, 0.8], work=3000, completed=3,
               attempted=3, seconds=1.0, device_busy_s=0.25)
    assert e2e("device_mrays").read(w) == pytest.approx(3000 / 0.25 / 1e6)
    assert e2e("device_mrays").read(Window()) is None


def test_device_busy_restarts_between_calls_and_sums_every_stretch(
        monkeypatch):
    # each stretch's profiler records two overlapping ops and one apart:
    # 0-3 us and 2-5 us merge to 5 us, 10-11 us adds 1 us
    class Ev:
        def __init__(self, s, e):
            self.s, self.e = s, e

        def device_type(self):
            return "DeviceType.CUDA"

        def start_ns(self):
            return self.s * 1000

        def duration_ns(self):
            return (self.e - self.s) * 1000

        def name(self):
            return "k"

        def is_user_annotation(self):
            return False

        def start_thread_id(self):
            return 0

    class Prof:
        stopped = 0

        def __init__(self):
            evs = [Ev(0, 3), Ev(2, 5), Ev(10, 11)]
            self.profiler = type("P", (), {"kineto_results": type(
                "R", (), {"events": staticmethod(lambda: evs)})()})()

        def stop(self):
            Prof.stopped += 1

    started = []
    monkeypatch.setattr(trace_mod, "start",
                        lambda dev, host: started.append(host) or Prof())
    clock = iter([0.0, 1.0, 5.0, 5.5, 9.2])
    monkeypatch.setattr(trace_mod.time, "perf_counter", lambda: next(clock))
    busy = trace_mod.DeviceBusy()
    for _ in range(5):          # stretches begin at 0.0, 5.0 and 9.2 s
        busy.before()
    busy.finish()
    assert started == [False] * 3 and Prof.stopped == 3
    assert busy.busy_s() == pytest.approx(3 * 6e-6)
    assert busy.busy_s() == 0.0     # each stretch is read once


def test_setup_s_is_the_windows_setup():
    assert e2e("setup_s").read(Window(setup_s=12.5)) == 12.5


def test_spread_is_interquartile_range_over_median():
    xs = [1.0, 2.0, 3.0, 4.0, 10.0, 11.0]
    q1, q2, q3 = statistics.quantiles(xs, n=4)
    assert spread(xs) == pytest.approx((q3 - q1) / q2)


def _trace():
    ops = [("void tbvh::cull_kernel(int const*)", 0.0, 10.0),
           ("void tbvh::(anonymous namespace)::mt_fused_kernel<2, false>"
            "(int const*)", 10.0, 40.0),
           ("void at::native::vectorized_gather_kernel<16, long>(long)",
            50.0, 90.0),
           ("Memcpy DtoH (Device -> Pinned)", 95.0, 100.0),
           ("void at::native::reduce_kernel<512, 1>(x)", 95.0, 98.0)]
    return Trace(calls=2, window_us=200.0, device_ops=ops,
                 port_kernels=frozenset({"cull_kernel", "mt_fused_kernel"}))


def test_layer_metrics_split_the_device_time():
    tr = _trace()
    port = layer("port_kernel_ms").read(tr)
    rest = layer("torch_kernel_ms").read(tr)
    assert port == pytest.approx(40.0 / 1e3 / 2)
    assert rest == pytest.approx(48.0 / 1e3 / 2)
    # busy: [0, 40] + [50, 90] + [95, 100] = 85 of 200 us
    assert layer("device_idle_pct").read(tr) == pytest.approx(57.5)
    assert layer("launches_per_call").read(tr) == 2.5


def test_layer_readers_find_nothing_in_an_empty_trace():
    tr = Trace(calls=1, window_us=100.0, device_ops=[])
    for m in ("port_kernel_ms", "torch_kernel_ms", "device_idle_pct",
              "launches_per_call"):
        assert layer(m).read(tr) is None


def test_kernel_base_names():
    assert kernel_base("void tbvh::(anonymous namespace)::mt_fused_kernel"
                       "<2, false>(int const*, float)") == "mt_fused_kernel"
    assert kernel_base("cull_kernel(int const*)") == "cull_kernel"
    assert kernel_base("void at::native::vectorized_gather_kernel<16, "
                       "long>(long)") == "vectorized_gather_kernel"


def test_port_kernels_are_read_from_the_programs_sources():
    names = port_kernel_names()
    assert {"cull_kernel", "mt_fused_kernel", "tile_order"} <= names
    assert "__launch_bounds__" not in names


def test_idle_gaps_are_named_by_the_open_host_op():
    ev = [  # (name, on device, start, end, user annotation, thread)
        ("portbench.call", False, 0.0, 100.0, True, 1),
        ("aten::nonzero", False, 40.0, 70.0, False, 1),
        ("cudaStreamSynchronize", False, 45.0, 70.0, False, 1),
        ("k1", True, 5.0, 40.0, False, 0),
        ("k2", True, 75.0, 95.0, False, 0)]
    gaps = idle_gaps(ev)
    assert gaps["portbench.call > portbench.call"] == pytest.approx(1e-5)
    assert gaps["portbench.call > aten::nonzero"] == pytest.approx(3.5e-5)
    tr = Trace(calls=1, window_us=100.0,
               device_ops=[("k1", 5.0, 40.0), ("k2", 75.0, 95.0)],
               naming=ev)
    bd = breakdown(tr)
    assert bd["device_ops"][0] == ["k1", pytest.approx(3.5e-5)]
    assert [k for k, _ in bd["idle_gaps"]] == [
        "portbench.call > aten::nonzero", "portbench.call > portbench.call"]


def test_host_syncs_are_counted_inside_the_calls():
    ev = [  # (name, on device, start, end, user annotation, thread)
        ("portbench.call", False, 0.0, 100.0, True, 1),
        ("cudaStreamSynchronize", False, 45.0, 70.0, False, 1),
        ("cudaStreamSynchronize", False, 71.0, 72.0, False, 1),
        ("cudaDeviceSynchronize", False, 90.0, 99.0, False, 1),
        ("portbench.call", False, 110.0, 200.0, True, 1),
        ("cudaEventSynchronize", False, 120.0, 130.0, False, 1),
        ("cudaStreamSynchronize", False, 201.0, 202.0, False, 1),
        ("cudaStreamSynchronize", False, 150.0, 151.0, False, 2),
        ("k1", True, 5.0, 40.0, False, 0)]
    tr = Trace(calls=1, window_us=100.0, device_ops=[("k1", 5.0, 40.0)],
               naming=ev)
    # two in the first call, one in the second; the benchmark's device
    # synchronize, one outside the calls and one on another thread are not
    assert layer("host_syncs_per_call").read(tr) == 1.5
    assert layer("host_syncs_per_call").read(Trace(1, 1.0)) is None
