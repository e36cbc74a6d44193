"""The port's spans and counters (tinybvh_tpu_torch/_trace.py) on the
packet path: nothing without a profiler, the tbvh.* ranges nested under
one, counters equal to direct counts, stamps inside their spans on the
profiler's clock, and the registry of launch tables.

The CPU tests run the kernels' plain twins (engine="packets"); the test
marked `cuda` repeats the stamp test on the card, where the device-side
annotations and a profiler of the device alone come in."""

import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

import tinybvh_tpu_torch as tt  # noqa: E402
from tinybvh_tpu_torch import _trace  # noqa: E402
from tinybvh_tpu_torch.io.loaders import random_tris  # noqa: E402
from tinybvh_tpu_torch.traverse import (  # noqa: E402
    frustum_walk, leaf_resolve, packet2, retrace, wavefront,
)
from tinybvh_tpu_torch.traverse.packet import (  # noqa: E402
    TILE, sort_rays_coherent,
)
from tinybvh_tpu_torch.tuning import get_tuning  # noqa: E402

STEPS = ("sort", "cull", "resolve", "retrace")


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs one test file per worker process: keep torch's
    intra-op pool small so the workers do not oversubscribe the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _scene(device):
    tris = random_tris(3000, seed=0)
    return tt.BVH(tris, device=device)


@pytest.fixture(scope="module")
def bvh():
    return _scene("cpu")


def _rays(device, n_wide=2, T=16):
    """T - n_wide tiles of camera rays, then n_wide tiles of rays in every
    direction from the scene's middle: those overflow the cull's leaf
    budget, so the retrace runs."""
    rng = np.random.default_rng(9)
    eye = np.array([5.0, 5.0, -8.0], np.float32)
    d = []
    for _ in range(T - n_wide):
        cx, cy = rng.uniform(-0.3, 0.3, 2)
        gx, gy = np.meshgrid((np.arange(16) + 0.5) / 16 * 0.05,
                             (np.arange(16) + 0.5) / 16 * 0.05)
        dd = np.stack([cx + gx, cy + gy, np.ones_like(gx)], -1)
        d.append((dd / np.linalg.norm(dd, axis=-1, keepdims=True))
                 .reshape(-1, 3))
    dw = rng.normal(size=(TILE * n_wide, 3))
    d.append(dw / np.linalg.norm(dw, axis=1, keepdims=True))
    d = np.concatenate(d).astype(np.float32)
    o = np.concatenate([np.broadcast_to(eye, (TILE * (T - n_wide), 3)),
                        np.full((TILE * n_wide, 3), 5.0)]).astype(np.float32)
    return tt.make_rays(o, d, device=device)


def _calls(bvh, rays):
    """The three packet-path calls: closest hit, any hit from one origin
    (direction bundling), any hit from many origins (coherence sort)."""
    src = rays.o[:1].expand_as(rays.o).contiguous()
    seg = rays.o + 3.0 * rays.d - src
    return {
        "intersect": lambda: bvh.intersect(rays, engine="packets"),
        "is_occluded_one_origin": lambda: bvh.is_occluded(
            tt.make_rays(src, seg, device=rays.o.device), 0.999,
            engine="packets"),
        "is_occluded": lambda: bvh.is_occluded(rays, 4.0, engine="packets"),
    }


def _spans(prof, device=False):
    """(name, start_ns, end_ns) of the profiler's tbvh.* events, on the
    host or the device."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        on_dev = "CUDA" in str(ev.device_type())
        if ev.name().startswith(_trace.PREFIX) and on_dev == device:
            out.append((ev.name(), ev.start_ns(),
                        ev.start_ns() + ev.duration_ns()))
    return out


def _traced(fn, activities=(ProfilerActivity.CPU,)):
    n0 = len(_trace.RECORDS)
    with profile(activities=list(activities)) as prof:
        out = fn()
    return out, list(_trace.RECORDS)[n0:], prof


def test_untraced_call_keeps_nothing_and_spans_are_the_null_context(
        bvh, monkeypatch):
    assert _trace.span("sort") is _trace._NULL
    opened = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a: opened.append(a) or real(*a))
    n0 = len(_trace.RECORDS)
    rays = _rays("cpu")
    for fn in _calls(bvh, rays).values():
        fn()
    assert len(_trace.RECORDS) == n0
    assert opened == []
    assert _trace.record() is None


@pytest.mark.parametrize("call", ["intersect", "is_occluded_one_origin",
                                  "is_occluded"])
def test_spans_nest_under_the_profiler(bvh, call):
    rays = _rays("cpu")
    _, recs, prof = _traced(_calls(bvh, rays)[call])
    spans = _spans(prof)
    api = "tbvh." + call.replace("_one_origin", "")
    outer = [s for s in spans if s[0] == api]
    assert len(outer) == 1 and len(recs) == 1
    _, a, b = outer[0]
    names = {n for n, _, _ in spans}
    assert names == {api} | {"tbvh." + s for s in STEPS}
    for n, s, e in spans:
        assert a <= s <= e <= b, n
    # the steps follow each other: sort, cull, resolve, retrace, sort
    steps = sorted((s, e, n) for n, s, e in spans if n != api)
    assert [n for _, _, n in steps][:3] == ["tbvh.sort", "tbvh.cull",
                                           "tbvh.resolve"]
    assert steps[-1][2] == "tbvh.sort"
    for (_, e0, _), (s1, _, _) in zip(steps, steps[1:]):
        assert e0 <= s1


def test_counters_equal_a_direct_count(bvh, monkeypatch):
    rays = _rays("cpu")
    _, recs, _ = _traced(_calls(bvh, rays)["intersect"])
    (rec,) = recs
    # the same rays in the same order through the packet pass alone
    tun = get_tuning(device="cpu")
    lo, hi = bvh.aabb
    order, _ = sort_rays_coherent(rays.o, rays.d, lo, hi)
    rs = rays.take(order)
    _, _, counts = packet2.intersect_packets2(
        bvh.bvh8, bvh.packet_aux, rs, max_leaves=tun.max_leaves,
        max_blocks=tun.max_blocks, retrace=False, return_counts=True)
    over = counts > tun.max_leaves // packet2.SPAN
    R = rays.o.shape[0]
    assert rec["rays"] == R
    assert rec["sent"] == int(over.sum()) * TILE > 0
    assert rec["retrace"] is True
    # the retrace's levels and pairs: one nonzero a level
    sizes = []
    real = torch.nonzero

    def spy(x, *a, **kw):
        out = real(x, *a, **kw)
        sizes.append(out.shape[0])
        return out

    monkeypatch.setattr(torch, "nonzero", spy)
    P = tun.wf_cap_factor * R
    wavefront.intersect_wavefront(
        bvh.bvh8, rs, t_max=torch.where(
            torch.repeat_interleave(over, TILE), 1e30, 0.0),
        cap_factor=tun.wf_cap_factor)
    monkeypatch.undo()
    assert rec["levels"] == len(sizes)
    assert rec["pairs"] == R + sum(min(n, P) for n in sizes)
    assert rec["peak"] == max([R] + sizes)
    assert rec["cap"] == P


def test_wavefront_engine_records_say_it_was_no_retrace(bvh):
    rays = _rays("cpu", n_wide=0, T=2)
    _, recs, _ = _traced(lambda: bvh.intersect(rays))    # "auto": wavefront
    (rec,) = recs
    assert rec["retrace"] is False and "sent" not in rec
    assert rec["levels"] > 0 and rec["cap"] == 8 * rays.o.shape[0]


def _assert_stamps_inside_their_spans(recs, prof):
    spans = _spans(prof)
    assert recs
    for rec in recs:
        assert any(n == rec["span"] and s <= rec["stamp_ns"] <= e
                   for n, s, e in spans), rec


def test_record_stamps_lie_inside_their_spans(bvh):
    rays = _rays("cpu")
    for fn in _calls(bvh, rays).values():
        _, recs, prof = _traced(fn)
        assert [r["span"] for r in recs] == ["tbvh.retrace"]
        _assert_stamps_inside_their_spans(recs, prof)


@pytest.mark.parametrize("mod", [packet2, leaf_resolve, frustum_walk,
                                 retrace])
def test_launch_tables_are_registered_and_count(mod, monkeypatch):
    """A launch counts once in its module's table; a launch a CUDA graph
    captures does not (the CPU build has no graphs: the capture test is
    stood in for)."""
    assert _trace.LAUNCHES[mod.__name__] is mod.LAUNCHES
    name = next(iter(mod.LAUNCHES))
    before = dict(mod.LAUNCHES)
    capturing = [False]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing[0])
    _trace.count_launch(mod.LAUNCHES, name)
    assert mod.LAUNCHES == dict(before, **{name: before[name] + 1})
    capturing[0] = True
    _trace.count_launch(mod.LAUNCHES, name)
    assert mod.LAUNCHES == dict(before, **{name: before[name] + 1})
    monkeypatch.setitem(mod.LAUNCHES, name, before[name])


def test_probe_launch_tables_keep_their_names():
    from tinybvh_tpu_torch.probes import gather, mt_ablation

    assert _trace.LAUNCHES[gather.__name__] is gather.LAUNCHES
    assert _trace.LAUNCHES[mt_ablation.__name__] is mt_ablation.LAUNCHES
    assert set(gather.LAUNCHES) == {
        "row_gather", "col_gather", "lane_gather", "sublane_gather",
        "flat_take", "chain_gather", "sum_gather", "onehot_gather"}
    assert set(mt_ablation.LAUNCHES) == {"mt_ablation"}
    assert set(packet2.LAUNCHES) == {"cull", "mt_fused", "mt_fused_omap",
                                     "mt_gathered", "cull_blocks"}


def test_smoke_reads_the_launch_registry():
    import chip_smoke

    tables = (packet2.LAUNCHES, leaf_resolve.LAUNCHES, frustum_walk.LAUNCHES,
              retrace.LAUNCHES)
    assert len(chip_smoke.launch_tables()) == len(tables)
    assert all(a is b for a, b in zip(chip_smoke.launch_tables(), tables))


def test_overflow_read_runs_the_same_ops_traced_or_not(monkeypatch):
    """The overflow read is one path: inside a traced call it runs the
    torch ops it runs outside one, so a traced run launches what a timed
    run launches, and only the record differs."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    monkeypatch.setattr(_trace, "RECORDS", collections.deque())
    mask = torch.tensor([False, True, False, True])
    with Ops() as plain:
        assert packet2._any_overflow(mask) is True
    with _trace._Call("intersect"):
        with Ops() as traced:
            assert packet2._any_overflow(mask) is True
    assert traced.ops == plain.ops
    (rec,) = _trace.RECORDS
    assert rec["rays"] == 4 * TILE and rec["sent"] == 2 * TILE


@pytest.mark.cuda
def test_record_stamps_lie_inside_their_spans_on_the_card():
    """The shared clock on the card: every record's stamp inside its span
    as Kineto recorded it; the retrace's device-side annotation is there
    for the benchmark's readers; and a profiler of the device alone also
    keeps records (the benchmark's first traced stretch)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    bvh = _scene("cuda")
    rays = _rays("cuda", n_wide=4, T=32)        # 8,192 rays: "auto" packets
    bvh.intersect(rays)                         # the kernels' build
    both = (ProfilerActivity.CPU, ProfilerActivity.CUDA)
    for fn in (lambda: bvh.intersect(rays),
               lambda: bvh.is_occluded(rays, 4.0)):
        out, recs, prof = _traced(fn, both)
        torch.cuda.synchronize()
        assert [r["span"] for r in recs] == ["tbvh.retrace"]
        assert recs[0]["sent"] > 0
        _assert_stamps_inside_their_spans(recs, prof)
        assert "tbvh.retrace" in {n for n, _, _ in _spans(prof, True)}
    _, recs, _ = _traced(lambda: bvh.intersect(rays),
                         (ProfilerActivity.CUDA,))
    assert len(recs) == 1 and recs[0]["sent"] > 0
