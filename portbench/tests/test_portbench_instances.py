"""The scene kind of instances (scenes/instance_grid.py) against the
program on the CPU, its near-to-far visits against a visit of every
entered instance, and the cell inst3375-primary's call, mix and limits
on a 3 x 3 x 3 grid of a 256-triangle soup run through the harness:
sound it is correct; the TF32 control, or two instances' transforms
swapped, is not. The kind's plain reference loads nothing of the
program."""

import json
import subprocess
import sys
import time

import pytest
import torch

from harness import cell as cellmod
from harness.spec import load_cell, load_json, load_module, load_scene

from portbench_tiny import BASE, ROOT, tiny_tree

KIND = load_module(BASE, "scenes", "instance_grid")
REAL = load_json(BASE / "configs" / "inst3375.json")
SMALL = dict(REAL, grid=3, blas_triangles=256,
             cube_side=(256 / 65536) ** (1 / 3) * REAL["cube_side"])


@pytest.fixture(scope="module")
def scene():
    return KIND.make(SMALL, 2 ** 34 + 5, "cpu")


def _rays(scene, n=3072, seed=6):
    """Rays from all around the grid towards points inside it."""
    c = torch.tensor((scene.lo + scene.hi) / 2, dtype=torch.float32)
    ext = float(max(scene.hi - scene.lo))
    g = torch.Generator().manual_seed(seed)
    o = c + torch.nn.functional.normalize(torch.randn((n, 3), generator=g),
                                          dim=1) * ext
    d = c + (torch.rand((n, 3), generator=g) - 0.5) * ext - o
    return o, d


@pytest.fixture(scope="module")
def program(scene):
    return scene.program()


def test_the_program_equals_the_reference(scene, program):
    import tinybvh_tpu_torch as tb

    o, d = _rays(scene)
    t, hit = scene.closest(o, d)
    inst, prim = scene.split(hit)
    got = program.intersect(tb.make_rays(o, d, device="cpu"))
    assert 0.3 < float((hit >= 0).double().mean()) < 0.99
    assert torch.equal(got.inst.long(), inst)
    assert torch.equal(got.prim.long(), prim)
    ok = hit >= 0
    assert torch.allclose(got.t[ok], t[ok], rtol=1e-4, atol=0.0)
    # segments past the closest hit on every other ray, short of it on
    # the rest
    even = torch.arange(o.shape[0]) % 2 == 0
    seg = torch.where(ok, t * torch.where(even, 1.3, 0.8), 0.7)
    occ = program.is_occluded(tb.make_rays(o, d * seg[:, None],
                                           device="cpu"), 1.0)
    want = scene.occluded(o, d * seg[:, None], 1.0)
    assert torch.equal(want, ok & even)
    assert torch.equal(occ, want)


def test_near_to_far_visits_give_the_full_loops_answers(scene, capsys):
    o, d = _rays(scene, seed=7)
    t, hit = scene.closest(o, d)
    tf, hitf = scene.closest(o, d, near_first=False)
    assert torch.equal(hit, hitf) and torch.equal(t, tf)
    near, full = [int(line.split("rays, ")[1].split()[0]) for line in
                  capsys.readouterr().err.splitlines()[-2:]]
    assert near < full        # the skip saves visits


def test_ties_go_to_the_lower_instance():
    """Two instances at the same place: every hit is the first's, in
    either order of visit."""
    scene = KIND.make(dict(SMALL, grid=1), 3, "cpu")
    twin = KIND.Instances(scene.blas_host, scene.mats.repeat(2, 0), "cpu",
                          {})
    o, d = _rays(scene, n=512)
    for near_first in (True, False):
        t, hit = twin.closest(o, d, near_first=near_first)
        inst, _ = twin.split(hit)
        assert (hit >= 0).any() and bool((inst[hit >= 0] == 0).all())


def test_the_scene_is_the_configurations_whatever_the_runs_seed():
    a, b = (KIND.make(SMALL, seed, "cpu") for seed in (3, 2 ** 40 + 11))
    assert (a.blas_host == b.blas_host).all() and (a.mats == b.mats).all()
    c = KIND.make(dict(SMALL, scene_seed=SMALL["scene_seed"] + 1), 3, "cpu")
    assert not (c.mats == a.mats).all()


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The tiny tree with a configuration of the instanced kind at SMALL's
    sizes, the cell's mix at 64 x 32 pixels and the cell's own limits."""
    bench_path, base = tiny_tree(tmp_path_factory.mktemp("inst"))
    (base / "configs" / "grid27.json").write_text(json.dumps(
        dict(SMALL, name="grid27")))
    mix = load_json(base / "traffic" / "primary-inst.json")
    mix.update(width=64, height=32, pool=3)
    (base / "traffic" / "tiny_primary-inst.json").write_text(json.dumps(mix))
    chk = load_json(base / "cells" / "inst3375-primary.json")
    chk.update(sample=2048, kept_per_call=128)
    (base / "cells" / "grid27-primary.json").write_text(json.dumps(chk))
    bench = json.loads(bench_path.read_text())
    bench["configs"].append({"name": "grid27", "source": "test",
                             "file": "portbench/configs/grid27.json",
                             "reduced": ["grid"], "why": "tests"})
    bench["workloads"].append({"name": "grid27-primary", "config": "grid27",
                               "traffic": "tiny_primary-inst", "chips": 1,
                               "why": "tests"})
    for m in bench["per_layer"]:
        if "inst3375-primary" in m.get("workloads", ()):
            m["workloads"].append("grid27-primary")
    bench_path.write_text(json.dumps(bench))
    return bench_path, base


def swapped_transforms(scene):
    """A fault: the program is handed the first and the last instance
    with each other's transforms."""
    mats = scene.mats.copy()
    mats[[0, -1]] = mats[[-1, 0]]
    real = scene.program

    def program():
        scene.mats, old = mats, scene.mats
        try:
            return real()
        finally:
            scene.mats = old
    scene.program = program


@pytest.mark.parametrize("broken", [None, "control", "swapped"])
def test_the_cell_runs_through_the_harness(tree, broken, monkeypatch):
    cell = load_cell("grid27-primary", *tree)
    if broken == "swapped":
        real = cellmod.load_scene

        def load(*a, **kw):
            s = real(*a, **kw)
            swapped_transforms(s)
            return s
        monkeypatch.setattr(cellmod, "load_scene", load)
    r = cellmod.run(cell, 2 ** 36 + 11, 1.0, False, "cpu",
                    time.perf_counter(),
                    control_precision="tf32" if broken == "control" else None)
    assert r["failed"] == 0 and r["attempted"] > 0
    assert r["correct"] is (broken is None), r["check"]
    if broken is None:
        assert set(r["metrics"]) == {"device_mrays", "setup_s"}


METRICS = ("tlas_ms", "tlas_idle_ms", "tlas_syncs_per_call",
           "tlas_discarded_pct", "tlas_visits_per_ray",
           "tlas_entries_per_ray")


def metric(name):
    return load_module(BASE, "metrics", name)


# the per-layer metrics of every cell that read any traced window
GENERIC = ("mrays_window", "torch_kernel_ms", "device_idle_pct",
           "launches_per_call", "host_syncs_per_call")


def test_the_cell_reports_the_tlas_metrics():
    cell = load_cell("inst3375-primary")
    names = [m["name"] for m in cell.per_layer]
    assert sorted(names[:5]) == sorted(GENERIC)
    assert names[5:] == list(METRICS)
    assert {m["layer"] for m in cell.per_layer[5:]} == {"TLAS traversal"}
    assert [m["name"] for m in cell.end_to_end] == ["device_mrays",
                                                    "setup_s"]


def _tlas_call(t0):
    """One TLAS call's events, shifted by t0 us, as harness/trace.py
    reads them: host spans on thread 1, device-side annotations and ops
    on the device."""
    host = [("portbench.call", 0, 1000), ("tbvh.tlas_intersect", 10, 990),
            ("tbvh.tlas_wavefront", 20, 300),
            ("tbvh.tlas_wavefront", 300, 600),
            ("tbvh.tlas_lockstep", 600, 980)]
    marks = [("tbvh.tlas_intersect", 15, 25),
             ("tbvh.tlas_wavefront", 30, 320),
             ("tbvh.tlas_wavefront", 320, 640),
             ("tbvh.tlas_lockstep", 640, 985),
             ("portbench.call", 990, 995)]
    ops = [("void at::native::elementwise_kernel<128>(x)", 15, 25),
           ("void at::native::index_kernel(x)", 30, 130),
           ("void at::native::nonzero_kernel(x)", 200, 320),
           ("void at::native::index_kernel(x)", 320, 400),
           ("void at::native::where_kernel(x)", 640, 700),
           ("void at::native::reduce_kernel(x)", 800, 985),
           ("void at::native::reduce_kernel(x)", 990, 995)]
    ev = [(n, False, t0 + s, t0 + e, True, 1) for n, s, e in host]
    ev += [(n, True, t0 + s, t0 + e, True, 7) for n, s, e in marks]
    ev += [(n, True, t0 + s, t0 + e, False, 7) for n, s, e in ops]
    return ev


def test_the_tlas_span_readers_on_a_trace_made_by_hand():
    from harness.trace import Trace

    tr = Trace(calls=3, window_us=500.0, device_ops=[("k", 0.0, 1.0)],
               naming=_tlas_call(0.0) + _tlas_call(5000.0))
    # ops inside the tlas annotations: 10 + 100 + 120 + 80 + 60 + 185 us;
    # the harness's gather after the call is not the program's
    assert metric("tlas_ms").read(tr) == pytest.approx(555 / 1e3)
    # host [10, 990] less the device's busy time in it (15-25, 30-130,
    # 200-400, 640-700, 800-985: 555 of 980 us)
    assert metric("tlas_idle_ms").read(tr) == pytest.approx(425 / 1e3)
    bare = Trace(calls=3, window_us=500.0, naming=[
        e for e in _tlas_call(0.0) if not e[0].startswith("tbvh.")])
    for name in ("tlas_ms", "tlas_idle_ms"):
        assert metric(name).read(bare) is None     # an older program


def _traced_tlas_records(program, scene, n=2):
    from torch.profiler import ProfilerActivity, profile

    import tinybvh_tpu_torch as tb
    from tinybvh_tpu_torch import _trace

    o, d = _rays(scene, n=512, seed=9)
    rays = tb.make_rays(o, d, device="cpu")
    n0 = len(_trace.RECORDS)
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(n):
            program.intersect(rays)
    return list(_trace.RECORDS)[n0:]


def test_the_tlas_counter_readers_read_the_programs_records(
        scene, program, monkeypatch):
    import collections

    from harness.trace import Trace
    from tinybvh_tpu_torch import _trace

    recs = _traced_tlas_records(program, scene)
    assert [r["api"] for r in recs] == ["tlas_intersect"] * 2
    # the readers read the device counts the program left in its records
    assert all(isinstance(r["entries"], torch.Tensor) for r in recs)
    nums = [{k: int(v) if isinstance(v, torch.Tensor) else v
             for k, v in r.items()} for r in recs]
    # a packet-path record in the window is not a TLAS call's
    other = {"api": "intersect", "stamp_ns": recs[0]["stamp_ns"],
             "rays": 9, "retrace": False}
    monkeypatch.setattr(_trace, "RECORDS", collections.deque(recs + [other]))
    w = [r["stamp_ns"] / 1e3 for r in recs]
    tr = Trace(calls=2, window_us=1.0,
               device_ops=[("k", min(w) - 1.0, max(w) + 1.0)])
    rays = sum(r["rays"] for r in nums)
    visits = sum(r["visits"] for r in nums)
    thrown = sum(r["discarded_visits"] for r in nums)
    assert metric("tlas_syncs_per_call").read(tr) == pytest.approx(
        sum(r["syncs"] for r in nums) / 2)
    assert metric("tlas_discarded_pct").read(tr) == pytest.approx(
        100.0 * thrown / (visits + thrown))
    assert metric("tlas_visits_per_ray").read(tr) == pytest.approx(
        visits / rays)
    assert metric("tlas_entries_per_ray").read(tr) == pytest.approx(
        sum(r["entries"] for r in nums) / rays)
    # outside the window, without TLAS records, or without the module
    late = Trace(calls=2, window_us=1.0,
                 device_ops=[("k", max(w) + 5.0, max(w) + 6.0)])
    counters = METRICS[2:]
    for name in counters:
        assert metric(name).read(late) is None
    monkeypatch.setattr(_trace, "RECORDS", collections.deque([other]))
    for name in counters:
        assert metric(name).read(tr) is None
    monkeypatch.setitem(sys.modules, "tinybvh_tpu_torch._trace", None)
    for name in counters:
        assert metric(name).read(tr) is None


_LOADS = """
import sys; sys.path[:0] = [sys.argv[1]]
import json, torch
from harness.spec import load_module, load_json
from harness.spec import BASE
kind = load_module(BASE, "scenes", "instance_grid")
cfg = dict(load_json(BASE / "configs" / "inst3375.json"), grid=3,
           blas_triangles=256)
s = kind.make(cfg, 3, "cpu")
c = torch.tensor((s.lo + s.hi) / 2, dtype=torch.float32)
g = torch.Generator().manual_seed(3)
o = c + torch.randn((256, 3), generator=g) * float(max(s.hi - s.lo))
t, hit = s.closest(o, c - o)
assert (hit >= 0).any()
s.occluded(o, c - o, 0.999)
s.normals(hit[hit >= 0], (c - o)[hit >= 0])
print(sorted({m.split('.')[0] for m in sys.modules}))
"""


def test_the_instanced_reference_loads_nothing_of_the_program():
    """instance_grid's closest, occluded and normals: no module of the
    program or of JAX is loaded."""
    out = subprocess.run([sys.executable, "-c", _LOADS, str(BASE)],
                         capture_output=True, text=True, check=True,
                         cwd=ROOT).stdout
    tops = eval(out.strip().splitlines()[-1])
    assert not {"tinybvh_tpu_torch", "tinybvh_tpu", "jax", "jaxlib",
                "flax"} & set(tops)
