"""A configuration, a traffic mix, a cell and a per-layer metric added as
new files and new BENCHMARK.json entries, with no file that was there
edited, run through the harness; and so a scene kind of instances, with
its program object, its plain reference and a call of its own
(tests/instanced/)."""

import hashlib
import json
import shutil
import time
from pathlib import Path

import pytest
import torch

from harness import cell as cellmod
from harness import reference
from harness.spec import load_cell, load_scene

from portbench_tiny import tiny_tree


def _digests(base):
    return {p.relative_to(base): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(base.rglob("*")) if p.is_file()}


def test_new_cell_config_mix_and_metric_are_found_by_name(tmp_path):
    bench_path, base = tiny_tree(tmp_path)
    before = _digests(base)
    bench = json.loads(bench_path.read_text())

    cfg = json.loads((base / "configs" / "tiny.json").read_text())
    cfg.update(triangle_count=768, vertex_offset=0.15)
    (base / "configs" / "wide768.json").write_text(json.dumps(cfg))
    mix = json.loads((base / "traffic" / "tiny_shadow.json").read_text())
    mix.update(light_offset=[0.0, 3.0, 1.0], rays_per_call=2048)
    (base / "traffic" / "high_light.json").write_text(json.dumps(mix))
    (base / "cells" / "wide768-high_light.json").write_text(json.dumps(
        {"kept_per_call": 64, "sample": 1024,
         "limits": {"occ_mismatch_pct": 0.1}}))
    (base / "metrics" / "traced_calls.py").write_text(
        "def read(trace):\n    return float(trace.calls)\n")
    bench["configs"].append({"name": "wide768", "source": "test",
                             "file": "portbench/configs/wide768.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "wide768-high_light",
                               "config": "wide768", "traffic": "high_light",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "traced_calls", "unit": "calls",
                               "better": "higher", "source": "device_trace",
                               "layer": "device", "moves": "device_mrays",
                               "workloads": ["wide768-high_light"]})
    for m in bench["per_layer"]:
        if m["name"] == "mrays_window":
            m["workloads"].append("wide768-high_light")
    bench_path.write_text(json.dumps(bench))

    cell = load_cell("wide768-high_light", bench_path, base)
    assert cell.config["triangle_count"] == 768
    assert [m["name"] for m in cell.per_layer][-1] == "traced_calls"
    r = cellmod.run(cell, 77, 1.5, False, "cpu", time.perf_counter())
    assert r["correct"] and set(r["metrics"]) == {"device_mrays", "setup_s"}
    r = cellmod.run(cell, 78, 2.0, True, "cpu", time.perf_counter())
    assert r["correct"] and r["metrics"]["traced_calls"]["value"] >= 3
    assert r["metrics"]["mrays_window"]["value"] > 0

    after = _digests(base)
    assert all(after[p] == h for p, h in before.items())


def test_unknown_cell_is_refused(tmp_path):
    bench_path, base = tiny_tree(tmp_path)
    with pytest.raises(KeyError):
        load_cell("no-such-cell", bench_path, base)


INSTANCED = Path(__file__).resolve().parent / "instanced"


@pytest.fixture(scope="module")
def instanced(tmp_path_factory):
    """The tiny tree with a scene kind of 2 x 2 x 2 turned instances of a
    128-triangle soup, its call, a configuration, a camera mix and a
    cell, all new files and entries. Returns (benchmark file, benchmark
    folder, digests of the files that were there)."""
    bench_path, base = tiny_tree(tmp_path_factory.mktemp("instanced"))
    before = _digests(base)
    for folder in ("scenes", "calls"):
        for p in (INSTANCED / folder).glob("*.py"):
            assert not (base / folder / p.name).exists()
            shutil.copy(p, base / folder / p.name)
    (base / "configs" / "grid8.json").write_text(json.dumps(
        {"name": "grid8", "scene": "grid_instances", "blas_triangles": 128,
         "grid": 2, "pitch": 1.5, "cube_side": 0.25, "vertex_offset": 0.1,
         "build": {}}))
    mix = json.loads((base / "traffic" / "tiny_primary.json").read_text())
    mix.update(call="intersect_inst")
    (base / "traffic" / "grid_camera.json").write_text(json.dumps(mix))
    (base / "cells" / "grid8-camera.json").write_text(json.dumps(
        {"kept_per_call": 128, "sample": 2048,
         "limits": {"hit_mismatch_pct": 0.15, "t_err_max": 0.001}}))
    bench = json.loads(bench_path.read_text())
    bench["configs"].append({"name": "grid8", "source": "test",
                             "file": "portbench/configs/grid8.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "grid8-camera", "config": "grid8",
                               "traffic": "grid_camera", "chips": 1,
                               "why": "test"})
    bench_path.write_text(json.dumps(bench))
    return bench_path, base, before


def swapped_instances(fn):
    """Instances 0 and 1 trade places in every answer."""
    def g(b):
        out = fn(b)
        inst = out.inst.clone()
        inst[out.inst == 0] = 1
        inst[out.inst == 1] = 0
        out.inst = inst
        return out
    return g


@pytest.mark.parametrize("broken", [None, "control", "swapped"])
def test_an_instanced_scene_kind_is_found_by_name(instanced, broken):
    """Sound, the instanced cell is correct; with the TF32 control in the
    program's place, or two instances swapped in its answers, it is
    not; and no file that was there has changed."""
    bench_path, base, before = instanced
    cell = load_cell("grid8-camera", bench_path, base)
    r = cellmod.run(cell, 2 ** 36 + 9, 1.0, False, "cpu",
                    time.perf_counter(),
                    control_precision="tf32" if broken == "control" else None,
                    fault=swapped_instances if broken == "swapped" else None)
    assert r["failed"] == 0 and r["attempted"] > 0
    assert r["correct"] is (broken is None), r["check"]
    after = _digests(base)
    assert all(after[p] == h for p, h in before.items())


def test_the_instanced_reference_sees_every_instance(instanced):
    """The instanced kind's reference against the brute force over its
    instances' world-space triangles, flattened: the same hits."""
    bench_path, base, _ = instanced
    cell = load_cell("grid8-camera", bench_path, base)
    scene = load_scene(cell.config, 4, "cpu", base)
    m = torch.from_numpy(scene.mats.astype("float64"))
    world = (torch.einsum("ijk,nvk->invj", m[:, :3, :3],
                          scene.blas.double()) + m[:, None, None, :3, 3])
    flat = world.reshape(-1, 3, 3).float()
    c = torch.tensor((scene.lo + scene.hi) / 2, dtype=torch.float32)
    g = torch.Generator().manual_seed(4)
    o = c + torch.randn((4096, 3), generator=g) * float(max(scene.hi -
                                                            scene.lo))
    d = c + torch.randn((4096, 3), generator=g) * 0.3 - o
    t, hit = scene.closest(o, d)
    rt, rhit = reference.closest(flat, o, d)
    assert (hit >= 0).float().mean() > 0.2
    assert float((hit != rhit).double().mean()) < 0.002
    same = (hit == rhit) & (hit >= 0)
    assert float(((t - rt).abs() / rt)[same].max()) < 1e-4
    occ = scene.occluded(o, d, 0.5)
    assert float((occ != ((rhit >= 0) & (rt < 0.5))).double().mean()) < 0.002
