"""A configuration, a traffic mix, a cell and a per-layer metric added as
new files and new BENCHMARK.json entries, with no file that was there
edited, run through the harness."""

import hashlib
import json
import time

import pytest

from harness import cell as cellmod
from harness.spec import load_cell

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
                               "layer": "device", "moves": "mrays",
                               "workloads": ["wide768-high_light"]})
    bench_path.write_text(json.dumps(bench))

    cell = load_cell("wide768-high_light", bench_path, base)
    assert cell.config["triangle_count"] == 768
    assert [m["name"] for m in cell.per_layer][-1] == "traced_calls"
    r = cellmod.run(cell, 77, 1.5, False, "cpu", time.perf_counter())
    assert r["correct"] and set(r["metrics"]) == {"mrays", "setup_s"}
    r = cellmod.run(cell, 78, 2.0, True, "cpu", time.perf_counter())
    assert r["correct"] and r["metrics"]["traced_calls"]["value"] >= 3

    after = _digests(base)
    assert all(after[p] == h for p, h in before.items())


def test_unknown_cell_is_refused(tmp_path):
    bench_path, base = tiny_tree(tmp_path)
    with pytest.raises(KeyError):
        load_cell("no-such-cell", bench_path, base)
