"""A copy of the benchmark's tree with tiny cells beside the real ones,
for runs of the harness on the CPU."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

BASE = Path(__file__).resolve().parents[1]
ROOT = BASE.parent

TINY = {"tiny-primary": ("primary", "intersect"),
        "tiny-shadow": ("shadow", "is_occluded"),
        "tiny-diffuse": ("diffuse", "intersect")}


def tiny_tree(dst: Path, triangles: int = 1024) -> tuple[Path, Path]:
    """dst/BENCHMARK.json and dst/portbench: the benchmark as it stands,
    plus a configuration "tiny" of `triangles` triangles of the minimal
    scene at its density and the cells TINY over shrunken copies of the
    mixes (their camera mix: "tiny_primary"). Returns (benchmark
    file, benchmark folder)."""
    base = dst / "portbench"
    shutil.copytree(BASE, base, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((base / "configs" / "tris64k.json").read_text())
    cfg.update(triangle_count=triangles,
               cube_side=(triangles / 8192) ** (1 / 3))
    (base / "configs" / "tiny.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": "tiny", "source": "test",
                             "file": "portbench/configs/tiny.json",
                             "reduced": ["triangle_count", "cube_side"],
                             "why": "tests"})
    for cell, (mix, call) in TINY.items():
        t = json.loads((base / "traffic" / f"{mix}.json").read_text())
        t.update(pool=3)
        if "width" in t:
            t.update(width=64, height=32)
        else:
            t.update(rays_per_call=4096, primary="tiny_primary")
        (base / "traffic" / f"tiny_{mix}.json").write_text(json.dumps(t))
        real = json.loads(
            (base / "cells" / f"tris64k-{mix}.json").read_text())
        real.update(sample=2048, kept_per_call=128)
        (base / "cells" / f"{cell}.json").write_text(json.dumps(real))
        bench["workloads"].append({"name": cell, "config": "tiny",
                                   "traffic": f"tiny_{mix}", "chips": 1,
                                   "why": "tests"})
        for m in bench["per_layer"] + bench["end_to_end"]:
            if "workloads" in m:
                m["workloads"].append(cell)
    path = dst / "BENCHMARK.json"
    path.write_text(json.dumps(bench, indent=1))
    return path, base
