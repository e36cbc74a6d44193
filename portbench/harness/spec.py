"""Finding a cell's parts by name.

`BENCHMARK.json` (at the checkout's root) names each cell's configuration
and traffic mix, and each metric. Each part is a file of its own under
the benchmark's folder, found by that name:

    configs/<config>.json     the scene and how it is built
    traffic/<traffic>.json    the parameters of the ray batches
    cells/<cell>.json         the size of the output check and its limits
    rays/<kind>.py            a kind of ray batch (`make(...)`)
    calls/<call>.py           a kind of call, its reference and its numbers
    e2e/<metric>.py           an end-to-end metric (`read(window)`)
    metrics/<metric>.py       a per-layer metric (`read(trace)`)

A later cell, mix, configuration or metric is new files and new entries,
never an edit of a file that is there."""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

BASE = Path(__file__).resolve().parents[1]      # the benchmark's folder
BENCHMARK = BASE.parent / "BENCHMARK.json"


@dataclass
class Cell:
    """One workload of BENCHMARK.json with every file it names loaded."""

    name: str
    chips: int
    config: dict
    traffic: dict
    check: dict
    end_to_end: list      # BENCHMARK.json entries that this cell reports
    per_layer: list
    base: Path


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench_path: Path = BENCHMARK,
              base: Path = BASE) -> Cell:
    """The cell `name` of the benchmark file, with its configuration,
    traffic mix and check file. KeyError for an unknown name."""
    bench = load_json(bench_path)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in {bench_path}; known: "
                       + ", ".join(sorted(work)))
    w = work[name]
    return Cell(
        name=name, chips=int(w["chips"]),
        config=load_json(base / "configs" / f"{w['config']}.json"),
        traffic=load_json(base / "traffic" / f"{w['traffic']}.json"),
        check=load_json(base / "cells" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
        base=base)


def load_module(base: Path, folder: str, name: str):
    """The Python file <base>/<folder>/<name>.py as a module. Names may
    hold '.' and '-', so the file is loaded by path, under a module name
    of its own."""
    path = base / folder / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"{folder}/{name}.py not found under {base}")
    mod_name = "portbench_" + folder + "_" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
