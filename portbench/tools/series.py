#!/usr/bin/env python3
"""Run cells of the benchmark one after another, each run in a process of
its own, and keep every result line.

    python3 portbench/tools/series.py --out results/set1.jsonl \
        --seconds 51 --trace 0 tris64k-primary:11,12,13 tris64k-shadow:14

Each argument is a workload and its seeds. Writes one JSON line a run
(workload, seed, trace, exit code, wall seconds, the result object or
null, the end of standard error) to --out, and prints a summary line a
run, then each metric's median and spread (interquartile range over the
median) a workload."""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

RUN = Path(__file__).resolve().parents[1] / "run.py"
sys.path.insert(0, str(RUN.parent))
from harness.stats import spread  # noqa: E402


def one(workload, seed, seconds, trace, timeout):
    t0 = time.perf_counter()
    try:
        p = subprocess.run(
            [sys.executable, str(RUN), "--workload", workload, "--seed",
             str(seed), "--seconds", str(seconds), "--trace", str(trace)],
            capture_output=True, text=True, timeout=timeout)
        rc, out, err = p.returncode, p.stdout, p.stderr
    except subprocess.TimeoutExpired as e:
        rc, out, err = 124, e.stdout or "", e.stderr or ""
        out = out if isinstance(out, str) else out.decode()
        err = err if isinstance(err, str) else err.decode()
    lines = out.strip().splitlines()
    try:
        result = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        result = None
    return {"workload": workload, "seed": seed, "trace": trace, "rc": rc,
            "wall_s": time.perf_counter() - t0, "result": result,
            "stderr_tail": err[-3000:]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--timeout", type=float, default=1200)
    ap.add_argument("cells", nargs="+", help="workload:seed,seed,...")
    args = ap.parse_args(argv)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    by_cell = {}
    with open(args.out, "a") as f:
        for spec in args.cells:
            w, seeds = spec.split(":")
            for s in seeds.split(","):
                r = one(w, int(s), args.seconds, args.trace, args.timeout)
                f.write(json.dumps(r) + "\n")
                f.flush()
                res = r["result"] or {}
                m = {k: v["value"] for k, v in res.get("metrics", {}).items()}
                by_cell.setdefault(w, []).append(m)
                print(json.dumps({
                    "workload": w, "seed": int(s), "rc": r["rc"],
                    "wall_s": round(r["wall_s"], 2),
                    "correct": res.get("correct"),
                    "attempted": res.get("attempted"),
                    "failed": res.get("failed"), "metrics": m,
                    "device": res.get("device"),
                    "check": res.get("check")}), flush=True)
                if r["rc"] != 0 or not res.get("correct"):
                    print(r["stderr_tail"][-1500:], flush=True)
    for w, ms in by_cell.items():
        names = sorted({k for m in ms for k in m})
        summary = {}
        for n in names:
            xs = [m[n] for m in ms if n in m]
            summary[n] = {"median": statistics.median(xs),
                          "spread": (spread(xs) if len(xs) > 1
                                     and statistics.median(xs) else None),
                          "n": len(xs)}
        print(json.dumps({"workload": w, "summary": summary}), flush=True)


if __name__ == "__main__":
    main()
