#!/usr/bin/env python3
"""The readings that a cell's check limits are set from: for each seed, a
short window of the cell at its own size and load, once with the program
and, with --control, once more with the control (the plain reference in
TF32 put in the program's place); each run's numbers and `correct`.
One process for all seeds.

    python3 portbench/tools/readings.py --workload tris64k-primary \\
        --seconds 12 --seeds 101,102,103 --control 101,102,103 \\
        --out results/readings.jsonl"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
for p in (str(HERE), str(HERE.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control", default="", help="seeds of control runs")
    ap.add_argument("--control-seconds", type=float, default=1.0)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from harness import cell as cellmod
    from harness.spec import load_cell

    cell = load_cell(args.workload)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    rows = []
    runs = [(int(s), None) for s in args.seeds.split(",") if s]
    runs += [(int(s), "tf32") for s in args.control.split(",") if s]
    with open(args.out, "a") as f:
        for seed, ctl in runs:
            t0 = time.perf_counter()
            r = cellmod.run(cell, seed, args.control_seconds if ctl
                            else args.seconds, False, args.device, t0,
                            control_precision=ctl)
            row = {"workload": args.workload, "seed": seed,
                   "side": "control" if ctl else "program",
                   "numbers": {k: v["value"] for k, v in r["check"].items()},
                   "judged": r.get("judged"),
                   "attempted": r["attempted"], "failed": r["failed"],
                   "correct": r["correct"], "metrics": r["metrics"],
                   "device": r["device"], "wall_s": time.perf_counter() - t0}
            rows.append(row)
            f.write(json.dumps(row) + "\n")
            print(json.dumps(row), flush=True)
    for side, pick in (("program", max), ("control", min)):
        got = [r for r in rows if r["side"] == side]
        if got:
            print(json.dumps({
                "side": side, "seeds": len(got),
                "correct": sum(r["correct"] for r in got),
                side + "_" + pick.__name__: {
                    n: pick(r["numbers"][n] for r in got)
                    for n in got[0]["numbers"]}}), flush=True)


if __name__ == "__main__":
    main()
