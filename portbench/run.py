#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the card.

    python3 portbench/run.py --workload tris64k-primary --seed 7 \
        --seconds 51 --trace 0

Run from the root of a checkout (BENCHMARK.json beside portbench/). The
last line of standard output is one JSON object: correct, attempted,
failed, metrics (the cell's end-to-end metrics, or with --trace 1 its
per-layer ones), device, with --trace 1 breakdown, and last check: each
number of the output check beside its limit (also the last lines of
standard error). Exits non-zero, with no result, without a CUDA device,
with fewer devices than the cell asks for, or where JAX or the JAX
package was loaded."""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for p in (str(HERE), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)

    import torch

    from harness import cell as cellmod
    from harness.spec import load_cell

    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA devices, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = cellmod.run(cell, args.seed % 2 ** 63, args.seconds,
                         bool(args.trace), "cuda", T0)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
