"""Kernel H: the gather forms of the TPU gather probes on the H100
(≙ benchmarks/pallas_gather_probe.py `kernel`, `kernel2` and
benchmarks/pallas_gather_probe2.py `kA`, `kB`, `kB2`, `kC`, `kE`, `kA100`,
`kC100`, `kD`), one CUDA kernel per form in csrc/gather_probe.cu, each
with a plain PyTorch twin of the same signature beside it:

  row     out[r] = table[idx[r], :]       table (8192, 48), idx (4096,)
  col     out[r] = a[r, col[r]]           a (4096, 32), col (4096,)
  A       o[f, l] = t[f, i[f, l]]         t (8, 128), i (8, 128)
  B       the same                        t (8, 1024), i (8, 1024)
  B2      the same                        t (8, 1024), i (8, 128)
  C       o[s, l] = t[i[s, l], l]         t (512, 128), i (8, 128)
  E       o = flat[i]                     flat (2048,), i (8, 128)
  A100    A chained 100 times on its own output
  C100    sum over s < 100 of t[(i + s) % 512, l], in order of s from zero
  D       sum of 10 products onehot(idx) @ t, t (N, 96) bf16, idx (256,),
          N = 2048 (D2048) and 8192 (D8192); exactly 10 * t[idx]

All tables are f32 but D's; indices are int32 and must lie inside their
tables. A wrapper runs the twin only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises. `LAUNCHES` counts kernel
launches per wrapper: never twin calls, and never a call captured into a
CUDA graph (recorded there, not run; the graph's replays run it).

    python -m tinybvh_tpu_torch.probes.gather

runs every form on the card: each kernel against its twin (torch.equal),
its time from CUDA events over 200 launches and its device time from one
CUDA graph of 200 launches; then the device time of an empty kernel's
launch (launch_floor_ms), the least any form can take.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from tinybvh_tpu_torch import _build
from tinybvh_tpu_torch.core.rays import default_device
from tinybvh_tpu_torch._timing import events_ms, graph_ms
from tinybvh_tpu_torch._trace import count_launch, launch_table
from tinybvh_tpu_torch.traverse.packet2 import _check, _on_cuda

F, W = 8, 128          # the (8, 128) block of the lane and chain forms
ROUNDS = 100           # chained rounds of A100 and C100
REPS = 10              # one-hot products of D
ONEHOT_M, ONEHOT_F = 64, 96  # D's kernel: 64-row output blocks, 96 columns
N_TIMED = 200          # launches timed by events and by a CUDA graph
LAUNCHES = launch_table(__name__, (
    "row_gather", "col_gather", "lane_gather", "sublane_gather", "flat_take",
    "chain_gather", "sum_gather", "onehot_gather"))


def _launch(name, entry, *args):
    """Call C entry `entry` with tensors as pointers, ints as ints, on the
    current stream; count the launch unless a CUDA graph captures it."""
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    err = getattr(_build.kernels(), entry)(
        *conv, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, entry)
    count_launch(LAUNCHES, name)


# ---- row: table rows by index (pallas_gather_probe.py:20) ----------------

def _row_plain(table, idx):
    return table[idx.long()]


ROW_PATHS = ("shape", "general", "earlier")  # tbvh_gather_row's `path`


def row_gather(table, idx, path="shape"):
    """Any (M, C) f32 table. The C entry gives rows of a multiple of 4
    floats (at most 1,024) in 16-byte aligned tables with offsets below
    2^31 its rows path (one 16-byte word a thread), any other table its
    general one (one float a thread, 64-bit offsets). `path` "general"
    forces the general path, "earlier" the design before the rows path
    (one 16-byte word a thread of a 1-D grid, the rows path's shapes
    only), for tests and timing. No indices (or no columns): the empty
    result, no launch."""
    if not _on_cuda("row_gather", table, idx):
        return _row_plain(table, idx)
    M, C = table.shape
    R = idx.shape[0]
    _check("row table", table, torch.float32, (M, C))
    _check("row idx", idx, torch.int32, (R,))
    out = torch.empty((R, C), dtype=torch.float32, device=table.device)
    if out.numel():
        _launch("row_gather", "tbvh_gather_row", table, idx, out, M, R, C,
                ROW_PATHS.index(path))
    return out


# ---- col: one lane per row (pallas_gather_probe.py:51) -------------------

def _col_plain(a, col):
    return a.gather(1, col.long()[:, None])[:, 0]


def col_gather(a, col):
    """The C entry gives short rows (C a multiple of 4, at most 32 floats,
    a 16-byte aligned, at most 2^18 floats in all) four lanes each, which
    load the row with its index; any other shape reads a[r, col[r]] from
    L2 after the index."""
    if not _on_cuda("col_gather", a, col):
        return _col_plain(a, col)
    R, C = a.shape
    _check("col a", a, torch.float32, (R, C))
    _check("col col", col, torch.int32, (R,))
    out = torch.empty(R, dtype=torch.float32, device=a.device)
    _launch("col_gather", "tbvh_gather_col", a, col, out, R, C)
    return out


# ---- A, B, B2: lanes of an (8, TW) table (pallas_gather_probe2.py:50-81) --

def _lane_plain(t, i):
    return t.gather(1, i.long())


def lane_gather(t, i):
    """The kernel runs one CTA per (row, output slice) and stages only that
    row: at TW = 128 (A) 128 outputs a CTA, one scalar load a thread; at
    TW = 1024 (B, B2) 256 outputs a CTA, by 16-byte loads, so a 1024-wide
    t must be 16-byte aligned."""
    if not _on_cuda("lane_gather", t, i):
        return _lane_plain(t, i)
    TW, OW = t.shape[1], i.shape[1]
    if TW not in (128, 1024):
        raise ValueError(f"lane_gather: table width {TW} not 128 or 1024")
    _check("lane t", t, torch.float32, (F, TW))
    _check("lane i", i, torch.int32, (F, OW))
    if TW == 1024 and t.data_ptr() % 16:
        raise ValueError("lane_gather: a 1024-wide t must be 16-byte aligned")
    out = torch.empty((F, OW), dtype=torch.float32, device=t.device)
    _launch("lane_gather", "tbvh_gather_lane", t, i, out, TW, OW)
    return out


# ---- C: sublanes of a (N, W) table (pallas_gather_probe2.py:93) ----------

def _sublane_plain(t, i):
    return t.gather(0, i.long())


def sublane_gather(t, i):
    """The kernel reads t[i, l] from L2 after the index, one output a
    thread of a (W / 128, S) grid; any shape."""
    if not _on_cuda("sublane_gather", t, i):
        return _sublane_plain(t, i)
    N, Wt = t.shape
    _check("sublane t", t, torch.float32, (N, Wt))
    _check("sublane i", i, torch.int32, (i.shape[0], Wt))
    out = torch.empty(i.shape, dtype=torch.float32, device=t.device)
    _launch("sublane_gather", "tbvh_gather_sublane", t, i, out, i.shape[0], Wt)
    return out


# ---- E: flat take (pallas_gather_probe2.py:107) --------------------------

def _flat_plain(flat, i):
    return flat[i.long()]


def flat_take(flat, i):
    """The C entry stages the whole table in each CTA's shared memory where
    it is short (at most 8,192 floats, a multiple of 4, 16-byte aligned,
    16 MB of copies in all); any other table is read from L2."""
    if not _on_cuda("flat_take", flat, i):
        return _flat_plain(flat, i)
    _check("flat table", flat, torch.float32, (flat.shape[0],))
    _check("flat i", i, torch.int32, tuple(i.shape))
    out = torch.empty(i.shape, dtype=torch.float32, device=flat.device)
    _launch("flat_take", "tbvh_gather_flat", flat, i, out, i.numel(),
            flat.shape[0])
    return out


# ---- A100: chained lane gathers (pallas_gather_probe2.py:120) ------------

def _chain_plain(t, i):
    acc, il = t, i.long()
    for _ in range(ROUNDS):
        acc = acc.gather(1, il)
    return acc


def chain_gather(t, i):
    """o[f, l] = t[f, i^ROUNDS(l)]: the kernel composes row f's index map
    by doubling."""
    if not _on_cuda("chain_gather", t, i):
        return _chain_plain(t, i)
    _check("chain t", t, torch.float32, (F, W))
    _check("chain i", i, torch.int32, (F, W))
    out = torch.empty((F, W), dtype=torch.float32, device=t.device)
    _launch("chain_gather", "tbvh_gather_chain", t, i, out, ROUNDS)
    return out


# ---- C100: shifted sublane sums (pallas_gather_probe2.py:134) ------------

def _sum_plain(t, i):
    N = t.shape[0]
    acc = torch.zeros(i.shape, dtype=torch.float32, device=t.device)
    for s in range(ROUNDS):
        acc = acc + t.gather(0, ((i + s) % N).long())
    return acc


def sum_gather(t, i):
    """At the probe's shape the kernel stages the table's column slices in
    shared memory; its C entry reads any other shape from L2."""
    if not _on_cuda("sum_gather", t, i):
        return _sum_plain(t, i)
    N, Wt = t.shape
    _check("sum t", t, torch.float32, (N, Wt))
    _check("sum i", i, torch.int32, (i.shape[0], Wt))
    out = torch.empty(i.shape, dtype=torch.float32, device=t.device)
    _launch("sum_gather", "tbvh_gather_sum", t, i, out, i.shape[0], Wt, N,
            ROUNDS)
    return out


# ---- D: one-hot products on the tensor cores (pallas_gather_probe2.py:155)

def _onehot_plain(t, idx):
    """Each one-hot product picks t[idx] exactly (one nonzero term a
    row), so the sum of REPS of them is REPS additions of t[idx]."""
    acc = torch.zeros((idx.shape[0], t.shape[1]), dtype=torch.float32,
                      device=t.device)
    rows = t[idx.long()].float()
    for _ in range(REPS):
        acc = acc + rows
    return acc


def onehot_gather(t, idx):
    if not _on_cuda("onehot_gather", t, idx):
        return _onehot_plain(t, idx)
    N, Ft = t.shape
    M = idx.shape[0]
    _check("onehot t", t, torch.bfloat16, (N, Ft))
    _check("onehot idx", idx, torch.int32, (M,))
    if M % ONEHOT_M or N % 16 or Ft != ONEHOT_F or t.data_ptr() % 16:
        raise ValueError(f"onehot_gather: M {M} must be a multiple of "
                         f"{ONEHOT_M}, N {N} of 16, F {Ft} must be "
                         f"{ONEHOT_F} and t 16-byte aligned")
    out = torch.empty((M, Ft), dtype=torch.float32, device=t.device)
    _launch("onehot_gather", "tbvh_gather_onehot", t, idx, out, M, N, Ft, REPS)
    return out


# ---- the launch floor -------------------------------------------------------

def _empty(dev):
    err = _build.kernels().tbvh_gather_empty(
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "tbvh_gather_empty")


def launch_floor_ms(device) -> float:
    """Device ms of one launch of an empty kernel (one warp), from one CUDA
    graph of N_TIMED launches: what any launch of these forms costs before
    its work. It computes nothing, so nothing counts it."""
    return graph_ms(lambda: _empty(device), N_TIMED)


# ---- the forms at the probes' shapes --------------------------------------

@dataclass(frozen=True)
class Form:
    wrapper: Callable  # the kernel's wrapper (its LAUNCHES entry's name)
    plain: Callable    # its twin
    replaces: str      # the TPU kernel (file:line)
    work: str          # what one call computes


FORMS = {
    "row": Form(row_gather, _row_plain,
                "benchmarks/pallas_gather_probe.py:20",
                "table (8192, 48) f32 by idx (4096,) -> (4096, 48)"),
    "col": Form(col_gather, _col_plain,
                "benchmarks/pallas_gather_probe.py:51",
                "a (4096, 32) f32, col (4096,) -> (4096,)"),
    "A": Form(lane_gather, _lane_plain,
              "benchmarks/pallas_gather_probe2.py:50",
              "t (8, 128) f32, i (8, 128) -> (8, 128)"),
    "B": Form(lane_gather, _lane_plain,
              "benchmarks/pallas_gather_probe2.py:65",
              "t (8, 1024) f32, i (8, 1024) -> (8, 1024)"),
    "B2": Form(lane_gather, _lane_plain,
               "benchmarks/pallas_gather_probe2.py:78",
               "t (8, 1024) f32, i (8, 128) -> (8, 128)"),
    "C": Form(sublane_gather, _sublane_plain,
              "benchmarks/pallas_gather_probe2.py:93",
              "t (512, 128) f32, i (8, 128) -> (8, 128)"),
    "E": Form(flat_take, _flat_plain,
              "benchmarks/pallas_gather_probe2.py:107",
              "flat (2048,) f32, i (8, 128) -> (8, 128)"),
    "A100": Form(chain_gather, _chain_plain,
                 "benchmarks/pallas_gather_probe2.py:120",
                 "A chained 100 times on (8, 128)"),
    "C100": Form(sum_gather, _sum_plain,
                 "benchmarks/pallas_gather_probe2.py:134",
                 "100 shifted gathers of (512, 128) summed -> (8, 128)"),
    "D2048": Form(onehot_gather, _onehot_plain,
                  "benchmarks/pallas_gather_probe2.py:155",
                  "10 x onehot (256, 2048) @ t (2048, 96) bf16 -> f32"),
    "D8192": Form(onehot_gather, _onehot_plain,
                  "benchmarks/pallas_gather_probe2.py:155",
                  "10 x onehot (256, 8192) @ t (8192, 96) bf16 -> f32"),
}


def make_inputs(seed: int = 0, device=None) -> dict:
    """Each form's arguments at the probes' shapes, drawn from one numpy
    generator seeded with `seed` (uniform [0, 1) tables, uniform
    indices); D's tables are rounded to bf16 (to nearest even)."""
    dev = default_device(device)
    rng = np.random.default_rng(seed)

    def f32(*shape):
        return rng.random(shape, dtype=np.float32)

    def i32(hi, *shape):
        return rng.integers(0, hi, shape, dtype=np.int32)

    t_a, t_b = f32(F, W), f32(F, 1024)
    t_c = f32(512, W)
    host = {
        "row": (f32(8192, 48), i32(8192, 4096)),
        "col": (f32(4096, 32), i32(32, 4096)),
        "A": (t_a, i32(W, F, W)),
        "B": (t_b, i32(1024, F, 1024)),
        "B2": (t_b, i32(1024, F, W)),
        "C": (t_c, i32(512, F, W)),
        "E": (f32(2048), i32(2048, F, W)),
    }
    host["A100"] = host["A"]
    host["C100"] = host["C"]
    out = {k: tuple(torch.from_numpy(x).to(dev) for x in v)
           for k, v in host.items()}
    for n in (2048, 8192):
        t = torch.from_numpy(f32(n, 96)).to(torch.bfloat16).to(dev)
        out[f"D{n}"] = (t, torch.from_numpy(i32(n, 256)).to(dev))
    return out


def run(device=None):
    """Each form's kernel on its inputs (on the CPU: its twin): the output,
    its time from CUDA events over N_TIMED launches and its device time
    from one CUDA graph of N_TIMED launches (None off the card), the
    wrapper's launches in this run (the graph's aren't counted) and the
    kernel's runs from the graph's two replays. Then the twin on the same
    inputs: the largest difference, which must be 0 (raises otherwise)."""
    inputs = make_inputs(0, device)
    res = {}
    for name, form in FORMS.items():
        fn, args = form.wrapper, inputs[name]
        before = LAUNCHES[fn.__name__]
        out = fn(*args)
        on_gpu = out.is_cuda
        ms = events_ms(lambda: fn(*args), N_TIMED) if on_gpu else None
        dev_ms = graph_ms(lambda: fn(*args), N_TIMED) if on_gpu else None
        launches = LAUNCHES[fn.__name__] - before
        ref = form.plain(*args)
        if not torch.equal(out, ref):
            raise AssertionError(f"gather {name}: kernel differs from its "
                                 "plain twin")
        res[name] = dict(args=args, out=out, ms=ms, device_ms=dev_ms,
                         launches=launches,
                         graph_runs=2 * N_TIMED if on_gpu else 0,
                         max_abs_err=float((out.double() - ref.double())
                                           .abs().max()))
    return res


def main() -> int:
    dev = default_device(None)
    res = run(dev)
    print(f"gather launch floor (an empty kernel): device "
          f"{launch_floor_ms(dev):.4f} ms", flush=True)
    for name, r in res.items():
        print(f"gather {name:5s} {FORMS[name].work}: kernel {r['ms']:.4f} ms, "
              f"device {r['device_ms']:.4f} ms, equal to its twin "
              f"({torch.cuda.get_device_name(dev)})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
