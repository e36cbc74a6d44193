"""Timing on the card: CUDA events around a run of calls, one CUDA graph
of the calls, or events around one call. Used by the probes' drivers and
by chip_smoke.py."""

from __future__ import annotations

import torch


def events_ms(fn, n: int) -> float:
    """Mean ms per call of fn() over n calls after one warm-up, from CUDA
    events around the run (the host's cost of a call included once it
    exceeds the kernel's)."""
    fn()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(n):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n


def graph_ms(fn, n: int) -> float:
    """Mean device ms per call of fn(): n calls captured in one CUDA graph,
    replayed once between two CUDA events after a warm-up replay (so each
    captured kernel runs twice)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n


def once_ms(fn):
    """(fn(), ms) of one call, from CUDA events around it."""
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize()
    return out, t0.elapsed_time(t1)
