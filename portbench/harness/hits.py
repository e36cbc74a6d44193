"""The visible surface points that shadow and bounce rays start from:
the closest hits of a camera mix's rays, found by the plain reference,
so that no ray depends on the program's answers.

A path tracer sends a shadow ray and a bounce ray from each primary hit;
upstream tinybvh's speedtest builds both batches so, from its reference
build's primary hits (tiny_bvh_speedtest.cpp:557-587)."""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from harness.spec import load_json, load_module

MAX_BATCHES = 64      # camera batches tried before giving up


@dataclass
class Hits:
    """Each (N, 3) float32: the hit point, the surface's world-space unit
    normal turned towards the ray that found it, and that ray's
    direction; and the seconds the reference took."""

    point: torch.Tensor
    normal: torch.Tensor
    incoming: torch.Tensor
    reference_s: float


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def primary_hits(scene, base, mix: str, gen, need: int) -> Hits:
    """The first `need` hits of the camera mix traffic/<mix>.json: its
    batches in their order (batch i from the mix's rays kind, with its
    index i), each batch's hits in the batch's ray order."""
    p = load_json(base / "traffic" / f"{mix}.json")
    kind = load_module(base, "rays", p["rays"])
    got, n, ref_s = [], 0, 0.0
    for i in range(MAX_BATCHES):
        if n >= need:
            break
        o, d = kind.make(scene, p, gen, i)
        _sync(scene.device)
        t0 = time.perf_counter()
        t, hit = scene.closest(o, d)
        _sync(scene.device)
        ref_s += time.perf_counter() - t0
        keep = torch.nonzero(hit >= 0).squeeze(1)
        t, hit, o, d = t[keep], hit[keep], o[keep], d[keep]
        got.append((o + t[:, None] * d, scene.normals(hit, d), d))
        n += keep.numel()
    if n < need:
        raise ValueError(f"{MAX_BATCHES} batches of {mix!r} hit the scene "
                         f"{n} times, fewer than the {need} asked for")
    cat = [torch.cat(x)[:need].contiguous() for x in zip(*got)]
    return Hits(*cat, reference_s=ref_s)
