#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port's main path once on one GPU.

    python3 chip_smoke.py

Phases (each prints one line; any failure raises and exits non-zero):
  1. device: needs torch.cuda; prints the card's name and power limit;
  2. build: the CUDA kernels (csrc/*.cu, nvcc) and the native host
     builder (tinybvh_tpu_torch/native/builder.c, cc), from the checkout;
  3. kernels A and B against their plain PyTorch twins on the card, every
     output bit for bit, at the shapes of the main path:
     random_tris(65536, seed=0), 640x640 camera rays in 16x16 tile order;
     then a line of their registers, shared memory, resident CTAs per SM
     and device time alone (a CUDA graph of the calls);
  4. main path through the API: BVH(tris, device="cuda").intersect(rays)
     and .is_occluded() for shadow segments from a point light to the
     hit points, with the wavefront retrace; launch counts, zero residual
     overflow, and agreement with the brute-force oracle on a 2048-ray
     subset (prim agreement >= 0.999, hit-t checksum within 1%, as
     tiny_bvh_speedtest.cpp's ValidateTraceResult gate); the same calls
     with the escalated packet retrace (16384 leaves) timed beside them;
  5. real size: the 4x4 grid of that scene (1,048,576 triangles), one
     primary trace through intersect_packets2 with the grid16 budgets,
     kernel G against its twin on that trace's cull descriptors (nbpad >
     128), and the API's default path (primary and shadow, wavefront
     retrace) gated by the oracles, with its peak device memory;
  6. kernels C and G against their twins: C at the fused=False path's
     shapes (T=1600 tiles, max_leaves=512, K4=2048 rows), G at the API's
     cull descriptors (G=200 groups);
  7. the cull-stage probes' path (benchmarks/cull_stage_probe.py): the
     coarse tier through kernel G, the worklists, kernel A; equal to the
     production cull's worklists, survivor counts and keys;
  8. the fused=False path (kernel C) and sort=True against the fused path
     on every ray, and the oracle on 2048 rays; each timed with and
     without the wavefront retrace;
  9. the wavefront retrace on the card: a 64-leaf first budget that
     overflows most tiles, closest hit and the any-hit shadow trace,
     gated by the oracles with zero residual overflow;
 10. the API off the packet path: 1000 rays and 4096 rays with a per-ray
     t_max (wavefront engine, with its lockstep fallback), engine=
     "lockstep", and 1000 rays on a sphere (the wavefront's own hits),
     each against the oracle on every ray;
 11. the v1 packet engine (traverse/packet.py intersect_packets) on the
     same rays at 512 leaves, pair cap 64 per tile, chunk 32, in its four
     modes (default frontier, phase1_flat, kernel D, kernels F + D), each
     with zero overflowed tiles and the oracle gates, prims equal across
     modes; kernels D (v2 and v3 bodies), E and F against their twins bit
     for bit (F also at 64 leaves, where tiles overflow); the shadow
     segments of phase 4's light through is_occluded_packets (kernel D,
     2048 leaves, pair cap 512: see V1_SHADOW)
     and the rays, shuffled inside each tile, through
     intersect_packets_sorted;
 12. inst512 (bench.py:779-788): 8x8x8 instances of the random64k BLAS,
     512x512 camera rays in tile order through the bucketed TLAS engine
     (tlas/packet.py: kernels A and B once per candidate round and per
     escalation pass; INST512, escalation over the whole BLAS, the h100
     row's wavefront cap), rounds raised to the per-tile candidate
     maximum + 1 if that exceeds 28; TLAS build time, hit rate, MRays/s,
     launches per call, zero residual overflow, and the lockstep
     two-level oracle on 2048 middle rays (t-agree, inst-agree and
     prim-agree >= 0.999, checksum within 1%); A and B against their
     twins (torch.equal) on the round with the most live tiles and on an
     escalation pass, timed at those shapes; a torch.profiler breakdown
     of one call (kernels A+B, other kernels, the device's idle share);
 12b. inst8 (bench.py:772-778): 2x2x2 instances through the bucketed
     engine (INST8), the per-instance engine, TLAS.intersect (16384
     rays), the two-level wavefront at cap 6 (timed; gated only if it
     does not overflow) and shadow segments from a light above the grid
     through is_occluded_tlas_packets2, each against the lockstep oracle
     (the two engines with a profiler breakdown);
 13. refit per frame (bench.py:304-318): refit_bvh8 + build_packet_aux
     on the card for a deformed random64k, timed; the moved camera rays
     through intersect_packets2 on the refit tables and, after BVH.refit,
     through BVH.intersect, each gated by the brute-force oracle (the
     frame and the trace with a profiler breakdown);
 14. the probes (tinybvh_tpu_torch/probes/): both drivers on the card, the
     launch counts reset before them and read after (eager launches:
     the wrappers do not count calls that a CUDA graph captures, whose
     kernels then run twice in the graph's replays). Kernel H, each of
     the TPU gather probes' forms at the probes' shapes: the kernel (CUDA
     events over 200 launches), its device time (one CUDA graph of 200
     launches), its twin, the one PyTorch call that computes it
     (index_select, gather, take, or one bf16 matmul of D's ten; events
     and a CUDA graph, as the kernel) and its bound. Kernel I, kernel
     B's tile loop in eight variants at 16, 64 and 256 clustered keys a
     tile and at 64 scattered ones (T = 1,600, k_cap 256, the random64k
     packet tables): each variant's time, device time, twin and bound,
     and the split of the loop by subtraction. Every kernel against its
     twin:
     torch.equal, bf16 within its tolerance (probes/mt_ablation.py check);
then a JSON line of the kernels (launches counted on each kernel's
own path: A and B in phase 4, G in phase 7, C in phase 8, D-v2 in phase
11's kernel-D trace, F in its F + D trace, D-v3 and E in their own
drives on that trace's inputs, since no path of the package runs them;
A and B also carry tlas_launches, their launches in one phase 12
bucketed call; H and I theirs in phase 14's drivers, with device_ms,
graph_runs and, for I, whose entry is the full variant at 64 clustered
keys a tile, a `variants` dict), each with its time, its plain twin's, and its bound (BOUND_RATES),
and as the last line {"ok": true, "device": {...}}.

Precision: TF32 stays off (torch.backends.cuda.matmul.allow_tf32 and
torch.backends.cudnn.allow_tf32 False); the ray path uses no tensor
cores (only the probes' bf16 products do). Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

REPLACES = {"cull": "tinybvh_tpu/traverse/packet2.py:488",
            "mt_fused": "tinybvh_tpu/traverse/packet2.py:858",
            "mt_gathered": "tinybvh_tpu/traverse/packet2.py:756",
            "cull_blocks": "tinybvh_tpu/traverse/packet2.py:455",
            "leaf_resolve_v2": "tinybvh_tpu/traverse/pallas_leaf.py:92",
            "leaf_resolve_v3": "tinybvh_tpu/traverse/pallas_leaf.py:151",
            "leaf_resolve": "tinybvh_tpu/traverse/pallas_leaf.py:34",
            "frustum_walk": "tinybvh_tpu/traverse/pallas_frustum.py:40",
            "gather_row": "benchmarks/pallas_gather_probe.py:20",
            "gather_col": "benchmarks/pallas_gather_probe.py:51",
            "gather_A": "benchmarks/pallas_gather_probe2.py:50",
            "gather_B": "benchmarks/pallas_gather_probe2.py:65",
            "gather_B2": "benchmarks/pallas_gather_probe2.py:78",
            "gather_C": "benchmarks/pallas_gather_probe2.py:93",
            "gather_E": "benchmarks/pallas_gather_probe2.py:107",
            "gather_A100": "benchmarks/pallas_gather_probe2.py:120",
            "gather_C100": "benchmarks/pallas_gather_probe2.py:134",
            "gather_D2048": "benchmarks/pallas_gather_probe2.py:155",
            "gather_D8192": "benchmarks/pallas_gather_probe2.py:155",
            "mt_ablation": "benchmarks/mt_ablation_probe.py:115"}
SOURCES = {"cull": "cull.cu", "mt_fused": "mt_fused.cu",
           "mt_gathered": "mt_gathered.cu", "cull_blocks": "cull_blocks.cu",
           "leaf_resolve_v2": "leaf_resolve.cu",
           "leaf_resolve_v3": "leaf_resolve.cu",
           "leaf_resolve": "leaf_resolve.cu",
           "frustum_walk": "frustum_walk.cu",
           **dict.fromkeys([k for k in REPLACES if k.startswith("gather")],
                           "gather_probe.cu"),
           "mt_ablation": "mt_ablation.cu"}
ORACLE_RAYS = 2048

# The least time the card could take for a kernel's work: the larger of
# its bytes (each input read once, each output written once) over the
# memory rate and its fp32 operations over the fp32 rate outside the
# tensor cores (NVIDIA's H100 SXM data sheet, at the full 700 W).
# Kernels on the tensor cores (the probes' bf16 products) count those
# operations at the dense bf16 rate.
BOUND_RATES = {"bytes_per_s": 3.35e12, "fp32_per_s": 67e12,
               "bf16_per_s": 989e12}
# fp32 operations per unit of work, counted from each kernel's source:
#   cull: per (segment, tile) test: 4 planes x 3 axes x (2 mul + 2 add)
#     + 4 compares, the reach cap's 3 x (2 sub, max, clamp, mul, add) +
#     sqrt + compare;
#   cull_blocks: per (block, tile) test: the 4-plane test alone;
#   mt_fused: per (triangle, ray): four 12-lane dots (96), sign flip (5),
#     hit test (6), divide and select (2), u and v (2), argmin (1);
#   mt_gathered: per (triangle row, ray): the same without u and v;
#   leaf_resolve*: per (triangle, ray): classic Möller–Trumbore (55:
#     common.cuh classic_mt) and the argmin compare (1);
#   frustum_walk: per pop: 8 children x 4 planes x 3 axes x (compare,
#     select, mul, add) + 32 compares.
OPS_PER_UNIT = {"cull": 76, "cull_blocks": 52, "mt_fused": 112,
                "mt_gathered": 110, "leaf_resolve_v2": 56,
                "leaf_resolve_v3": 56, "leaf_resolve": 56,
                "frustum_walk": 416}
# Kernel I (csrc/mt_ablation.cu), per (row, ray) its result needs
# (mt_ablation.tested_pairs: the live rows of the walked super-blocks;
# every walked row for mathonly, which masks nothing): the dots 96 (48
# multiplies, 48 adds), the epilogue 16 (sign select and 4 flips, the
# hit test's 5 compares and 1 add, the live test, reciprocal, multiply,
# select, the first-minimum compare); mathonly: the dots, 3 adds and a
# min; bf16: the dots as 96 bf16 operations (K = 12, the padding not
# counted), the epilogue in fp32; skeleton: one add per ray, no row.
ABLATION_OPS = {"mathonly": {"fp32": 100}, "bf16": {"bf16": 96, "fp32": 16}}
ABLATION_OPS_DEFAULT = {"fp32": 112}


def camera_rays(lo, hi, W=640, H=640):
    """bench.py's camera recipe: 16x16 tile order, one shared eye."""
    center = (lo + hi) * 0.5
    extent = float(np.max(hi - lo))
    eye = center + np.array([0.6, 0.35, 1.1]) * extent * 1.2
    fwd = center - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, [0, 1, 0])
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    xs = (np.arange(W) + 0.5) / W - 0.5
    ys = (np.arange(H) + 0.5) / H - 0.5
    gx, gy = np.meshgrid(xs, ys)
    d = (fwd[None, None] + 0.9 * gx[..., None] * right[None, None]
         + 0.9 * gy[..., None] * up[None, None])
    d = d / np.linalg.norm(d, axis=2, keepdims=True)
    d = d.reshape(H // 16, 16, W // 16, 16, 3).transpose(0, 2, 1, 3, 4)
    d = d.reshape(-1, 3).astype(np.float32)
    o = np.broadcast_to(eye.astype(np.float32), d.shape).copy()
    return o, d, center, extent


def grid_scene(tris, nx, ny):
    """bench.py's _bunny_grid: nx*ny translated copies of a scene."""
    ex = tris.reshape(-1, 3).max(0) - tris.reshape(-1, 3).min(0)
    return np.concatenate(
        [tris + np.array([ex[0] * 1.1 * i, ex[1] * 1.1 * j, 0], np.float32)
         for i in range(nx) for j in range(ny)])


def sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_ms(fn, dev, n):
    """Mean ms per call over n calls after one warm-up: CUDA events on the
    card (tinybvh_tpu_torch._timing.events_ms), the host clock elsewhere."""
    if dev.type == "cuda":
        from tinybvh_tpu_torch._timing import events_ms

        return events_ms(fn, n)
    fn()
    s = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - s) * 1e3 / n


def device_ms(fn, n):
    """Mean device time per call of fn(): n calls captured in one CUDA
    graph (tinybvh_tpu_torch._timing.graph_ms). Unlike time_ms it leaves
    out the host's cost of a call, which events around a run of calls
    include once a kernel is shorter than its wrapper."""
    from tinybvh_tpu_torch._timing import graph_ms

    return graph_ms(fn, n)


def wall_s(fn, dev, reps=3):
    """Median wall seconds of fn() ending in a device synchronize."""
    fn()
    sync(dev)
    ts = []
    for _ in range(reps):
        s = time.perf_counter()
        fn()
        sync(dev)
        ts.append(time.perf_counter() - s)
    return float(np.median(ts))


def capture(packet2, names):
    """Patch packet2.<name> to record each call's arguments; returns
    (records, restore)."""
    rec = {n: [] for n in names}
    real = {n: getattr(packet2, n) for n in names}

    def wrap(n):
        def f(*args):
            rec[n].append(args)
            return real[n](*args)
        return f

    for n in names:
        setattr(packet2, n, wrap(n))

    def restore():
        for n in names:
            setattr(packet2, n, real[n])
    return rec, restore


def oracle_subset(R, dev):
    """ORACLE_RAYS rays spread evenly over the image."""
    import torch

    return torch.arange(0, R, R // ORACLE_RAYS, device=dev)[:ORACLE_RAYS]


def oracle_check(hits_sub, rays_sub, tris, what):
    """prim agreement and the hit-t checksum ratio against brute force."""
    from tinybvh_tpu_torch.core.intersect import brute_force_closest

    ref = brute_force_closest(rays_sub, tris)
    agree = float((hits_sub.prim == ref.prim).float().mean())
    # the reference's gate sums hit t over hits (speedtest.cpp:348-366)
    s_ours = float(hits_sub.t[hits_sub.prim >= 0].double().sum())
    s_ref = float(ref.t[ref.prim >= 0].double().sum())
    if s_ref <= 0.0:
        raise AssertionError(f"{what}: the oracle subset hits nothing")
    ratio = s_ours / s_ref
    if not (agree >= 0.999 and abs(ratio - 1.0) <= 0.01):
        raise AssertionError(f"{what}: oracle prim-agree {agree}, checksum "
                             f"ratio {ratio}")
    return agree, ratio


def launch_tables():
    """Every kernel module's launch counters."""
    from tinybvh_tpu_torch.traverse import frustum_walk, leaf_resolve, packet2

    return (packet2.LAUNCHES, leaf_resolve.LAUNCHES, frustum_walk.LAUNCHES)


def reset_launches():
    for table in launch_tables():
        for k in table:
            table[k] = 0


def read_launches(dev, names, what):
    """The launch counts of `names` since the last reset; on the card each
    must be > 0."""
    sync(dev)
    counts = {k: v for table in launch_tables() for k, v in table.items()}
    got = {k: counts[k] for k in names}
    if dev.type == "cuda" and min(got.values()) == 0:
        raise AssertionError(f"{what} skipped a kernel: {got}")
    return got


def nbytes(xs):
    import torch

    return sum(x.numel() * x.element_size() for x in xs
               if isinstance(x, torch.Tensor))


def bound_of(n_bytes, ops):
    """bound_ms and bound_by of n_bytes moved and ops {"fp32": n, "bf16":
    n} of operations, each kind at its rate (BOUND_RATES)."""
    t_bytes = n_bytes / BOUND_RATES["bytes_per_s"]
    t_ops = sum(n / BOUND_RATES[f"{kind}_per_s"] for kind, n in ops.items())
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def bound(name, args, outs, units):
    """bound_ms and bound_by of kernel `name` on these arguments: `units`
    of work (OPS_PER_UNIT), the tensor arguments read once and the
    outputs written once."""
    return dict(**bound_of(nbytes(args) + nbytes(outs),
                           {"fp32": units * OPS_PER_UNIT[name]}),
                library_ms=None)


def live_rows(geom, n_run=None):
    """Rows of a gathered table (T, K, lanes) that are not all zero (dead
    rows are); with n_run (T,), only among the first n_run rows of each
    tile."""
    import torch

    live = (geom != 0).any(dim=-1)
    if n_run is not None:
        live &= (torch.arange(geom.shape[1], device=geom.device)
                 < n_run[:, None])
    return int(live.sum())


def fused_tests(b, n_sb):
    """(triangle, ray) tests that kernel B's arguments `b` need: the
    nonzero triangles of the live keys in the super-blocks each tile ran
    before its gate stopped it (n_sb, from the plain twin), times 256
    rays."""
    import torch

    offs, counts, gtab = b[0], b[1], b[6]
    k_cap, tri_blk, rps, pack = b[7], b[8], b[9], b[10]
    dev = offs.device
    keys = torch.minimum(n_sb * (tri_blk // rps),
                         counts.clamp(max=k_cap).long())
    run = torch.arange(k_cap, device=dev) < keys[:, None]
    rows = offs[run].long()[:, None] + torch.arange(rps, device=dev)
    tris = gtab[:, :48 * pack][rows].reshape(-1, pack, 48)
    return int((tris != 0).any(dim=-1).sum()) * 256


def kernel_line(phase, name, r, gpu_line):
    print(f"phase {phase} kernel {name}: {r['shape']} max_abs_err "
          f"{r['max_abs_err']} kernel {r['ms']:.4f} ms plain "
          f"{r['plain_ms']:.4f} ms bound {r['bound_ms']:.4f} ms "
          f"({r['bound_by']}) [{gpu_line}]", flush=True)


def phase_kernels(bvh, rays, gpu_line, n_kernel=20, n_plain=3):
    """Kernel A and B against their plain twins on the arguments the API
    path hands them (first cull pass and its MT resolve), every output
    bit for bit. Returns the results and the arguments of both (kernel G
    reuses A's descriptors)."""
    from tinybvh_tpu_torch.traverse import packet2

    rec, restore = capture(packet2, ("cull", "mt_fused"))
    try:
        bvh.intersect(rays)
    finally:
        restore()
    dev = rays.o.device
    on_gpu = dev.type == "cuda"
    out = {}

    a = rec["cull"][0]
    kern = packet2._cull_cuda if on_gpu else packet2._cull_plain
    ref_a = packet2._cull_plain(*a)
    got = kern(*a)
    out["cull"] = dict(max_abs_err=equal_twin("cull", got, ref_a),
                       ms=time_ms(lambda: kern(*a), dev, n_kernel),
                       plain_ms=time_ms(lambda: packet2._cull_plain(*a), dev,
                                        n_plain),
                       shape=f"G={a[1].shape[0]} max_blocks={a[1].shape[1]}"
                             f" k_cap={a[6]}",
                       **bound("cull", a, got,
                               int(a[0].sum()) * packet2.LANES
                               * packet2.TB))

    b = rec["mt_fused"][0]

    def plain_b(*args):
        return packet2._mt_fused_plain(*args)[:5]

    kern = packet2._mt_fused_cuda if on_gpu else plain_b
    *ref_b, n_sb = packet2._mt_fused_plain(*b)
    got = kern(*b)
    out["mt_fused"] = dict(max_abs_err=equal_twin("mt_fused", got, ref_b),
                           ms=time_ms(lambda: kern(*b), dev, n_kernel),
                           plain_ms=time_ms(lambda: plain_b(*b), dev,
                                            n_plain),
                           shape=f"T={b[0].shape[0]} k_cap={b[7]} "
                                 f"tri_blk={b[8]} rps={b[9]}",
                           **bound("mt_fused", b, got, fused_tests(b, n_sb)))
    for name, r in out.items():
        kernel_line(3, name, r, gpu_line)
    return out, a, b


def occupancy_text(occ):
    return (f"{occ['threads']} threads, {occ['registers']} registers, "
            f"{occ['static_smem']} B static + {occ['dynamic_smem']} B "
            f"dynamic shared, {occ['local_bytes']} B local, "
            f"{occ['ctas_per_sm']} CTAs/SM "
            f"({occ['ctas_per_sm'] * occ['threads'] // 32} warps)")


def phase_occupancy(a, b, gpu_line, n=50):
    """Registers, shared memory and resident CTAs per SM of kernels A and
    B as the package launches them, and the device time of each on phase
    3's arguments `a` and `b` (device_ms: at A's size, events around a run
    of calls time the wrapper's host cost, not the kernel)."""
    from tinybvh_tpu_torch import _build
    from tinybvh_tpu_torch.traverse import packet2

    ms = {"cull": device_ms(lambda: packet2._cull_cuda(*a), n),
          "mt_fused": device_ms(lambda: packet2._mt_fused_cuda(*b), n)}
    occ = {"cull": _build.occupancy("tbvh_cull_occupancy"),
           "mt_fused pack 2": _build.occupancy("tbvh_mt_fused_occupancy", 2),
           "mt_fused pack 1": _build.occupancy("tbvh_mt_fused_occupancy", 1)}
    print("phase 3 occupancy: " + "; ".join(
        f"{k}: {occupancy_text(v)}" for k, v in occ.items())
        + "; device time " + ", ".join(f"{k} {v:.4f} ms"
                                       for k, v in ms.items())
        + f" [{gpu_line}]", flush=True)


def setup_scene(tris, dev, W):
    """BVH (host build + packet tables + upload, timed) and camera rays."""
    from tinybvh_tpu_torch import BVH, make_rays

    t0 = time.perf_counter()
    bvh = BVH(tris, device=dev)
    bvh.packet_aux
    sync(dev)
    build_s = time.perf_counter() - t0
    lo, hi = bvh.aabb
    o, d, center, extent = camera_rays(np.asarray(lo), np.asarray(hi), W, W)
    return bvh, make_rays(o, d, device=dev), center, extent, build_s


def shadow_rays(hits, rays, center, extent):
    """Segments from a point light to the primary hit points (the far
    image plane for misses); returns (light, points, rays)."""
    import torch
    from tinybvh_tpu_torch import make_rays

    ht = torch.where(hits.prim >= 0, hits.t, torch.ones_like(hits.t))
    pts = rays.o + ht[:, None] * rays.d
    light = torch.as_tensor(
        (center + np.array([0, 2.0, 0]) * extent).astype(np.float32),
        device=rays.o.device)
    return light, pts, make_rays(light.expand_as(pts), pts - light)


def peak_gib(fn, dev):
    """fn() and the peak device memory it allocated above what was
    allocated before it, in GiB (0.0 off the card)."""
    import torch

    if dev.type != "cuda":
        return fn(), 0.0
    sync(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    out = fn()
    sync(dev)
    return out, (torch.cuda.max_memory_allocated(dev) - base) / 2**30


def api_calls(bvh, rays, center, extent, cutoff):
    """BVH.intersect(rays), then BVH.is_occluded of shadow segments to a
    point light, each with its peak device memory. Returns (hits, occ,
    (light, points, shadow rays), (primary GiB, shadow GiB))."""
    hits, mem_p = peak_gib(lambda: bvh.intersect(rays), rays.o.device)
    shadow = shadow_rays(hits, rays, center, extent)
    occ, mem_s = peak_gib(lambda: bvh.is_occluded(shadow[2], cutoff),
                          rays.o.device)
    return hits, occ, shadow, (mem_p, mem_s)


def api_gates(bvh, rays, hits, srays, occ, cutoff, what):
    """The API's oracle gates on ORACLE_RAYS rays: (hit rate, prim
    agreement, checksum ratio, shadow agreement)."""
    from tinybvh_tpu_torch.core.intersect import brute_force_any

    hit_rate = float((hits.prim >= 0).float().mean())
    if not 0.0 < hit_rate < 1.0:
        raise AssertionError(f"{what}: hit rate {hit_rate}")
    idx = oracle_subset(rays.o.shape[0], rays.o.device)
    agree, ratio = oracle_check(hits.take(idx), rays.take(idx), bvh.tris,
                                f"{what} primary")
    occ_ref = brute_force_any(srays.take(idx), bvh.tris, cutoff)
    occ_agree = float((occ[idx] == occ_ref).float().mean())
    if occ_agree < 0.999:
        raise AssertionError(f"{what} shadow: oracle agreement {occ_agree}")
    return hit_rate, agree, ratio, occ_agree


def phase_api(bvh, rays, center, extent, build_s, gpu_line):
    """The main path through the public API (wavefront retrace), then the
    same two calls with the escalated packet retrace for comparison.
    Returns the launch counts of exactly the API run and the shadow
    segments."""
    from tinybvh_tpu_torch.traverse import packet2
    from tinybvh_tpu_torch.tuning import get_tuning

    dev = rays.o.device
    R = rays.o.shape[0]
    cutoff = 1.0 - 1e-3

    reset_launches()
    hits, occ, shadow, mem = api_calls(bvh, rays, center, extent, cutoff)
    launches = read_launches(dev, ("cull", "mt_fused"), "the API path")
    srays = shadow[2]
    hit_rate, agree, ratio, occ_agree = api_gates(bvh, rays, hits, srays,
                                                  occ, cutoff, "api")

    prim_s = wall_s(lambda: bvh.intersect(rays), dev)
    shadow_s = wall_s(lambda: bvh.is_occluded(srays, cutoff), dev)
    # the same calls with the escalated packet retrace instead
    tun = get_tuning(device=dev)
    pk = dict(max_leaves=tun.max_leaves, max_blocks=tun.max_blocks,
              retrace="packet", retrace_ml=16384)
    lo, hi = bvh.aabb
    prim_pk = wall_s(lambda: packet2.intersect_packets2_sorted(
        bvh.bvh8, bvh.packet_aux, rays, lo, hi, **pk), dev)
    shadow_pk = wall_s(lambda: packet2.occluded_direction_sorted(
        bvh.bvh8, bvh.packet_aux, srays, cutoff, **pk), dev)
    tables_s = wall_s(lambda: packet2.build_packet_aux(bvh.bvh8), dev)
    print(f"phase 4 api: {bvh.tris.shape[0]} tris, {R} rays, build {build_s:.3f}"
          f" s (packet tables alone {tables_s * 1e3:.3f} ms warm), hit rate "
          f"{hit_rate:.4f}, primary {R / prim_s / 1e6:.3f} "
          f"MRays/s, shadow {R / shadow_s / 1e6:.3f} MRays/s (occluded "
          f"{float(occ.float().mean()):.4f}) with the wavefront retrace "
          f"(cap {tun.wf_cap_factor}; peak device memory {mem[0]:.3f} / "
          f"{mem[1]:.3f} GiB); packet retrace (16384 leaves): primary "
          f"{R / prim_pk / 1e6:.3f} MRays/s, shadow {R / shadow_pk / 1e6:.3f}"
          f" MRays/s; oracle prim-agree {agree:.5f} checksum {ratio:.6f} "
          f"shadow-agree {occ_agree:.5f}, residual overflow 0, launches "
          f"{launches} [{gpu_line}]", flush=True)
    return launches, shadow


def phase_grid(tris, dev, W, gpu_line):
    """bench.py's grid16 section: one primary trace at its budgets, kernel
    G on its cull descriptors, then the API's default path (wavefront
    retrace) on the same rays, primary and shadow."""
    from tinybvh_tpu_torch.traverse import packet2

    bvh, rays, center, extent, build_s = setup_scene(tris, dev, W)
    aux = bvh.packet_aux
    R = rays.o.shape[0]
    cutoff = 1.0 - 1e-3

    def primary():
        return packet2.intersect_packets2(
            bvh.bvh8, aux, rays, max_leaves=2560, max_blocks=256,
            retrace="packet", retrace_ml=8192, retrace_blocks=256,
            tri_blk=128)

    rec, restore = capture(packet2, ("cull",))
    reset_launches()
    try:
        hits, ovf = primary()
    finally:
        restore()
    launches = read_launches(dev, ("cull", "mt_fused"), "the grid trace")
    blocks = grid_cull_blocks(aux, rec["cull"][0][2])
    n_ovf = int(ovf.sum())
    if n_ovf:
        raise AssertionError(f"grid: {n_ovf} tiles with residual overflow")
    hit_rate = float((hits.prim >= 0).float().mean())
    if not 0.0 < hit_rate < 1.0:
        raise AssertionError(f"grid hit rate {hit_rate}")
    idx = oracle_subset(R, dev)
    agree, ratio = oracle_check(hits.take(idx), rays.take(idx), bvh.tris,
                                "grid primary")
    prim_s = wall_s(primary, dev)

    hits, occ, shadow, mem = api_calls(bvh, rays, center, extent, cutoff)
    _, a_agree, a_ratio, occ_agree = api_gates(bvh, rays, hits, shadow[2],
                                               occ, cutoff, "grid api")
    api_s = wall_s(lambda: bvh.intersect(rays), dev)
    api_shadow_s = wall_s(lambda: bvh.is_occluded(shadow[2], cutoff), dev)
    print(f"phase 5 grid: {tris.shape[0]} tris, {R} rays, build "
          f"{build_s:.3f} s, hit rate {hit_rate:.4f}, primary "
          f"{R / prim_s / 1e6:.3f} MRays/s, oracle prim-agree {agree:.5f} "
          f"checksum {ratio:.6f}, residual overflow 0, launches {launches}, "
          f"{blocks}; api (wavefront retrace): primary "
          f"{R / api_s / 1e6:.3f} MRays/s, shadow "
          f"{R / api_shadow_s / 1e6:.3f} MRays/s, peak device memory "
          f"{mem[0]:.3f} / {mem[1]:.3f} GiB, oracle prim-agree "
          f"{a_agree:.5f} checksum {a_ratio:.6f} shadow-agree "
          f"{occ_agree:.5f} [{gpu_line}]", flush=True)


def grid_cull_blocks(aux, desc):
    """Kernel G against its twin on grid16's cull descriptors, where
    nbpad > 128: each thread strides over several block ids, and the
    n_blocks mask falls past the first 128."""
    import torch
    from tinybvh_tpu_torch.traverse import packet2

    nbpad = aux.blk_lo.shape[1]
    if nbpad <= packet2.LANES:
        raise AssertionError(f"grid: nbpad {nbpad} does not exceed 128")
    g = (desc, aux.blk_lo, aux.blk_hi, aux.n_blocks)
    kern = (packet2._cull_blocks_cuda if desc.device.type == "cuda"
            else packet2._cull_blocks_plain)
    m_k = kern(*g)
    if not torch.equal(m_k, packet2._cull_blocks_plain(*g)):
        raise AssertionError("cull_blocks: grid16 mask differs from the "
                             "plain twin")
    return (f"kernel G equal to its twin at G={m_k.shape[0]} nbpad={nbpad} "
            f"n_blocks={aux.n_blocks} ({int(m_k.sum())} blocks set)")


UNFUSED = dict(max_leaves=512, max_blocks=256)   # K4 = 2048 rows


def phase_kernels_cg(bvh, rays, cull_args, gpu_line, n_kernel=20,
                     n_plain=3):
    """Kernel C against its twin at the fused=False path's shapes, kernel
    G at the API cull's descriptors. Both are held to bit equality."""
    import torch
    from tinybvh_tpu_torch.traverse import packet2

    dev = rays.o.device
    on_gpu = dev.type == "cuda"
    out = {}
    rec, restore = capture(packet2, ("mt_resolve",))
    try:
        packet2.intersect_packets2(bvh.bvh8, bvh.packet_aux, rays,
                                   retrace=False, fused=False, **UNFUSED)
    finally:
        restore()
    c = rec["mt_resolve"][0]

    def plain_c(*args):
        return packet2._mt_plain(*args)[:2]

    kern = packet2._mt_cuda if on_gpu else plain_c
    t_k, i_k = kern(*c)
    t_p, i_p, n_blk = packet2._mt_plain(*c)
    if not (torch.equal(i_k, i_p) and torch.equal(t_k, t_p)):
        raise AssertionError("mt_gathered: t or row differs from the plain "
                             "twin")
    out["mt_gathered"] = dict(
        max_abs_err=float((t_k - t_p).abs().max()),
        ms=time_ms(lambda: kern(*c), dev, n_kernel),
        plain_ms=time_ms(lambda: plain_c(*c), dev, n_plain),
        shape=f"T={c[2].shape[0]} K4={c[2].shape[1]}",
        # live rows of the 128-row blocks each tile ran before its gate
        **bound("mt_gathered", c, (t_k, i_k),
                live_rows(c[2], n_blk * packet2.TRI_BLK) * 256))

    aux = bvh.packet_aux
    g = (cull_args[2], aux.blk_lo, aux.blk_hi, aux.n_blocks)
    kern = packet2._cull_blocks_cuda if on_gpu else packet2._cull_blocks_plain
    m_k = kern(*g)
    m_p = packet2._cull_blocks_plain(*g)
    if not torch.equal(m_k, m_p):
        raise AssertionError("cull_blocks: mask differs from the plain twin")
    out["cull_blocks"] = dict(
        max_abs_err=int((m_k - m_p).abs().max()),
        ms=time_ms(lambda: kern(*g), dev, n_kernel),
        plain_ms=time_ms(lambda: packet2._cull_blocks_plain(*g), dev,
                         n_plain),
        shape=f"G={m_k.shape[0]} nbpad={m_k.shape[2]} "
              f"n_blocks={aux.n_blocks}",
        **bound("cull_blocks", g, (m_k,), g[0].shape[0] * aux.n_blocks))
    for name, r in out.items():
        kernel_line(6, name, r, gpu_line)
    return out


def phase_cull_stage(bvh, cull_args, gpu_line):
    """The cull-stage probes' path (benchmarks/cull_stage_probe.py:61-99):
    coarse tier through kernel G, worklist compaction, fine tier through
    kernel A, on the API cull's descriptors. It must reproduce the
    production cull (inline coarse tier) exactly. Returns the launch
    counts of this path."""
    import torch
    from tinybvh_tpu_torch.traverse import packet2

    nblk0, wl0, desc, llo, lhi, n_segs, k_cap, leaf_bits = cull_args
    dev = desc.device
    aux = bvh.packet_aux
    max_blocks = wl0.shape[1]

    def stage():
        mask = packet2.cull_blocks(desc, aux.blk_lo, aux.blk_hi,
                                   aux.n_blocks)
        nblk, wl, _ = packet2._worklists(mask[:, 0] > 0, max_blocks)
        return nblk, wl, packet2.cull(nblk, wl, desc, llo, lhi, n_segs,
                                      k_cap, leaf_bits)

    reset_launches()
    nblk, wl, (keys, cnt) = stage()
    launches = read_launches(dev, ("cull_blocks", "cull"), "the cull stage")
    keys0, cnt0 = packet2.cull(*cull_args)
    if not (torch.equal(nblk, nblk0) and torch.equal(wl, wl0)
            and torch.equal(cnt, cnt0) and torch.equal(keys, keys0)):
        raise AssertionError("cull stage: kernel G's worklists or the keys "
                             "differ from the production cull's")
    stage_ms = time_ms(stage, dev, 20)
    print(f"phase 7 cull stage: G={wl.shape[0]} groups, mean live blocks "
          f"{float(nblk.float().mean()):.2f}, worklists and {int(cnt.sum())} "
          f"survivors equal to the production cull, {stage_ms:.4f} ms per "
          f"stage, launches {launches} [{gpu_line}]", flush=True)
    return launches


def same_hits(h, ref, what):
    """prim equal on every ray, t within 1e-4 where both hit."""
    import torch

    n_diff = int((h.prim != ref.prim).sum())
    if n_diff:
        raise AssertionError(f"{what}: prim differs on {n_diff} rays")
    m = ref.prim >= 0
    if not torch.allclose(h.t[m], ref.t[m], rtol=1e-4, atol=1e-4):
        raise AssertionError(f"{what}: t outside 1e-4")
    return float((h.t[m] - ref.t[m]).abs().max())


def phase_unfused(bvh, rays, gpu_line):
    """fused=False (kernel C) and sort=True against the fused path, rays
    in tile order, each with the wavefront retrace; each timed with and
    without that retrace. Returns the launch counts of the fused=False
    run."""
    from tinybvh_tpu_torch.traverse import packet2
    from tinybvh_tpu_torch.tuning import get_tuning

    dev = rays.o.device
    R = rays.o.shape[0]
    kw = dict(UNFUSED, retrace=True,
              wf_cap_factor=get_tuning(device=dev).wf_cap_factor)

    def run(**extra):
        h, ov = packet2.intersect_packets2(bvh.bvh8, bvh.packet_aux, rays,
                                           **kw, **extra)
        if int(ov.sum()):
            raise AssertionError(f"{extra}: {int(ov.sum())} tiles with "
                                 "residual overflow")
        return h

    reset_launches()
    hu = run(fused=False)
    launches = read_launches(dev, ("cull", "mt_gathered"),
                             "the fused=False path")
    hf = run()
    hs = run(sort=True)
    err_u = same_hits(hu, hf, "fused=False vs fused")
    err_s = same_hits(hs, hf, "sort=True vs fused")
    idx = oracle_subset(R, dev)
    agree, ratio = oracle_check(hu.take(idx), rays.take(idx), bvh.tris,
                                "fused=False")

    def first_pass(**extra):
        return packet2.intersect_packets2(bvh.bvh8, bvh.packet_aux, rays,
                                          retrace=False, **UNFUSED, **extra)

    # the first pass alone compares the resolves; the wavefront retrace
    # adds the same work to each mode
    first, full = [], []
    for k, x in (("fused=False", dict(fused=False)), ("fused", {}),
                 ("sort=True", dict(sort=True))):
        r_first = R / wall_s(lambda: first_pass(**x), dev) / 1e6
        r_full = R / wall_s(lambda: run(**x), dev) / 1e6
        first.append(f"{k} {r_first:.3f}")
        full.append(f"{k} {r_full:.3f}")
    first, full = ", ".join(first), ", ".join(full)
    print(f"phase 8 unfused: {R} rays in tile order, max_leaves "
          f"{UNFUSED['max_leaves']}, MRays/s of the first pass: {first}; "
          f"with the wavefront retrace: {full}; prim equal on every ray (t "
          f"max diff {err_u:.3g} unfused, {err_s:.3g} sorted), oracle "
          f"prim-agree {agree:.5f} checksum {ratio:.6f}, residual overflow "
          f"0, launches {launches} [{gpu_line}]", flush=True)
    return launches


RETRACE = dict(max_leaves=64, max_blocks=256, retrace=True,
               wf_cap_factor=64)


def phase_retrace(bvh, rays, shadow, gpu_line):
    """The wavefront retrace on the card: a first budget of 64 leaves
    overflows most tiles; closest hit and the any-hit shadow trace."""
    from tinybvh_tpu_torch.core.intersect import brute_force_any
    from tinybvh_tpu_torch.traverse import packet2

    dev = rays.o.device
    R = rays.o.shape[0]
    light, pts, srays = shadow
    cutoff = 1.0 - 1e-3

    def primary():
        return packet2.intersect_packets2(bvh.bvh8, bvh.packet_aux, rays,
                                          return_counts=True, **RETRACE)

    def occluded():
        return packet2.is_occluded_packets2_sorted(
            bvh.bvh8, bvh.packet_aux, light, pts, cutoff, **RETRACE)

    reset_launches()
    hits, ovf, counts = primary()
    occ, sovf = occluded()
    launches = read_launches(dev, ("cull", "mt_fused"), "the retrace phase")
    n_first = int((counts > RETRACE["max_leaves"] // 4).sum())
    if n_first < counts.shape[0] // 2:
        raise AssertionError(f"only {n_first} tiles overflowed the first "
                             "budget")
    if int(ovf.sum()) or int(sovf.sum()):
        raise AssertionError(f"residual overflow: {int(ovf.sum())} tiles, "
                             f"{int(sovf.sum())} shadow rays")
    idx = oracle_subset(R, dev)
    agree, ratio = oracle_check(hits.take(idx), rays.take(idx), bvh.tris,
                                "wavefront retrace")
    occ_ref = brute_force_any(srays.take(idx), bvh.tris, cutoff)
    occ_agree = float((occ[idx] == occ_ref).float().mean())
    if occ_agree < 0.999:
        raise AssertionError(f"retrace shadow: oracle agreement {occ_agree}")
    prim_s = wall_s(primary, dev)
    shadow_s = wall_s(occluded, dev)
    print(f"phase 9 retrace: max_leaves {RETRACE['max_leaves']}, "
          f"{n_first} of {counts.shape[0]} tiles overflow the first pass, "
          f"wavefront cap {RETRACE['wf_cap_factor']}: primary "
          f"{R / prim_s / 1e6:.3f} MRays/s, shadow {R / shadow_s / 1e6:.3f} "
          f"MRays/s; oracle prim-agree {agree:.5f} checksum {ratio:.6f} "
          f"shadow-agree {occ_agree:.5f}, residual overflow 0, launches "
          f"{launches} [{gpu_line}]", flush=True)


def phase_off_packets(bvh, rays, extent, gpu_line):
    """The API on batches the packet path does not take, each against the
    oracle on every ray. Each case names the engine whose hits came back:
    on random_tris the wavefront's frontier needs ~40 pairs per camera
    ray, past the API's cap of 8, so those calls end in the lockstep
    fallback; the sphere's fits, and must come back from the wavefront."""
    import torch
    from tinybvh_tpu_torch import BVH
    from tinybvh_tpu_torch.core.intersect import brute_force_closest
    from tinybvh_tpu_torch.core.vecmath import BVH_FAR
    from tinybvh_tpu_torch.io.loaders import sphere_tris
    from tinybvh_tpu_torch.traverse import wide

    dev = rays.o.device
    R = rays.o.shape[0]
    r1000 = rays.take(torch.arange(0, R, R // 1000, device=dev)[:1000])
    r4096 = rays.take(torch.arange(0, R, R // 4096, device=dev)[:4096])
    gen = torch.Generator(device="cpu").manual_seed(0)
    tm = (torch.rand(4096, generator=gen) * 1.5 * extent + 0.5 * extent).to(
        device=dev, dtype=torch.float32)
    sphere, s_rays, _, _, _ = setup_scene(sphere_tris(128, 256), dev, 640)
    Rs = s_rays.o.shape[0]
    s1000 = s_rays.take(torch.arange(0, Rs, Rs // 1000, device=dev)[:1000])
    cases = (("1000 rays", bvh, r1000, BVH_FAR, "auto"),
             ("4096 rays, per-ray t_max", bvh, r4096, tm, "auto"),
             ("1000 rays, engine=lockstep", bvh, r1000, BVH_FAR, "lockstep"),
             ("sphere, 1000 rays", sphere, s1000, BVH_FAR, "auto"))
    fallbacks = []
    real = wide.intersect_bvh8

    def counted(*args, **kw):
        fallbacks.append(1)
        return real(*args, **kw)

    parts = []
    for what, b, r, t_max, engine in cases:
        eng = b._engine(r, t_max, engine)
        if eng != ("lockstep" if engine == "lockstep" else "wavefront"):
            raise AssertionError(f"{what}: dispatched to {eng}")
        fallbacks.clear()
        wide.intersect_bvh8 = counted
        try:
            h = b.intersect(r, t_max, engine=engine)
        finally:
            wide.intersect_bvh8 = real
        if eng == "wavefront" and fallbacks:
            eng = "wavefront, frontier overflow at cap 8 -> lockstep"
        if b is sphere and fallbacks:
            raise AssertionError(f"{what}: the wavefront overflowed")
        ref = brute_force_closest(r, b.tris, t_max)
        err = same_hits(h, ref, what)
        hit = float((h.prim >= 0).float().mean())
        if not 0.0 < hit < 1.0:
            raise AssertionError(f"{what}: hit rate {hit}")
        ms = wall_s(lambda: b.intersect(r, t_max, engine=engine), dev) * 1e3
        parts.append(f"{what} ({eng}): {ms:.2f} ms, hit rate {hit:.4f}, "
                     f"t max diff {err:.3g}")
    print(f"phase 10 off-packet api: {'; '.join(parts)}; prim equal to the "
          f"oracle on every ray [{gpu_line}]", flush=True)


V1 = dict(max_leaves=512, chunk=32, pair_cap_factor=64)
V1_MODES = (("default", {}), ("phase1_flat", dict(phase1_flat=True)),
            ("D", dict(leaf_kernel=True)),
            ("F+D", dict(walk_kernel=True, leaf_kernel=True)))
V1_PATH = {"D": ("leaf_resolve_v2",),
           "F+D": ("frustum_walk", "leaf_resolve_v2")}
# Budgets of the two wrappers on this scene: the shadow bundles from the
# light to the tile-order hit points, and the re-sorted tiles, are far
# less coherent than the camera's tiles, and at V1's budgets their pair
# frontier passes its cap, which flags every tile (phase 11 prints the
# count at both budgets).
V1_SHADOW = dict(max_leaves=2048, pair_cap_factor=512)
V1_SORTED = dict(max_leaves=512, pair_cap_factor=128)


def equal_twin(what, got, ref):
    """Each output of a kernel equals its plain twin's bit for bit;
    returns the largest absolute difference (0)."""
    import torch

    for g, r in zip(got, ref):
        if not torch.equal(g, r):
            raise AssertionError(f"{what} differs from its plain twin")
    return max(float((g.double() - r.double()).abs().max()) for g, r in
               zip(got, ref))


def kernel_entry(name, kern, plain, args, units, dev, shape, n_kernel=20,
                 n_plain=3):
    """Kernel against its twin on `args` (bit equality), both timed, and
    the kernel's bound on these arguments."""
    got = kern(*args)
    ref = plain(*args)
    return dict(max_abs_err=equal_twin(name, got, ref),
                ms=time_ms(lambda: kern(*args), dev, n_kernel),
                plain_ms=time_ms(lambda: plain(*args), dev, n_plain),
                shape=shape, **bound(name, args, got, units))


def phase_v1(bvh, rays, center, extent, gpu_line):
    """The v1 packet engine at full size: four modes gated by the oracle
    and equal to one another, kernels D, E and F against their twins on
    the arguments of this trace, the shadow and sorted wrappers. Returns
    (kernel results, launch counts of each kernel on its own path)."""
    import torch
    from tinybvh_tpu_torch.core.intersect import brute_force_any
    from tinybvh_tpu_torch.traverse import frustum_walk as fw
    from tinybvh_tpu_torch.traverse import leaf_resolve as lr
    from tinybvh_tpu_torch.traverse import packet as pk

    start = time.perf_counter()
    dev = rays.o.device
    on_gpu = dev.type == "cuda"
    R = rays.o.shape[0]
    T = R // 256
    b8 = bvh.bvh8
    idx = oracle_subset(R, dev)
    rec, restore = capture(lr, ("leaf_resolve_v2",))
    rec_f, restore_f = capture(fw, ("collect_tile_leaves_kernel",))
    hits, rates, launches, parts = {}, [], {}, []
    try:
        for mode, kw in V1_MODES:
            def trace():
                return pk.intersect_packets(b8, rays, **V1, **kw)

            reset_launches()
            h, ov = trace()
            if mode in V1_PATH:
                got = read_launches(dev, V1_PATH[mode], f"the {mode} trace")
                launches.setdefault("leaf_resolve_v2",
                                    got["leaf_resolve_v2"])
                launches.update({k: v for k, v in got.items()
                                 if k == "frustum_walk"})
            n_ovf = int(ov.sum())
            if n_ovf:
                raise AssertionError(f"v1 {mode}: {n_ovf} tiles overflow")
            agree, ratio = oracle_check(h.take(idx), rays.take(idx),
                                        bvh.tris, f"v1 {mode}")
            hits[mode] = h
            rates.append(f"{mode} {R / wall_s(trace, dev) / 1e6:.3f}")
            parts.append(f"{mode} prim-agree {agree:.5f} checksum "
                         f"{ratio:.6f}")
    finally:
        restore()
        restore_f()
    err = max(same_hits(hits[m], hits["default"], f"v1 {m} vs default")
              for m, _ in V1_MODES[1:])

    # kernel D (both bodies) on the D trace's rows, E on its leaf lists
    d_args = rec["leaf_resolve_v2"][0]
    k_d = (lr._resolve_v2_cuda if on_gpu else lr._resolve_v2_plain)
    d_units = live_rows(d_args[2]) * 256
    d_shape = f"T={T} K4={d_args[2].shape[1]}"
    out = {}
    for name, wide in (("leaf_resolve_v2", False), ("leaf_resolve_v3", True)):
        out[name] = kernel_entry(
            name, lambda *a, w=wide: k_d(*a, wide=w),
            lambda *a, w=wide: lr._resolve_v2_plain(*a, wide=w), d_args,
            d_units, dev, d_shape)
    o3 = rays.o.reshape(T, 256, 3)
    leaves, _ = pk.collect_tile_leaves(b8, o3.amin(1),
                                       rays.d.reshape(T, 256, 3),
                                       V1["max_leaves"], V1["pair_cap_factor"],
                                       tile_ohi=o3.amax(1))
    rows = torch.clamp(leaves, 0, b8.leaf_tris.shape[0] - 1)
    live = (leaves != 2**31 - 1).to(torch.int32)
    e_args = (d_args[0], d_args[1],
              lr.pack_leaf_geom(b8)[rows.long()].contiguous(), live, rows)
    # no path of the package runs v3 or E: each is driven once on its own
    reset_launches()
    t_v3, _ = lr.leaf_resolve_v2(*d_args, wide=True)
    t_e, _ = lr.leaf_resolve(*e_args)
    launches.update(read_launches(dev, ("leaf_resolve_v3", "leaf_resolve"),
                                  "the v3 and E drives"))
    t_v2, _ = lr.leaf_resolve_v2(*d_args)
    if not (torch.equal(t_e, t_v2) and torch.equal(t_v3, t_v2)):
        raise AssertionError("kernels E, D-v3 and D-v2 disagree on t")
    k_e = lr._resolve_cuda if on_gpu else lr._resolve_plain
    out["leaf_resolve"] = kernel_entry(
        "leaf_resolve", k_e, lr._resolve_plain, e_args,
        int(live.sum()) * 4 * 256, dev, f"T={T} K={leaves.shape[1]}")

    # kernel F on the F + D trace's planes, at 512 leaves and at 64
    f_args = rec_f["collect_tile_leaves_kernel"][0]

    def plain_f(*args):
        return fw._walk_plain(*args)[:2]

    k_f = fw._walk_cuda if on_gpu else plain_f
    pops = int(fw._walk_plain(*f_args)[2].sum())
    out["frustum_walk"] = kernel_entry(
        "frustum_walk", k_f, plain_f, f_args, pops, dev,
        f"T={T} M={f_args[0].shape[0]} K={f_args[4]} ({pops} pops)")
    f64 = f_args[:4] + (64,)
    ref64 = plain_f(*f64)
    f_err = equal_twin("frustum_walk at 64 leaves", k_f(*f64), ref64)
    n_ovf64 = int((ref64[1] < 0).sum())
    if on_gpu and n_ovf64 == 0:
        raise AssertionError("no tile overflows 64 leaves")

    # shadow segments from phase 4's light through kernel D, and the rays
    # shuffled through the sorted wrapper
    light, pts, srays = shadow_rays(hits["D"], rays, center, extent)
    cutoff = 1.0 - 1e-3
    v1_budget = dict(max_leaves=V1["max_leaves"],
                     pair_cap_factor=V1["pair_cap_factor"])
    n_sov_v1 = int(pk.is_occluded_packets(
        b8, light, pts, cutoff, chunk=V1["chunk"], leaf_kernel=True,
        **v1_budget)[1].sum())
    occ, sov = pk.is_occluded_packets(b8, light, pts, cutoff,
                                      chunk=V1["chunk"], leaf_kernel=True,
                                      **V1_SHADOW)
    keep = ~torch.repeat_interleave(sov, 256)[idx]
    occ_ref = brute_force_any(srays.take(idx), bvh.tris, cutoff)
    occ_agree = float((occ[idx][keep] == occ_ref[keep]).float().mean())
    if occ_agree < 0.999 or int(keep.sum()) < ORACLE_RAYS // 2:
        raise AssertionError(f"v1 shadow: oracle agreement {occ_agree} on "
                             f"{int(keep.sum())} rays")
    # a seeded shuffle of the rays inside each tile: with one shared eye
    # the coherence key is the octant alone, so a shuffle across tiles
    # would leave no coherent tile to compare
    gen = torch.Generator(device="cpu").manual_seed(0)
    within = torch.argsort(torch.rand(T, 256, generator=gen), dim=1)
    perm = (torch.arange(T)[:, None] * 256 + within).reshape(-1).to(dev)
    lo, hi = bvh.aabb
    n_sorted_v1 = int(pk.intersect_packets_sorted(
        b8, rays.take(perm), lo, hi, chunk=V1["chunk"], leaf_kernel=True,
        **v1_budget)[1].sum()) // 256
    hs, sov_r = pk.intersect_packets_sorted(
        b8, rays.take(perm), lo, hi, chunk=V1["chunk"], leaf_kernel=True,
        **V1_SORTED)
    ok = ~sov_r
    ref = hits["D"].take(perm)
    n_diff = int((hs.prim[ok] != ref.prim[ok]).sum())
    if n_diff or float(ok.float().mean()) < 0.5:
        raise AssertionError(f"v1 sorted: prim differs on {n_diff} rays, "
                             f"{int(ok.sum())} of {R} rays fit")
    print(f"phase 11 v1 engine: {R} rays in tile order, {V1}, MRays/s: "
          f"{', '.join(rates)}; zero overflowed tiles, prims equal across "
          f"modes (t max diff {err:.3g}); {'; '.join(parts)}; kernels D-v2,"
          f" D-v3 and E agree on t; F at 64 leaves equal to its twin "
          f"(max_abs_err {f_err}, {n_ovf64} tiles overflow); shadow "
          f"(kernel D): {n_sov_v1} of {T} tiles overflow at {v1_budget}, "
          f"{int(sov.sum())} at {V1_SHADOW}, "
          f"oracle agreement {occ_agree:.5f} on {int(keep.sum())} rays; "
          f"sorted: {n_sorted_v1} tiles overflow at {v1_budget}, "
          f"{int(sov_r.sum()) // 256} at {V1_SORTED}, prims equal "
          f"on the other {int(ok.sum())} rays; launches {launches}; "
          f"{time.perf_counter() - start:.1f} s [{gpu_line}]", flush=True)
    for name, r in out.items():
        kernel_line(11, name, r, gpu_line)
    return out, launches


# bench.py:772-788: the bucketed engine's budgets on the instance grids
INST512 = dict(n=(8, 8, 8), rounds=28, max_leaves=1024, max_blocks=256,
               retrace="packet", retrace_blocks=256)     # retrace_ml "full"
INST8 = dict(n=(2, 2, 2), rounds=6, max_leaves=1024, max_blocks=256,
             retrace="packet", retrace_ml=4096, retrace_blocks=256)
INST_W = 512


def full_retrace_ml(bvh8):
    """bench.py:564-569: an escalation budget covering every segment of
    the BLAS (4 x ceil(n_segs / 8) x 8 leaves)."""
    n_segs = -(-int(bvh8.leaf_tris.shape[0]) // 4)
    return 4 * (-(-n_segs // 8) * 8), n_segs


def instance_scene(bvh, tris, n, dev, W=INST_W):
    """bench.py's _bench_instances scene: nx*ny*nz translated instances of
    one BLAS spaced at 1.15 x its extent, the TLAS and its packet tables
    built (timed), and W x W camera rays over the
    grid in 16x16 tile order."""
    from tinybvh_tpu_torch import make_rays
    from tinybvh_tpu_torch.tlas.packet import build_tlas_packet

    nx, ny, nz = n
    lo = tris.reshape(-1, 3).min(0)
    ex = tris.reshape(-1, 3).max(0) - lo
    mats = []
    for i in range(nx):
        for j in range(ny):
            for k in range(nz):
                m = np.eye(4, dtype=np.float32)
                m[:3, 3] = ex * 1.15 * np.array([i, j, k], np.float32)
                mats.append(m)
    mats = np.stack(mats)
    t0 = time.perf_counter()
    tp = build_tlas_packet([bvh.bvh8], mats)
    sync(dev)
    build_s = time.perf_counter() - t0
    whi = lo + ex * np.array([1.15 * (nx - 1) + 1, 1.15 * (ny - 1) + 1,
                              1.15 * (nz - 1) + 1])
    o, d, center, extent = camera_rays(lo, whi, W, W)
    return tp, mats, make_rays(o, d, device=dev), build_s, center, extent


def middle(R, n, dev):
    """n consecutive rays from the middle of the batch (bench.py:617)."""
    import torch

    return torch.arange(R // 2 - n // 2, R // 2 + n // 2, device=dev)


def tlas_oracle(tp, rays, idx):
    """The lockstep two-level traversal on rays[idx], with its wall time
    and step count."""
    from tinybvh_tpu_torch.tlas.instance import intersect_tlas8

    dev = rays.o.device
    sync(dev)
    t0 = time.perf_counter()
    ref, steps = intersect_tlas8(tp.tlas, rays.take(idx), with_steps=True)
    sync(dev)
    return ref, steps, time.perf_counter() - t0


def tlas_gates(h, ref, what):
    """bench.py:606-637: t agreement at 1% relative t (both miss, or both
    hit within it), instance agreement, the hit-t checksum ratio; and
    prim agreement. Raises below 0.999, or outside 1%."""
    import torch

    both_miss = (h.prim < 0) & (ref.prim < 0)
    both_hit = (h.prim >= 0) & (ref.prim >= 0)
    t_ok = (h.t - ref.t).abs() <= 0.01 * torch.clamp(ref.t.abs(), min=1e-9)
    t_agree = float((both_miss | (both_hit & t_ok)).float().mean())
    inst_agree = float((h.inst == ref.inst).float().mean())
    prim_agree = float((h.prim == ref.prim).float().mean())
    s_ours = float(h.t[h.prim >= 0].double().sum())
    s_ref = float(ref.t[ref.prim >= 0].double().sum())
    if s_ref <= 0.0:
        raise AssertionError(f"{what}: the oracle subset hits nothing")
    ratio = s_ours / s_ref
    if not (t_agree >= 0.999 and inst_agree >= 0.999 and prim_agree >= 0.999
            and abs(ratio - 1.0) <= 0.01):
        raise AssertionError(f"{what}: oracle t-agree {t_agree} inst-agree "
                             f"{inst_agree} prim-agree {prim_agree} checksum "
                             f"ratio {ratio}")
    return (f"t-agree {t_agree:.5f} inst-agree {inst_agree:.5f} prim-agree "
            f"{prim_agree:.5f} checksum {ratio:.6f}")


def breakdown(fn, dev, wall_ms):
    """Where one call of fn() spends its time, from one call under
    torch.profiler (CPU and CUDA activities): kernels A and B's device
    time (csrc/cull.cu cull_kernel, csrc/mt_fused.cu tile_order and
    mt_fused_kernel), all other device time, the
    device's busy share of wall_ms (an unprofiled call's median wall
    time) and the four torch kernels with the most device time. "not
    measured" where the profiler saw no device time (off the card, or
    records dropped)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if dev.type != "cuda":
        return "breakdown not measured (no card)"
    sync(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(dev)
    # device-side events only (kernels, copies): a CPU op's self device
    # time repeats the kernels it launched
    evs = [e for e in prof.key_averages()
           if str(getattr(e, "device_type", "")).endswith("CUDA")
           and getattr(e, "self_device_time_total", 0) > 0]
    if not evs:
        return "breakdown not measured (the profiler saw no device time)"
    ms = {e.key: e.self_device_time_total / 1e3 for e in evs}

    def is_ab(name):
        return any(k in name for k in ("cull_kernel", "mt_fused_kernel",
                                       "tile_order"))

    ours = sum(v for k, v in ms.items() if is_ab(k))
    total = sum(ms.values())
    top = sorted(((v, k) for k, v in ms.items() if not is_ab(k)),
                 reverse=True)[:4]
    return (f"device {total:.2f} ms of {wall_ms:.2f} ms wall (busy "
            f"{total / wall_ms:.3f}, idle {1 - total / wall_ms:.3f}): "
            f"kernels A+B {ours:.2f} ms, other kernels {total - ours:.2f} "
            "ms, most: " + ", ".join(f"{k[:48]} {v:.2f}" for v, k in top))


def live_tiles(b):
    """Tiles of kernel B's arguments `b` with at least one key."""
    return int((b[1] > 0).sum())


def round_kernels(rec, k_first, gpu_line, what, n_kernel=20):
    """Kernels A and B against their twins (torch.equal on every output)
    on two captured calls of a bucketed trace: the first-pass round with
    the most live tiles (k_cap = k_first) and the escalation pass with
    the most; each timed by CUDA events and as device time (a CUDA graph
    of the calls), with its bound. Prints one line per call."""
    from tinybvh_tpu_torch.traverse import packet2

    dev = rec["cull"][0][2].device
    on_gpu = dev.type == "cuda"
    first = [i for i, b in enumerate(rec["mt_fused"]) if b[7] == k_first]
    esc = [i for i, b in enumerate(rec["mt_fused"]) if b[7] > k_first]
    if not first or not esc:
        raise AssertionError(f"{what}: {len(first)} first passes, {len(esc)}"
                             " escalation passes captured")
    for label, calls in (("round", first), ("escalation", esc)):
        i = max(calls, key=lambda j: live_tiles(rec["mt_fused"][j]))
        a, b = rec["cull"][i], rec["mt_fused"][i]
        if a[6] != b[7]:
            raise AssertionError(f"{what}: cull and resolve calls unpaired")
        kern_a = packet2._cull_cuda if on_gpu else packet2._cull_plain
        ref_a = packet2._cull_plain(*a)
        got_a = kern_a(*a)
        err_a = equal_twin(f"cull ({label})", got_a, ref_a)

        def plain_b(*args):
            return packet2._mt_fused_plain(*args)[:5]

        kern_b = packet2._mt_fused_cuda if on_gpu else plain_b
        *ref_b, n_sb = packet2._mt_fused_plain(*b)
        got_b = kern_b(*b)
        err_b = equal_twin(f"mt_fused ({label})", got_b, ref_b)
        r = {}
        for name, kern, plain, args, got, units, err in (
                ("cull", kern_a, packet2._cull_plain, a, got_a,
                 int(a[0].sum()) * packet2.LANES * packet2.TB, err_a),
                ("mt_fused", kern_b, plain_b, b, got_b,
                 fused_tests(b, n_sb), err_b)):
            r[name] = dict(
                max_abs_err=err,
                ms=time_ms(lambda: kern(*args), dev, n_kernel),
                device_ms=(device_ms(lambda: kern(*args), n_kernel)
                           if on_gpu else float("nan")),
                plain_ms=time_ms(lambda: plain(*args), dev, 1),
                **bound(name, args, got, units))
        shape = (f"T={b[0].shape[0]} ({live_tiles(b)} live) k_cap={b[7]} "
                 f"max_blocks={a[1].shape[1]} tri_blk={b[8]}")
        print(f"{what} kernels, {label} pass: {shape}; " + "; ".join(
            f"{k} equal to its twin (max_abs_err {v['max_abs_err']}), "
            f"kernel {v['ms']:.4f} ms, device {v['device_ms']:.4f} ms, plain "
            f"{v['plain_ms']:.2f} ms, bound {v['bound_ms']:.4f} ms "
            f"({v['bound_by']})" for k, v in r.items())
            + f" [{gpu_line}]", flush=True)


def phase_inst512(bvh, tris, gpu_line):
    """bench.py's inst512 section: 512 instances of the BLAS through the
    bucketed engine (kernels A and B once per candidate round and per
    escalation pass), gated by the lockstep two-level oracle on 2048 rays
    from the middle of the batch; A and B against their twins on the
    round with the most live tiles and on an escalation pass. Returns the
    launch counts of one bucketed call."""
    from tinybvh_tpu_torch.traverse import packet2
    from tinybvh_tpu_torch.tlas.packet import (
        intersect_tlas_packets2_bucketed, tile_candidates,
    )
    from tinybvh_tpu_torch.tuning import get_tuning

    start = time.perf_counter()
    dev = bvh.device
    tp, _, rays, build_s, _, _ = instance_scene(bvh, tris, INST512["n"], dev)
    R = rays.o.shape[0]
    rml, n_segs = full_retrace_ml(bvh.bvh8)
    (_, _, n_cand), = tile_candidates(tp, rays, 1)
    cand_max = int(n_cand.max())
    rounds = max(INST512["rounds"], cand_max + 1)
    kw = dict(rounds=rounds, max_leaves=INST512["max_leaves"],
              max_blocks=INST512["max_blocks"], retrace=INST512["retrace"],
              retrace_ml=rml, retrace_blocks=INST512["retrace_blocks"],
              wf_cap_factor=get_tuning(device=dev).wf_cap_factor)

    def trace():
        return intersect_tlas_packets2_bucketed(tp, rays, **kw)

    reset_launches()
    h, ovf = trace()
    launches = read_launches(dev, ("cull", "mt_fused"), "the bucketed trace")
    n_ovf = int(ovf.sum())
    if n_ovf:
        raise AssertionError(f"inst512: {n_ovf} tiles with residual overflow")
    hit_rate = float((h.prim >= 0).float().mean())
    if not 0.0 < hit_rate < 1.0:
        raise AssertionError(f"inst512 hit rate {hit_rate}")
    idx = middle(R, ORACLE_RAYS, dev)
    ref, steps, oracle_s = tlas_oracle(tp, rays, idx)
    gates = tlas_gates(h.take(idx), ref, "inst512")
    rec, restore = capture(packet2, ("cull", "mt_fused"))
    try:
        trace()
    finally:
        restore()
    round_kernels(rec, INST512["max_leaves"] // 4, gpu_line,
                  "phase 12 inst512")
    del rec
    call_s = wall_s(trace, dev)
    rate = R / call_s / 1e6
    print(f"phase 12 inst512 breakdown of one call: "
          f"{breakdown(trace, dev, call_s * 1e3)} [{gpu_line}]", flush=True)
    print(f"phase 12 inst512: {len(tp.blas_of)} instances of "
          f"{tris.shape[0]} tris ({len(tp.blas_of) * tris.shape[0]} in all; "
          f"BLAS {bvh.bvh8.leaf_tris.shape[0]} leaves, n_segs {n_segs}), "
          f"{R} rays, TLAS build {build_s:.3f} s, per-tile candidate max "
          f"{cand_max} -> rounds {rounds}, escalation {rml} leaves; hit rate "
          f"{hit_rate:.4f}, {rate:.3f} MRays/s (median of 3 after a warm-up),"
          f" launches per call {launches}, residual overflow 0; lockstep "
          f"oracle on {ORACLE_RAYS} rays: {steps} steps, {oracle_s:.2f} s, "
          f"{gates}; {time.perf_counter() - start:.1f} s [{gpu_line}]",
          flush=True)
    return launches


def phase_inst8(bvh, tris, gpu_line):
    """bench.py's inst8 section: 2x2x2 instances through the bucketed
    engine, the per-instance engine and TLAS.intersect (the API: the
    two-level wavefront at caps 4 and 12, then lockstep), the two-level
    wavefront at cap 6 (bench.py:675-679) and shadow segments through
    is_occluded_tlas_packets2, each gated by the lockstep oracle."""
    import torch
    from tinybvh_tpu_torch import TLAS, make_rays
    from tinybvh_tpu_torch.tlas import instance
    from tinybvh_tpu_torch.tlas.packet import (
        intersect_tlas_packets2, intersect_tlas_packets2_bucketed,
        is_occluded_tlas_packets2, tile_candidates,
    )
    from tinybvh_tpu_torch.tuning import get_tuning

    start = time.perf_counter()
    dev = bvh.device
    cap = get_tuning(device=dev).wf_cap_factor
    tp, mats, rays, build_s, center, extent = instance_scene(
        bvh, tris, INST8["n"], dev)
    R = rays.o.shape[0]
    idx = middle(R, ORACLE_RAYS, dev)
    ref, steps, _ = tlas_oracle(tp, rays, idx)
    (_, _, n_cand), = tile_candidates(tp, rays, 1)
    cand_max = int(n_cand.max())
    rounds = max(INST8["rounds"], cand_max + 1)
    kw = {k: v for k, v in INST8.items() if k != "n"}
    kw.update(rounds=rounds, wf_cap_factor=cap)
    rml, _ = full_retrace_ml(bvh.bvh8)
    parts = []

    def bucketed():
        return intersect_tlas_packets2_bucketed(tp, rays, **kw)

    def per_instance():
        return intersect_tlas_packets2(
            tp, rays, max_leaves=INST8["max_leaves"],
            max_blocks=INST8["max_blocks"], retrace="packet",
            retrace_ml=rml, retrace_blocks=INST8["retrace_blocks"])

    hits = {}
    for what, fn in (("bucketed", bucketed), ("per-instance", per_instance)):
        h, ovf = fn()
        if int(ovf.sum()):
            raise AssertionError(f"inst8 {what}: {int(ovf.sum())} tiles "
                                 "with residual overflow")
        hits[what] = h
        gates = tlas_gates(h.take(idx), ref, f"inst8 {what}")
        call_s = wall_s(fn, dev)
        parts.append(f"{what} {R / call_s / 1e6:.3f} MRays/s, {gates}, "
                     f"{breakdown(fn, dev, call_s * 1e3)}")

    # the API on the middle 16384 rays; the oracle's rays lie inside
    n_api = min(16384, R)
    api_idx = middle(R, n_api, dev)
    tlas = TLAS([bvh], mats)
    fallbacks = []
    real = instance.intersect_tlas8

    def counted(*args, **kwargs):
        fallbacks.append(1)
        return real(*args, **kwargs)

    instance.intersect_tlas8 = counted
    try:
        sync(dev)
        t0 = time.perf_counter()
        h_api = tlas.intersect(rays.take(api_idx))
        sync(dev)
        api_s = time.perf_counter() - t0
    finally:
        instance.intersect_tlas8 = real
    off = (n_api - ORACLE_RAYS) // 2
    gates = tlas_gates(h_api.take(torch.arange(off, off + ORACLE_RAYS,
                                               device=dev)), ref, "inst8 api")
    engine = "lockstep after wavefront overflow" if fallbacks else "wavefront"
    parts.append(f"TLAS.intersect on {n_api} rays ({engine}) {api_s:.2f} s, "
                 f"{gates}")

    def wavefront():
        return instance.intersect_tlas_wavefront(tp.tlas, rays, cap_factor=6)

    h_wf, wf_ovf = wavefront()
    wf_s = wall_s(wavefront, dev)
    if wf_ovf:
        wf_note = "frontier overflow: inexact, not gated (as in JAX)"
    else:
        wf_note = tlas_gates(h_wf.take(idx), ref, "inst8 wavefront")
    parts.append(f"wavefront cap 6 {R / wf_s / 1e6:.3f} MRays/s, {wf_note}")

    # shadow segments from a light above the grid to the bucketed hits
    cutoff = 1.0 - 1e-3
    hb = hits["bucketed"]
    ht = torch.where(hb.prim >= 0, hb.t, torch.ones_like(hb.t))
    pts = rays.o + ht[:, None] * rays.d
    light = torch.as_tensor((center + np.array([0, 2.0, 0]) * extent).astype(
        np.float32), device=dev)

    def occluded():
        return is_occluded_tlas_packets2(
            tp, light, pts, cutoff, max_leaves=INST8["max_leaves"],
            max_blocks=INST8["max_blocks"], wf_cap_factor=cap)

    occ, sovf = occluded()
    if int(sovf.sum()):
        raise AssertionError(f"inst8 shadow: {int(sovf.sum())} tiles with "
                             "residual overflow")
    srays = make_rays(light.expand_as(pts), pts - light)
    sref, _, _ = tlas_oracle(tp, srays, idx)
    occ_ref = (sref.prim >= 0) & (sref.t < cutoff)
    occ_agree = float((occ[idx] == occ_ref).float().mean())
    if occ_agree < 0.999:
        raise AssertionError(f"inst8 shadow: lockstep agreement {occ_agree}")
    parts.append(f"shadow {R / wall_s(occluded, dev) / 1e6:.3f} MRays/s "
                 f"(occluded {float(occ.float().mean()):.4f}), lockstep "
                 f"segment agreement {occ_agree:.5f}")
    print(f"phase 12b inst8: {len(tp.blas_of)} instances, {R} rays, TLAS "
          f"build {build_s:.3f} s, per-tile candidate max {cand_max} -> "
          f"rounds {rounds}; lockstep oracle {steps} steps; "
          f"{'; '.join(parts)}; residual overflow 0; "
          f"{time.perf_counter() - start:.1f} s [{gpu_line}]", flush=True)


def phase_refit(bvh, tris, rays, gpu_line):
    """bench.py's per-frame refit row (bench.py:304-318): refit_bvh8 and
    build_packet_aux on the card for a deformed random64k (anisotropic
    scale, translation, seeded per-vertex jitter, as
    tests/test_builder.py:175-178), timed; the phase 4 camera rays, moved
    with the geometry, through intersect_packets2 on the refit tables;
    then BVH.refit + BVH.intersect through the API. Both gated by the
    brute-force oracle over the moved triangles."""
    import torch
    from tinybvh_tpu_torch import BVH, make_rays
    from tinybvh_tpu_torch.builders.refit import bvh8_refit_plan, refit_bvh8
    from tinybvh_tpu_torch.traverse import packet2
    from tinybvh_tpu_torch.tuning import get_tuning

    start = time.perf_counter()
    dev = rays.o.device
    tun = get_tuning(device=dev)
    scale = np.float32([1.3, 0.7, 1.0])
    shift = np.float32([2.0, -1.0, 0.5])
    rng = np.random.default_rng(0)
    moved = (tris * scale + shift + rng.normal(
        scale=0.02, size=tris.shape).astype(np.float32)).astype(np.float32)
    moved_dev = torch.from_numpy(moved).to(dev)
    plan = bvh8_refit_plan(bvh.bvh8.child)

    def frame():
        b8 = refit_bvh8(bvh.bvh8, moved_dev, plan)
        return b8, packet2.build_packet_aux(b8)

    frame_s = wall_s(frame, dev)
    frame_parts = breakdown(frame, dev, frame_s * 1e3)
    b8, aux = frame()
    s_dev = torch.from_numpy(scale).to(dev)
    rays_m = make_rays(rays.o * s_dev + torch.from_numpy(shift).to(dev),
                       rays.d * s_dev)
    R = rays_m.o.shape[0]
    idx = oracle_subset(R, dev)

    def trace():
        return packet2.intersect_packets2(
            b8, aux, rays_m, max_leaves=tun.max_leaves,
            max_blocks=tun.max_blocks, wf_cap_factor=tun.wf_cap_factor)

    h, ovf = trace()
    if int(ovf.sum()):
        raise AssertionError(f"refit: {int(ovf.sum())} tiles with residual "
                             "overflow")
    agree, ratio = oracle_check(h.take(idx), rays_m.take(idx), moved_dev,
                                "refit packets")
    trace_s = wall_s(trace, dev)
    rate = R / trace_s / 1e6
    trace_parts = breakdown(trace, dev, trace_s * 1e3)

    fresh = BVH(tris, device=dev)
    sync(dev)
    t0 = time.perf_counter()
    fresh.refit(moved)
    sync(dev)
    api_refit_s = time.perf_counter() - t0
    h_api, mem = peak_gib(lambda: fresh.intersect(rays_m), dev)
    a_agree, a_ratio = oracle_check(h_api.take(idx), rays_m.take(idx),
                                    moved_dev, "refit api")
    api_rate = R / wall_s(lambda: fresh.intersect(rays_m), dev) / 1e6
    print(f"phase 13 refit: {tris.shape[0]} tris, refit_bvh8 + "
          f"build_packet_aux {frame_s * 1e3:.3f} ms a frame (median of 3), "
          f"{tris.shape[0] / frame_s / 1e6:.3f} Mtris/s ({frame_parts}); "
          f"moved camera rays ({R}, tile order) through intersect_packets2 "
          f"on the refit tables {rate:.3f} MRays/s ({trace_parts}), oracle "
          f"prim-agree {agree:.5f} checksum {ratio:.6f}, residual overflow "
          f"0; BVH.refit {api_refit_s:.3f} s "
          f"({fresh.bvh8.leaf_tris.shape[0]} leaves without combining, "
          f"against {bvh.bvh8.leaf_tris.shape[0]}), then BVH.intersect "
          f"{api_rate:.3f} MRays/s (peak device memory {mem:.3f} GiB), "
          f"oracle prim-agree {a_agree:.5f} checksum {a_ratio:.6f}; "
          f"{time.perf_counter() - start:.1f} s [{gpu_line}]", flush=True)


PROBE_KPT = (16, 64, 256)    # keys a tile of kernel I: 1, 2, 8 super-blocks
PROBE_KPT_SCATTERED = (64,)  # the same, keys spread over the table
PROBE_T = 1600               # kernel I's tiles (the reference's T)


def ms_text(ms, digits=4):
    return "not measured" if ms is None else f"{ms:.{digits}f} ms"


def library_call(form, args):
    """One PyTorch call that computes H form `form` on its arguments (a
    zero-argument callable; its int64 indices made beforehand), or None
    where there is none. Timed beside the kernel; the port never calls
    it."""
    import torch

    if form == "row":
        table, idx = args
        return lambda: torch.index_select(table, 0, idx)
    if form == "col":
        a, col = args
        col64 = col.long()[:, None]
        return lambda: torch.gather(a, 1, col64)
    if form in ("A", "B", "B2", "C"):
        t, i = args
        i64 = i.long()
        dim = 0 if form == "C" else 1
        return lambda: torch.gather(t, dim, i64)
    if form == "E":
        flat, i = args
        i64 = i.long()
        return lambda: torch.take(flat, i64)
    if form.startswith("D"):
        # one of the form's ten products
        t, idx = args
        onehot = (torch.arange(t.shape[0], device=t.device)[None]
                  == idx[:, None]).to(torch.bfloat16)
        return lambda: torch.matmul(onehot, t)
    return None


def phase_probes(bvh, gpu_line, n_plain=20):
    """Phase 14: the probes' drivers (kernels H and I), each kernel against
    its twin, launches counted over the drivers' runs; each H form and I
    variant with its time, device time, twin's time, bound and (H) the
    library call's time; kernel I's split of B's tile loop. Returns the
    kernel entries and launches of the JSON line."""
    from tinybvh_tpu_torch import _build
    from tinybvh_tpu_torch.probes import gather, mt_ablation

    dev = bvh.device
    for table in (gather.LAUNCHES, mt_ablation.LAUNCHES):
        for k in table:
            table[k] = 0
    h = gather.run(dev)
    i_res = {(kpt, keys): r
             for keys, kpts in (("clustered", PROBE_KPT),
                                ("scattered", PROBE_KPT_SCATTERED))
             for kpt, r in mt_ablation.run(
                 dev, keys_per_tile=kpts, T=PROBE_T, bvh=bvh,
                 scattered=keys == "scattered").items()}
    sync(dev)
    counts = dict(gather.LAUNCHES, **mt_ablation.LAUNCHES)
    if dev.type == "cuda" and min(counts.values()) == 0:
        raise AssertionError(f"phase 14 skipped a kernel: {counts}")
    print(f"phase 14 probes: launches {counts}", flush=True)

    kern, launches = {}, {}
    for form, r in h.items():
        f = gather.FORMS[form]
        lib = library_call(form, r["args"])
        # D's result is exactly REPS * t[idx]: its bound is its bytes; the
        # one-hot products the kernel runs are its method, printed apart
        ops = ({"fp32": gather.ROUNDS * r["out"].numel()} if form == "C100"
               else {})
        name = f"gather_{form}"
        kern[name] = dict(
            max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=time_ms(lambda: f.plain(*r["args"]), dev, n_plain),
            library_ms=time_ms(lib, dev, 200) if lib else None,
            library_device_ms=(device_ms(lib, 200)
                               if lib and dev.type == "cuda" else None),
            device_ms=r["device_ms"], graph_runs=r["graph_runs"],
            **bound_of(nbytes(r["args"]) + nbytes((r["out"],)), ops))
        launches[name] = r["launches"]
        k = kern[name]
        lib_txt = (f"{ms_text(k['library_ms'])} (device "
                   f"{ms_text(k['library_device_ms'])})" if lib else "none")
        if form.startswith("D"):
            t, idx = r["args"]
            mma = bound_of(0, {"bf16": 2 * gather.REPS * idx.numel()
                               * t.numel()})["bound_ms"]
            lib_txt += (f"; the one-hot method's bf16 operations alone "
                        f"{mma:.6f} ms")
        print(f"phase 14 kernel {name}: {f.work}: max_abs_err "
              f"{k['max_abs_err']} kernel {ms_text(k['ms'])} device "
              f"{ms_text(k['device_ms'])} plain {k['plain_ms']:.4f} ms "
              f"library {lib_txt} bound {k['bound_ms']:.6f} ms "
              f"({k['bound_by']}) [{gpu_line}]", flush=True)

    if dev.type == "cuda":
        occ = {v: _build.occupancy("tbvh_mt_ablation_occupancy", i)
               for i, v in enumerate(mt_ablation.VARIANTS)}
        print("phase 14 occupancy of kernel I: " + "; ".join(
            f"{v}: {occupancy_text(o)}" for v, o in occ.items()), flush=True)
    variants = {}
    for (kpt, keys), r in i_res.items():
        args, gtab = r["inputs"], r["gtab"]
        T, k_cap = args[0].shape
        label = str(kpt) if keys == "clustered" else f"{kpt} {keys}"
        for v in mt_ablation.VARIANTS:
            x = r[v]
            pairs = mt_ablation.tested_pairs(args[1], x["n_sb"], k_cap, v)
            ops = ({"fp32": T * 256} if v == "skeleton" else
                   {kind: n * pairs for kind, n in
                    ABLATION_OPS.get(v, ABLATION_OPS_DEFAULT).items()})
            entry = dict(max_abs_err=x["max_abs_err"], ms=x["ms"],
                         device_ms=x["device_ms"], plain_ms=x["plain_ms"],
                         launches=x["launches"], graph_runs=x["graph_runs"],
                         super_blocks=int(x["n_sb"].sum()), pairs=pairs,
                         **bound_of(mt_ablation.bytes_moved(
                             args, gtab, v, x["n_sb"], x["out"]), ops))
            variants.setdefault(v, {})[label] = entry
            per_tile = (f"{entry['device_ms'] / T * 1e3:.4f} us/tile"
                         if entry["device_ms"] is not None else "")
            print(f"phase 14 kernel mt_ablation {v} kpt {label} (T={T}, "
                  f"{entry['super_blocks']} super-blocks, {pairs} (row, "
                  f"ray) pairs its result needs): max_abs_err "
                  f"{entry['max_abs_err']} kernel {ms_text(entry['ms'])} "
                  f"device {ms_text(entry['device_ms'])} ({per_tile}) plain "
                  f"{ms_text(entry['plain_ms'], 2)} bound "
                  f"{entry['bound_ms']:.4f} ms ({entry['bound_by']}) "
                  f"[{gpu_line}]", flush=True)
        if dev.type == "cuda":
            print(f"phase 14 split kpt {label} (device ms): " + ", ".join(
                f"{what} {ms:.4f}" for what, ms in mt_ablation.split(r))
                + f" [{gpu_line}]", flush=True)
    full = variants["full"]["64"]
    kern["mt_ablation"] = dict(
        {k: full[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                              "bound_by", "device_ms", "graph_runs")},
        library_ms=None, variants=variants)
    launches["mt_ablation"] = mt_ablation.LAUNCHES["mt_ablation"]
    return kern, launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    # the port itself: fails before any output outside a checkout
    from tinybvh_tpu_torch import _build, native
    from tinybvh_tpu_torch.io.loaders import random_tris

    # phase 1: device
    gpu_line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(gpu_line, flush=True)
    print(f"phase 1 device: torch {torch.__version__} cuda "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # phase 2: build from the checkout's sources
    t0 = time.perf_counter()
    _build.kernels()
    t_k = time.perf_counter() - t0
    t0 = time.perf_counter()
    native._load()
    t_n = time.perf_counter() - t0
    print(f"phase 2 build: kernels {t_k:.2f} s (nvcc), native builder "
          f"{t_n:.2f} s (cc)", flush=True)

    tris = random_tris(65536, seed=0)
    scene = setup_scene(tris, dev, 640)
    bvh, rays, _, extent, _ = scene
    kern, cull_args, mt_args = phase_kernels(bvh, rays, gpu_line)
    phase_occupancy(cull_args, mt_args, gpu_line)
    launches, shadow = phase_api(*scene, gpu_line)
    phase_grid(grid_scene(tris, 4, 4), dev, 640, gpu_line)
    kern.update(phase_kernels_cg(bvh, rays, cull_args, gpu_line))
    launches.update(cull_blocks=phase_cull_stage(
        bvh, cull_args, gpu_line)["cull_blocks"])
    launches.update(mt_gathered=phase_unfused(bvh, rays,
                                              gpu_line)["mt_gathered"])
    phase_retrace(bvh, rays, shadow, gpu_line)
    phase_off_packets(bvh, rays, extent, gpu_line)
    v1_kern, v1_launches = phase_v1(bvh, rays, scene[2], extent, gpu_line)
    kern.update(v1_kern)
    launches.update(v1_launches)
    tlas_launches = phase_inst512(bvh, tris, gpu_line)
    phase_inst8(bvh, tris, gpu_line)
    phase_refit(bvh, tris, rays, gpu_line)
    probe_kern, probe_launches = phase_probes(bvh, gpu_line)
    kern.update(probe_kern)
    launches.update(probe_launches)

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"tinybvh_tpu_torch/csrc/{SOURCES[name]}",
         "replaces": REPLACES[name], "launches": launches[name],
         **{k: kern[name][k] for k in keys},
         **{k: v for k, v in kern[name].items()
            if k in ("device_ms", "library_device_ms", "graph_runs",
                     "variants")},
         **({"tlas_launches": tlas_launches[name]}
            if name in tlas_launches else {})}
        for name in SOURCES]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
