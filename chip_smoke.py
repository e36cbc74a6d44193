#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port's main path once on one GPU.

    python3 chip_smoke.py          # every phase
    python3 chip_smoke.py --resolves   # phases 1-2, 6, 11 and kernel G on
                                       # grid16, no JSON lines
    python3 chip_smoke.py --render     # phases 1-2, 15 and 15b, no JSON
                                       # lines
    python3 chip_smoke.py --foliage    # phases 1-2 and 16, no JSON lines
    python3 chip_smoke.py --probes     # phases 1-2 and 14, no JSON lines
    python3 chip_smoke.py --engines    # phases 1-2 and 17 (every path
                                       # profiled), no JSON lines
    python3 chip_smoke.py --builders   # phases 1-2 and 18, no JSON lines
    python3 chip_smoke.py --mesh       # phases 1-2 and 19, no JSON lines
    python3 chip_smoke.py --f64        # phases 1-2 and 20, no JSON lines

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
     128) with its device time and bound, and the API's default path
     (primary and shadow, wavefront retrace) gated by the oracles, with
     its peak device memory;
  6. kernels C and G against their twins: C at the fused=False path's
     shapes (T=1600 tiles, max_leaves=512, K4=2048 rows) with the rows
     its result needs (live rows of the walked blocks) beside the walked
     ones, G at the API's cull descriptors (G=200 groups); each with its
     device time; then a line of their registers, shared memory and
     resident CTAs per SM;
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
     for bit (F also at 64 leaves, where tiles overflow), each with its
     device time (a CUDA graph), D with its live rows, E with the nonzero
     triangles of its live leaves, F with its pops a tile (most, mean,
     spread) and the tiles that took its in-kernel sequential walk, and
     a line of the registers, shared
     memory and resident CTAs per SM of D, E and F; the shadow
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
     (the two engines with a profiler breakdown); A and B against their
     twins on the per-instance engine's closest-hit and shadow passes
     with the most live tiles;
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
     (index_select, gather, take, or for D torch.mm of 10 x the one-hot
     matrix in f32 with t in f32, equal to the kernel; events and a CUDA
     graph, as the kernel) and its bound; the launch floor (an empty
     kernel's device time) and, for the redesigned H-row, H-A, H-B, H-B2,
     H-C, H-col, H-E, H-A100 and H-C100, the device time of each kernel
     (and of H-row's general path at 47 columns and on a table view one
     float into its storage, of H-row's earlier design, and of both H-row
     designs at 262,144 indices into 1,048,576 rows with that shape's
     bound; of H-A100's at 0 rounds, of H-C's on 65,543 index rows (grid
     z), of H-col's general path at 48 columns and at 8,193 rows and of
     H-E's on a 2,049-float table), each output checked, what sets the
     pace, and their occupancy (H-row's rows path at 48 columns and its
     general one at 47, the lane kernel at widths 128 and 1,024, H-C,
     H-col's rows path, H-E's staged path); H-D's occupancy.
     Kernel I, kernel
     B's tile loop in eight variants at 16, 64 and 256 clustered keys a
     tile and at 64 scattered ones (T = 1,600, k_cap 256, the random64k
     packet tables): each variant's time, device time, twin and bound,
     and the split of the loop by subtraction. Every kernel against its
     twin:
     torch.equal, bf16 within its tolerance (probes/mt_ablation.py check);
 15. render64k: render() of random64k with a floor quad below it and an
     emissive quad above it (RENDER: 640x640 pixels, 2 samples, 3
     bounces), every extension and shadow pass through the packet2 engine
     (aux=, kernels A and B) at the h100 row's budgets and retrace cap;
     the frame's overflow flag, finite and lit radiance, bounce 0's hits
     against the brute-force oracle on 2048 rays, and the same frame
     through the wavefront engine with the same draws (0.999 of the
     pixels within rtol 1e-3 / atol 1e-4, means within 1e-3); A and B
     against their twins on a bounce-1 extension pass (sorted incoherent
     rays); frame time, traversals, rays and launches a frame, a
     profiler breakdown (device time, idle share, A+B, the wavefront
     retraces' device time, recorded in the frame and replayed under the
     profiler) and peak device memory;
 15b. scene16: a Scene of 16 instances of one rigid random64k mesh with
     a morph target on bench.py's 4x4 grid (1,048,576 triangles) and an
     emissive quad, animated (a LINEAR translation of the grid, a LINEAR
     morph weight); 3 frames of update(t) (refit on the card, TLAS),
     tlas_packet() and trace_paths_tlas(tpacket=) at 512x512, 1 sample, 2
     bounces, each gated by Scene.intersect against brute force over the
     frame's world triangles; the last frame against the wavefront route
     with the same draws (0.98 of the rays within rtol 2e-2 / atol 2e-3,
     means within 2e-2) at the h100 row's cap; update, tlas_packet,
     trace and frame times, launches a frame, device time, idle share
     and the retraces' device time; A and B against their twins on the
     last trace's per-instance extension and shadow passes with the most
     live tiles (refit BLAS tables);
 16. foliage64k: random64k with per-triangle opacity micromaps baked
     from a leaf-shaped alpha (a disc of the barycentric domain, its
     radius hashed from the prim id; about half the cells opaque) at S = 8
     (pack 2) and S = 16 (pack 1): phase 4's camera rays through
     intersect_packets2 and shadow segments to their hits through
     is_occluded_packets2 (h100 row budgets, the wavefront retrace with
     the micromaps at its cap), the launch counts reset just before and
     read just after; zero residual overflow, prim agreement >= 0.999
     and the hit-t checksum within 1% against an alpha-aware brute force
     on 2048 rays (all pairs, Möller–Trumbore, the cell's bit, the
     minimum; written here), shadow agreement >= 0.999, an all-opaque
     micromap equal to none on every ray, and some rays changed by the
     micromaps; kernel B's micromap mode against its twin on each of the
     four resolves, with its device time beside B's without micromaps on
     the same rays, beside its own with an all-opaque micromap there and
     at S = 5 (pack 2) and 32 (pack 1) there, and the occupancy of its
     instantiation at both packs; inst8 with micromaps through
     the bucketed engine (rounds and escalation leaving nothing to the
     two-level wavefront) against the brute force per instance, with
     B's micromap mode against its twin on each of its launches and
     their device times; 4096
     sphere queries over random64k's BVH2 against brute force on 256;
     the voxel DDA on a full 256^3 VoxelSet (a sphere shell and a height
     field, millions of voxels) with 512x512 rays against a sampling
     oracle on 2048; each timed;
 17. the plain-torch engines at phase 4's width (random64k, 640x640
     camera rays, phase 4's light): engine="rayloop" through the API on
     the camera rays, on diffuse bounce rays (bench.py:440-455, a seeded
     torch.Generator) and on the shadow segments, intersect_rayloop on
     the quantized tables; the wavefront engine at the h100 row's cap in
     each leaf test (mt, watertight, baldwin); the BVH2 engine of
     BVH(tris, layout="bvh2") in each leaf test and of BVH(tris,
     max_leaf=16) (leaves of 5), closest hit and shadow; the two-level
     rayloop on phase 12b's inst8, closest hit and shadow, with the
     bucketed engine's rate beside it; intersect_one; the watertight
     shared-edge construction (64 quads, 8 rays each) through the test
     and 16 of them through the wavefront and BVH2 engines, no ray
     leaking. Each path: the oracle gates of phases 4 and 12b, MRays/s
     (median of 3 after a warm-up), its loop's steps or rounds per level
     and host syncs (the engine's count, and torch.cuda's sync debug
     mode's), peak device memory, the rayloop's stack overflows (the
     API re-traces those rays with the lockstep engine; the direct
     engine calls must have none), and for each engine's first path
     (every path under --engines) one more call under the profiler: its
     kernel launches, copies, device time and the device's busy share of
     the wall time; no max_rounds raise, and no kernel of the
     package launched (the engines are plain torch);
 18. the builders and layouts: (a) build_lbvh and build_binned_device on
     the card at random_tris(65536) and random_tris(1048576) (seed 0):
     the first call, the median of 3 warm calls ending in a synchronize,
     Mtris/s, host syncs (the sync debug mode) by source line, peak
     device memory, SAH cost and one profiled call's launches and device
     ms, the native host build of the same soup beside them, the
     tree traced by the BVH2 engine against brute force on 2048 rays and
     prim_idx a permutation; (b) BVH(random64k, builder="lbvh"), its
     build split into the device build, host copies and uploads, the
     Python collapse and the packet tables, intersect and is_occluded
     on phase 4's rays through packet2 (kernels A and B, their launches
     reset just before and read just after) with the wavefront retrace,
     phase 4's gates, and the SAH API timed beside it; (c) the wavefront
     at the h100 row's cap on random64k's BVH8Q against its BVH8: prims
     equal on every ray, MRays/s, one profiled call's device ms,
     node-table bytes and peak memory; (d) build_sweep, build_sbvh,
     optimize_reinsertion, combine_leafs, split_leafs and epo_cost at
     HOST_SIZES, host seconds, each tree traced on the card against
     brute force; (e) save_bvh / load_bvh of a BVH2, BVH8, BVH8Q and
     TLAS8, each loaded onto the card equal to what was saved;
 19. the multi-device layer (parallel/mesh.py) at random64k's 640x640
     camera rays and the h100 row's budgets: (a) a one-rank NCCL process
     group, mesh 1 x 1: trace_packets_dp torch.equal to
     intersect_packets2 on the same rays (prim, t, u, v), its launches
     of A and B reset just before and read just after;
     trace_packets_sharded over one shard, trace_sharded (the BVH2
     engine) and render_step_dp (its image against the same terms over
     brute-force hits and shadows, 0.999 of 2048 pixels within 1e-4),
     each traced call gated by the oracle (prim agreement >= 0.999,
     checksum within 1%), with its wall time (median of 2 after the
     first), peak device memory and the collectives' count and time;
     (b) two gloo ranks sharing the card, spawned by parallel/launch.py
     run_local: mesh 1 x 2 (random64k in two scene shards) through
     trace_packets_sharded and trace_sharded under the same gates, and
     mesh 2 x 1 through trace_packets_dp, torch.equal to (a)'s; each
     rank prints its walls, collectives and peak memory, and a failed
     rank fails the smoke;
 20. the double-precision path (ops/f64.py): random64k in float64
     shifted by 1e9 on every axis (f32 rounds to 64-unit steps there):
     BVHDouble's host build timed, then intersect and is_occluded
     (shadow segments to a light above, cutoff 0.999) on the card with
     640x640 camera rays at the offset, gated by an f64 brute force on
     the card over 2048 rays (written here: prims equal on every ray, t
     within 1e-12 relative; shadow agreement >= 0.999), with the f32
     closest hit's prim agreement on the same shifted scene beside them
     (not a gate); TLASDouble over inst8's 2 x 2 x 2 grid of that BLAS
     at the offset with 512x512 rays against the brute force over the
     world-space triangles (prim and inst agreement >= 0.999, t within
     1e-6); each query's MRays/s, steps, compactions, host syncs, peak
     memory and one profiled call;
then a JSON line of the kernels (launches counted on each kernel's
own path: A and B in phase 4, G in phase 7, C in phase 8, D-v2 in phase
11's kernel-D trace, F in its F + D trace, D-v3 and E in their own
drives on that trace's inputs, since no path of the package runs them;
A and B also carry tlas_launches, their launches in one phase 12
bucketed call, render_launches, theirs in one phase 15 frame, and
scene_launches, theirs in one phase 15b frame's trace,
lbvh_launches, theirs in phase 18's builder="lbvh" API calls, and
mesh_launches, theirs in phase 19a's trace_packets_dp call; B's micromap
mode, mt_fused_omap, its launches in phase 16's main path, where A's
are foliage_launches; H and I theirs
in phase 14's drivers, with device_ms, graph_runs and, for I, whose
entry is the full variant at 64 clustered keys a tile, a `variants`
dict), each with its time, its plain twin's, and its bound
(BOUND_RATES), and as the last line {"ok": true, "device": {...}}.

Precision: TF32 stays off (torch.backends.cuda.matmul.allow_tf32 and
torch.backends.cudnn.allow_tf32 False); the ray path uses no tensor
cores (only the probes' bf16 products do). Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
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
            "mt_ablation": "benchmarks/mt_ablation_probe.py:115",
            "mt_fused_omap": "tinybvh_tpu/traverse/packet2.py:858"}
SOURCES = {"cull": "cull.cu", "mt_fused": "mt_fused.cu",
           "mt_gathered": "mt_gathered.cu", "cull_blocks": "cull_blocks.cu",
           "leaf_resolve_v2": "leaf_resolve.cu",
           "leaf_resolve_v3": "leaf_resolve.cu",
           "leaf_resolve": "leaf_resolve.cu",
           "frustum_walk": "frustum_walk.cu",
           **dict.fromkeys([k for k in REPLACES if k.startswith("gather")],
                           "gather_probe.cu"),
           "mt_ablation": "mt_ablation.cu", "mt_fused_omap": "mt_fused.cu"}
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


def wall_s(fn, dev, reps=3, warmed=False):
    """Median wall seconds of fn() ending in a device synchronize, after
    a warm-up call (none where the caller has just run fn: warmed)."""
    if not warmed:
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


def live_tris(geom, live):
    """Nonzero triangles (a field of the 9 not zero) of the live leaves
    (live > 0) of x-major leaf rows geom (T, K, 48): the triangles kernel
    E's result needs, as live_rows counts kernel D's rows."""
    T, K = geom.shape[:2]
    nz = (geom[..., :36].reshape(T, K, 9, 4) != 0).any(dim=2)
    return int((nz & (live > 0)[..., None]).sum())


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
    dev_txt = (f" device {ms_text(r['device_ms'])}" if "device_ms" in r
               else "")
    print(f"phase {phase} kernel {name}: {r['shape']} max_abs_err "
          f"{r['max_abs_err']} kernel {r['ms']:.4f} ms{dev_txt} plain "
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
            bvh.bvh8, aux, rays, retrace="packet", retrace_ml=8192,
            retrace_blocks=256, **GRID_BUDGETS)

    rec, restore = capture(packet2, ("cull",))
    reset_launches()
    try:
        hits, ovf = primary()
    finally:
        restore()
    launches = read_launches(dev, ("cull", "mt_fused"), "the grid trace")
    blocks = grid_cull_blocks(aux, rec["cull"][0][2], gpu_line)
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


def grid_cull_blocks(aux, desc, gpu_line, n_kernel=20, n_plain=3):
    """Kernel G against its twin on grid16's cull descriptors, where
    nbpad > 128 (the kernel's 2-D grid spans several chunks of block ids
    and the n_blocks mask falls past the first 128), timed with its
    device time and bound as in phase 6. Prints its kernel line and
    returns a summary for the phase line."""
    import torch
    from tinybvh_tpu_torch.traverse import packet2

    nbpad = aux.blk_lo.shape[1]
    if nbpad <= packet2.LANES:
        raise AssertionError(f"grid: nbpad {nbpad} does not exceed 128")
    g = (desc, aux.blk_lo, aux.blk_hi, aux.n_blocks)
    dev = desc.device
    on_gpu = dev.type == "cuda"
    kern = packet2._cull_blocks_cuda if on_gpu else packet2._cull_blocks_plain
    m_k = kern(*g)
    m_p = packet2._cull_blocks_plain(*g)
    if not torch.equal(m_k, m_p):
        raise AssertionError("cull_blocks: grid16 mask differs from the "
                             "plain twin")
    shape = (f"G={m_k.shape[0]} nbpad={nbpad} n_blocks={aux.n_blocks} "
             f"({int(m_k.sum())} blocks set)")
    r = dict(
        max_abs_err=int((m_k - m_p).abs().max()),
        ms=time_ms(lambda: kern(*g), dev, n_kernel),
        device_ms=(device_ms(lambda: kern(*g), G_GRAPH_RUNS) if on_gpu
                   else None),
        plain_ms=time_ms(lambda: packet2._cull_blocks_plain(*g), dev,
                         n_plain),
        shape=f"grid16 {shape}",
        **bound("cull_blocks", g, (m_k,), desc.shape[0] * aux.n_blocks))
    kernel_line(5, "cull_blocks", r, gpu_line)
    return f"kernel G equal to its twin at {shape}"


GRID_BUDGETS = dict(max_leaves=2560, max_blocks=256, tri_blk=128)
# kernel G's device time: a few microseconds a launch, so its CUDA graph
# holds more launches than the other kernels' to damp the graph's own cost
G_GRAPH_RUNS = 200


def grid_kernel_g(tris, dev, gpu_line, W=640):
    """Kernel G alone on grid16's cull descriptors (the first cull pass of
    phase 5's primary trace), for --resolves."""
    from tinybvh_tpu_torch.traverse import packet2

    bvh, rays, _, _, _ = setup_scene(grid_scene(tris, 4, 4), dev, W)
    rec, restore = capture(packet2, ("cull",))
    try:
        packet2.intersect_packets2(bvh.bvh8, bvh.packet_aux, rays,
                                   retrace=False, **GRID_BUDGETS)
    finally:
        restore()
    grid_cull_blocks(bvh.packet_aux, rec["cull"][0][2], gpu_line)


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
    n_walked = int(n_blk.sum()) * packet2.TRI_BLK
    n_live = live_rows(c[2], n_blk * packet2.TRI_BLK)
    out["mt_gathered"] = dict(
        max_abs_err=float((t_k - t_p).abs().max()),
        ms=time_ms(lambda: kern(*c), dev, n_kernel),
        device_ms=device_ms(lambda: kern(*c), n_kernel) if on_gpu else None,
        plain_ms=time_ms(lambda: plain_c(*c), dev, n_plain),
        shape=f"T={c[2].shape[0]} K4={c[2].shape[1]} ({n_live} live rows "
              f"of {n_walked} walked)",
        # live rows of the 128-row blocks each tile ran before its gate
        **bound("mt_gathered", c, (t_k, i_k), n_live * 256))

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
        device_ms=(device_ms(lambda: kern(*g), G_GRAPH_RUNS) if on_gpu
                   else None),
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
    """Kernel against its twin on `args` (bit equality), both timed (the
    kernel also by device_ms on the card), and the kernel's bound on
    these arguments."""
    got = kern(*args)
    ref = plain(*args)
    return dict(max_abs_err=equal_twin(name, got, ref),
                ms=time_ms(lambda: kern(*args), dev, n_kernel),
                device_ms=(device_ms(lambda: kern(*args), n_kernel)
                           if dev.type == "cuda" else None),
                plain_ms=time_ms(lambda: plain(*args), dev, n_plain),
                shape=shape, **bound(name, args, got, units))


def sequential_tiles(fw, args):
    """Tiles of kernel F's launch on `args` that took its in-kernel
    sequential walk; "n/a" off the card, or for a tree of the package
    whose kernel walks every tile that way (before its redesign)."""
    if args[0].device.type != "cuda" or not hasattr(fw, "sequential_tiles"):
        return "n/a"
    return fw.sequential_tiles(*args)


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
    n_live = live_rows(d_args[2])
    d_units = n_live * 256
    d_shape = (f"T={T} K4={d_args[2].shape[1]} ({n_live} live rows of "
               f"{T * d_args[2].shape[1]})")
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
    n_leaves = int(live.sum())
    n_tris = live_tris(e_args[2], live)
    out["leaf_resolve"] = kernel_entry(
        "leaf_resolve", k_e, lr._resolve_plain, e_args, n_tris * 256, dev,
        f"T={T} K={leaves.shape[1]} ({n_tris} nonzero triangles in "
        f"{n_leaves} live leaves; the earlier yardstick counted 4 a leaf, "
        f"{4 * n_leaves})")

    # kernel F on the F + D trace's planes, at 512 leaves and at 64
    f_args = rec_f["collect_tile_leaves_kernel"][0]

    def plain_f(*args):
        return fw._walk_plain(*args)[:2]

    k_f = fw._walk_cuda if on_gpu else plain_f
    tile_pops = fw._walk_plain(*f_args)[2].double()
    pops = int(tile_pops.sum())
    out["frustum_walk"] = kernel_entry(
        "frustum_walk", k_f, plain_f, f_args, pops, dev,
        f"T={T} M={f_args[0].shape[0]} K={f_args[4]} ({pops} pops; a "
        f"tile: most {int(tile_pops.max())}, mean "
        f"{float(tile_pops.mean()):.2f}, std {float(tile_pops.std()):.2f}; "
        f"{sequential_tiles(fw, f_args)} tiles took the kernel's "
        f"sequential walk)")
    f64 = f_args[:4] + (64,)
    ref64 = plain_f(*f64)
    f_err = equal_twin("frustum_walk at 64 leaves", k_f(*f64), ref64)
    n_ovf64 = int((ref64[1] < 0).sum())
    if on_gpu and n_ovf64 == 0:
        raise AssertionError("no tile overflows 64 leaves")
    seq64 = sequential_tiles(fw, f64)

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
          f"(max_abs_err {f_err}, {n_ovf64} tiles overflow, {seq64} took "
          f"the kernel's sequential walk); shadow "
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


def instance_scene(bvh, tris, n, dev, W=INST_W, omaps=None):
    """bench.py's _bench_instances scene: nx*ny*nz translated instances of
    one BLAS spaced at 1.15 x its extent, the TLAS and its packet tables
    built (timed; with omaps, the BLAS's micromaps baked into them), and
    W x W camera rays over the grid in 16x16 tile order."""
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
    tp = build_tlas_packet([bvh.bvh8], mats, omaps=omaps)
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


def profile_split(fn, dev):
    """One call of fn() under torch.profiler with the CUDA activity alone
    (the CPU side's events cost ~20 s around the 68 packet passes of a
    scene16 trace): dict(total=all device ms, ab=kernels A and B's device
    ms (csrc/cull.cu cull_kernel, csrc/mt_fused.cu tile_order and
    mt_fused_kernel), top=the four other kernels with the most device
    time); None where the profiler saw no device time (off the card, or
    records dropped)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if dev.type != "cuda":
        return None
    sync(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(dev)
    ms = {e.key: e.self_device_time_total / 1e3
          for e in prof.key_averages()
          if str(getattr(e, "device_type", "")).endswith("CUDA")
          and getattr(e, "self_device_time_total", 0) > 0}
    if not ms:
        return None

    def is_ab(name):
        return any(k in name for k in ("cull_kernel", "mt_fused_kernel",
                                       "tile_order"))

    return dict(
        total=sum(ms.values()),
        ab=sum(v for k, v in ms.items() if is_ab(k)),
        top=sorted(((v, k) for k, v in ms.items() if not is_ab(k)),
                   reverse=True)[:4])


def breakdown(fn, dev, wall_ms, retrace=False):
    """Where one call of fn() spends its time (profile_split): device ms,
    the device's busy and idle share of wall_ms (an unprofiled call's
    median wall time), kernels A+B, the other kernels and the four with
    the most device time; "not measured" where the profiler saw no
    device time. With retrace, the packet paths' wavefront retraces
    (traverse/wavefront.py's intersect_wavefront, which packet2 imports
    at each retrace, and tlas/packet.py's intersect_tlas_wavefront) are
    recorded during the call and replayed on the same inputs under the
    profiler: their device ms, a part of the other kernels'."""
    from tinybvh_tpu_torch.tlas import packet as tpk
    from tinybvh_tpu_torch.traverse import wavefront

    targets = ((wavefront, "intersect_wavefront"),
               (tpk, "intersect_tlas_wavefront")) if retrace else ()
    with Calls(*targets) as rec:
        sp = profile_split(fn, dev)
    if dev.type != "cuda":
        return "breakdown not measured (no card)"
    if sp is None:
        return "breakdown not measured (the profiler saw no device time)"
    total, ours = sp["total"], sp["ab"]
    extra = ""
    if retrace:
        rt = profile_split(lambda: [real(*args, **kw)
                                    for real, args, kw, _ in rec.calls], dev)
        extra = (f", of which the retrace ({len(rec.calls)} calls, "
                 + ("replayed) not measured" if rt is None else
                    f"replayed) {rt['total']:.2f} ms"))
    del rec
    return (f"device {total:.2f} ms of {wall_ms:.2f} ms wall (busy "
            f"{total / wall_ms:.3f}, idle {1 - total / wall_ms:.3f}): "
            f"kernels A+B {ours:.2f} ms, other kernels {total - ours:.2f} "
            f"ms{extra}, most: " + ", ".join(
                f"{k[:48]} {v:.2f}" for v, k in sp["top"]))


def live_tiles(b):
    """Tiles of kernel B's arguments `b` with at least one key."""
    return int((b[1] > 0).sum())


def pair_kernels(a, b, n_kernel=20):
    """Kernels A and B against their twins (torch.equal on every output)
    on one captured cull call `a` and its resolve call `b`, each timed by
    CUDA events and as device time (a CUDA graph of the calls), with its
    bound. Returns {name: result}."""
    from tinybvh_tpu_torch.traverse import packet2

    if a[6] != b[7]:
        raise AssertionError("cull and resolve calls unpaired")
    dev = a[2].device
    on_gpu = dev.type == "cuda"
    kern_a = packet2._cull_cuda if on_gpu else packet2._cull_plain
    ref_a = packet2._cull_plain(*a)
    got_a = kern_a(*a)
    err_a = equal_twin("cull", got_a, ref_a)

    def plain_b(*args):
        return packet2._mt_fused_plain(*args)[:5]

    kern_b = packet2._mt_fused_cuda if on_gpu else plain_b
    *ref_b, n_sb = packet2._mt_fused_plain(*b)
    got_b = kern_b(*b)
    err_b = equal_twin("mt_fused", got_b, ref_b)
    r = {}
    for name, kern, plain, args, got, units, err in (
            ("cull", kern_a, packet2._cull_plain, a, got_a,
             int(a[0].sum()) * packet2.LANES * packet2.TB, err_a),
            ("mt_fused", kern_b, plain_b, b, got_b, fused_tests(b, n_sb),
             err_b)):
        r[name] = dict(
            max_abs_err=err,
            ms=time_ms(lambda: kern(*args), dev, n_kernel),
            device_ms=(device_ms(lambda: kern(*args), n_kernel)
                       if on_gpu else float("nan")),
            plain_ms=time_ms(lambda: plain(*args), dev, 1),
            **bound(name, args, got, units))
    return r


def pair_text(a, b, r):
    shape = (f"T={b[0].shape[0]} ({live_tiles(b)} live) k_cap={b[7]} "
             f"max_blocks={a[1].shape[1]} tri_blk={b[8]}")
    return f"{shape}; " + "; ".join(
        f"{k} equal to its twin (max_abs_err {v['max_abs_err']}), "
        f"kernel {v['ms']:.4f} ms, device {v['device_ms']:.4f} ms, plain "
        f"{v['plain_ms']:.2f} ms, bound {v['bound_ms']:.4f} ms "
        f"({v['bound_by']})" for k, v in r.items())


def round_kernels(rec, k_first, gpu_line, what, n_kernel=20):
    """Kernels A and B against their twins (pair_kernels) on two captured
    calls of a bucketed trace: the first-pass round with the most live
    tiles (k_cap = k_first) and the escalation pass with the most. Prints
    one line per call."""
    first = [i for i, b in enumerate(rec["mt_fused"]) if b[7] == k_first]
    esc = [i for i, b in enumerate(rec["mt_fused"]) if b[7] > k_first]
    if not first or not esc:
        raise AssertionError(f"{what}: {len(first)} first passes, {len(esc)}"
                             " escalation passes captured")
    for label, calls in (("round", first), ("escalation", esc)):
        i = max(calls, key=lambda j: live_tiles(rec["mt_fused"][j]))
        a, b = rec["cull"][i], rec["mt_fused"][i]
        r = pair_kernels(a, b, n_kernel)
        print(f"{what} kernels, {label} pass: {pair_text(a, b, r)} "
              f"[{gpu_line}]", flush=True)


def pass_kernels(fn, gpu_line, what, n_kernel=20):
    """Kernels A and B against their twins (pair_kernels) on two of the
    packet passes one fn() call makes: the closest-hit pass and the
    any-hit pass with the most live tiles. Prints one line per pass."""
    from tinybvh_tpu_torch.traverse import packet2

    rec, restore = capture(packet2, ("cull", "mt_fused"))
    try:
        fn()
    finally:
        restore()
    for label, any_hit in (("closest-hit", False), ("any-hit", True)):
        calls = [i for i, b in enumerate(rec["mt_fused"]) if b[11] == any_hit]
        if not calls:
            raise AssertionError(f"{what}: no {label} pass captured")
        i = max(calls, key=lambda j: live_tiles(rec["mt_fused"][j]))
        a, b = rec["cull"][i], rec["mt_fused"][i]
        r = pair_kernels(a, b, n_kernel)
        print(f"{what} kernels, {label} pass {i} of {len(rec['mt_fused'])}: "
              f"{pair_text(a, b, r)} [{gpu_line}]", flush=True)


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
    is_occluded_tlas_packets2, each gated by the lockstep oracle;
    kernels A and B against their twins on the per-instance engine's
    closest-hit and shadow passes (pass_kernels)."""
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
    # kernels A and B on the per-instance engine's passes
    pass_kernels(lambda: (per_instance(), occluded()), gpu_line,
                 "phase 12b inst8 per-instance and shadow")
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


# phase 15: random64k with a floor and an emissive quad, 640x640 pixels,
# 2 samples a pixel, 3 bounces, through render(aux=) (packet routing)
RENDER = dict(W=640, spp=2, bounces=3, seed=0, emission=8.0)
# phase 15b: scene16, the 4x4 grid of random64k as 16 instances of one
# rigid, morphing mesh in a Scene, 512x512 camera rays, 1 sample, 2
# bounces a frame, 3 frames
SCENE16 = dict(W=512, bounces=2, frames=(0.0, 0.4, 0.8), emission=8.0)


def lit_box(tris):
    """random64k's box with a floor quad below it and an emissive quad
    above it: (all triangles, emission (N, 3))."""
    v = tris.reshape(-1, 3)
    lo, hi = v.min(0), v.max(0)
    c, ext = (lo + hi) / 2, hi - lo

    def quad(y, half, flip):
        a = [c[0] - half[0], y, c[2] - half[2]]
        b = [c[0] + half[0], y, c[2] - half[2]]
        cc = [c[0] + half[0], y, c[2] + half[2]]
        d = [c[0] - half[0], y, c[2] + half[2]]
        q = np.array([[a, b, cc], [a, cc, d]], np.float32)
        return q[:, ::-1] if flip else q

    floor = quad(lo[1] - 0.05 * ext[1], ext, False)
    light = quad(hi[1] + 0.3 * ext[1], 0.25 * ext, True)
    all_tris = np.concatenate([tris, floor, light]).astype(np.float32)
    emission = np.zeros((all_tris.shape[0], 3), np.float32)
    emission[-2:] = RENDER["emission"]
    return all_tris, emission


class Calls:
    """A with-block that patches each (module, name) of `targets` to
    record its calls, at most `keep` of them (all with keep=None), as
    (the real function, args, kwargs, result) in .calls, and puts the
    functions back on leaving."""

    def __init__(self, *targets, keep=None):
        self.targets, self.keep = targets, keep
        self.calls, self.real = [], []

    def __enter__(self):
        for module, name in self.targets:
            real = getattr(module, name)

            def f(*args, _real=real, **kw):
                out = _real(*args, **kw)
                if self.keep is None or len(self.calls) < self.keep:
                    self.calls.append((_real, args, kw, out))
                return out

            setattr(module, name, f)
            self.real.append((module, name, real))
        return self

    def __exit__(self, *exc):
        for module, name, real in self.real:
            setattr(module, name, real)
        self.real = []


def image_gate(got, ref, rtol, atol, frac, mean_rtol, what):
    """At least `frac` of the pixels (rays) within rtol / atol on every
    channel, and the means within mean_rtol; returns the text."""
    import torch

    close = torch.isclose(got.reshape(-1, 3), ref.reshape(-1, 3), rtol=rtol,
                          atol=atol).all(dim=-1)
    share = float(close.float().mean())
    m_got, m_ref = float(got.double().mean()), float(ref.double().mean())
    rel = abs(m_got - m_ref) / max(abs(m_ref), 1e-30)
    if not (share >= frac and rel <= mean_rtol and bool(
            got.isfinite().all())):
        raise AssertionError(f"{what}: {share:.5f} of the pixels within "
                             f"rtol {rtol} / atol {atol} (need {frac}), "
                             f"means {m_got} / {m_ref} (rel {rel})")
    return (f"{share:.5f} of the pixels within rtol {rtol} / atol {atol}, "
            f"means {m_got:.6f} / {m_ref:.6f} (rel {rel:.2e})")


def phase_render(tris, dev, gpu_line):
    """Phase 15, render64k: render() of random64k lit by an emissive quad
    above a floor, every extension and shadow pass through the packet2
    engine (kernels A and B; the h100 row's budgets and retrace cap). The
    frame's overflow flag, its radiance (finite, lit), bounce 0's hits
    against the brute-force oracle on 2048 rays, the same frame through
    the wavefront engine with the same draws; A and B against their twins
    on a bounce-1 extension pass's arguments (sorted incoherent rays);
    frame time, rays and launches a frame, a profiler breakdown and peak
    device memory. Returns A's and B's launches in one frame."""
    from tinybvh_tpu_torch import BVH
    from tinybvh_tpu_torch.render import camera, pathtracer
    from tinybvh_tpu_torch.traverse import packet2
    from tinybvh_tpu_torch.tuning import get_tuning

    start = time.perf_counter()
    W, spp, bounces = RENDER["W"], RENDER["spp"], RENDER["bounces"]
    all_tris, emission = lit_box(tris)
    bvh = BVH(all_tris, device=dev)
    aux = bvh.packet_aux
    scene = pathtracer.make_scene_arrays(bvh.tris, emissive=emission)
    cam = camera.auto_camera(*bvh.aabb)
    cap = get_tuning(device=dev).wf_cap_factor
    sync(dev)
    build_s = time.perf_counter() - start

    def frame(route_aux=aux):
        return pathtracer.render(
            bvh.bvh8, scene, *cam, W, W, spp=spp, bounces=bounces,
            sampler=pathtracer.Sampler.seeded(RENDER["seed"], dev),
            cap_factor=cap, aux=route_aux)

    t0 = time.perf_counter()
    with Calls((packet2, "intersect_packets2"), keep=1) as first:
        reset_launches()
        (img, ovf), mem = peak_gib(frame, dev)
        launches = read_launches(dev, ("cull", "mt_fused"),
                                 "the render frame")
    first_s = time.perf_counter() - t0
    if bool(ovf):
        raise AssertionError("render64k: the frame overflowed")
    if not (bool(img.isfinite().all()) and float(img.max()) > 0.0):
        raise AssertionError("render64k: radiance not finite, or black")
    _, (_, _, cam_rays), _, (hits0, _) = first.calls[0]
    idx = oracle_subset(cam_rays.o.shape[0], dev)
    agree, ratio = oracle_check(hits0.take(idx), cam_rays.take(idx),
                                bvh.tris, "render64k bounce 0")

    # the same frame through the wavefront engine, the same draws
    img_wf, ovf_wf = frame(None)
    if bool(ovf_wf):
        raise AssertionError(f"render64k: the wavefront frame overflowed at "
                             f"cap {cap}")
    gate = image_gate(img, img_wf, 1e-3, 1e-4, 0.999, 1e-3,
                      "render64k packets against wavefront")

    # kernels A and B on bounce 1's extension pass (sorted rays)
    rec, restore = capture(packet2, ("cull", "mt_fused"))
    try:
        rays = camera.primary_rays(*cam, W, W, device=dev)
        pathtracer.trace_paths(bvh.bvh8, scene, rays,
                               pathtracer.Sampler.seeded(1, dev),
                               bounces=2, aux=aux)
    finally:
        restore()
    a, b = rec["cull"][2], rec["mt_fused"][2]
    del rec
    r = pair_kernels(a, b)
    print(f"phase 15 render64k kernels, bounce-1 extension pass: "
          f"{pair_text(a, b, r)} [{gpu_line}]", flush=True)

    wf_s = wall_s(lambda: frame(None), dev, warmed=True)
    frame_s = wall_s(frame, dev, warmed=True)
    t0 = time.perf_counter()
    parts = breakdown(frame, dev, frame_s * 1e3, retrace=True)
    prof_s = time.perf_counter() - t0
    traversals = spp * bounces * 2
    n_rays = traversals * W * W
    print(f"phase 15 render64k: {all_tris.shape[0]} tris (random64k, a "
          f"floor, an emissive quad of {RENDER['emission']}), {W}x{W} "
          f"pixels, {spp} samples, {bounces} bounces, packet routing (h100 "
          f"row, retrace cap {cap}); frame {frame_s * 1e3:.3f} ms (median "
          f"of 3 after a warm-up), {traversals} traversals and {n_rays} "
          f"rays a frame, {n_rays / frame_s / 1e6:.3f} MRays/s; launches a "
          f"frame {launches}; overflow 0; image mean "
          f"{float(img.double().mean()):.6f}; bounce 0 oracle prim-agree "
          f"{agree:.5f} checksum {ratio:.6f}; the same frame through the "
          f"wavefront engine (cap {cap}, same draws) {wf_s * 1e3:.3f} ms "
          f"(median of 3 after a warm-up): {gate}; breakdown of one frame: "
          f"{parts}; peak device memory {mem:.3f} GiB; BVH and tables "
          f"{build_s:.2f} s, first frame {first_s:.2f} s, profiled frame "
          f"{prof_s:.2f} s, phase {time.perf_counter() - start:.1f} s "
          f"[{gpu_line}]", flush=True)
    return launches


def scene16(tris, dev):
    """The scene16 Scene: one random64k mesh, policy "rigid", with one
    morph target (phase 13's deformation as a delta), 16 instances of it
    on the 4x4 grid of bench.py:704-708 under one root node, the root's
    LINEAR translation channel and instance 0's LINEAR weights channel,
    and an emissive quad above the grid. Returns (scene, lamp instance
    id)."""
    from tinybvh_tpu_torch.scene.graph import Animation, Node, Scene
    from tinybvh_tpu_torch.scene.mesh import Material, Mesh

    rng = np.random.default_rng(0)
    moved = (tris * np.float32([1.3, 0.7, 1.0]) + np.float32([2.0, -1.0, 0.5])
             + rng.normal(scale=0.02, size=tris.shape).astype(np.float32))
    s = Scene(device=dev)
    mesh = Mesh(tris=tris.copy())
    mesh.base_tris = tris.copy()
    mesh.morph_targets = (moved - tris).astype(np.float32)[None]
    mid = s.add_mesh(mesh, policy="rigid")
    v = tris.reshape(-1, 3)
    lo, ex = v.min(0), v.max(0) - v.min(0)
    root = s.add_node(Node(name="grid"))
    inst = [s.add_node(Node(mesh=mid, translation=np.float32(
        [ex[0] * 1.1 * i, ex[1] * 1.1 * j, 0])), parent=root)
        for i in range(4) for j in range(4)]
    top = lo + ex * np.float32([4.4 / 2, 4.4 + 0.3, 0.5])
    lamp = s.add_material(Material(emissive=np.full(3, SCENE16["emission"],
                                                    np.float32)))
    s.add_instance(s.add_quad(top, float(ex.max()) * 1.5, normal_axis=1,
                              material=lamp))
    s.animations.append(Animation([
        dict(node=root, path="translation", times=np.array([0.0, 1.0]),
             values=np.float32([[0, 0, 0], [ex[0] * 0.5, 0, 0]]),
             interp="LINEAR"),
        dict(node=inst[0], path="weights", times=np.array([0.0, 1.0]),
             values=np.float32([[0.0], [1.0]]), interp="LINEAR")]))
    return s, len(inst)


def world_tris(s):
    """The frame's world-space triangles, instance by instance in the
    TLAS's instance order, and each instance's first row."""
    parts, first = [], []
    n = 0
    for m, w in s._instances:
        t = s.meshes[m].tris
        parts.append(t @ w[:3, :3].T + w[:3, 3])
        first.append(n)
        n += t.shape[0]
    return np.concatenate(parts).astype(np.float32), np.array(first)


def scene_oracle(s, rays, dev):
    """Scene.intersect (the lockstep two-level traversal) on ORACLE_RAYS
    of `rays` against brute force over the frame's world-space
    triangles: prim and instance agreement >= 0.999, hit-t checksum
    within 1%."""
    import torch
    from tinybvh_tpu_torch.core.intersect import brute_force_closest

    idx = oracle_subset(rays.o.shape[0], dev)
    sub = rays.take(idx)
    h = s.intersect(sub)
    wt, first = world_tris(s)
    ref = brute_force_closest(sub, torch.from_numpy(wt).to(dev))
    first_t = torch.from_numpy(first).to(dev)
    ref_inst = torch.where(ref.prim >= 0, torch.searchsorted(
        first_t, ref.prim.long(), right=True) - 1, -1)
    ref_prim = torch.where(ref.prim >= 0,
                           ref.prim - first_t[ref_inst.clamp(min=0)], -1)
    prim_agree = float((h.prim == ref_prim).float().mean())
    inst_agree = float((h.inst == ref_inst).float().mean())
    s_ours = float(h.t[h.prim >= 0].double().sum())
    s_ref = float(ref.t[ref.prim >= 0].double().sum())
    if s_ref <= 0.0:
        raise AssertionError("scene16: the oracle subset hits nothing")
    ratio = s_ours / s_ref
    if not (prim_agree >= 0.999 and inst_agree >= 0.999
            and abs(ratio - 1.0) <= 0.01):
        raise AssertionError(f"scene16 Scene.intersect: prim-agree "
                             f"{prim_agree} inst-agree {inst_agree} "
                             f"checksum ratio {ratio}")
    return (f"prim-agree {prim_agree:.5f} inst-agree {inst_agree:.5f} "
            f"checksum {ratio:.6f}")


def phase_scene16(tris, dev, gpu_line):
    """Phase 15b, scene16: a Scene of 16 instances of a rigid, morphing
    random64k (1,048,576 triangles) and an emissive quad, 3 frames of
    update(t) (animation, morph, refit on the card, TLAS), tlas_packet()
    and trace_paths_tlas(tpacket=) at 512x512, 1 sample, 2 bounces.
    Each frame: Scene.intersect against brute force over the frame's
    world triangles; the last frame's radiance against the wavefront
    route with the same draws (the standard of tests/
    test_pathtracer_tlas.py:152-157), a profiler breakdown with the
    retrace's device time, and kernels A and B against their twins on
    its per-instance extension and shadow passes (pass_kernels). Returns
    A's and B's launches in one frame's trace."""
    import torch
    from tinybvh_tpu_torch.render import camera, pathtracer
    from tinybvh_tpu_torch.render.pathtracer_tlas import trace_paths_tlas
    from tinybvh_tpu_torch.tuning import get_tuning

    start = time.perf_counter()
    W, bounces = SCENE16["W"], SCENE16["bounces"]
    s, lamp = scene16(tris, dev)
    t0 = time.perf_counter()
    s.update(0.0)
    sync(dev)
    first_s = time.perf_counter() - t0
    wt, _ = world_tris(s)
    v = wt.reshape(-1, 3)
    cam = camera.auto_camera(v.min(0), v.max(0))
    rays = camera.primary_rays(*cam, W, W, device=dev)
    n_inst = len(s._instances)
    inst_albedo = torch.full((n_inst, 3), 0.7, device=dev)
    inst_albedo[lamp] = 0.0
    inst_emissive = torch.zeros((n_inst, 3), device=dev)
    inst_emissive[lamp] = SCENE16["emission"]
    lm, lw = s._instances[lamp]
    light_tris = torch.from_numpy(
        (s.meshes[lm].tris @ lw[:3, :3].T + lw[:3, 3]).astype(
            np.float32)).to(dev)
    light_emission = torch.full((2, 3), SCENE16["emission"], device=dev)
    shade = (inst_albedo, inst_emissive, light_tris, light_emission)
    tun = get_tuning(device=dev)

    def trace(tp, seed, route_tp=True, cap=4):
        return trace_paths_tlas(
            s.tlas, *shade, rays, pathtracer.Sampler.seeded(seed, dev),
            bounces=bounces, cap_factor=cap, tpacket=tp if route_tp else None)

    lines = []
    for f, t in enumerate(SCENE16["frames"]):
        sync(dev)
        t0 = time.perf_counter()
        s.update(t)
        sync(dev)
        upd_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        tp = s.tlas_packet()
        sync(dev)
        tp_s = time.perf_counter() - t0
        reset_launches()
        t0 = time.perf_counter()
        rad, ovf = trace(tp, f)
        sync(dev)
        trace_s = time.perf_counter() - t0
        launches = read_launches(dev, ("cull", "mt_fused"),
                                 "the scene16 frame")
        if bool(ovf):
            raise AssertionError(f"scene16 frame {f}: overflow")
        if not (bool(rad.isfinite().all()) and float(rad.max()) > 0.0):
            raise AssertionError(f"scene16 frame {f}: radiance not finite "
                                 "or black")
        t0 = time.perf_counter()
        gate = scene_oracle(s, rays, dev)
        oracle_s = time.perf_counter() - t0
        n_rays = bounces * 2 * rays.o.shape[0]
        lines.append(
            f"frame {f} (t {t}): update {upd_s * 1e3:.3f} ms, tlas_packet "
            f"{tp_s * 1e3:.3f} ms, trace {trace_s * 1e3:.3f} ms, frame "
            f"{(upd_s + tp_s + trace_s) * 1e3:.3f} ms, "
            f"{n_rays / trace_s / 1e6:.3f} MRays/s traced, launches "
            f"{launches}, Scene.intersect {gate} "
            f"({oracle_s:.1f} s)")

    # the last frame: the wavefront route with the same draws, and where
    # a frame's time goes
    cap = tun.wf_cap_factor
    rad_wf, ovf_wf = trace(tp, f, route_tp=False, cap=cap)
    if bool(ovf_wf):
        raise AssertionError(f"scene16: the wavefront route overflowed at "
                             f"cap {cap}")
    gate = image_gate(rad, rad_wf, 2e-2, 2e-3, 0.98, 2e-2,
                      "scene16 tpacket against wavefront")
    t_last = SCENE16["frames"][-1]
    upd_s = wall_s(lambda: s.update(t_last), dev)
    sp = profile_split(lambda: s.update(t_last), dev)
    upd_dev = "not measured" if sp is None else f"{sp['total']:.3f} ms"
    wf_s = wall_s(lambda: trace(tp, f, route_tp=False, cap=cap), dev,
                  warmed=True)
    # wall: the last frame's trace, timed above
    t0 = time.perf_counter()
    parts = breakdown(lambda: trace(tp, f), dev, trace_s * 1e3, retrace=True)
    prof_s = time.perf_counter() - t0
    # kernels A and B on the last frame's per-instance passes (refit BLAS)
    pass_kernels(lambda: trace(tp, f), gpu_line,
                 "phase 15b scene16 last trace")
    print(f"phase 15b scene16: {n_inst - 1} instances of {tris.shape[0]} "
          f"tris ({(n_inst - 1) * tris.shape[0]} in all, policy rigid, one "
          f"morph target) and an emissive quad, {W}x{W} rays, 1 sample, "
          f"{bounces} bounces; first update (build) {first_s:.3f} s; "
          + "; ".join(lines) + f"; last frame: update {upd_s * 1e3:.3f} ms "
          f"wall (median of 3), device {upd_dev}; trace breakdown {parts}; "
          f"the same trace through the two-level wavefront (cap {cap}, same "
          f"draws) {wf_s * 1e3:.3f} ms (median of 3 after a warm-up): "
          f"{gate}; profiled trace {prof_s:.2f} s; "
          f"{time.perf_counter() - start:.1f} s [{gpu_line}]", flush=True)
    return launches


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
    from tinybvh_tpu_torch.probes import gather

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
        # the whole function, 10 * t[idx], as one f32 product (TF32 off):
        # each output is one nonzero product 10 * v, exact
        t, idx = args
        oh10 = (torch.arange(t.shape[0], device=t.device)[None]
                == idx[:, None]).to(torch.float32) * gather.REPS
        t32 = t.float()
        return lambda: torch.mm(oh10, t32)
    return None


SECTOR = 32  # bytes: the least a read from device memory moves


def gather_bytes(form, args, out):
    """The bytes H form `form` must move on these arguments: each 32-byte
    sector of its table that this run's indices pick (for C100, over all
    its rounds; for A100, at the composed index), read once, its index
    array read once and its output written once. The rest of the table
    is never read."""
    import torch
    from tinybvh_tpu_torch.probes import gather

    t, idx = args
    pos = torch.arange(t.numel(), device=t.device).reshape(t.shape)
    if form == "C100":
        picked = torch.cat([pos.gather(0, ((idx + s) % t.shape[0]).long())
                            for s in range(gather.ROUNDS)])
    elif form.startswith("D"):
        picked = pos[idx.long()]
    else:
        picked = gather.FORMS[form].plain(pos, idx)
    sectors = torch.unique(picked * t.element_size() // SECTOR).numel()
    return sectors * SECTOR + nbytes((idx, out))


# H forms given a design
REDESIGNS = ("row", "A", "B", "B2", "C", "col", "E", "A100", "C100")
# what a redesigned form's time above the launch floor pays for, where no
# call of it at 0 rounds splits it
REDESIGN_REST = {"row": "its index and data round trips",
                 "A": "its row's staging and lookup",
                 "B": "its row's staging and lookup",
                 "B2": "its row's staging and lookup",
                 "C": "its index and data round trips",
                 "col": "its rows' load and pick",
                 "E": "its table's staging and lookup",
                 "C100": "its staging and rounds"}


# H-row's large shape: 262,144 indices into 1,048,576 rows of 48 floats
# (201 MB, four times L2), both drawn on the card from this seed
ROW_LARGE = dict(M=1048576, C=48, R=262144, seed=7)


def row_large_inputs(dev):
    """H-row's table and indices at ROW_LARGE, uniform, from a generator
    on `dev` seeded with ROW_LARGE["seed"]."""
    import torch

    g = torch.Generator(device=dev).manual_seed(ROW_LARGE["seed"])
    M = ROW_LARGE["M"]
    t = torch.rand((M, ROW_LARGE["C"]), generator=g, device=dev)
    i = torch.randint(0, M, (ROW_LARGE["R"],), generator=g, device=dev,
                      dtype=torch.int32)
    return t, i


def redesign_calls(form, args):
    """H form `form` (REDESIGNS) on `args`: {label: (zero-argument
    callable, expected output[, arguments whose bound the line prints])},
    the wrapper's call first; for row, its general path at 47 columns and
    on a table view one float into its storage, its earlier design, and
    both designs and the library call (index_select, never the port's) at
    ROW_LARGE; for A100, its
    kernel at 0 rounds through the C entry (its fixed part: loads and
    stores); for E, its general path on the table with one float more
    (2,049, not a multiple of 4: the same outputs); for col, its general
    path on the table widened to 48 columns (the same outputs) and on
    8,193 rows, one past its rows path's 2^18 floats; for C, the kernel on
    65,543 index rows (grid z). Each call writes a buffer of its own."""
    import torch
    from tinybvh_tpu_torch.probes import gather

    t, i = args
    ref = gather.FORMS[form].plain(t, i)
    if form == "row":
        narrow = t[:, :47].contiguous()
        odd = torch.zeros(t.numel() + 1, device=t.device)[1:].view(t.shape)
        odd.copy_(t)
        big, big_i = row_large_inputs(t.device)
        big_ref = gather._row_plain(big, big_i)
        return {"rows path": (lambda: gather.row_gather(t, i), ref),
                "general (C = 47)": (lambda: gather.row_gather(narrow, i),
                                     gather._row_plain(narrow, i)),
                "general (offset view)": (
                    lambda: gather.row_gather(odd, i), ref),
                "earlier design": (
                    lambda: gather.row_gather(t, i, path="earlier"), ref),
                "rows path, large": (lambda: gather.row_gather(big, big_i),
                                     big_ref, (big, big_i)),
                "earlier design, large": (
                    lambda: gather.row_gather(big, big_i, path="earlier"),
                    big_ref, (big, big_i)),
                "library index_select, large": (
                    library_call(form, (big, big_i)), big_ref, (big, big_i))}
    if form in ("A", "B", "B2"):
        return {"row slices": (lambda: gather.lane_gather(t, i), ref)}
    if form == "C":
        iz = i[torch.arange(65543, device=t.device) % i.shape[0]]
        return {"(W / 128, S) grid": (lambda: gather.sublane_gather(t, i),
                                      ref),
                "65,543 index rows (grid z)": (
                    lambda: gather.sublane_gather(t, iz),
                    gather._sublane_plain(t, iz))}
    if form == "col":
        wide = torch.cat([t, torch.zeros_like(t[:, :16])], 1)
        rows = torch.arange(8193, device=t.device) % t.shape[0]
        tall, col_tall = t[rows], i[rows]
        return {"rows (4 lanes a row)": (lambda: gather.col_gather(t, i),
                                         ref),
                "general (C = 48)": (lambda: gather.col_gather(wide, i),
                                     ref),
                "general (R = 8,193)": (
                    lambda: gather.col_gather(tall, col_tall),
                    gather._col_plain(tall, col_tall))}
    if form == "E":
        longer = torch.cat([t, t[:1]])
        return {"staged": (lambda: gather.flat_take(t, i), ref),
                "general (N = 2,049)": (lambda: gather.flat_take(longer, i),
                                        ref)}
    if form == "C100":
        return {"staged": (lambda: gather.sum_gather(t, i), ref)}

    def zero_rounds():
        out = torch.empty_like(t)
        gather._launch("chain_gather", "tbvh_gather_chain", t, i, out, 0)
        return out

    return {"doubling": (lambda: gather.chain_gather(t, i), ref),
            "doubling at 0 rounds": (zero_rounds, t)}


def phase_redesigns(h, kern, gpu_line, n=3):
    """The redesigned H forms (REDESIGNS) against the launch floor: the
    device time (one CUDA graph of N_TIMED launches) of an empty kernel
    and of each call of redesign_calls, n rounds in turns, each output
    checked with torch.equal; what sets the pace of the wrapper's form:
    the floor, its fixed part above the floor (A100) and the rest; then
    the kernels' resources."""
    import torch
    from tinybvh_tpu_torch import _build
    from tinybvh_tpu_torch.probes import gather

    dev = h["A100"]["out"].device
    floor = gather.launch_floor_ms(dev)
    print(f"phase 14 launch floor: an empty kernel (one warp) device "
          f"{floor:.6f} ms [{gpu_line}]", flush=True)
    for form in REDESIGNS:
        calls = redesign_calls(form, h[form]["args"])
        times = {k: [] for k in calls}
        for k in [k for _ in range(n) for k in calls]:
            fn, expected, *_ = calls[k]
            if not torch.equal(fn(), expected):
                raise AssertionError(f"gather_{form} {k}: wrong output")
            times[k].append(device_ms(fn, gather.N_TIMED))
        # calls at a shape of their own: the share of their bound reached
        shares = []
        for lab, (_, expected, *own) in calls.items():
            if own:
                b = bound_of(gather_bytes(form, own[0], expected), {})
                shares.append(f"{lab} at {b['bound_ms'] / min(times[lab]):.1%}"
                              f" of its bound {b['bound_ms']:.6f} ms "
                              f"({b['bound_by']})")
        k = kern[f"gather_{form}"]
        main = next(iter(calls))
        new = min(times[main])
        if form == "A100":
            fixed = min(times[f"{main} at 0 rounds"])
            parts = {"the launch floor": floor,
                     "its fixed part": fixed - floor, "its rounds": new - fixed}
        else:
            parts = {"the launch floor": floor,
                     REDESIGN_REST[form]: new - floor}
        print(f"phase 14 redesign gather_{form}: device ms " + "; ".join(
            f"{lab} " + " / ".join(f"{x:.6f}" for x in ts)
            for lab, ts in times.items())
              + f"; equal to its twin in every call; bound "
              f"{k['bound_ms']:.6f} ms ({k['bound_by']}), launch "
              f"floor {floor:.6f} ms; {main} {new / floor:.2f}x the floor, "
              "paced by " + ", ".join(f"{lab} {ms:.6f}" for lab, ms in
                                       sorted(parts.items(),
                                              key=lambda kv: -kv[1]))
              + "".join(f"; {x}" for x in shares)
              + f" [{gpu_line}]", flush=True)
        del calls
    n_flat = h["E"]["args"][0].shape[0]
    for (entry, *args), form in (
            (("tbvh_gather_row_occupancy", 48), "row (rows path, C = 48)"),
            (("tbvh_gather_row_occupancy", 47), "row (general, C = 47)"),
            (("tbvh_gather_lane_occupancy", gather.W), "A"),
            (("tbvh_gather_lane_occupancy", 1024), "B / H-B2"),
            (("tbvh_gather_sublane_occupancy",), "C"),
            (("tbvh_gather_col_occupancy",), "col (rows path)"),
            (("tbvh_gather_flat_occupancy", n_flat),
             f"E (staged, N = {n_flat})"),
            (("tbvh_gather_chain_occupancy",), "A100"),
            (("tbvh_gather_sum_occupancy",), "C100")):
        print(f"phase 14 occupancy of kernel H-{form}: "
              + occupancy_text(_build.occupancy(entry, *args))
              + f" [{gpu_line}]", flush=True)


def phase_probes(bvh, gpu_line, n_plain=20):
    """Phase 14: the probes' drivers (kernels H and I), each kernel against
    its twin, launches counted over the drivers' runs; each H form and I
    variant with its time, device time, twin's time, bound and (H) the
    library call's time; the redesigned H forms against the launch floor
    (phase_redesigns); kernel I's split of
    B's tile loop. Returns the kernel entries and launches of the JSON
    line."""
    import torch
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
        if lib and form.startswith("D") and not torch.equal(lib(), r["out"]):
            raise AssertionError(f"{name}: torch.mm differs from the kernel")
        kern[name] = dict(
            max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=time_ms(lambda: f.plain(*r["args"]), dev, n_plain),
            library_ms=time_ms(lib, dev, 200) if lib else None,
            library_device_ms=(device_ms(lib, 200)
                               if lib and dev.type == "cuda" else None),
            device_ms=r["device_ms"], graph_runs=r["graph_runs"],
            **bound_of(gather_bytes(form, r["args"], r["out"]), ops))
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
        phase_redesigns(h, kern, gpu_line)
        print("phase 14 occupancy of kernel H-D: " + occupancy_text(
            _build.occupancy("tbvh_gather_onehot_occupancy"))
            + f" [{gpu_line}]", flush=True)
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


# the occupancy entries of phases 6 and 11: name -> (C entry, *args)
# --------------------------------------------------------------------------
# phase 16: foliage64k, opacity micromaps
# --------------------------------------------------------------------------

FOLIAGE = dict(sizes=(8, 16), other_sizes=(5, 32), spheres=4096,
               sphere_oracle=256, vox_W=512, vox_samples=48000)
# fp32 / int operations of the micromap test per pair that hits
# geometrically (mt_fused.cu omap_opaque): u and v (2 multiplies), times S
# (2), two conversions and four clamps, the bit index (a multiply-add and
# a shift, an and), the word's load and conversion, shift, and, compare:
# 20, all counted at the fp32 rate
OMAP_OPS = 20


def leaf_alpha(prim, u, v):
    """A leaf-shaped alpha: opaque inside a disc of the barycentric domain
    whose radius (0.2 to 0.45) comes from a hash of the prim id, about
    half of the cells inside a triangle."""
    h = (np.asarray(prim, np.int64) * 2654435761) % 4096 / 4096.0
    return (u - 0.3) ** 2 + (v - 0.3) ** 2 < (0.2 + 0.25 * h) ** 2


def omap_oracle(o, d, tris, omap, t_max=1e30, any_hit=False, chunk=4096):
    """The alpha-aware brute force, written here and not in the package:
    every (ray, triangle) pair by Möller–Trumbore, then the bit of the
    hit's micromap cell (floor(u S), floor(v S)), then the minimum (any
    hit: any pair below t_max). o, d (R, 3); tris (N, 3, 3); omap (N, S,
    S) bool. Returns (t, prim) or (R,) occluded."""
    import torch

    R = o.shape[0]
    S = omap.shape[-1]
    dev = o.device
    best_t = torch.full((R,), 1e30, dtype=torch.float32, device=dev)
    best_p = torch.full((R,), -1, dtype=torch.int64, device=dev)
    occ = torch.zeros(R, dtype=torch.bool, device=dev)
    oo, dd = o[:, None, :], d[:, None, :]

    def cross(a, b):
        return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]],
                           dim=-1)

    for base in range(0, tris.shape[0], chunk):
        tc = tris[base:base + chunk]
        v0 = tc[None, :, 0]
        e1 = tc[None, :, 1] - v0
        e2 = tc[None, :, 2] - v0
        h = cross(dd, e2)
        det = (e1 * h).sum(-1)
        ok = det.abs() > 1e-9
        inv = 1.0 / torch.where(ok, det, 1.0)
        s = oo - v0
        u = (s * h).sum(-1) * inv
        q = cross(s, e1)
        v = (dd * q).sum(-1) * inv
        t = (e2 * q).sum(-1) * inv
        hit = (ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 0)
               & (t < t_max))
        iu = torch.clamp(torch.where(hit, u * S, 0.0).long(), 0, S - 1)
        iv = torch.clamp(torch.where(hit, v * S, 0.0).long(), 0, S - 1)
        ids = torch.arange(base, base + tc.shape[0], device=dev)[None, :]
        hit &= omap[ids, iu, iv]
        if any_hit:
            occ |= hit.any(dim=1)
            continue
        tt, a = torch.where(hit, t, 1e30).min(dim=1)
        better = tt < best_t
        best_t = torch.where(better, tt, best_t)
        best_p = torch.where(better, a + base, best_p)
    return occ if any_hit else (best_t, best_p)


def omap_gates(hits, rays, idx, tris, omap, what):
    """prim agreement and the hit-t checksum ratio of hits[idx] against
    the alpha-aware oracle; raises below 0.999 or outside 1%."""
    ref_t, ref_p = omap_oracle(rays.o[idx], rays.d[idx], tris, omap)
    h = hits.take(idx)
    agree = float((h.prim.long() == ref_p).float().mean())
    s_ours = float(h.t[h.prim >= 0].double().sum())
    s_ref = float(ref_t[ref_p >= 0].double().sum())
    if s_ref <= 0.0:
        raise AssertionError(f"{what}: the oracle subset hits nothing")
    ratio = s_ours / s_ref
    if not (agree >= 0.999 and abs(ratio - 1.0) <= 0.01):
        raise AssertionError(f"{what}: alpha-aware oracle prim-agree {agree}"
                             f", checksum ratio {ratio}")
    return agree, ratio


def omap_tests(b, n_sb, chunk=64):
    """(triangle, ray) pairs kernel B's micromap call `b` tests (as
    fused_tests) and, among them, the pairs that hit geometrically, whose
    micromap bit it then reads: the bound's two units of work."""
    import torch
    from tinybvh_tpu_torch.traverse import packet2

    offs, counts, ff, gtab = b[0], b[1], b[4], b[6]
    k_cap, tri_blk, rps, pack = b[7], b[8], b[9], b[10]
    dev = offs.device
    walked = torch.minimum(n_sb * tri_blk,
                           counts.clamp(max=k_cap).long() * rps)
    rows = torch.arange(k_cap * rps, device=dev)
    geo = 0
    for c0 in range(0, offs.shape[0], chunk):
        c1 = min(offs.shape[0], c0 + chunk)
        addr = offs[c0:c1][:, rows // rps].long() + rows % rps
        g = gtab[addr]
        run = rows[None, :] < walked[c0:c1, None]
        for base in ((0, 48) if pack == 2 else (0,)):
            hit = packet2._signed_terms(g, ff[c0:c1], base)[4]
            geo += int((hit & run[..., None]).sum())
    return fused_tests(b, n_sb), geo


def omap_kernel_entry(b, n_kernel=20, n_plain=3):
    """Kernel B's micromap instantiation against its twin on one captured
    call `b` (torch.equal on every output), timed by CUDA events, as
    device time (a CUDA graph) and its twin, with its bound: the
    Möller–Trumbore work of fused_tests plus OMAP_OPS per geometric hit."""
    from tinybvh_tpu_torch.traverse import packet2

    dev = b[0].device
    on_gpu = dev.type == "cuda"

    def plain(*args):
        return packet2._mt_fused_plain(*args)[:5]

    kern = packet2._mt_fused_cuda if on_gpu else plain
    *ref, n_sb = packet2._mt_fused_plain(*b)
    got = kern(*b)
    err = equal_twin("mt_fused_omap", got, ref)
    tests, geo = omap_tests(b, n_sb)
    r = dict(max_abs_err=err,
             ms=time_ms(lambda: kern(*b), dev, n_kernel),
             device_ms=(device_ms(lambda: kern(*b), n_kernel) if on_gpu
                        else float("nan")),
             plain_ms=time_ms(lambda: plain(*b), dev, n_plain),
             shape=f"T={b[0].shape[0]} k_cap={b[7]} tri_blk={b[8]} "
                   f"rps={b[9]} pack={b[10]} S={b[12]} any_hit={b[11]}",
             tests=tests, geo_hits=geo,
             **bound_of(nbytes(b) + nbytes(got),
                        {"fp32": tests * OPS_PER_UNIT["mt_fused"]
                         + geo * OMAP_OPS}), library_ms=None)
    return r


def omap_pass_times(calls, n=10):
    """Kernel B's micromap mode against its twin (torch.equal on every
    output) on each captured call of `calls`, and each call's device time
    (a CUDA graph of n calls; None off the card)."""
    from tinybvh_tpu_torch.traverse import packet2

    out = []
    for b in calls:
        if b[12] == 0:
            raise AssertionError("a resolve without micromaps captured")
        on_gpu = b[0].is_cuda
        ref = packet2._mt_fused_plain(*b)[:5]
        kern = packet2._mt_fused_cuda if on_gpu else packet2.mt_fused
        equal_twin("mt_fused_omap", kern(*b), ref)
        out.append(device_ms(lambda: kern(*b), n) if on_gpu else None)
    return out


def omap_ms_text(ms):
    if not ms or ms[0] is None:
        return "not measured"
    return (f"{sum(ms):.4f} ms over {len(ms)} launches ("
            + ", ".join(f"{x:.4f}" for x in ms) + ")")


def foliage_tables(bvh, S):
    """Micromaps of every random64k triangle at S x S (leaf_alpha), aligned
    with the BVH8's leaves, and the packet tables that carry them."""
    from tinybvh_tpu_torch.ops.omap import bake_omap, leaf_align
    from tinybvh_tpu_torch.traverse import packet2

    om = bake_omap(bvh.tris.shape[0], leaf_alpha, S=S, device=bvh.device)
    leaf = leaf_align(om, bvh.bvh8,
                      leaf_prim_host=bvh._bvh8_host["leaf_prim"])
    return om, leaf, packet2.build_packet_aux(bvh.bvh8, omap=leaf)


def foliage_traces(bvh, aux, rays, center, extent, tun, cutoff):
    """The micromap path: camera rays through intersect_packets2, then the
    shadow segments from phase 4's light to those hits through
    is_occluded_packets2, both at the h100 row's budgets with the
    wavefront retrace (and the micromaps) at its cap. Returns (hits,
    primary overflow, (light, points, shadow rays), occluded, shadow
    overflow)."""
    from tinybvh_tpu_torch.traverse import packet2

    kw = dict(max_leaves=tun.max_leaves, max_blocks=tun.max_blocks,
              retrace=True, wf_cap_factor=tun.wf_cap_factor)
    hits, ov = packet2.intersect_packets2(bvh.bvh8, aux, rays, **kw)
    shadow = shadow_rays(hits, rays, center, extent)
    occ, ov2 = packet2.is_occluded_packets2(bvh.bvh8, aux, shadow[0],
                                            shadow[1], cutoff=cutoff, **kw)
    return hits, ov, shadow, occ, ov2


def foliage_tlas(bvh, tris, om, leaf, gpu_line):
    """inst8 with micromaps: build_tlas_packet(omaps=) and the bucketed
    engine with rounds covering every tile's candidates and an escalation
    budget covering the whole BLAS, so that no tile is left to the
    two-level wavefront (which takes no micromaps and raises with them);
    gated against the smoke's alpha-aware brute force per instance on
    2048 middle rays."""
    import torch
    from tinybvh_tpu_torch.core.rays import Hits
    from tinybvh_tpu_torch.core.vecmath import mat3_apply
    from tinybvh_tpu_torch.tlas.packet import (
        intersect_tlas_packets2_bucketed, tile_candidates,
    )
    from tinybvh_tpu_torch.traverse import packet2

    dev = bvh.device
    tp, mats, rays, build_s, _, _ = instance_scene(bvh, tris, INST8["n"],
                                                   dev, omaps=[leaf])
    (_, _, n_cand), = tile_candidates(tp, rays, 1)
    rounds = int(n_cand.max())
    ml, _ = full_retrace_ml(bvh.bvh8)
    kw = dict(rounds=rounds, max_leaves=INST8["max_leaves"],
              max_blocks=INST8["max_blocks"], retrace="packet",
              retrace_ml=ml, retrace_blocks=INST8["retrace_blocks"])
    rec, restore = capture(packet2, ("mt_fused",))
    reset_launches()
    try:
        h, ovf = intersect_tlas_packets2_bucketed(tp, rays, **kw)
    finally:
        restore()
    got = read_launches(dev, ("cull", "mt_fused_omap"), "foliage inst8")
    if bool(ovf.any()):
        raise AssertionError("foliage inst8: residual overflow")
    omap_ms = omap_pass_times(rec["mt_fused"])
    secs = wall_s(lambda: intersect_tlas_packets2_bucketed(tp, rays, **kw),
                  dev, warmed=True)
    R = rays.o.shape[0]
    idx = middle(R, ORACLE_RAYS, dev)
    o, d = rays.o[idx], rays.d[idx]
    t_ref = torch.full((idx.shape[0],), 1e30, device=dev)
    p_ref = torch.full((idx.shape[0],), -1, dtype=torch.int32, device=dev)
    i_ref = torch.full((idx.shape[0],), -1, dtype=torch.int32, device=dev)
    for i in range(tp.inst_inv.shape[0]):
        inv = tp.inst_inv[i]
        t_i, p_i = omap_oracle(mat3_apply(inv[None, :3, :3], o) + inv[:3, 3],
                               mat3_apply(inv[None, :3, :3], d), bvh.tris,
                               om)
        better = t_i < t_ref
        t_ref = torch.where(better, t_i, t_ref)
        p_ref = torch.where(better, p_i.to(torch.int32), p_ref)
        i_ref = torch.where(better, i, i_ref)
    ref = Hits(t=t_ref, u=t_ref, v=t_ref, prim=p_ref, inst=i_ref)
    gates = tlas_gates(h.take(idx), ref, "foliage inst8")
    print(f"phase 16 foliage inst8: {tp.inst_inv.shape[0]} instances, {R} "
          f"rays, TLAS build {build_s:.3f} s, bucketed rounds {rounds} "
          f"escalation {ml} leaves: {R / secs / 1e6:.3f} MRays/s, hit rate "
          f"{float((h.prim >= 0).float().mean()):.4f}, residual overflow 0, "
          f"launches {got}, alpha-aware oracle {gates}; kernel B's micromap "
          f"mode equal to its twin on all {len(omap_ms)} of its launches, "
          f"device {omap_ms_text(omap_ms)} [{gpu_line}]", flush=True)


def foliage_spheres(bvh, tris, gpu_line):
    """intersect_sphere: FOLIAGE["spheres"] spheres over random64k's BVH2
    against brute-force sphere_tri_overlap on FOLIAGE["sphere_oracle"] of
    them, timed."""
    import torch
    from tinybvh_tpu_torch.core.intersect import sphere_tri_overlap
    from tinybvh_tpu_torch.layouts.bvh2 import BVH2
    from tinybvh_tpu_torch.ops.queries import intersect_sphere
    from tinybvh_tpu_torch.traverse.stack import pack_tris

    dev = bvh.device
    bvh2 = BVH2.from_host(bvh._host, dev)
    packed = pack_tris(bvh2, bvh.tris)
    leaf_max = int(bvh._host["count"].max())
    rng = np.random.default_rng(16)
    lo, hi = tris.reshape(-1, 3).min(0), tris.reshape(-1, 3).max(0)
    n = FOLIAGE["spheres"]
    c = torch.from_numpy(rng.uniform(lo, hi, (n, 3)).astype(
        np.float32)).to(dev)
    r = torch.from_numpy(rng.uniform(0.001, 0.012, n).astype(
        np.float32) * float(np.max(hi - lo))).to(dev)
    got = intersect_sphere(bvh2, packed, c, r, leaf_max=leaf_max)
    secs = wall_s(lambda: intersect_sphere(bvh2, packed, c, r,
                                           leaf_max=leaf_max), dev,
                  warmed=True)
    k = FOLIAGE["sphere_oracle"]
    t = bvh.tris
    ref = torch.zeros(k, dtype=torch.bool, device=dev)
    for base in range(0, t.shape[0], 8192):
        tc = t[base:base + 8192]
        ref |= sphere_tri_overlap(c[:k, None], r[:k, None], tc[None, :, 0],
                                  tc[None, :, 1], tc[None, :, 2]).any(dim=1)
    if not torch.equal(got[:k], ref):
        raise AssertionError(f"foliage spheres: {int((got[:k] != ref).sum())}"
                             f" of {k} differ from brute force")
    share = float(got.float().mean())
    if not 0.0 < share < 1.0:
        raise AssertionError(f"foliage spheres: overlap share {share}")
    print(f"phase 16 spheres: {n} spheres over the BVH2 of {t.shape[0]} "
          f"triangles in {secs * 1e3:.3f} ms ({n / secs / 1e6:.4f} "
          f"Mqueries/s), overlapping {share:.4f}, equal to brute force on "
          f"{k} [{gpu_line}]", flush=True)


def voxel_scene():
    """A full 256^3 VoxelSet: a sphere shell (radius 100, 2 voxels thick)
    and a height field filled from y = 4 to 30-62 voxels, both kept 4-8
    voxels off the volume's faces (rays enter through empty cells, so the
    DDA's entry offset of 1e-4 in t picks no cell that sampling would
    not). Returns (VoxelSet, (256, 256, 256) bool occupancy)."""
    from tinybvh_tpu_torch.ops.voxel import VoxelSet

    g = np.arange(256, dtype=np.float32)
    x, y, z = g[:, None, None], g[None, :, None], g[None, None, :]
    r = np.sqrt((x - 128) ** 2 + (y - 150) ** 2 + (z - 128) ** 2)
    hf = 46 + 10 * np.sin(x / 19) + 6 * np.cos(z / 13)
    inner = ((x >= 8) & (x < 248) & (z >= 8) & (z < 248)) & (y >= 4)
    occ = (((r >= 99) & (r < 101)) | (y < hf)) & inner
    xs, ys, zs = np.nonzero(occ)
    vs = VoxelSet()
    vs.set(xs, ys, zs)
    return vs, occ


def voxel_march(o, d, occ, n, t_end=3.0, chunk=128):
    """The sampling oracle (as tests/test_ops.py's): each ray's first
    occupied voxel among n evenly spaced points in [0, t_end], or -1, and
    the t of that point."""
    import torch

    dev = o.device
    occ_t = torch.from_numpy(occ).to(dev)
    ts = torch.linspace(0, t_end, n, device=dev)
    out = torch.full((o.shape[0], 3), -1, dtype=torch.int64, device=dev)
    t_out = torch.full((o.shape[0],), float("inf"), device=dev)
    for c0 in range(0, o.shape[0], chunk):
        p = torch.floor((o[c0:c0 + chunk, None] + ts[None, :, None]
                         * d[c0:c0 + chunk, None]) * 256).long()
        ok = ((p >= 0) & (p < 256)).all(dim=-1)
        pc = p.clamp(0, 255)
        full = ok & occ_t[pc[..., 0], pc[..., 1], pc[..., 2]]
        any_ = full.any(dim=1)
        first = full.float().argmax(dim=1)
        hitp = p[torch.arange(p.shape[0], device=dev), first]
        out[c0:c0 + chunk] = torch.where(any_[:, None], hitp, -1)
        t_out[c0:c0 + chunk] = torch.where(any_, ts[first], float("inf"))
    return out, t_out


def voxel_agreement(o, d, t, v, occ, n):
    """Per ray, whether the DDA's hit (t, voxel v) agrees with the
    sampling oracle: both miss, or the same voxel, or (where the samples
    step over a sliver of a voxel the ray clips) the DDA's voxel is
    occupied, the ray passes through it (an f64 slab test) and enters it
    no later than the first occupied sample. Returns (agree, same voxel)."""
    import torch

    first, t_first = voxel_march(o, d, occ, n)
    hit = t < 1e30
    same = (hit == (first[:, 0] >= 0)) & (~hit | (v.long() == first).all(
        dim=1))
    vl = v.long().clamp(0, 255)
    lo = vl.double() / 256
    t1 = (lo - o.double()) / d.double()
    t2 = (lo + 1 / 256 - o.double()) / d.double()
    t_in = torch.minimum(t1, t2).amax(dim=1)
    t_out = torch.maximum(t1, t2).amin(dim=1)
    on_ray = (t_in <= t_out + 1e-9) & (t_out > 0)
    filled = torch.from_numpy(occ).to(o.device)[vl[:, 0], vl[:, 1],
                                                vl[:, 2]]
    sliver = (hit & (first[:, 0] >= 0) & filled & on_ray
              & (t_in <= t_first.double() + 1e-9))
    return same | sliver, same


def foliage_voxels(dev, gpu_line):
    """The voxel DDA on a full 256^3 VoxelSet: FOLIAGE["vox_W"]^2 camera
    rays, timed, against the sampling oracle on 2048 rays (the first
    voxel, hit or miss, agreeing on >= 0.999 of them)."""
    from tinybvh_tpu_torch import make_rays
    from tinybvh_tpu_torch.ops.voxel import intersect_voxels

    t0 = time.perf_counter()
    vs, occ = voxel_scene()
    vox = vs.freeze(device=dev)
    set_s = time.perf_counter() - t0
    W = FOLIAGE["vox_W"]
    o, d, _, _ = camera_rays(np.zeros(3), np.ones(3), W, W)
    rays = make_rays(o, d, device=dev)
    t, _, v = intersect_voxels(vox, rays)
    secs = wall_s(lambda: intersect_voxels(vox, rays), dev, warmed=True)
    idx = oracle_subset(rays.o.shape[0], dev)
    agree, same = voxel_agreement(rays.o[idx], rays.d[idx], t[idx], v[idx],
                                  occ, FOLIAGE["vox_samples"])
    share = float(agree.float().mean())
    hit_rate = float((t < 1e30).float().mean())
    if share < 0.999 or not 0.0 < hit_rate < 1.0:
        raise AssertionError(f"foliage voxels: sampling-oracle agreement "
                             f"{share}, hit rate {hit_rate}")
    print(f"phase 16 voxels: {int(occ.sum())} voxels in "
          f"{vs.bricks.shape[0] - 1} bricks (set and frozen in "
          f"{set_s:.3f} s), {W}x{W} rays in {secs * 1e3:.3f} ms "
          f"({W * W / secs / 1e6:.3f} MRays/s), hit rate {hit_rate:.4f}, "
          f"sampling-oracle agreement {share:.5f} on {idx.shape[0]} rays "
          f"(the same voxel {float(same.float().mean()):.5f}, the rest an "
          f"earlier voxel clipped between samples) [{gpu_line}]",
          flush=True)


def phase_foliage(bvh, rays, center, extent, gpu_line):
    """Phase 16, foliage64k: random64k with per-triangle micromaps from
    bake_omap (leaf_alpha) at S = 8 (pack 2, 4 words a triangle) and S =
    16 (pack 1, 16 words). The main path, with the launch counts reset
    just before it and read just after: at each size the camera rays
    through intersect_packets2 and the shadow segments through
    is_occluded_packets2 (h100 row budgets, the wavefront retrace with
    the micromaps at its cap). Gates: zero residual overflow; prim
    agreement >= 0.999 and the hit-t checksum within 1% against the
    alpha-aware brute force on 2048 rays, shadow agreement >= 0.999; an
    all-opaque micromap gives the prims of no micromap on every ray; the
    micromaps change some rays' hits. Then kernel B's micromap mode
    against its twin on every captured call (closest hit and any hit at
    both sizes), its device time beside B's without micromaps on the
    same rays, and its occupancy; inst8 with micromaps; the sphere
    queries; the voxel DDA. Returns (kernel entry, launches)."""
    import torch
    from tinybvh_tpu_torch import _build
    from tinybvh_tpu_torch.ops.omap import leaf_align
    from tinybvh_tpu_torch.traverse import packet2
    from tinybvh_tpu_torch.tuning import get_tuning

    start = time.perf_counter()
    dev = rays.o.device
    tun = get_tuning(device=dev)
    cutoff = 1.0 - 1e-3
    R = rays.o.shape[0]
    tables = {S: foliage_tables(bvh, S) for S in FOLIAGE["sizes"]}

    # the main path
    rec, restore = capture(packet2, ("mt_fused",))
    reset_launches()
    try:
        runs = {S: foliage_traces(bvh, tables[S][2], rays, center, extent,
                                  tun, cutoff) for S in FOLIAGE["sizes"]}
    finally:
        restore()
    launches = read_launches(dev, ("cull", "mt_fused_omap"),
                             "the micromap path")

    idx = oracle_subset(R, dev)
    kern = {}
    plain_hits, _ = packet2.intersect_packets2(
        bvh.bvh8, bvh.packet_aux, rays, max_leaves=tun.max_leaves,
        max_blocks=tun.max_blocks, retrace=True,
        wf_cap_factor=tun.wf_cap_factor)
    for S in FOLIAGE["sizes"]:
        om, leaf, aux = tables[S]
        hits, ov, shadow, occ, ov2 = runs[S]
        if bool(ov.any()) or bool(ov2.any()):
            raise AssertionError(f"foliage S={S}: residual overflow")
        agree, ratio = omap_gates(hits, rays, idx, bvh.tris, om,
                                  f"foliage S={S}")
        occ_ref = omap_oracle(shadow[2].o[idx], shadow[2].d[idx], bvh.tris,
                              om, t_max=cutoff, any_hit=True)
        occ_agree = float((occ[idx] == occ_ref).float().mean())
        if occ_agree < 0.999:
            raise AssertionError(f"foliage S={S} shadow: alpha-aware oracle "
                                 f"agreement {occ_agree}")
        # all-opaque micromaps trace exactly as none (same pack)
        opaque = packet2.build_packet_aux(
            bvh.bvh8, omap=leaf_align(torch.ones_like(om), bvh.bvh8))
        kw = dict(max_leaves=tun.max_leaves, max_blocks=tun.max_blocks,
                  retrace=True, wf_cap_factor=tun.wf_cap_factor)
        h_op, _ = packet2.intersect_packets2(bvh.bvh8, opaque, rays, **kw)
        h_no = (plain_hits if aux.pack == 2 else packet2.intersect_packets2(
            bvh.bvh8, packet2.build_packet_aux(bvh.bvh8, pack=1), rays,
            **kw)[0])
        if not torch.equal(h_op.prim, h_no.prim):
            raise AssertionError(f"foliage S={S}: all-opaque micromaps "
                                 f"change {int((h_op.prim != h_no.prim).sum())}"
                                 " prims")
        changed = float((hits.prim != plain_hits.prim).float().mean())
        if changed <= 0.0:
            raise AssertionError(f"foliage S={S}: the micromaps change no ray")
        secs = wall_s(lambda: packet2.intersect_packets2(
            bvh.bvh8, aux, rays, **kw), dev, warmed=True)
        s_secs = wall_s(lambda: packet2.is_occluded_packets2(
            bvh.bvh8, aux, shadow[0], shadow[1], cutoff=cutoff, **kw), dev,
            warmed=True)
        # the same two calls on the tables without micromaps
        secs0 = wall_s(lambda: packet2.intersect_packets2(
            bvh.bvh8, bvh.packet_aux, rays, **kw), dev)
        s_secs0 = wall_s(lambda: packet2.is_occluded_packets2(
            bvh.bvh8, bvh.packet_aux, shadow[0], shadow[1], cutoff=cutoff,
            **kw), dev)
        bd = breakdown(lambda: packet2.intersect_packets2(
            bvh.bvh8, aux, rays, **kw), dev, secs * 1e3, retrace=True)
        print(f"phase 16 foliage S={S}: pack {aux.pack}, {R} rays, hit rate "
              f"{float((hits.prim >= 0).float().mean()):.4f} (without "
              f"micromaps {float((plain_hits.prim >= 0).float().mean()):.4f};"
              f" prims changed on {changed:.4f} of the rays), primary "
              f"{R / secs / 1e6:.3f} MRays/s, shadow {R / s_secs / 1e6:.3f} "
              f"MRays/s (occluded {float(occ.float().mean()):.4f}; the same "
              f"calls without micromaps {R / secs0 / 1e6:.3f} / "
              f"{R / s_secs0 / 1e6:.3f}), residual overflow 0, alpha-aware "
              f"oracle prim-agree {agree:.5f} (disagreeing {1 - agree:.5f}) "
              f"checksum {ratio:.6f} shadow-agree {occ_agree:.5f}, "
              f"all-opaque == no micromap on every ray; primary: {bd} "
              f"[{gpu_line}]", flush=True)

    # kernel B's micromap mode against its twin on every captured call
    calls = rec["mt_fused"]
    if len(calls) != 2 * len(FOLIAGE["sizes"]) or any(
            b[12] == 0 for b in calls):
        raise AssertionError(f"foliage: {len(calls)} micromap resolves "
                             "captured")
    for i, b in enumerate(calls):
        r = omap_kernel_entry(b)
        kernel_line(16, "mt_fused_omap", r, gpu_line)
        print(f"  tests {r['tests']}, of them hitting geometrically "
              f"{r['geo_hits']}", flush=True)
        if i == 0:
            kern["mt_fused_omap"] = r
    # B without micromaps on the same rays, and B's micromap mode on them
    # with an all-opaque S = 8 micromap (the same walk as B's) and at the
    # sizes the main path does not use (pack 2 S = 5, pack 1 S = 32)
    opaque8 = packet2.build_packet_aux(
        bvh.bvh8, omap=leaf_align(torch.ones_like(tables[8][0]), bvh.bvh8))
    others = [foliage_tables(bvh, S)[2] for S in FOLIAGE["other_sizes"]]
    rec0, restore = capture(packet2, ("mt_fused",))
    try:
        for aux in (bvh.packet_aux, opaque8, *others):
            packet2.intersect_packets2(bvh.bvh8, aux, rays,
                                       max_leaves=tun.max_leaves,
                                       max_blocks=tun.max_blocks,
                                       retrace=False)
    finally:
        restore()
    b0, b_op, *b_others = rec0["mt_fused"]
    *_, n_sb0 = packet2._mt_fused_plain(*b0)
    tests0 = fused_tests(b0, n_sb0)
    ms_op, *ms_others = omap_pass_times([b_op, *b_others], 20)
    if dev.type == "cuda":
        ms0 = device_ms(lambda: packet2._mt_fused_cuda(*b0), 20)
        occ_txt = "; ".join(
            f"pack {p}: " + occupancy_text(_build.occupancy(
                "tbvh_mt_fused_omap_occupancy", p)) for p in (2, 1))
        others_txt = ", ".join(
            f"S={b[12]} (pack {b[10]}) {ms:.4f} ms"
            for b, ms in zip(b_others, ms_others))
        print(f"phase 16 occupancy: mt_fused_omap {occ_txt}; device time "
              f"mt_fused_omap S=8 {kern['mt_fused_omap']['device_ms']:.4f} "
              f"ms ({kern['mt_fused_omap']['tests']} tests), mt_fused "
              f"without micromaps on the same rays {ms0:.4f} ms ({tests0} "
              f"tests), mt_fused_omap with an all-opaque S=8 micromap on "
              f"them {ms_op:.4f} ms, and at {others_txt} on them (each "
              f"equal to its twin) [{gpu_line}]",
              flush=True)

    foliage_tlas(bvh, bvh.tris.cpu().numpy(), tables[8][0], tables[8][1],
                 gpu_line)
    foliage_spheres(bvh, bvh.tris.cpu().numpy(), gpu_line)
    foliage_voxels(dev, gpu_line)
    print(f"phase 16 foliage64k: {time.perf_counter() - start:.1f} s",
          flush=True)
    return kern, launches


ENGINES_LEAF_TESTS = ("watertight", "baldwin")
EDGE_QUADS = 64


def sync_sites(fn):
    """fn()'s output and the host syncs it made on the card, counted by
    the source line that made each (file:line): the synchronizing CUDA
    calls torch.cuda's sync debug mode reports (none off the card). The
    warnings slow the call: never time it."""
    import collections
    import os
    import warnings

    import torch

    if not torch.cuda.is_available():
        return fn(), collections.Counter()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode(1)
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, collections.Counter(
        f"{os.path.basename(w.filename)}:{w.lineno}" for w in seen
        if "synchroniz" in str(w.message))


def host_syncs(fn):
    """fn()'s output and the number of host syncs it made (sync_sites)."""
    out, sites = sync_sites(fn)
    return out, sum(sites.values())


def device_ops(fn, dev, wall_ms):
    """One call of fn() under torch.profiler with the CUDA activity alone:
    the kernels it launched and the copies and memsets it made, their
    device ms and the device's busy share of wall_ms (an unprofiled
    call's median wall time); "not measured" where the profiler saw no
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if dev.type != "cuda":
        return "device ops not measured (no card)"
    sync(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(dev)
    ev = [e for e in prof.key_averages()
          if str(getattr(e, "device_type", "")).endswith("CUDA")
          and getattr(e, "self_device_time_total", 0) > 0]
    if not ev:
        return "device ops not measured (the profiler saw no device time)"
    copies = sum(e.count for e in ev if e.key.startswith(("Memcpy",
                                                            "Memset")))
    kernels = sum(e.count for e in ev) - copies
    ms = sum(e.self_device_time_total for e in ev) / 1e3
    return (f"kernel launches {kernels}, copies and memsets {copies}, "
            f"device {ms:.2f} ms of {wall_ms:.2f} ms wall (busy "
            f"{ms / wall_ms:.3f}), {1e3 * wall_ms / (kernels + copies):.2f}"
            f" us wall a device op")


def engine_run(fn, dev, stats=None, profiled=True):
    """One path of phase 17: a first call with its peak device memory and
    host syncs, the median wall time of 3 more, then with profiled one
    under the profiler (device_ops). Returns (output, seconds, text);
    stats: the engine's LAST_CALL, read after the first call."""
    out, mem = peak_gib(lambda: host_syncs(fn), dev)
    out, syncs = out
    loops = "" if stats is None else (
        ", ".join(f"{k} {v}" for k, v in stats.items()) + "; ")
    secs = wall_s(fn, dev, warmed=True)
    ops = f"; {device_ops(fn, dev, secs * 1e3)}" if profiled else ""
    return out, secs, (f"{loops}host syncs {syncs}, peak device memory "
                       f"{mem:.3f} GiB{ops}")


def diffuse_rays(bvh, hits, rays, seed=1):
    """bench.py:440-455's diffuse bounce rays: from each primary hit point
    (1 unit along the ray for a miss), offset 1e-3 along the triangle's
    normal turned to face the ray, a direction drawn from a seeded
    torch.Generator and turned into that hemisphere."""
    import torch
    from tinybvh_tpu_torch import make_rays
    from tinybvh_tpu_torch.core.vecmath import cross, normalize

    dev = rays.o.device
    ht = torch.where(torch.isfinite(hits.t) & (hits.t < 1e29), hits.t, 1.0)
    p = rays.o + ht[:, None] * rays.d
    tri = bvh.tris[torch.clamp(hits.prim.long(), min=0)]
    nrm = normalize(cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]))
    nrm = torch.where(((nrm * rays.d).sum(1) > 0)[:, None], -nrm, nrm)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dd = torch.randn(p.shape, generator=gen, device=dev)
    dd = dd / torch.linalg.vector_norm(dd, dim=1, keepdim=True)
    dd = torch.where(((dd * nrm).sum(1) < 0)[:, None], -dd, dd)
    return make_rays(p + nrm * 1e-3, dd)


def quad_edge_case(rng, n=8):
    """tests/test_watertight.py:49-92: a planar quad split along a
    diagonal into two triangles that share the edge (p1, p2), and n rays
    aimed at points of that edge."""
    p2d = np.array(
        [[rng.uniform(-0.5, 1.5), rng.uniform(0.2, 1.5)], [0.0, 0.0],
         [rng.uniform(0.8, 2.0), 0.0],
         [rng.uniform(-0.5, 1.5), -rng.uniform(0.2, 1.5)]], np.float32)
    basis = rng.normal(size=(3, 3)).astype(np.float32)
    basis[0] /= np.linalg.norm(basis[0])
    basis[1] -= basis[1] @ basis[0] * basis[0]
    basis[1] /= np.linalg.norm(basis[1])
    p = p2d @ basis[:2] + rng.uniform(-1, 1, 3).astype(np.float32)
    tris = np.stack([np.stack([p[0], p[1], p[2]]),
                     np.stack([p[1], p[3], p[2]])]).astype(np.float32)
    lam = rng.uniform(0.05, 0.95, n).astype(np.float32)
    target = lam[:, None] * p[1] + (1 - lam[:, None]) * p[2]
    o = rng.uniform(2, 4, (n, 3)).astype(np.float32)
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return tris, o, d.astype(np.float32)


def shared_edge_leaks(dev):
    """The watertight guarantee on the card: EDGE_QUADS quads x 8 edge
    rays through moller_trumbore_watertight (every ray must hit one of
    the two triangles), and 16 of them through the wavefront and BVH2
    engines under tri_test="watertight". Returns (rays, leaks) per
    form."""
    import torch
    from tinybvh_tpu_torch import make_rays
    from tinybvh_tpu_torch.builders.binned import build_binned
    from tinybvh_tpu_torch.config import use_config
    from tinybvh_tpu_torch.core.intersect import moller_trumbore_watertight
    from tinybvh_tpu_torch.layouts.mbvh import collapse_bvh2
    from tinybvh_tpu_torch.traverse.stack import intersect_bvh2, pack_tris
    from tinybvh_tpu_torch.traverse.wavefront import intersect_wavefront

    rng = np.random.default_rng(3)
    cases = [quad_edge_case(rng) for _ in range(EDGE_QUADS)]
    o = np.concatenate([c[1] for c in cases])
    d = np.concatenate([c[2] for c in cases])
    tris = np.stack([c[0] for c in cases])                 # (Q, 2, 3, 3)
    rays = make_rays(o, d, device=dev)
    vert = torch.from_numpy(np.repeat(tris, 8, axis=0)).to(dev)
    far = torch.full((o.shape[0],), 1e30, device=dev)
    hit = [moller_trumbore_watertight(rays.o, rays.d, rays.rd,
                                      vert[:, k, 0], vert[:, k, 1],
                                      vert[:, k, 2], far)[0]
           for k in range(2)]
    out = {"function": (o.shape[0], int((~(hit[0] | hit[1])).sum()))}
    leaks_wf = leaks_b2 = 0
    with use_config(tri_test="watertight"):
        for q in range(16):
            r = make_rays(o[8 * q:8 * q + 8], d[8 * q:8 * q + 8], device=dev)
            bvh2, host = build_binned(tris[q], max_leaf=2, return_host=True,
                                      device=dev)
            h2 = intersect_bvh2(bvh2, pack_tris(bvh2, tris[q]), r,
                                leaf_max=2)
            leaks_b2 += int((h2.prim < 0).sum())
            hw, _ = intersect_wavefront(collapse_bvh2(bvh2, tris[q],
                                                      host=host), r)
            leaks_wf += int((hw.prim < 0).sum())
    out["wavefront"] = (128, leaks_wf)
    out["BVH2 engine"] = (128, leaks_b2)
    for what, (n, leaks) in out.items():
        if leaks:
            raise AssertionError(f"watertight {what}: {leaks} of {n} "
                                 "shared-edge rays leaked")
    return out


def phase_engines(bvh, tris, rays, center, extent, gpu_line,
                  profile_every=False):
    """Phase 17: the BVH2, rayloop and TLAS rayloop engines and the
    watertight and Baldwin–Weber leaf tests at full width (random64k,
    phase 4's 640x640 camera and light), each path with its oracle gates,
    MRays/s (median of 3 after a warm-up), loop counts, host syncs and
    peak device memory; the watertight shared-edge construction on the
    card; intersect_one. The engines are plain torch: the kernel counts
    are read across them (all 0). One call of each engine's first path
    (of every path with profile_every: the profiler's parse of a BVH2
    call's ~50,000 events takes seconds) runs under the profiler."""
    import torch
    from tinybvh_tpu_torch import BVH, make_rays
    from tinybvh_tpu_torch.config import use_config
    from tinybvh_tpu_torch.core.intersect import brute_force_any
    from tinybvh_tpu_torch.tlas import rayloop as tlas_rayloop
    from tinybvh_tpu_torch.tlas.packet import (
        intersect_tlas_packets2_bucketed, tile_candidates,
    )
    from tinybvh_tpu_torch.traverse import rayloop, stack
    from tinybvh_tpu_torch.traverse.wavefront import intersect_wavefront
    from tinybvh_tpu_torch.tuning import get_tuning

    start = time.perf_counter()
    dev = rays.o.device
    R = rays.o.shape[0]
    cutoff = 1.0 - 1e-3
    cap = get_tuning(device=dev).wf_cap_factor
    idx = oracle_subset(R, dev)

    def shadow_gate(occ, srays, tris_dev, what):
        ref = brute_force_any(srays.take(idx), tris_dev, cutoff)
        agree = float((occ[idx] == ref).float().mean())
        if agree < 0.999:
            raise AssertionError(f"{what}: shadow agreement {agree}")
        return (f"occluded {float(occ.float().mean()):.4f}, shadow-agree "
                f"{agree:.5f}")

    def hit_gate(h, r, tris_dev, what):
        agree, ratio = oracle_check(h.take(idx), r.take(idx), tris_dev, what)
        return (f"hit rate {float((h.prim >= 0).float().mean()):.4f}, "
                f"prim-agree {agree:.5f} checksum {ratio:.6f}")

    def line(what, secs, gates, extra, n=R):
        print(f"phase 17 {what} {n / secs / 1e6:.3f} MRays/s, {gates}; "
              f"{extra} [{gpu_line}]", flush=True)

    reset_launches()
    # the rayloop engine through the API: camera, diffuse bounce, shadow.
    # The API re-traces a ray whose stack overflows with the lockstep
    # engine: LAST_CALL counts such rays (the first call's), and the
    # oracle gates them like the rest
    hits, secs, extra = engine_run(
        lambda: bvh.intersect(rays, engine="rayloop"), dev,
        rayloop.LAST_CALL)
    line("engine=rayloop camera", secs,
         hit_gate(hits, rays, bvh.tris, "rayloop camera"), extra)
    _, _, srays = shadow_rays(hits, rays, center, extent)
    drays = diffuse_rays(bvh, hits, rays)
    h, secs, extra = engine_run(
        lambda: bvh.intersect(drays, engine="rayloop"), dev,
        rayloop.LAST_CALL, profile_every)
    line("engine=rayloop diffuse", secs,
         hit_gate(h, drays, bvh.tris, "rayloop diffuse"), extra)
    occ, secs, extra = engine_run(
        lambda: bvh.is_occluded(srays, cutoff, engine="rayloop"), dev,
        rayloop.LAST_CALL, profile_every)
    line("engine=rayloop shadow", secs,
         shadow_gate(occ, srays, bvh.tris, "rayloop shadow"), extra)
    qtab = rayloop.make_rayloop_tables(bvh.bvh8, quantized=True,
                                       host=bvh._bvh8_host)
    (h, sovf), secs, extra = engine_run(
        lambda: rayloop.intersect_rayloop(qtab, rays), dev, rayloop.LAST_CALL,
        profile_every)
    if int(sovf.sum()):   # no re-trace on this path: its hits would be off
        raise AssertionError(f"rayloop quantized: {int(sovf.sum())} rays "
                             "overflowed the stack")
    line("intersect_rayloop quantized camera", secs,
         hit_gate(h, rays, bvh.tris, "rayloop quantized"), extra)

    # the wavefront engine on the same rays (no fallback: the h100 row's
    # cap), then its two other leaf tests
    for test in ("mt",) + ENGINES_LEAF_TESTS:
        with use_config(tri_test=test):
            (h, ovf), secs, extra = engine_run(
                lambda: intersect_wavefront(bvh.bvh8, rays,
                                            cap_factor=cap), dev, None,
                profile_every or test == "mt")
            if ovf:
                raise AssertionError(f"wavefront {test}: frontier overflow "
                                     f"at cap {cap}")
            line(f"wavefront tri_test={test} camera", secs,
                 hit_gate(h, rays, bvh.tris, f"wavefront {test}"), extra)
            (_, occ, ovf), secs, extra = engine_run(
                lambda: intersect_wavefront(bvh.bvh8, srays, cutoff,
                                            cap_factor=cap, any_hit=True),
                dev, None, profile_every)
            if ovf:
                raise AssertionError(f"wavefront {test} shadow: overflow")
            line(f"wavefront tri_test={test} shadow", secs,
                 shadow_gate(occ, srays, bvh.tris, f"wavefront {test}"),
                 extra)

    # the BVH2 engine: layout="bvh2" in every leaf test, and max_leaf=16
    t0 = time.perf_counter()
    b2 = {"layout=bvh2": BVH(tris, layout="bvh2", device=dev),
          "max_leaf=16": BVH(tris, max_leaf=16, device=dev)}
    build_s = time.perf_counter() - t0
    first = True
    for what, b in b2.items():
        if b.bvh8 is not None or b._engine(rays, 1e30, "auto") != "bvh2":
            raise AssertionError(f"{what}: not on the BVH2 path")
        for test in ("mt",) + (ENGINES_LEAF_TESTS if b is b2["layout=bvh2"]
                               else ()):
            with use_config(tri_test=test):
                h, secs, extra = engine_run(lambda: b.intersect(rays), dev,
                                            stack.LAST_CALL,
                                            profile_every or first)
                first = False
                line(f"BVH2 engine {what} (leaves up to {b.leaf_max}) "
                     f"tri_test={test} camera", secs,
                     hit_gate(h, rays, b.tris, f"bvh2 {what} {test}"), extra)
                occ, secs, extra = engine_run(
                    lambda: b.is_occluded(srays, cutoff), dev,
                    stack.LAST_CALL, profile_every)
                line(f"BVH2 engine {what} tri_test={test} shadow", secs,
                     shadow_gate(occ, srays, b.tris, f"bvh2 {what} {test}"),
                     extra)

    # intersect_one against the camera trace's hit for that ray
    i = int(torch.nonzero(hits.prim >= 0)[0])
    one = bvh.intersect_one(rays.o[i].cpu().numpy(), rays.d[i].cpu().numpy())
    if one["prim"] != int(hits.prim[i]) or abs(
            float(one["t"]) - float(hits.t[i])) > 1e-4 * float(hits.t[i]):
        raise AssertionError(f"intersect_one: {one} against prim "
                             f"{int(hits.prim[i])} t {float(hits.t[i])}")
    edges = shared_edge_leaks(dev)

    # the two-level rayloop on phase 12b's inst8, beside the bucketed engine
    tp, _, irays, _, icenter, iextent = instance_scene(bvh, tris, INST8["n"],
                                                       dev)
    Ri = irays.o.shape[0]
    iidx = middle(Ri, ORACLE_RAYS, dev)
    ref, _, _ = tlas_oracle(tp, irays, iidx)
    ttab = tlas_rayloop.make_tlas_rayloop_tables(tp.tlas)
    (h, sovf), secs, extra = engine_run(
        lambda: tlas_rayloop.intersect_tlas_rayloop(ttab, irays), dev,
        tlas_rayloop.LAST_CALL)
    if int(sovf.sum()):
        raise AssertionError(f"tlas rayloop: {int(sovf.sum())} stack "
                             "overflows")
    line("intersect_tlas_rayloop inst8", secs,
         tlas_gates(h.take(iidx), ref, "tlas rayloop"), extra, Ri)
    ht = torch.where(h.prim >= 0, h.t, torch.ones_like(h.t))
    pts = irays.o + ht[:, None] * irays.d
    light = torch.as_tensor((icenter + np.array([0, 2.0, 0]) * iextent)
                            .astype(np.float32), device=dev)
    israys = make_rays(light.expand_as(pts), pts - light)
    (occ, sovf), secs, extra = engine_run(
        lambda: tlas_rayloop.is_occluded_tlas_rayloop(ttab, israys, cutoff),
        dev, tlas_rayloop.LAST_CALL, profile_every)
    sref, _, _ = tlas_oracle(tp, israys, iidx)
    agree = float((occ[iidx] == ((sref.prim >= 0) & (sref.t < cutoff)))
                  .float().mean())
    if int(sovf.sum()) or agree < 0.999:
        raise AssertionError(f"tlas rayloop shadow: {int(sovf.sum())} "
                             f"overflows, lockstep agreement {agree}")
    line("is_occluded_tlas_rayloop inst8", secs,
         f"occluded {float(occ.float().mean()):.4f}, lockstep segment "
         f"agreement {agree:.5f}", extra, Ri)
    sync(dev)
    launches = {k: v for table in launch_tables() for k, v in table.items()
                if v}
    if launches:
        raise AssertionError(f"phase 17's engines launched kernels: "
                             f"{launches}")
    (_, _, n_cand), = tile_candidates(tp, irays, 1)
    kw = {k: v for k, v in INST8.items() if k != "n"}
    kw.update(rounds=max(INST8["rounds"], int(n_cand.max()) + 1),
              wf_cap_factor=cap)
    bucketed = wall_s(lambda: intersect_tlas_packets2_bucketed(
        tp, irays, **kw), dev)
    print(f"phase 17 engines: {R} camera rays on random64k, {Ri} on inst8 "
          f"(bucketed engine {Ri / bucketed / 1e6:.3f} MRays/s beside the "
          f"two-level rayloop); BVH2 builds {build_s:.3f} s; intersect_one "
          f"prim {int(one['prim'])} t {float(one['t']):.6f} equal to the "
          f"camera trace's; shared-edge rays "
          + ", ".join(f"{k} {n} with {leaks} leaks"
                      for k, (n, leaks) in edges.items())
          + f"; no max_rounds raise; launches of the package's kernels 0; "
          f"{time.perf_counter() - start:.1f} s [{gpu_line}]",
          flush=True)


BUILD_SIZES = (65536, 1048576)
# phase 18(d)'s host builders: sizes that keep the phase near 90 s
HOST_SIZES = dict(sweep=16384, sbvh=8192, optimize=16384, leafshape=16384,
                  epo=4096)
OPT = dict(passes=2, batch=16)


def tree_gate(bvh2, tris_dev, rays, what):
    """A BVH2 (on the card) traced by the BVH2 engine on ORACLE_RAYS of
    `rays` against brute force: (prim agreement, checksum ratio)."""
    from tinybvh_tpu_torch.traverse.stack import intersect_bvh2, pack_tris

    idx = oracle_subset(rays.o.shape[0], rays.o.device)
    sub = rays.take(idx)
    h = intersect_bvh2(bvh2, pack_tris(bvh2, tris_dev), sub,
                       leaf_max=max(int(bvh2.count.max()), 1))
    return oracle_check(h, sub, tris_dev, what)


def device_build_line(name, build, tris, dev, rays, gpu_line):
    """Phase 18(a): one device builder on tris: its first call, the median
    of 3 warm calls ending in a synchronize, Mtris/s, host syncs (the
    sync debug mode) by source line, peak device memory and SAH cost,
    one profiled call's launches, device ms and busy share; the native
    host build of the same soup beside it; the tree traced like brute
    force, its prim_idx a permutation."""
    import torch
    from tinybvh_tpu_torch import native
    from tinybvh_tpu_torch.layouts.bvh2 import BVH2, sah_cost

    n = tris.shape[0]
    tris_dev = torch.from_numpy(tris).to(dev)
    sync(dev)
    t0 = time.perf_counter()
    bvh = build(tris_dev)
    sync(dev)
    first = time.perf_counter() - t0
    warm = wall_s(lambda: build(tris_dev), dev, warmed=True)
    ops = device_ops(lambda: build(tris_dev), dev, warm * 1e3)
    bvh, sites = sync_sites(lambda: build(tris_dev))
    syncs = (f"{sum(sites.values())} ("
             + ", ".join(f"{k} x{v}" for k, v in sorted(sites.items()))
             + ")") if sites else "0"
    bvh, mem = peak_gib(lambda: build(tris_dev), dev)
    if not torch.equal(torch.sort(bvh.prim_idx).values,
                       torch.arange(n, dtype=torch.int32, device=dev)):
        raise AssertionError(f"{name} {n}: prim_idx is not a permutation")
    agree, ratio = tree_gate(bvh, tris_dev, rays, f"{name} {n}")
    t0 = time.perf_counter()
    _, host = native.build_binned_native(tris, max_leaf=4, return_host=True)
    native_s = time.perf_counter() - t0
    native_sah = float(sah_cost(BVH2.from_host(host, "cpu")))
    print(f"phase 18 build {name} {n} tris: first {first:.4f} s, warm "
          f"{warm:.4f} s ({n / warm / 1e6:.3f} Mtris/s), host syncs "
          f"{syncs}, peak device memory {mem:.3f} GiB, SAH "
          f"{float(sah_cost(bvh)):.4f}, {bvh.n_nodes} nodes; native host "
          f"build {native_s:.4f} s ({n / native_s / 1e6:.3f} Mtris/s) SAH "
          f"{native_sah:.4f}; oracle prim-agree {agree:.5f} checksum "
          f"{ratio:.6f}, prim_idx a permutation; one profiled call: {ops} "
          f"[{gpu_line}]", flush=True)
    del tris_dev, bvh
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def lbvh_api_line(bvh, tris, rays, center, extent, gpu_line):
    """Phase 18(b): BVH(tris, builder="lbvh") on the card, its build split
    (device build, host copies and uploads, the Python collapse, the
    packet tables), intersect and is_occluded through packet2 and the
    wavefront retrace with the launches of kernels A and B counted
    (reset just before, read just after), the oracle gates, and the SAH
    API (phase 4's) timed beside it. Returns the launch counts."""
    from tinybvh_tpu_torch import BVH
    from tinybvh_tpu_torch.builders import lbvh
    from tinybvh_tpu_torch.layouts import mbvh

    dev = rays.o.device
    R = rays.o.shape[0]
    cutoff = 1.0 - 1e-3
    spent = {"device build": 0.0, "collapse": 0.0}
    real = {"build": lbvh.build_lbvh, "collapse": mbvh.collapse_bvh2}

    def timed(what, fn):
        def f(*a, **kw):
            sync(dev)
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            sync(dev)
            spent[what] += time.perf_counter() - t0
            return out
        return f

    lbvh.build_lbvh = timed("device build", real["build"])
    mbvh.collapse_bvh2 = timed("collapse", real["collapse"])
    try:
        sync(dev)
        t0 = time.perf_counter()
        b = BVH(tris, builder="lbvh", device=dev)
        total = time.perf_counter() - t0
    finally:
        lbvh.build_lbvh, mbvh.collapse_bvh2 = real["build"], real["collapse"]
    t0 = time.perf_counter()
    b.packet_aux
    sync(dev)
    tables = time.perf_counter() - t0
    copies = total - spent["device build"] - spent["collapse"]
    if b.bvh8 is None or b._engine(rays, 1e30, "auto") != "packets":
        raise AssertionError("lbvh API: not on the packet path")

    reset_launches()
    hits, occ, shadow, mem = api_calls(b, rays, center, extent, cutoff)
    launches = read_launches(dev, ("cull", "mt_fused"), "the lbvh API path")
    srays = shadow[2]
    hit_rate, agree, ratio, occ_agree = api_gates(b, rays, hits, srays, occ,
                                                  cutoff, "lbvh api")
    prim_s = wall_s(lambda: b.intersect(rays), dev)
    shadow_s = wall_s(lambda: b.is_occluded(srays, cutoff), dev)
    sah_prim = wall_s(lambda: bvh.intersect(rays), dev)
    sah_shadow = wall_s(lambda: bvh.is_occluded(srays, cutoff), dev)
    print(f"phase 18 api builder=lbvh: {tris.shape[0]} tris, build "
          f"{total:.3f} s (device build {spent['device build']:.4f} s, host "
          f"copies and uploads {copies:.3f} s, Python collapse "
          f"{spent['collapse']:.3f} s; packet tables {tables * 1e3:.3f} ms), "
          f"{b.bvh8.n_nodes} BVH8 rows, {b.bvh8.n_leaves} leaves; {R} "
          f"rays, hit rate {hit_rate:.4f}, primary {R / prim_s / 1e6:.3f} "
          f"MRays/s, shadow {R / shadow_s / 1e6:.3f} MRays/s (the SAH API "
          f"in this run: {R / sah_prim / 1e6:.3f} / "
          f"{R / sah_shadow / 1e6:.3f}); peak device memory {mem[0]:.3f} / "
          f"{mem[1]:.3f} GiB; oracle prim-agree {agree:.5f} checksum "
          f"{ratio:.6f} shadow-agree {occ_agree:.5f}, residual overflow 0, "
          f"launches {launches} [{gpu_line}]", flush=True)
    return launches


def bvh8q_line(bvh, rays, gpu_line):
    """Phase 18(c): the wavefront at the h100 row's cap on random64k's
    BVH8Q against its BVH8: prims equal on every ray; MRays/s, one
    profiled call's device ms, node-table bytes and peak memory each."""
    import torch
    from tinybvh_tpu_torch.layouts.cwbvh import quantize_bvh8
    from tinybvh_tpu_torch.traverse.wavefront import intersect_wavefront
    from tinybvh_tpu_torch.tuning import get_tuning

    dev = rays.o.device
    R = rays.o.shape[0]
    cap = get_tuning(device=dev).wf_cap_factor
    t0 = time.perf_counter()
    q = quantize_bvh8(bvh.bvh8)
    sync(dev)
    quant_s = time.perf_counter() - t0
    out, parts = {}, []
    for name, tab, nbytes_ in (
            ("BVH8", bvh.bvh8, nbytes([bvh.bvh8.bounds])),
            ("BVH8Q", q, nbytes([q.origin, q.scale, q.qbounds]))):
        (h, ovf), mem = peak_gib(lambda: intersect_wavefront(
            tab, rays, cap_factor=cap), dev)
        if ovf:
            raise AssertionError(f"wavefront {name}: overflow at cap {cap}")
        secs = wall_s(lambda: intersect_wavefront(tab, rays, cap_factor=cap),
                      dev, warmed=True)
        ops = device_ops(lambda: intersect_wavefront(tab, rays,
                                                     cap_factor=cap),
                         dev, secs * 1e3)
        out[name] = h
        parts.append(f"{name} {R / secs / 1e6:.3f} MRays/s, node bounds "
                     f"{nbytes_} B, peak device memory {mem:.3f} GiB, {ops}")
    if not torch.equal(out["BVH8"].prim, out["BVH8Q"].prim):
        n_bad = int((out["BVH8"].prim != out["BVH8Q"].prim).sum())
        raise AssertionError(f"BVH8Q wavefront: {n_bad} rays differ")
    print(f"phase 18 wavefront cap {cap} on {R} camera rays: quantize "
          f"{quant_s:.3f} s; " + "; ".join(parts) + "; prims equal on every "
          f"ray, t equal {torch.equal(out['BVH8'].t, out['BVH8Q'].t)} "
          f"[{gpu_line}]", flush=True)


def host_builder_lines(dev, gpu_line):
    """Phase 18(d): the host builders and transforms at HOST_SIZES, each
    tree uploaded and traced on the card against brute force (64x64
    camera rays over the soup, ORACLE_RAYS of them)."""
    import torch
    from tinybvh_tpu_torch import make_rays
    from tinybvh_tpu_torch.builders.binned import build_binned
    from tinybvh_tpu_torch.builders.optimize import (
        epo_cost, optimize_reinsertion,
    )
    from tinybvh_tpu_torch.builders.sbvh import build_sbvh
    from tinybvh_tpu_torch.builders.sweep import build_sweep
    from tinybvh_tpu_torch.io.loaders import random_tris
    from tinybvh_tpu_torch.layouts.bvh2 import sah_cost
    from tinybvh_tpu_torch.layouts.leafshape import combine_leafs, split_leafs

    soups, rays = {}, {}

    def soup(n):
        if n not in soups:
            soups[n] = random_tris(n, seed=0)
            o, d, _, _ = camera_rays(soups[n].reshape(-1, 3).min(0),
                                     soups[n].reshape(-1, 3).max(0), 64, 64)
            rays[n] = make_rays(o, d, device=dev)
        return soups[n], torch.from_numpy(soups[n]).to(dev)

    def run(what, n, fn):
        t0 = time.perf_counter()
        out = fn()
        secs = time.perf_counter() - t0
        if not isinstance(out, float):
            agree, ratio = tree_gate(out, soup(n)[1], rays[n], what)
            out = (f"SAH {float(sah_cost(out)):.4f}, leaves up to "
                   f"{int(out.count.max())}, oracle prim-agree {agree:.5f} "
                   f"checksum {ratio:.6f}")
        else:
            out = f"EPO cost {out:.5f}"
        return f"{what} {n} tris {secs:.3f} s ({out})"

    parts = []
    n = HOST_SIZES["sweep"]
    parts.append(run("build_sweep", n, lambda: build_sweep(
        soup(n)[0], device=dev)))
    n = HOST_SIZES["sbvh"]
    parts.append(run("build_sbvh", n, lambda: build_sbvh(
        soup(n)[0], device=dev)))
    n = HOST_SIZES["optimize"]
    base = build_binned(soup(n)[0], device=dev)
    parts.append(run(f"optimize_reinsertion ({OPT['passes']} passes of "
                     f"{OPT['batch']}; input SAH "
                     f"{float(sah_cost(base)):.4f})", n,
                     lambda: optimize_reinsertion(base, **OPT)))
    n = HOST_SIZES["leafshape"]
    fine = build_binned(soup(n)[0], max_leaf=1, device=dev)
    parts.append(run("combine_leafs(4) of a max_leaf=1 tree", n,
                     lambda: combine_leafs(fine, 4)))
    coarse = build_binned(soup(n)[0], max_leaf=None, c_trav=16.0, device=dev)
    parts.append(run(f"split_leafs(4) of leaves up to "
                     f"{int(coarse.count.max())}", n,
                     lambda: split_leafs(coarse, 4)))
    n = HOST_SIZES["epo"]
    tree = build_binned(soup(n)[0], device=dev)
    parts.append(run("epo_cost", n, lambda: epo_cost(tree, soup(n)[0])))
    print("phase 18 host builders: " + "; ".join(parts) + f" [{gpu_line}]",
          flush=True)


def serialize_line(bvh, tris, gpu_line):
    """Phase 18(e): save_bvh / load_bvh of random64k's BVH2, BVH8, BVH8Q
    and inst8's TLAS8 (a temporary directory), each loaded onto the card
    equal to what was saved."""
    import os
    import tempfile

    import torch
    from tinybvh_tpu_torch.io.serialize import load_bvh, save_bvh
    from tinybvh_tpu_torch.layouts.cwbvh import quantize_bvh8
    from tinybvh_tpu_torch.tlas.instance import build_tlas

    dev = bvh.tris.device
    ex = tris.reshape(-1, 3).max(0) - tris.reshape(-1, 3).min(0)
    mats = np.stack([np.eye(4, dtype=np.float32)] * 8)
    mats[:, :3, 3] = ex * 1.15 * np.array(
        [[i, j, k] for i in range(2) for j in range(2) for k in range(2)],
        np.float32)
    objs = {"BVH2": bvh.bvh2, "BVH8": bvh.bvh8,
            "BVH8Q": quantize_bvh8(bvh.bvh8),
            "TLAS8": build_tlas([bvh.bvh8], mats, host8s=[bvh._bvh8_host],
                                device=dev)}
    parts = []
    with tempfile.TemporaryDirectory() as tmp:
        for name, obj in objs.items():
            path = os.path.join(tmp, f"{name}.npz")
            t0 = time.perf_counter()
            save_bvh(path, obj)
            t1 = time.perf_counter()
            back = load_bvh(path, device=dev)
            sync(dev)
            t2 = time.perf_counter()
            if type(back) is not type(obj):
                raise AssertionError(f"{name}: loaded {type(back)}")
            for k, v in vars(obj).items():
                w = getattr(back, k)
                same = (torch.equal(v, w) and w.device == v.device
                        if isinstance(v, torch.Tensor) else v == w)
                if not same:
                    raise AssertionError(f"{name}.{k} differs after a load")
            parts.append(f"{name} {os.path.getsize(path)} B save "
                         f"{(t1 - t0) * 1e3:.1f} ms load "
                         f"{(t2 - t1) * 1e3:.1f} ms")
    print("phase 18 save / load round trips (equal on the card): "
          + "; ".join(parts) + f" [{gpu_line}]", flush=True)


def phase_builders(bvh, tris, rays, center, extent, gpu_line):
    """Phase 18: the device builders (LBVH, binned SAH) on the card at
    BUILD_SIZES, the API with builder="lbvh" (kernels A and B), the
    wavefront on the quantized BVH8Q, the host builders and transforms,
    and serialization. Returns the lbvh API path's launches of A and
    B."""
    from tinybvh_tpu_torch.builders.binned_device import build_binned_device
    from tinybvh_tpu_torch.builders.lbvh import build_lbvh
    from tinybvh_tpu_torch.io.loaders import random_tris

    start = time.perf_counter()
    dev = rays.o.device
    for n in BUILD_SIZES:
        soup = tris if n == tris.shape[0] else random_tris(n, seed=0)
        for name, build in (("lbvh", build_lbvh),
                            ("binned_device", build_binned_device)):
            device_build_line(name, build, soup, dev, rays, gpu_line)
    launches = lbvh_api_line(bvh, tris, rays, center, extent, gpu_line)
    bvh8q_line(bvh, rays, gpu_line)
    host_builder_lines(dev, gpu_line)
    serialize_line(bvh, tris, gpu_line)
    print(f"phase 18: {time.perf_counter() - start:.1f} s [{gpu_line}]",
          flush=True)
    return launches


MESH_LIGHT = (0.3, 0.8, 0.5)
MESH_TIMEOUT_S = 300.0    # the process groups' and 19b's ranks' limit
MESH_BACKEND = "nccl"     # 19a's one-rank group (19b's two share a card:
                          # gloo, since NCCL takes one rank a card)


def render_oracle(tris, packed, rays, light, shadow_any):
    """render_step_dp's image from brute-force hits and shadows: the same
    Lambert and shadow terms (the normal of packed[prim], as the port and
    JAX take it) over the oracle's prims."""
    import torch
    from tinybvh_tpu_torch.core.intersect import (
        brute_force_any, brute_force_closest,
    )
    from tinybvh_tpu_torch.core.rays import make_rays

    ref = brute_force_closest(rays, tris)
    tri = packed[torch.clamp(ref.prim, min=0).long()]
    e1, e2 = tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]
    n = torch.stack([e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1],
                     e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2],
                     e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]], -1)
    n = n / torch.clamp(torch.sqrt((n * n).sum(-1, keepdim=True)), min=1e-20)
    lt = torch.as_tensor(light, dtype=torch.float32, device=tris.device)
    ndl = (n[:, 0] * lt[0] + n[:, 1] * lt[1] + n[:, 2] * lt[2]).abs()
    p = rays.o + ref.t[:, None] * rays.d
    occ = shadow_any(make_rays(p + n * 1e-3, lt.expand_as(p)))
    return torch.where(ref.prim >= 0, ndl * torch.where(occ, 0.2, 1.0), 0.05)


def mesh_gate(hits, rays, tris, what):
    """The smoke's oracle gates on ORACLE_RAYS rays; returns their text."""
    idx = oracle_subset(rays.o.shape[0], rays.o.device)
    agree, ratio = oracle_check(hits.take(idx), rays.take(idx), tris, what)
    return f"prim-agree {agree:.5f} checksum {ratio:.6f}"


def image_gate_render(img, tris, packed, rays, what):
    """render_step_dp's image against render_oracle on ORACLE_RAYS rays:
    0.999 of the pixels within 1e-4."""
    from tinybvh_tpu_torch.core.intersect import brute_force_any

    idx = oracle_subset(rays.o.shape[0], rays.o.device)
    ref = render_oracle(tris, packed, rays.take(idx), MESH_LIGHT,
                        lambda r: brute_force_any(r, tris, 1e4))
    got = img[idx, 0]
    frac = float(((got - ref).abs() <= 1e-4).float().mean())
    if frac < 0.999 or not bool((img[:, 0] == img[:, 1]).all()):
        raise AssertionError(f"{what}: {frac} of the oracle's pixels within "
                             "1e-4")
    return f"pixels within 1e-4 of the oracle {frac:.5f}"


def timed(fn, dev):
    """fn()'s output, its first call's peak device memory (GiB) and the
    median wall seconds of 2 more calls."""
    out, mem = peak_gib(fn, dev)
    return out, mem, wall_s(fn, dev, reps=2, warmed=True)


@contextlib.contextmanager
def collective_clock():
    """Times the mesh layer's collectives from outside while open: swaps
    parallel/mesh.py's _all_gather for one that syncs the card before
    and after each collective and adds its host milliseconds (a gloo
    group's host copies included) to the returned dict's "ms". The layer
    itself does not sync."""
    from tinybvh_tpu_torch.parallel import mesh as pm

    inner = pm._all_gather
    clock = {"ms": 0.0}

    def timed_gather(mesh, group, x):
        sync(x.device)
        t0 = time.perf_counter()
        out = inner(mesh, group, x)
        sync(out.device)
        clock["ms"] += (time.perf_counter() - t0) * 1e3
        return out

    pm._all_gather = timed_gather
    try:
        yield clock
    finally:
        pm._all_gather = inner


def mesh_calls(mesh, bvh, tris, rays, dev, n_scene):
    """Phase 19's calls on one mesh rank: the sharded BVH2 and packet2
    traces over n_scene shards of random64k (and with one shard, the
    render step), each gated by the oracle; returns the text."""
    from tinybvh_tpu_torch.parallel import mesh as pm
    from tinybvh_tpu_torch.tuning import get_tuning

    tun = get_tuning(device=dev)
    kw = dict(max_leaves=tun.max_leaves, max_blocks=tun.max_blocks,
              wf_cap_factor=tun.wf_cap_factor)
    R = rays.o.shape[0]
    text = []
    t0 = time.perf_counter()
    b8s, auxes, gids8 = pm.shard_scene_packets(tris, n_scene, device=dev)
    bvhs, packed, gids = pm.shard_scene(tris, n_scene, device=dev)
    sync(dev)
    text.append(f"shard builds {time.perf_counter() - t0:.2f} s")
    mesh.stats.update(collectives=0)
    with collective_clock() as clock:
        h, mem, secs = timed(lambda: pm.trace_packets_sharded(
            mesh, b8s, auxes, gids8, rays, **kw), dev)
        text.append(f"trace_packets_sharded {secs * 1e3:.1f} ms "
                    f"({R / secs / 1e6:.3f} MRays/s, peak {mem:.3f} GiB; "
                    f"{mesh_gate(h, rays, bvh.tris, 'trace_packets_sharded')})")
        h, mem, secs = timed(lambda: pm.trace_sharded(
            mesh, bvhs, packed, gids, rays), dev)
        text.append(f"trace_sharded {secs * 1e3:.1f} ms "
                    f"({R / secs / 1e6:.3f} MRays/s, peak {mem:.3f} GiB; "
                    f"{mesh_gate(h, rays, bvh.tris, 'trace_sharded')})")
        if n_scene == 1:
            bvh2 = pm._shard(bvhs, 0, dev)
            img, mem, secs = timed(lambda: pm.render_step_dp(
                mesh, bvh2, packed[0], rays, MESH_LIGHT), dev)
            gate = image_gate_render(img, bvh.tris, packed[0], rays,
                                     "render_step_dp")
            text.append(f"render_step_dp {secs * 1e3:.1f} ms (peak "
                        f"{mem:.3f} GiB; {gate})")
    text.append(f"collectives {mesh.stats['collectives']} in "
                f"{clock['ms']:.1f} ms")
    return "; ".join(text)


def phase_mesh(bvh, tris, rays, gpu_line):
    """Phase 19a: a one-rank NCCL process group, mesh 1 x 1:
    trace_packets_dp equal to intersect_packets2 on the same rays, its
    launches of A and B, then the sharded traces and the render step
    gated by the oracle. Returns the launches and the dp hits on the
    host."""
    import tempfile
    from datetime import timedelta

    import torch
    import torch.distributed as dist
    from tinybvh_tpu_torch.parallel import mesh as pm
    from tinybvh_tpu_torch.traverse.packet2 import intersect_packets2
    from tinybvh_tpu_torch.tuning import get_tuning

    dev = rays.o.device
    tun = get_tuning(device=dev)
    kw = dict(max_leaves=tun.max_leaves, max_blocks=tun.max_blocks,
              wf_cap_factor=tun.wf_cap_factor)
    start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            MESH_BACKEND, store=dist.FileStore(f"{tmp}/store", 1), rank=0,
            world_size=1, timeout=timedelta(seconds=MESH_TIMEOUT_S))
        try:
            mesh = pm.make_mesh(1, 1, device=dev)
            reset_launches()
            h, mem = peak_gib(lambda: pm.trace_packets_dp(
                mesh, bvh.bvh8, bvh.packet_aux, rays, **kw), dev)
            launches = read_launches(dev, ("cull", "mt_fused"),
                                     "phase 19a trace_packets_dp")
            ref, _ = intersect_packets2(bvh.bvh8, bvh.packet_aux, rays,
                                        retrace=True, **kw)
            for k in ("prim", "t", "u", "v"):
                if not torch.equal(getattr(h, k), getattr(ref, k)):
                    raise AssertionError(f"phase 19a: trace_packets_dp's {k}"
                                         " differs from intersect_packets2's")
            secs = wall_s(lambda: pm.trace_packets_dp(
                mesh, bvh.bvh8, bvh.packet_aux, rays, **kw), dev,
                reps=2, warmed=True)
            R = rays.o.shape[0]
            print(f"phase 19a mesh 1x1 ({MESH_BACKEND}): trace_packets_dp {R} rays {secs * 1e3:.1f} ms "
                  f"({R / secs / 1e6:.3f} MRays/s, peak {mem:.3f} GiB), equal"
                  f" to intersect_packets2 (prim, t, u, v), "
                  f"{mesh_gate(h, rays, bvh.tris, 'trace_packets_dp')}, "
                  f"launches {launches}; "
                  f"{mesh_calls(mesh, bvh, tris, rays, dev, 1)}; "
                  f"{time.perf_counter() - start:.1f} s [{gpu_line}]",
                  flush=True)
        finally:
            dist.destroy_process_group()
    return launches, {k: getattr(h, k).cpu() for k in ("prim", "t", "u", "v")}


def mesh_rank(n_tris, W, device):
    """Phase 19b on one of two gloo ranks sharing the card: phase 4's
    scene (random_tris(n_tris)) and W x W camera rays, then mesh 1 x 2 (two
    scene shards) and mesh 2 x 1 (trace_packets_dp over two ray blocks).
    Prints its line; rank 0 returns its trace_packets_dp hits. device:
    the card's (both ranks share it)."""
    import torch
    import torch.distributed as dist
    from tinybvh_tpu_torch.io.loaders import random_tris
    from tinybvh_tpu_torch.parallel import mesh as pm
    from tinybvh_tpu_torch.tuning import get_tuning

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = dist.get_rank()
    dev = torch.device(device)
    start = time.perf_counter()
    tris = random_tris(n_tris, seed=0)
    bvh, rays, _, _, _ = setup_scene(tris, dev, W)
    tun = get_tuning(device=dev)
    kw = dict(max_leaves=tun.max_leaves, max_blocks=tun.max_blocks,
              wf_cap_factor=tun.wf_cap_factor)
    m12 = pm.make_mesh(1, 2, device=dev)
    m21 = pm.make_mesh(2, 1, device=dev)
    text = mesh_calls(m12, bvh, tris, rays, dev, 2)
    m21.stats.update(collectives=0)
    with collective_clock() as clock:
        h, mem, secs = timed(lambda: pm.trace_packets_dp(
            m21, bvh.bvh8, bvh.packet_aux, rays, **kw), dev)
    R = rays.o.shape[0]
    print(f"phase 19b rank {rank} of 2 (gloo, one card): mesh 1x2: {text}; "
          f"mesh 2x1: trace_packets_dp {secs * 1e3:.1f} ms "
          f"({R / secs / 1e6:.3f} MRays/s, peak {mem:.3f} GiB), "
          f"collectives {m21.stats['collectives']} in "
          f"{clock['ms']:.1f} ms; "
          f"{time.perf_counter() - start:.1f} s", flush=True)
    return {k: getattr(h, k) for k in ("prim", "t", "u", "v")}


def phase_mesh_ranks(dp_hits, tris, dev, W, gpu_line):
    """Phase 19b: two gloo ranks on the one card (NCCL takes one rank a
    card), spawned by run_local; rank 0's trace_packets_dp must equal
    phase 19a's single-rank result. A failed rank raises."""
    import torch
    from tinybvh_tpu_torch.parallel.launch import run_local

    t0 = time.perf_counter()
    got = run_local(2, mesh_rank, tris.shape[0], W, str(dev), backend="gloo",
                    timeout_s=MESH_TIMEOUT_S)
    for k in ("prim", "t", "u", "v"):
        if not torch.equal(got[k], dp_hits[k]):
            raise AssertionError(f"phase 19b: the 2x1 trace_packets_dp's {k}"
                                 " differs from phase 19a's")
    print(f"phase 19b: 2 ranks in {time.perf_counter() - t0:.1f} s, mesh "
          f"2x1 trace_packets_dp equal to phase 19a's (prim, t, u, v) "
          f"[{gpu_line}]", flush=True)


F64_OFFSET = 1e9       # f32 rounds to 64 m steps there
F64_TLAS_W = 512


def brute_f64(o, d, tris, t_max=1e300, any_hit=False, chunk=2048):
    """O(R*N) in float64 with the reference's double test (|det| < 1e-12
    rejected, 1e-12 < t < t_max), chunked over triangles: (t, prim) of
    the least t (the first triangle on a tie), or with any_hit (R,)
    bool."""
    import torch

    R = o.shape[0]
    best = torch.full((R,), t_max, dtype=torch.float64, device=o.device)
    prim = torch.full((R,), -1, dtype=torch.int64, device=o.device)
    occ = torch.zeros(R, dtype=torch.bool, device=o.device)

    def dot(a, b):
        return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]

    def cross(a, b):
        return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]],
                           -1)

    oo, dd = o[:, None], d[:, None]
    for base in range(0, tris.shape[0], chunk):
        tc = tris[base:base + chunk]
        v0 = tc[None, :, 0]
        e1, e2 = tc[None, :, 1] - v0, tc[None, :, 2] - v0
        h = cross(dd, e2)
        det = dot(e1, h)
        inv = 1.0 / det
        sv = oo - v0
        uu = dot(sv, h) * inv
        q = cross(sv, e1)
        vv = dot(dd, q) * inv
        tt = dot(e2, q) * inv
        ok = (~(det.abs() < 1e-12) & ~((uu < 0) | (uu > 1))
              & ~((vv < 0) | (uu + vv > 1)) & (tt > 1e-12)
              & (tt < best[:, None]))
        if any_hit:
            occ |= ok.any(dim=1)
            continue
        bt, bi = torch.where(ok, tt, torch.inf).min(dim=1)
        better = bt < best
        best = torch.where(better, bt, best)
        prim = torch.where(better, bi + base, prim)
    return occ if any_hit else (best, prim)


def f64_gates(res, o, d, tris, what, t_rel=None, t_abs=None,
              n_per_inst=None):
    """res (a BVHDouble / TLASDouble result) against brute_f64 on
    ORACLE_RAYS rays: with t_rel, prims equal on every ray and t within
    t_rel relative; with t_abs (a TLAS over world-space triangles, whose
    ids are inst * n_per_inst + prim), prim and inst agreement >= 0.999
    and t within t_abs where both agree. Returns the text."""
    import torch

    idx = oracle_subset(o.shape[0], o.device)
    bt, bp = brute_f64(o[idx], d[idx], tris)
    t, prim = res["t"][idx], res["prim"][idx]
    if t_rel is not None:
        same = bool(torch.equal(prim, bp))
        hit = bp >= 0
        rel = float(((t - bt).abs() / bt.abs())[hit].max()) if bool(
            hit.any()) else 0.0
        if not same or rel > t_rel:
            raise AssertionError(f"{what}: prims equal {same}, t max rel "
                                 f"{rel}")
        return (f"prims equal on {idx.numel()} rays, t max rel {rel:.3e}, "
                f"hit rate {float(hit.float().mean()):.4f}")
    inst = torch.where(bp >= 0, bp // n_per_inst, -1)
    pr = torch.where(bp >= 0, bp % n_per_inst, -1)
    pa = float((prim == pr).float().mean())
    ia = float((res["inst"][idx] == inst).float().mean())
    both = (prim == pr) & (bp >= 0)
    dt = float((t - bt).abs()[both].max()) if bool(both.any()) else 0.0
    if pa < 0.999 or ia < 0.999 or dt > t_abs:
        raise AssertionError(f"{what}: prim-agree {pa} inst-agree {ia} t max "
                             f"abs {dt}")
    return (f"prim-agree {pa:.5f} inst-agree {ia:.5f} t max abs {dt:.3e}, "
            f"hit rate {float((bp >= 0).float().mean()):.4f}")


def f64_run(obj, fn, dev, profiled=False):
    """fn()'s output, with its first call's peak memory and host syncs
    (the engine's count and torch.cuda's sync debug mode's), the wall of
    one more call and, with profiled, one call under the profiler;
    returns (out, secs, text)."""
    out, mem = peak_gib(lambda: host_syncs(fn), dev)
    out, syncs = out
    stats = dict(obj.last_call)
    secs = wall_s(fn, dev, reps=1, warmed=True)
    ops = f"; {device_ops(fn, dev, secs * 1e3)}" if profiled else ""
    return out, secs, (f"steps {stats['steps']}, compactions "
                       f"{stats['compactions']}, host syncs {stats['syncs']}"
                       f" (debug mode {syncs}), peak {mem:.3f} GiB{ops}")


def phase_f64(tris32, dev, gpu_line, W=640):
    """Phase 20: BVHDouble of random64k in f64 shifted by F64_OFFSET on
    every axis (the host build timed), intersect and is_occluded on the
    card with W x W camera rays at the offset, gated by brute_f64; the
    f32 answer on the same shifted scene beside it; then TLASDouble of
    inst8's 2 x 2 x 2 grid of that BLAS at F64_TLAS_W^2 rays."""
    import torch
    from tinybvh_tpu_torch.core.intersect import brute_force_closest
    from tinybvh_tpu_torch.core.rays import make_rays
    from tinybvh_tpu_torch.ops.f64 import BLASInstanceEx, BVHDouble, TLASDouble

    start = time.perf_counter()
    off = F64_OFFSET
    tris = tris32.astype(np.float64) + off
    t0 = time.perf_counter()
    b = BVHDouble(tris, device=dev)
    sync(dev)
    build_s = time.perf_counter() - t0
    lo = tris32.reshape(-1, 3).min(0)
    hi = tris32.reshape(-1, 3).max(0)
    o, d, center, extent = camera_rays(lo, hi, W, W)
    o = torch.as_tensor(o, dtype=torch.float64, device=dev) + off
    d = torch.as_tensor(d, dtype=torch.float64, device=dev)
    tris_dev = torch.as_tensor(tris, device=dev)
    R = o.shape[0]
    res, secs, text = f64_run(b, lambda: b.intersect(o, d), dev,
                              profiled=True)
    t0 = time.perf_counter()
    gate = f64_gates(res, o, d, tris_dev, "phase 20 BVHDouble.intersect",
                     t_rel=1e-12)
    gates_s = time.perf_counter() - t0
    # shadow segments from a light above to the hit points (misses: the
    # far image plane), cutoff 0.999 as in phase 4
    ht = torch.where(res["prim"] >= 0, res["t"], torch.ones_like(res["t"]))
    pts = o + ht[:, None] * d
    light = torch.as_tensor(center + np.array([0, 2.0, 0]) * extent,
                            device=dev) + off
    sd = pts - light
    so = light.expand_as(pts)
    occ, ssecs, stext = f64_run(b, lambda: b.is_occluded(so, sd, 0.999), dev)
    t0 = time.perf_counter()
    idx = oracle_subset(R, dev)
    occ_ref = brute_f64(so[idx], sd[idx], tris_dev, 0.999, any_hit=True)
    occ_agree = float((occ[idx] == occ_ref).float().mean())
    gates_s += time.perf_counter() - t0
    if occ_agree < 0.999:
        raise AssertionError(f"phase 20 BVHDouble.is_occluded: agreement "
                             f"{occ_agree}")
    # the f32 answer: the shifted scene and rays rounded to f32 (every
    # vertex rounds to one point), the exact f32 closest hit over it
    r32 = make_rays(o[idx].float(), d[idx].float(), device=dev)
    h32 = brute_force_closest(r32, tris_dev.float())
    f32_agree = float((h32.prim.long() == res["prim"][idx]).float().mean())
    print(f"phase 20 f64 BVHDouble: {tris.shape[0]} tris at +{off:.0e}, host"
          f" build {build_s:.2f} s (depth {b.depth}); intersect {R} rays "
          f"{secs * 1e3:.1f} ms ({R / secs / 1e6:.3f} MRays/s; {text}), "
          f"{gate}; is_occluded {ssecs * 1e3:.1f} ms "
          f"({R / ssecs / 1e6:.3f} MRays/s, occluded "
          f"{float(occ.float().mean()):.4f}; {stext}), oracle agreement "
          f"{occ_agree:.5f}; f32 prim agreement on the same shifted scene "
          f"{f32_agree:.4f} (brute force in f32, not a gate); oracles "
          f"{gates_s:.1f} s [{gpu_line}]", flush=True)

    ex = hi - lo
    insts, mats = [], []
    for i in range(2):
        for j in range(2):
            for k in range(2):
                m = np.eye(4)
                m[:3, 3] = ex.astype(np.float64) * 1.15 * np.array([i, j, k])
                mats.append(m)
                insts.append(BLASInstanceEx(0, m))
    t0 = time.perf_counter()
    tl = TLASDouble(insts, [b], device=dev)
    sync(dev)
    tlas_s = time.perf_counter() - t0
    whi = lo + ex * np.array([1.15 + 1, 1.15 + 1, 1.15 + 1])
    o2, d2, _, _ = camera_rays(lo, whi, F64_TLAS_W, F64_TLAS_W)
    o2 = torch.as_tensor(o2, dtype=torch.float64, device=dev) + off
    d2 = torch.as_tensor(d2, dtype=torch.float64, device=dev)
    res2, secs2, text2 = f64_run(tl, lambda: tl.intersect(o2, d2), dev)
    world = torch.cat([tris_dev + torch.as_tensor(m[:3, 3], device=dev)
                       for m in mats])
    t0 = time.perf_counter()
    gate2 = f64_gates(res2, o2, d2, world, "phase 20 TLASDouble.intersect",
                      t_abs=1e-6, n_per_inst=tris.shape[0])
    gates_s = time.perf_counter() - t0
    R2 = o2.shape[0]
    print(f"phase 20 f64 TLASDouble: inst8 (8 instances of the BLAS) at "
          f"+{off:.0e}, TLAS build {tlas_s:.3f} s; intersect {R2} rays "
          f"{secs2 * 1e3:.1f} ms ({R2 / secs2 / 1e6:.3f} MRays/s; {text2}), "
          f"{gate2} (oracle {gates_s:.1f} s); phase 20 "
          f"{time.perf_counter() - start:.1f} s [{gpu_line}]", flush=True)


OCC6 = {"C": ("tbvh_mt_gathered_occupancy",),
        "G": ("tbvh_cull_blocks_occupancy",)}
OCC11 = {"D-v2": ("tbvh_leaf_resolve_v2_occupancy", 0),
         "D-v3": ("tbvh_leaf_resolve_v2_occupancy", 1),
         "E": ("tbvh_leaf_resolve_occupancy",),
         "F": ("tbvh_frustum_walk_occupancy",)}


def print_occupancy(phase, entries, gpu_line):
    """One line of the registers, shared memory and resident CTAs per SM
    of kernels as the package launches them: name -> (C entry, *args)."""
    from tinybvh_tpu_torch import _build

    print(f"phase {phase} occupancy: " + "; ".join(
        f"{name}: {occupancy_text(_build.occupancy(*entry))}"
        for name, entry in entries.items()) + f" [{gpu_line}]", flush=True)


def main(argv=()):
    import torch

    resolves_only = "--resolves" in argv
    render_only = "--render" in argv
    foliage_only = "--foliage" in argv
    probes_only = "--probes" in argv
    engines_only = "--engines" in argv
    builders_only = "--builders" in argv
    mesh_only = "--mesh" in argv
    f64_only = "--f64" in argv

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
    if f64_only:
        phase_f64(tris, dev, gpu_line)
        return 0
    if render_only:
        phase_render(tris, dev, gpu_line)
        phase_scene16(tris, dev, gpu_line)
        return 0
    scene = setup_scene(tris, dev, 640)
    bvh, rays, _, extent, _ = scene
    if foliage_only:
        phase_foliage(bvh, rays, scene[2], extent, gpu_line)
        return 0
    if probes_only:
        phase_probes(bvh, gpu_line)
        return 0
    if engines_only:
        phase_engines(bvh, tris, rays, scene[2], extent, gpu_line,
                      profile_every=True)
        return 0
    if builders_only:
        phase_builders(bvh, tris, rays, scene[2], extent, gpu_line)
        return 0
    if mesh_only:
        _, dp_hits = phase_mesh(bvh, tris, rays, gpu_line)
        phase_mesh_ranks(dp_hits, tris, dev, 640, gpu_line)
        return 0
    if resolves_only:
        # phases 6 and 11 alone, on the API cull's descriptors
        from tinybvh_tpu_torch.traverse import packet2

        rec, restore = capture(packet2, ("cull",))
        try:
            bvh.intersect(rays)
        finally:
            restore()
        phase_kernels_cg(bvh, rays, rec["cull"][0], gpu_line)
        print_occupancy(6, OCC6, gpu_line)
        phase_v1(bvh, rays, scene[2], extent, gpu_line)
        print_occupancy(11, OCC11, gpu_line)
        grid_kernel_g(tris, dev, gpu_line)
        return 0
    kern, cull_args, mt_args = phase_kernels(bvh, rays, gpu_line)
    phase_occupancy(cull_args, mt_args, gpu_line)
    launches, shadow = phase_api(*scene, gpu_line)
    phase_grid(grid_scene(tris, 4, 4), dev, 640, gpu_line)
    kern.update(phase_kernels_cg(bvh, rays, cull_args, gpu_line))
    print_occupancy(6, OCC6, gpu_line)
    launches.update(cull_blocks=phase_cull_stage(
        bvh, cull_args, gpu_line)["cull_blocks"])
    launches.update(mt_gathered=phase_unfused(bvh, rays,
                                              gpu_line)["mt_gathered"])
    phase_retrace(bvh, rays, shadow, gpu_line)
    phase_off_packets(bvh, rays, extent, gpu_line)
    v1_kern, v1_launches = phase_v1(bvh, rays, scene[2], extent, gpu_line)
    print_occupancy(11, OCC11, gpu_line)
    kern.update(v1_kern)
    launches.update(v1_launches)
    tlas_launches = phase_inst512(bvh, tris, gpu_line)
    phase_inst8(bvh, tris, gpu_line)
    phase_refit(bvh, tris, rays, gpu_line)
    probe_kern, probe_launches = phase_probes(bvh, gpu_line)
    kern.update(probe_kern)
    launches.update(probe_launches)
    t0 = time.perf_counter()
    render_launches = phase_render(tris, dev, gpu_line)
    t_render = time.perf_counter() - t0
    t0 = time.perf_counter()
    scene_launches = phase_scene16(tris, dev, gpu_line)
    print(f"phases 15 / 15b: {t_render:.1f} s / "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    omap_kern, omap_launches = phase_foliage(bvh, rays, scene[2], extent,
                                             gpu_line)
    kern.update(omap_kern)
    launches.update(mt_fused_omap=omap_launches["mt_fused_omap"])
    phase_engines(bvh, tris, rays, scene[2], extent, gpu_line)
    lbvh_launches = phase_builders(bvh, tris, rays, scene[2], extent,
                                   gpu_line)
    t0 = time.perf_counter()
    mesh_launches, dp_hits = phase_mesh(bvh, tris, rays, gpu_line)
    phase_mesh_ranks(dp_hits, tris, dev, 640, gpu_line)
    t_mesh = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_f64(tris, dev, gpu_line)
    print(f"phases 19 / 20: {t_mesh:.1f} s / {time.perf_counter() - t0:.1f} s",
          flush=True)

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
         **{k: table[name] for k, table in (
             ("tlas_launches", tlas_launches),
             ("render_launches", render_launches),
             ("scene_launches", scene_launches),
             ("foliage_launches", omap_launches),
             ("lbvh_launches", lbvh_launches),
             ("mesh_launches", mesh_launches)) if name in table}}
        for name in SOURCES]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
