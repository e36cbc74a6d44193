#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port's main path once on one GPU.

    python3 chip_smoke.py

Phases (each prints one line; any failure raises and exits non-zero):
  1. device: needs torch.cuda; prints the card's name and power limit;
  2. build: the CUDA kernels (csrc/*.cu, nvcc) and the native host
     builder (tinybvh_tpu/native/builder.c, cc), from the checkout;
  3. kernels against their plain PyTorch twins on the card, at the
     shapes of the main path: random_tris(65536, seed=0), 640x640
     camera rays in 16x16 tile order;
  4. main path through the API: BVH(tris, device="cuda").intersect(rays)
     and .is_occluded() for shadow segments from a point light to the
     hit points; launch counts, zero residual overflow, and agreement
     with the brute-force oracle on a 2048-ray subset (prim agreement
     >= 0.999, hit-t checksum within 1%, as tiny_bvh_speedtest.cpp's
     ValidateTraceResult gate);
  5. real size: the 4x4 grid of that scene (1,048,576 triangles), one
     primary trace through intersect_packets2 with the grid16 budgets;
then a JSON line of the kernels, and as the last line
{"ok": true, "device": {...}}.

Precision: TF32 stays off (torch.backends.cuda.matmul.allow_tf32 and
torch.backends.cudnn.allow_tf32 False); the kernels use no tensor cores.
Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

CULL_REPLACES = "tinybvh_tpu/traverse/packet2.py:488"
MT_REPLACES = "tinybvh_tpu/traverse/packet2.py:858"
ORACLE_RAYS = 2048


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
    card, the host clock elsewhere."""
    import torch

    fn()
    if dev.type == "cuda":
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(n):
            fn()
        t1.record()
        torch.cuda.synchronize(dev)
        return t0.elapsed_time(t1) / n
    s = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - s) * 1e3 / n


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


def phase_kernels(bvh, rays, gpu_line, n_kernel=20, n_plain=3):
    """Kernel A and B against their plain twins on the arguments the API
    path hands them (first cull pass and its MT resolve)."""
    import torch
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
    k_g, c_g = kern(*a)
    k_p, c_p = packet2._cull_plain(*a)
    if not torch.equal(c_g, c_p):
        raise AssertionError("cull: survivor counts differ from the plain "
                             "twin")
    # survivor SETS per tile (order inside a tile is free)
    s_g = torch.sort(k_g, dim=1).values.long()
    s_p = torch.sort(k_p, dim=1).values.long()
    if not torch.equal(s_g, s_p):
        raise AssertionError("cull: survivor sets differ from the plain twin")
    out["cull"] = dict(max_abs_err=int((s_g - s_p).abs().max()),
                       ms=time_ms(lambda: kern(*a), dev, n_kernel),
                       plain_ms=time_ms(lambda: packet2._cull_plain(*a), dev,
                                        n_plain),
                       shape=f"G={a[1].shape[0]} max_blocks={a[1].shape[1]}"
                             f" k_cap={a[6]}")

    b = rec["mt_fused"][0]
    kern = packet2._mt_fused_cuda if on_gpu else packet2._mt_fused_plain
    got = kern(*b)
    ref = packet2._mt_fused_plain(*b)
    if not torch.equal(got[4], ref[4]):
        raise AssertionError("mt_fused: prim differs from the plain twin")
    errs = [float((got[i] - ref[i]).abs().max()) for i in (0, 2, 3)]
    for i, tol in ((0, 1e-4), (2, 1e-3), (3, 1e-3)):
        if not torch.allclose(got[i], ref[i], rtol=tol, atol=tol):
            raise AssertionError(f"mt_fused: output {i} outside {tol}")
    out["mt_fused"] = dict(max_abs_err=max(errs),
                           ms=time_ms(lambda: kern(*b), dev, n_kernel),
                           plain_ms=time_ms(
                               lambda: packet2._mt_fused_plain(*b), dev,
                               n_plain),
                           shape=f"T={b[0].shape[0]} k_cap={b[7]} "
                                 f"tri_blk={b[8]} rps={b[9]}")
    for name, r in out.items():
        print(f"phase 3 kernel {name}: {r['shape']} max_abs_err "
              f"{r['max_abs_err']} kernel {r['ms']:.4f} ms plain "
              f"{r['plain_ms']:.4f} ms [{gpu_line}]", flush=True)
    return out


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


def phase_api(bvh, rays, center, extent, build_s, gpu_line):
    """The main path through the public API; returns the launch counts of
    exactly this run."""
    import torch
    from tinybvh_tpu_torch import make_rays
    from tinybvh_tpu_torch.core.intersect import brute_force_any
    from tinybvh_tpu_torch.traverse import packet2

    dev = rays.o.device
    R = rays.o.shape[0]

    for k in packet2.LAUNCHES:
        packet2.LAUNCHES[k] = 0
    hits = bvh.intersect(rays)
    ht = torch.where(hits.prim >= 0, hits.t, torch.ones_like(hits.t))
    pts = rays.o + ht[:, None] * rays.d
    light = torch.as_tensor(
        (center + np.array([0, 2.0, 0]) * extent).astype(np.float32),
        device=dev)
    cutoff = 1.0 - 1e-3
    srays = make_rays(light.expand_as(pts), pts - light)
    occ = bvh.is_occluded(srays, cutoff)
    sync(dev)
    launches = dict(packet2.LAUNCHES)
    if dev.type == "cuda" and min(launches.values()) == 0:
        raise AssertionError(f"main path skipped a kernel: {launches}")

    hit_rate = float((hits.prim >= 0).float().mean())
    if not 0.0 < hit_rate < 1.0:
        raise AssertionError(f"hit rate {hit_rate}")
    idx = oracle_subset(R, dev)
    agree, ratio = oracle_check(hits.take(idx), rays.take(idx), bvh.tris,
                                "primary")
    occ_ref = brute_force_any(srays.take(idx), bvh.tris, cutoff)
    occ_agree = float((occ[idx] == occ_ref).float().mean())
    if occ_agree < 0.999:
        raise AssertionError(f"shadow: oracle agreement {occ_agree}")

    prim_s = wall_s(lambda: bvh.intersect(rays), dev)
    shadow_s = wall_s(lambda: bvh.is_occluded(srays, cutoff), dev)
    print(f"phase 4 api: {bvh.tris.shape[0]} tris, {R} rays, build {build_s:.3f}"
          f" s, hit rate {hit_rate:.4f}, primary {R / prim_s / 1e6:.3f} "
          f"MRays/s, shadow {R / shadow_s / 1e6:.3f} MRays/s (occluded "
          f"{float(occ.float().mean()):.4f}), oracle prim-agree {agree:.5f}"
          f" checksum {ratio:.6f} shadow-agree {occ_agree:.5f}, residual "
          f"overflow 0, launches {launches} [{gpu_line}]", flush=True)
    return launches


def phase_grid(tris, dev, W, gpu_line):
    """bench.py's grid16 section: one primary trace at its budgets."""
    import torch
    from tinybvh_tpu_torch.traverse import packet2

    bvh, rays, _, _, build_s = setup_scene(tris, dev, W)
    aux = bvh.packet_aux
    R = rays.o.shape[0]

    def primary():
        return packet2.intersect_packets2(
            bvh.bvh8, aux, rays, max_leaves=2560, max_blocks=256,
            retrace="packet", retrace_ml=8192, retrace_blocks=256,
            tri_blk=128)

    for k in packet2.LAUNCHES:
        packet2.LAUNCHES[k] = 0
    hits, ovf = primary()
    sync(dev)
    launches = dict(packet2.LAUNCHES)
    if dev.type == "cuda" and min(launches.values()) == 0:
        raise AssertionError(f"grid trace skipped a kernel: {launches}")
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
    print(f"phase 5 grid: {tris.shape[0]} tris, {R} rays, build "
          f"{build_s:.3f} s, hit rate {hit_rate:.4f}, primary "
          f"{R / prim_s / 1e6:.3f} MRays/s, oracle prim-agree {agree:.5f} "
          f"checksum {ratio:.6f}, residual overflow 0, launches {launches} "
          f"[{gpu_line}]", flush=True)


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
    kern = phase_kernels(scene[0], scene[1], gpu_line)
    launches = phase_api(*scene, gpu_line)
    phase_grid(grid_scene(tris, 4, 4), dev, 640, gpu_line)

    print(json.dumps({"kernels": [
        {"name": "cull", "route": "cuda",
         "source": "tinybvh_tpu_torch/csrc/cull.cu",
         "replaces": CULL_REPLACES, "launches": launches["cull"],
         "max_abs_err": kern["cull"]["max_abs_err"],
         "ms": kern["cull"]["ms"], "plain_ms": kern["cull"]["plain_ms"]},
        {"name": "mt_fused", "route": "cuda",
         "source": "tinybvh_tpu_torch/csrc/mt_fused.cu",
         "replaces": MT_REPLACES, "launches": launches["mt_fused"],
         "max_abs_err": kern["mt_fused"]["max_abs_err"],
         "ms": kern["mt_fused"]["ms"],
         "plain_ms": kern["mt_fused"]["plain_ms"]},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
