"""Local multi-rank runs: spawn n ranks of torch.distributed on this host
(≙ the virtual multi-device CPU mesh that the JAX package's tests and
`__graft_entry__.dryrun_multichip` run on).

    from tinybvh_tpu_torch.parallel.launch import run_local
    out = run_local(4, fn, arg, backend="gloo", timeout_s=60.0)

Each rank is a spawned process that joins a process group through a
FileStore in a fresh temporary directory (no TCP port, so runs side by
side do not collide), calls fn(*args), and reports to the parent. The
process group's timeout is timeout_s, so a rank stuck in a collective
fails instead of hanging; the parent waits for all ranks at most
timeout_s + STARTUP_S seconds, raises RuntimeError when a rank fails or
the time runs out (ending every rank still running), and returns rank
0's result. fn must be importable by name in a fresh process (a
module-level function of a module that the children can import); its
result, with every tensor moved to the host, is pickled.

`dryrun_multichip(n)` runs the JAX package's multi-device dry run with the
port, on n gloo ranks of the CPU:

    python -m tinybvh_tpu_torch.parallel.launch 4

This module imports no JAX, so the spawned children never load it."""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import queue
import shutil
import sys
import tempfile
import time
import traceback
from datetime import timedelta

import torch

STARTUP_S = 30.0   # a rank's start (the spawn and torch's import) at most


def _to_host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    return x


def _rank_main(rank, n, fn, args, backend, store_path, timeout_s, results):
    import torch.distributed as dist

    try:
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, n), rank=rank,
            world_size=n, timeout=timedelta(seconds=timeout_s))
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        # pickled here, by value: the queue's own pickler would hand
        # tensors over as shared memory that dies with this process
        results.put((rank, None, pickle.dumps(_to_host(out))
                     if rank == 0 else None))
    except BaseException:
        results.put((rank, traceback.format_exc(), None))
        sys.exit(1)


def run_local(n: int, fn, *args, backend: str = "gloo",
              timeout_s: float = 60.0):
    """fn(*args) on n spawned local ranks of one process group; returns
    rank 0's result. Raises RuntimeError naming each rank that failed,
    or each rank still running when the time ran out."""
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="tbvh_ranks_")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, n, fn, args, backend,
                               os.path.join(tmp, "store"), timeout_s,
                               results))
             for r in range(n)]
    deadline = time.monotonic() + timeout_s + STARTUP_S
    errors, out, done, started = {}, None, set(), []
    try:
        for p in procs:
            p.start()
            started.append(p)
        while len(done) < n and not errors:
            try:
                rank, err, val = results.get(timeout=0.2)
            except queue.Empty:
                silent = [r for r, p in enumerate(procs)
                          if r not in done and p.exitcode is not None]
                if silent:
                    # a rank that died without a report (a signal)
                    errors.update({r: f"exit code {procs[r].exitcode}"
                                   for r in silent})
                elif time.monotonic() > deadline:
                    errors.update({r: f"still running after "
                                   f"{timeout_s + STARTUP_S:.0f} s"
                                   for r in range(n) if r not in done})
                continue
            done.add(rank)
            if err is not None:
                errors[rank] = err
            elif rank == 0:
                out = pickle.loads(val)
    finally:
        for p in started:
            p.join(timeout=0 if errors else 10)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if errors:
        raise RuntimeError("run_local: " + "; ".join(
            f"rank {r}: {e}" for r, e in sorted(errors.items())))
    return out


def _dryrun_rank(n_devices: int):
    """The three calls of JAX's dryrun_multichip on this rank, at its tiny
    shapes: the two-axis sharded trace, the data-parallel render step and
    the packet2 trace over the rays axis (one 16x16 tile a rank)."""
    import numpy as np

    from tinybvh_tpu_torch.builders.binned import build_binned
    from tinybvh_tpu_torch.core.rays import make_rays
    from tinybvh_tpu_torch.io.loaders import random_tris
    from tinybvh_tpu_torch.layouts.mbvh import collapse_bvh2
    from tinybvh_tpu_torch.parallel.mesh import (
        make_mesh, render_step_dp, shard_scene, trace_packets_dp,
        trace_sharded,
    )
    from tinybvh_tpu_torch.traverse.packet2 import build_packet_aux
    from tinybvh_tpu_torch.traverse.stack import pack_tris

    torch.set_num_threads(1)
    cpu = "cpu"
    n_scene = 2 if n_devices % 2 == 0 else 1
    mesh = make_mesh(n_devices // n_scene, n_scene, device=cpu)

    tris = random_tris(256, seed=0)
    rng = np.random.default_rng(0)
    o = rng.uniform(-2, 12, (16 * n_devices, 3)).astype(np.float32)
    d = rng.normal(size=o.shape).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = make_rays(o, d, device=cpu)

    bvhs, packed, gids = shard_scene(tris, n_scene, device=cpu)
    hits = trace_sharded(mesh, bvhs, packed, gids, rays)
    if not bool(torch.isfinite(hits.t).any()):
        raise AssertionError("trace_sharded: no finite t")

    mesh_dp = make_mesh(n_devices, 1, device=cpu)
    bvh = build_binned(tris, max_leaf=8, device=cpu)
    img = render_step_dp(mesh_dp, bvh, pack_tris(bvh, tris), rays,
                         [0.3, 0.8, 0.5])
    if not bool(torch.isfinite(img).all()):
        raise AssertionError("render_step_dp: non-finite image")

    bvh8 = collapse_bvh2(build_binned(tris, max_leaf=4, device=cpu), tris)
    aux = build_packet_aux(bvh8)
    eye = np.array([0.5, 0.5, -4.0], np.float32)
    dt = []
    for k in range(n_devices):
        cx, cy = 0.2 + 0.6 * (k % 3) / 2.0, 0.2 + 0.6 * (k // 3) / 2.0
        gx, gy = np.meshgrid((np.arange(16) + 0.5) / 16 * 0.2,
                             (np.arange(16) + 0.5) / 16 * 0.2)
        dd = np.stack([cx + gx, cy + gy, np.full_like(gx, 4.0)], -1)
        dd /= np.linalg.norm(dd, axis=-1, keepdims=True)
        dt.append(dd.reshape(-1, 3))
    dt = np.concatenate(dt).astype(np.float32)
    trays = make_rays(np.broadcast_to(eye, dt.shape).copy(), dt, device=cpu)
    ph = trace_packets_dp(mesh_dp, bvh8, aux, trays)
    if not bool(torch.isfinite(ph.t).any()):
        raise AssertionError("trace_packets_dp: no finite t")
    return dict(hits_t=hits.t, img=img, packet_t=ph.t)


def dryrun_multichip(n_devices: int, timeout_s: float = 120.0):
    """The port's counterpart of `__graft_entry__.dryrun_multichip`: the
    same three calls at the same tiny shapes on n_devices gloo ranks of
    the CPU. Returns rank 0's results (the hits' t, the image and the
    packet trace's t); raises if a rank fails."""
    return run_local(n_devices, _dryrun_rank, n_devices, backend="gloo",
                     timeout_s=timeout_s)


if __name__ == "__main__":
    res = dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
    print({k: tuple(v.shape) for k, v in res.items()})
