"""Rank functions for tests/test_torch_parallel.py, run on gloo ranks of
the CPU by tinybvh_tpu_torch.parallel.launch.run_local. A helper module,
not a test file: it imports torch and the port only, so the spawned
ranks never load JAX."""

import os
import time

import numpy as np
import torch
import torch.distributed as dist

from tinybvh_tpu_torch.builders.binned import build_binned
from tinybvh_tpu_torch.core.rays import make_rays
from tinybvh_tpu_torch.layouts.mbvh import collapse_bvh2
from tinybvh_tpu_torch.parallel import mesh as pm
from tinybvh_tpu_torch.traverse.packet2 import (
    build_packet_aux, intersect_packets2,
)
from tinybvh_tpu_torch.traverse.stack import pack_tris

CPU = "cpu"


def _hits(h):
    return {k: getattr(h, k) for k in ("t", "u", "v", "prim", "inst")}


def _raises(fn):
    """The name of the exception fn() raises, or None."""
    try:
        fn()
    except (ValueError, RuntimeError) as e:
        return type(e).__name__
    return None


def parity_cases(inp, out_dir):
    """Every traced case of the parity tests on a 4-rank world, each
    rank's results saved to out_dir/rank<r>.pt: trace_sharded on a 1 x 4
    mesh, trace_packets_sharded on 2 x 2, trace_packets_dp and
    render_step_dp on 4 x 1 (with the single-rank intersect_packets2 on
    the same rays), the duplicated triangle on 2 x 2, and the calls that
    must raise."""
    torch.set_num_threads(1)
    res = {}

    mesh = pm.make_mesh(1, 4, device=CPU)
    bvhs, packed, gids = pm.shard_scene(inp["tris777"], 4, device=CPU)
    rays = make_rays(inp["o"], inp["d"], device=CPU)
    res["sharded"] = _hits(pm.trace_sharded(mesh, bvhs, packed, gids, rays))
    res["sharded_stats"] = dict(mesh.stats)

    mesh22 = pm.make_mesh(2, 2, device=CPU)
    trays = make_rays(inp["to"], inp["td"], device=CPU)
    b8s, auxes, g2 = pm.shard_scene_packets(inp["tris1200"], 2, device=CPU)
    res["packets_sharded"] = _hits(pm.trace_packets_sharded(
        mesh22, b8s, auxes, g2, trays))

    mesh41 = pm.make_mesh(4, 1, device=CPU)
    tris = inp["tris1500"]
    bvh8 = collapse_bvh2(build_binned(tris, max_leaf=4, device=CPU), tris)
    aux = build_packet_aux(bvh8)
    dprays = make_rays(inp["dpo"], inp["dpd"], device=CPU)
    res["dp"] = _hits(pm.trace_packets_dp(mesh41, bvh8, aux, dprays))
    res["dp_single"] = _hits(intersect_packets2(bvh8, aux, dprays)[0])

    tris = inp["tris500"]
    bvh = build_binned(tris, max_leaf=8, device=CPU)
    res["render"] = pm.render_step_dp(
        mesh41, bvh, pack_tris(bvh, tris),
        make_rays(inp["ro"], inp["rd"], device=CPU), [0.3, 0.8, 0.5])

    bvhs, packed, gids = pm.shard_scene(inp["dup_tris"], 2, device=CPU)
    res["dup"] = _hits(pm.trace_sharded(
        mesh22, bvhs, packed, gids,
        make_rays(inp["dup_o"], inp["dup_d"], device=CPU)))

    odd = make_rays(inp["o"][:255], inp["d"][:255], device=CPU)
    half_tile = make_rays(inp["to"][:512], inp["td"][:512], device=CPU)
    res["raises"] = {
        "world_too_small": _raises(lambda: pm.make_mesh(4, 2, device=CPU)),
        "rays_axis": _raises(lambda: pm.trace_sharded(
            mesh22, bvhs, packed, gids, odd)),
        "tile_block": _raises(lambda: pm.trace_packets_dp(
            mesh41, bvh8, aux, half_tile)),
    }
    real = torch.cuda.is_available
    torch.cuda.is_available = lambda: False
    try:
        res["raises"]["no_card"] = _raises(lambda: pm.make_mesh(2, 2))
    finally:
        torch.cuda.is_available = real
    torch.save(res, os.path.join(out_dir, f"rank{dist.get_rank()}.pt"))
    return dist.get_rank()


def hang_rank(hold_s):
    """Rank 0 waits in an all-gather that rank 1 never joins."""
    if dist.get_rank() == 1:
        time.sleep(hold_s)
        return None
    x = torch.zeros(4)
    dist.all_gather([torch.empty_like(x) for _ in range(2)], x)
    return 0


def fail_rank():
    """Rank 1 raises; rank 0 returns."""
    if dist.get_rank() == 1:
        raise ValueError("rank 1 failed on purpose")
    return np.arange(3)
