"""The packet path's exact retrace: the rays of the tiles whose cull
survivors overflowed the packet pass's leaf budget, traced again exactly
(≙ the wavefront retrace of tinybvh_tpu/traverse/packet2.py
intersect_packets2 and is_occluded_packets2).

Two engines, chosen by what the call holds:

  kernel R, `retrace` (csrc/retrace.cu; replaces no TPU kernel: the JAX
      package leaves this engine to XLA): CUDA tensors, a BVH8 and the
      "mt" leaf test. One launch over the tiles, a CTA a tile and a
      thread a ray, depth first with a stack of STACK entries, which
      holds the deepest walk MAX_LEVELS allows. It writes the exact hits
      (or the occlusion flags) of the flagged tiles' rays over the packet
      pass's, in place, and clears each tile's overflow flag unless a ray
      of it was cut at MAX_LEVELS;
  the plain twin: the wavefront engine (traverse/wavefront.py) over every
      ray, t_max 0 on the rays of the other tiles, its frontier capped at
      cap_factor pairs a ray, merged over the packet pass's hits: CPU
      tensors, a BVH8Q, and the "watertight" and "baldwin" leaf tests.

Both give each ray the least key (t, leaf depth, leaf row * 4 + lane) it
reaches, the wavefront's tie rule; on the card kernel R's t, u, v and
prim equal the twin's bit for bit. The overflow mask they return differs
only where the twin's is coarser: the twin flags every traced tile when
its frontier passed the cap or a pair was left at MAX_LEVELS; kernel R
has no cap, and flags the tiles of the rays it cut.

Inside an API call traced by a torch profiler the call's record
(_trace.py) gets, from kernel R: levels 0 (no level loop, no host sync),
pairs (node and leaf visits over the rays sent), leaf_pairs (the leaf
visits of them), peak (the deepest stack a ray reached) and cap (the
stack's capacity, STACK). The kernel sums the three counters into a
buffer kept on each device, which its last CTA zeroes for the next
launch; they come to the host by an asynchronous copy that every launch
makes, traced or not. So an untraced call adds to the kernel's launch
one copy of 24 bytes, into a pinned buffer from torch's caching host
allocator, and no memset. `LAUNCHES` counts kernel R's launches (closest
and any hit)."""

from __future__ import annotations

import torch

from tinybvh_tpu_torch import _build, _trace
from tinybvh_tpu_torch._trace import count_launch, launch_table
from tinybvh_tpu_torch.core.rays import Hits, Rays
from tinybvh_tpu_torch.layouts.mbvh import BVH8
from tinybvh_tpu_torch.traverse.packet import TILE
from tinybvh_tpu_torch.traverse.packet2 import (
    PacketAux, _check, _merge, _on_cuda,
)
from tinybvh_tpu_torch.traverse import wavefront
from tinybvh_tpu_torch.traverse.wavefront import check_omap

LAUNCHES = launch_table(__name__, ("retrace", "retrace_any"))
# Kernel R's stack (csrc/retrace.cu kStack): a node visit pops one entry
# and pushes at most 8, and a node at depth MAX_LEVELS - 1 pushes none.
STACK = 512
_STATS: dict = {}       # device -> kernel R's (8,) int64 counter buffer


def _stats(device) -> torch.Tensor:
    """Kernel R's counter buffer on `device`, zeroed once; each launch
    leaves it zeroed but for its own sums in [4, 7), so launches that
    share it run one at a time (on the current stream)."""
    buf = _STATS.get(device)
    if buf is None:
        buf = _STATS[device] = torch.zeros(8, dtype=torch.int64,
                                           device=device)
    return buf


def _tri_test(tri_test):
    if tri_test is None:
        from tinybvh_tpu_torch.config import get_config

        tri_test = get_config().tri_test
    return tri_test


def _takes_kernel(bvh8, tri_test: str, *tensors) -> bool:
    """Kernel R for CUDA tensors, a BVH8 and the "mt" leaf test; the plain
    twin otherwise (raises where the tensors lie on several devices)."""
    return (_on_cuda("retrace", *tensors) and isinstance(bvh8, BVH8)
            and tri_test == "mt")


def _retrace_cuda(bvh8: BVH8, aux: PacketAux, rays: Rays, t_max, overflow,
                  hits: Hits | None = None, occ=None):
    """Kernel R launch (csrc/retrace.cu): hits (closest hit) or occ (any
    hit) and overflow rewritten in place on the flagged tiles; t_max an
    (R,) f32 tensor or a float for every ray. Returns the pinned (3,)
    int64 tensor the launch's visits, leaf visits and deepest stack are
    being copied into (None for no tile)."""
    R = rays.o.shape[0]
    T = overflow.shape[0]
    M, L = bvh8.child.shape[0], bvh8.leaf_tris.shape[0]
    if R != T * TILE:
        raise ValueError(f"retrace: {R} rays for {T} tiles of {TILE}")
    for name, x, dtype, shape in (
            ("o", rays.o, torch.float32, (R, 3)),
            ("d", rays.d, torch.float32, (R, 3)),
            ("rd", rays.rd, torch.float32, (R, 3)),
            ("overflow", overflow, torch.bool, (T,)),
            ("bounds", bvh8.bounds, torch.float32, (M, 48)),
            ("child", bvh8.child, torch.int32, (M, 8)),
            ("leaf_tris", bvh8.leaf_tris, torch.float32, (L, 4, 3, 3)),
            ("leaf_prim", bvh8.leaf_prim, torch.int32, (L, 4))):
        _check(f"retrace {name}", x, dtype, shape)
    t_scalar = 0.0
    if isinstance(t_max, torch.Tensor):
        _check("retrace t_max", t_max, torch.float32, (R,))
    else:
        t_scalar, t_max = float(t_max), None
    if occ is None:
        outs = (hits.t, hits.u, hits.v, hits.prim)
        for name, x, dtype in zip(("t", "u", "v", "prim"), outs, (
                torch.float32, torch.float32, torch.float32, torch.int32)):
            _check(f"retrace {name}", x, dtype, (R,))
    else:
        _check("retrace occ", occ, torch.bool, (R,))
        outs = (None,) * 4
    omap, S = aux.omap, 0
    if omap is not None:
        check_omap(bvh8, omap)
        S = omap.shape[-1]
        _check("retrace omap", omap, torch.bool, (L, 4, S, S))
    for x in (bvh8.bounds, bvh8.child, bvh8.leaf_tris):
        if x.data_ptr() % 16:
            raise ValueError("retrace: the BVH8's tables must be 16-byte "
                             "aligned")
    if T == 0:
        return None
    stats = _stats(overflow.device)
    lib = _build.kernels()
    stream = torch.cuda.current_stream(overflow.device).cuda_stream

    def ptr(*xs):
        return [None if x is None else x.data_ptr() for x in xs]

    err = lib.tbvh_retrace(
        *ptr(rays.o, rays.d, rays.rd, t_max), t_scalar,
        *ptr(bvh8.bounds, bvh8.child, bvh8.leaf_tris, bvh8.leaf_prim, omap,
             overflow, *outs, occ, stats), T, S, int(occ is not None),
        stream)
    _build.check(err, "tbvh_retrace")
    count_launch(LAUNCHES, "retrace" if occ is None else "retrace_any")
    host = torch.empty(3, dtype=torch.int64, pin_memory=True)
    host.copy_(stats[4:7], non_blocking=True)
    _trace.note(levels=0, cap=STACK)
    _trace.note_later(host, ("pairs", "leaf_pairs", "peak"))
    return host


def _hits_plain(bvh8, aux: PacketAux, rays: Rays, t_max, overflow,
                hits: Hits, cap_factor: int, tri_test: str):
    """Plain twin of retrace_hits: the wavefront over every ray, t_max 0
    outside the flagged tiles, merged over hits."""
    ov_ray = torch.repeat_interleave(overflow, TILE)
    h2, ov2 = wavefront.intersect_wavefront(
        bvh8, rays, t_max=torch.where(ov_ray, t_max, 0.0),
        cap_factor=cap_factor, omap=aux.omap, tri_test=tri_test)
    return _merge(ov_ray, h2, hits), overflow & ov2


def _occluded_plain(bvh8, aux: PacketAux, rays: Rays, cutoff: float,
                    overflow, occ, cap_factor: int, tri_test: str):
    """Plain twin of retrace_occluded: the any-hit wavefront."""
    ov_ray = torch.repeat_interleave(overflow, TILE)
    _, wf_occ, wf_ovf = wavefront.intersect_wavefront(
        bvh8, rays, t_max=torch.where(ov_ray, cutoff, 0.0),
        cap_factor=cap_factor, any_hit=True, omap=aux.omap,
        tri_test=tri_test)
    return torch.where(ov_ray, wf_occ, occ), overflow & wf_ovf


def retrace_hits(bvh8, aux: PacketAux, rays: Rays, t_max, overflow,
                 hits: Hits, cap_factor: int = 8, tri_test=None):
    """Closest hits of the rays of the tiles that overflow ((T,) bool)
    flags, traced again exactly over bvh8 up to t_max ((R,) f32, as the
    packet pass's), in place of theirs in hits (rays in tile order).
    Returns (hits, overflow): overflow then flags the tiles whose hits may
    still be inexact. cap_factor: the plain twin's frontier, pairs a ray;
    tri_test: the leaf test (default: the config's)."""
    tri_test = _tri_test(tri_test)
    _trace.note(retrace=True)
    if _takes_kernel(bvh8, tri_test, rays.o, t_max, overflow, hits.t):
        _retrace_cuda(bvh8, aux, rays, t_max, overflow, hits=hits)
        return hits, overflow
    return _hits_plain(bvh8, aux, rays, t_max, overflow, hits, cap_factor,
                       tri_test)


def retrace_occluded(bvh8, aux: PacketAux, rays: Rays, cutoff: float,
                     overflow, occ, cap_factor: int = 8, tri_test=None):
    """Any hit in (0, cutoff) of the rays of the tiles that overflow
    flags, traced again exactly, in place of theirs in occ ((R,) bool).
    Returns (occ, overflow); the rest as retrace_hits."""
    tri_test = _tri_test(tri_test)
    _trace.note(retrace=True)
    if _takes_kernel(bvh8, tri_test, rays.o, overflow, occ):
        _retrace_cuda(bvh8, aux, rays, cutoff, overflow, occ=occ)
        return occ, overflow
    return _occluded_plain(bvh8, aux, rays, cutoff, overflow, occ,
                           cap_factor, tri_test)
