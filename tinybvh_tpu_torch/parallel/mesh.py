"""Multi-device tracing over a mesh of torch.distributed ranks
(≙ tinybvh_tpu/parallel/mesh.py, which runs under shard_map on a
jax.sharding.Mesh).

The reference is single-process (SURVEY.md §2.5); its scaling axes are
ray count and scene size:

  * 'rays' axis: data parallelism over ray blocks (≙ the reference's tile
    work queues, tiny_bvh_anim.cpp:30,194). Every rank holds the whole
    BVH and traces its own contiguous block of rays; nothing is sent
    until the image is assembled.
  * 'scene' axis: geometry sharding. Each rank of a scene row holds the
    BVH of one shard of the triangles, traces its row's whole ray block
    against it, and the row min-combines the hits: an all-gather, then
    the shard of the least t (the lowest shard on a tie, as jnp.argmin
    and torch.argmin both pick the first).

Rank r sits at (r // n_scene, r % n_scene), JAX's reshape of the device
list. Where shard_map returns a global array that the caller reads
whole, every rank here returns the whole batch: after the combine each
rank all-gathers the ray blocks of its rays column (the image assembly).
The callers pass the whole ray batch and the whole shard stack to every
rank, as shard_map is handed global arrays; each rank slices its part.

The process group is the caller's (torch.distributed.init_process_group:
NCCL between cards, gloo on the CPU). Gloo's all-gather takes host
tensors only, so on a gloo group the hits of CUDA ranks are copied to
the host for the collective alone (chosen by the group's backend). The
hits of a rank ride one collective: t, u, v, prim, inst (and the
packet engines' overflow flags) as the int32 bits of one (6, rays)
tensor."""

from __future__ import annotations

import dataclasses
import os
from functools import partial

import numpy as np
import torch
import torch.distributed as dist

from tinybvh_tpu_torch.core.rays import Hits, Rays, default_device
from tinybvh_tpu_torch.core.vecmath import BVH_FAR
from tinybvh_tpu_torch.traverse.stack import intersect_bvh2


@dataclasses.dataclass
class Mesh:
    """A rank's place in an (n_rays, n_scene) grid of ranks: row, the
    process group of its scene row (the ranks that share its ray block),
    and col, that of its rays column (the ranks that share its scene
    shard); device, where it traces. stats counts the collectives."""

    n_rays: int
    n_scene: int
    rank: int
    device: torch.device
    row: object
    col: object
    stats: dict = dataclasses.field(default_factory=lambda: dict(
        collectives=0))

    @property
    def ray_index(self):
        return self.rank // self.n_scene

    @property
    def scene_index(self):
        return self.rank % self.n_scene

    def ray_block(self, R: int, multiple: int = 1) -> slice:
        """This rank's contiguous block of R rays. Raises ValueError when
        R does not split evenly over the rays axis (shard_map refuses
        it), or a block is not a multiple of `multiple`."""
        if R % self.n_rays:
            raise ValueError(f"{R} rays do not split evenly over a rays axis "
                             f"of {self.n_rays}")
        n = R // self.n_rays
        if n % multiple:
            raise ValueError(f"each rank's block of {n} rays must be a "
                             f"multiple of {multiple}")
        return slice(self.ray_index * n, (self.ray_index + 1) * n)


def make_mesh(n_rays_axis: int, n_scene_axis: int = 1, group=None,
              device=None) -> Mesh | None:
    """The (rays, scene) mesh over the first n_rays_axis * n_scene_axis
    ranks of `group` (default: the default process group, which the
    caller has set up). Every rank of the default group must call it, in
    the same order as its other group creations: it creates one process
    group for each scene row, then one for each rays column. Ranks past
    the mesh get None. device: the rank's device, by default
    cuda:<LOCAL_RANK> (else the rank modulo the visible cards); without
    a card and without device="cpu" this raises RuntimeError
    (core.rays.default_device). Raises ValueError when the group has
    fewer ranks than the mesh."""
    ranks = dist.get_process_group_ranks(group or dist.group.WORLD)
    n = n_rays_axis * n_scene_axis
    if len(ranks) < n:
        raise ValueError(f"a {n_rays_axis} x {n_scene_axis} mesh needs {n} "
                         f"ranks; the group has {len(ranks)}")
    dev = default_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    grid = np.asarray(ranks[:n]).reshape(n_rays_axis, n_scene_axis)
    rows = [dist.new_group(grid[i].tolist()) for i in range(n_rays_axis)]
    cols = [dist.new_group(grid[:, j].tolist()) for j in range(n_scene_axis)]
    me = dist.get_rank()
    if me not in grid:
        return None
    i, j = (int(x[0]) for x in np.nonzero(grid == me))
    return Mesh(n_rays=n_rays_axis, n_scene=n_scene_axis,
                rank=i * n_scene_axis + j, device=dev, row=rows[i],
                col=cols[j])


def _all_gather(mesh: Mesh, group, x):
    """(k,) + x.shape: x of each of the group's k ranks, in rank order.
    On a gloo group the collective runs on a host copy."""
    src = x.cpu() if dist.get_backend(group) == "gloo" else x
    parts = [torch.empty_like(src)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src.contiguous(), group=group)
    mesh.stats["collectives"] += 1
    return torch.stack(parts).to(x.device)


def _pack(h: Hits, prim, overflow):
    """(6, W) int32: the bits of t, u, v (float32), then prim, inst
    (int32) and the overflow flags."""
    return torch.stack([h.t.view(torch.int32), h.u.view(torch.int32),
                        h.v.view(torch.int32), prim, h.inst,
                        overflow.to(torch.int32)])


def _unpack(p):
    """Hits and the overflow flags from _pack's rows."""
    f = p[:3].view(torch.float32).clone()
    return Hits(t=f[0], u=f[1], v=f[2], prim=p[3].clone(),
                inst=p[4].clone()), p[5] > 0


def _scene_combine(mesh: Mesh, p):
    """Min-combine packed hits over the scene row: the shard of the least
    t, the first shard on a tie (jnp.argmin's pick); a ray overflowed
    where any shard's did."""
    g = _all_gather(mesh, mesh.row, p)                 # (S, 6, W)
    win = torch.argmin(g[:, 0].view(torch.float32), dim=0)
    out = torch.gather(g, 0, win.reshape(1, 1, -1).expand(1, 6, -1))[0]
    out[5] = g[:, 5].amax(dim=0)
    return out


def _assemble(mesh: Mesh, p, what: str) -> Hits:
    """The whole batch from each rank's block (the rays column's
    all-gather); raises where a packet trace left a tile inexact, on
    every rank, since every rank holds every flag."""
    g = _all_gather(mesh, mesh.col, p)                 # (n_rays, 6, W)
    hits, overflow = _unpack(g.permute(1, 0, 2).reshape(6, -1))
    if bool(overflow.any()):
        raise RuntimeError(
            f"{what}: {int(overflow.sum())} rays in tiles whose wavefront "
            "retrace overflowed its frontier (raise wf_cap_factor)")
    return hits


def _local_rays(mesh: Mesh, rays: Rays, multiple: int = 1) -> Rays:
    blk = mesh.ray_block(rays.o.shape[0], multiple)
    return Rays(*(x[blk].to(mesh.device) for x in (rays.o, rays.d, rays.rd,
                                                   rays.mask)))


def _global_prim(prim, gids):
    return torch.where(prim >= 0, gids[torch.clamp(prim, min=0).long()], -1)


def _stack(items):
    """One dataclass of the items' fields stacked on a new leading axis:
    tensors as they are, ints (n_nodes, the table sizes) as an int32
    tensor; None stays None."""
    out = {}
    for f in dataclasses.fields(items[0]):
        vals = [getattr(x, f.name) for x in items]
        if vals[0] is None:
            out[f.name] = None
        elif isinstance(vals[0], torch.Tensor):
            out[f.name] = torch.stack(vals)
        else:
            out[f.name] = torch.tensor(vals, dtype=torch.int32)
    return type(items[0])(**out)


def _shard(stack, s, device):
    """Shard s of a _stack'ed dataclass, on `device` (its ints as ints)."""
    out = {}
    for f in dataclasses.fields(stack):
        v = getattr(stack, f.name)
        if isinstance(v, torch.Tensor):
            v = v[s]
            v = int(v) if v.dim() == 0 else v.to(device)
        out[f.name] = v
    return type(stack)(**out)


def _split(tris, n_shards: int):
    """The soup padded with zero (never hit) triangles to n_shards equal
    contiguous ranges, and each range's global ids (n_shards, per). JAX's
    docstring says interleaved subsets; its code takes contiguous
    ranges, as here."""
    if isinstance(tris, torch.Tensor):
        tris = tris.detach().cpu().numpy()
    tris = np.asarray(tris, np.float32)
    n = tris.shape[0]
    per = -(-n // n_shards)
    tris_p = np.concatenate(
        [tris, np.zeros((per * n_shards - n, 3, 3), np.float32)], axis=0)
    return tris_p, np.arange(per * n_shards).reshape(n_shards, per)


def shard_scene(tris, n_shards: int, builder=None, device=None):
    """Split a triangle soup into n_shards contiguous ranges (padded to
    equal sizes with zero-area triangles) and build one BVH2 per range
    (default: builders.binned.build_binned with max_leaf=8 on `device`,
    the card unless asked). Returns (bvh_stack, packed_stack, gid_stack):
    the BVH2s' tensors and the packed triangles stacked on a leading
    shard axis (n_nodes a (n_shards,) tensor), and each shard's
    global prim ids (n_shards, per) int32."""
    from tinybvh_tpu_torch.builders.binned import build_binned
    from tinybvh_tpu_torch.traverse.stack import pack_tris

    tris_p, shards = _split(tris, n_shards)
    build = builder or partial(build_binned, max_leaf=8, device=device)
    bvhs, packed, gids = [], [], []
    for ids in shards:
        sub = tris_p[ids]
        b = build(sub)
        bvhs.append(b)
        packed.append(pack_tris(b, sub))
        gids.append(torch.as_tensor(ids, dtype=torch.int32,
                                    device=b.prim_idx.device))
    return _stack(bvhs), torch.stack(packed), torch.stack(gids)


def trace_sharded(mesh: Mesh, bvh_stack, packed_stack, gid_stack, rays: Rays,
                  t_max=BVH_FAR, leaf_max: int = 8) -> Hits:
    """Two-axis sharded closest-hit trace: rays split over 'rays', (BVH2,
    triangles) over 'scene'. Each rank traces its ray block against its
    scene shard with intersect_bvh2, maps the shard's prim ids to global
    ones, and the scene row min-combines the hits. t_max: a scalar, as in
    JAX. Returns the whole batch's Hits on every rank."""
    if bvh_stack.node_min.shape[0] != mesh.n_scene:
        raise ValueError(f"{bvh_stack.node_min.shape[0]} shards for a scene "
                         f"axis of {mesh.n_scene}")
    s = mesh.scene_index
    bvh = _shard(bvh_stack, s, mesh.device)
    r = _local_rays(mesh, rays)
    h = intersect_bvh2(bvh, packed_stack[s].to(mesh.device), r, t_max,
                       leaf_max=leaf_max)
    gprim = _global_prim(h.prim, gid_stack[s].to(mesh.device))
    p = _scene_combine(mesh, _pack(h, gprim, torch.zeros_like(gprim)))
    return _assemble(mesh, p, "trace_sharded")


def _packets(bvh8, aux, rays, t_max, max_leaves, max_blocks, wf_cap_factor):
    """intersect_packets2 with its exact retrace (kernel R on the card;
    elsewhere the wavefront, its frontier the device's tuning row unless
    given) and the per-ray overflow flags."""
    from tinybvh_tpu_torch.traverse.packet2 import TILE, intersect_packets2
    from tinybvh_tpu_torch.tuning import get_tuning

    if wf_cap_factor is None:
        wf_cap_factor = get_tuning(device=rays.o.device).wf_cap_factor
    h, overflow = intersect_packets2(
        bvh8, aux, rays, max_leaves=max_leaves, t_max=t_max, retrace=True,
        max_blocks=max_blocks, wf_cap_factor=wf_cap_factor)
    return h, torch.repeat_interleave(overflow, TILE)


def trace_packets_dp(mesh: Mesh, bvh8, aux, rays: Rays, t_max=BVH_FAR,
                     max_leaves: int = 256, max_blocks: int = 128,
                     wf_cap_factor: int | None = None) -> Hits:
    """Data-parallel trace with the packet2 engine: the BVH8 and its
    packet tables replicated, tile-ordered rays split over 'rays' (each
    rank's block a multiple of 256 rays, else ValueError), each rank
    running intersect_packets2 with its exact retrace (kernels A, B and R
    on the card). No communication until the final gather (≙ the
    reference's tile threads calling BVH8_CPU::Intersect,
    tiny_bvh_anim.cpp:194-205). t_max: a scalar, as in JAX. Returns the
    whole batch's Hits on every rank; raises RuntimeError on every rank
    where a tile stayed flagged after the retrace: on the card a ray cut
    at MAX_LEVELS (64) of tree depth, elsewhere the wavefront's frontier
    past wf_cap_factor pairs a ray (default: the device's tuning row;
    JAX's returns those tiles' hits as they are)."""
    from tinybvh_tpu_torch.traverse.packet2 import TILE

    r = _local_rays(mesh, rays, TILE)
    h, ov = _packets(bvh8, aux, r, t_max, max_leaves, max_blocks,
                     wf_cap_factor)
    return _assemble(mesh, _pack(h, h.prim, ov), "trace_packets_dp")


def shard_scene_packets(tris, n_shards: int, max_leaf: int = 4, device=None):
    """Geometry sharding for the packet2 engine: split the soup into
    n_shards contiguous ranges, build a BVH8 and packet tables per range
    (on `device`, the card unless asked), pad every shard to common
    shapes (empty nodes and leaf rows are inert: EMPTY_SLOT children,
    +FAR minima and -FAR maxima that always cull, zero triangles with
    prim -1; leaf rows rounded up to the 128-segment block), and stack
    them on a leading shard axis. Returns (bvh8_stack, aux_stack,
    gid_stack)."""
    from tinybvh_tpu_torch.builders.binned import build_binned
    from tinybvh_tpu_torch.layouts.mbvh import EMPTY_SLOT, collapse_bvh2
    from tinybvh_tpu_torch.traverse.packet2 import build_packet_aux

    tris_p, shards = _split(tris, n_shards)
    b8s, gids = [], []
    for ids in shards:
        sub = tris_p[ids]
        b8s.append(collapse_bvh2(build_binned(sub, max_leaf=max_leaf,
                                              device=device), sub))
        gids.append(torch.as_tensor(ids, dtype=torch.int32,
                                    device=b8s[-1].bounds.device))
    n_nodes = max(b.n_nodes for b in b8s)
    n_leaves = -(-max(b.n_leaves for b in b8s) // 128) * 128

    def pad(b):
        pn, pl = n_nodes - b.n_nodes, n_leaves - b.n_leaves
        dev = b.bounds.device
        empty = torch.full((pn, 6, 8), BVH_FAR, dtype=torch.float32,
                           device=dev)
        empty[:, 3:] = -BVH_FAR
        return dataclasses.replace(
            b, bounds=torch.cat([b.bounds, empty.reshape(pn, 48)]),
            child=torch.cat([b.child, torch.full((pn, 8), EMPTY_SLOT,
                                                 dtype=b.child.dtype,
                                                 device=dev)]),
            leaf_tris=torch.cat([b.leaf_tris, torch.zeros(
                (pl, 4, 3, 3), dtype=b.leaf_tris.dtype, device=dev)]),
            leaf_prim=torch.cat([b.leaf_prim, torch.full(
                (pl, 4), -1, dtype=b.leaf_prim.dtype, device=dev)]))

    b8s = [pad(b) for b in b8s]
    auxes = [build_packet_aux(b) for b in b8s]
    return _stack(b8s), _stack(auxes), torch.stack(gids)


def trace_packets_sharded(mesh: Mesh, bvh8_stack, aux_stack, gid_stack,
                          rays: Rays, t_max=BVH_FAR, max_leaves: int = 256,
                          max_blocks: int = 128,
                          wf_cap_factor: int | None = None) -> Hits:
    """Two-axis sharded packet2 trace: rays over 'rays', geometry over
    'scene'. Each rank packet-traces its ray block against its shard
    (its retrace included), and the scene row min-combines the hits as
    trace_sharded does (≙ SURVEY §2.5 P6 with the fast engine). Returns
    the whole batch's Hits on every rank; raises as trace_packets_dp."""
    from tinybvh_tpu_torch.traverse.packet2 import TILE

    if bvh8_stack.bounds.shape[0] != mesh.n_scene:
        raise ValueError(f"{bvh8_stack.bounds.shape[0]} shards for a scene "
                         f"axis of {mesh.n_scene}")
    s = mesh.scene_index
    r = _local_rays(mesh, rays, TILE)
    h, ov = _packets(_shard(bvh8_stack, s, mesh.device),
                     _shard(aux_stack, s, mesh.device), r, t_max,
                     max_leaves, max_blocks, wf_cap_factor)
    gprim = _global_prim(h.prim, gid_stack[s].to(mesh.device))
    p = _scene_combine(mesh, _pack(h, gprim, ov))
    return _assemble(mesh, p, "trace_packets_sharded")


def render_step_dp(mesh: Mesh, bvh, packed, rays: Rays, light_dir,
                   leaf_max: int = 8):
    """One data-parallel render step: trace, Lambert term, shadow ray
    (≙ the reference's tiled CPU renderers, tiny_bvh_pt.cpp:30-60). The
    BVH2 replicated, rays split over 'rays'; returns the whole (R, 3)
    image on every rank. As in JAX, the normal is taken from
    packed[prim], the packed (prim_idx-ordered) triangle at the global
    prim id's position."""
    from tinybvh_tpu_torch.core.intersect import tri_edges
    from tinybvh_tpu_torch.core.rays import make_rays
    from tinybvh_tpu_torch.core.vecmath import cross, norm
    from tinybvh_tpu_torch.traverse.stack import is_occluded_bvh2

    dev = mesh.device
    r = _local_rays(mesh, rays)
    packed = packed.to(dev)
    bvh = dataclasses.replace(bvh, **{
        f.name: getattr(bvh, f.name).to(dev) for f in dataclasses.fields(bvh)
        if isinstance(getattr(bvh, f.name), torch.Tensor)})
    h = intersect_bvh2(bvh, packed, r, leaf_max=leaf_max)
    _, e1, e2 = tri_edges(packed[torch.clamp(h.prim, min=0).long()])
    n = cross(e1, e2)
    n = n / torch.clamp(norm(n, keepdim=True), min=1e-20)
    light = torch.as_tensor(light_dir, dtype=torch.float32, device=dev)
    # an explicit multiply-sum: no matmul (TF32) on the ray path
    ndl = (n[:, 0] * light[0] + n[:, 1] * light[1] + n[:, 2] * light[2]).abs()
    p = r.o + h.t[:, None] * r.d
    srays = make_rays(p + n * 1e-3, light.expand_as(p))
    occ = is_occluded_bvh2(bvh, packed, srays, 1e4, leaf_max=leaf_max)
    shade = torch.where(h.prim >= 0,
                        ndl * torch.where(occ, 0.2, 1.0), 0.05)
    img = torch.stack([shade, shade, shade], dim=-1)        # (W, 3)
    g = _all_gather(mesh, mesh.col, img)
    return g.reshape(-1, 3)
