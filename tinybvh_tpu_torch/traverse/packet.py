"""Packet traversal (≙ tinybvh_tpu/traverse/packet.py): the tile frustum
planes and the coherence sort that the packet2 pipeline shares, and the
v1 packet engine, `intersect_packets`, with its wrappers
`is_occluded_packets` and `intersect_packets_sorted`.

The v1 engine (≙ Intersect256Rays, tiny_bvh.h:3528-3696) works on tiles
of 256 coherent rays in 16x16 scan order sharing one origin:
  1. phase 1 lists each tile's leaves: a level-synchronous frustum BFS
     over (tile, node) pairs in plain torch (`collect_tile_leaves`, or
     `collect_tile_leaves_flat` with one flat pair buffer and a sort), or
     kernel F, a per-tile depth-first walk
     (traverse/frustum_walk.py, csrc/frustum_walk.cu);
  2. phase 2 tests every ray of a tile against the tile's leaves: kernel D
     over the gathered triangle rows (traverse/leaf_resolve.py,
     csrc/leaf_resolve.cu), or a chunked Möller–Trumbore loop in plain
     torch.
Tiles whose list overflows report in the returned mask; their hits may
miss geometry. Explicit multiply-sums on all ray math: no `@`/einsum."""

from __future__ import annotations

import torch

from tinybvh_tpu_torch.core.intersect import moller_trumbore, tri_edges
from tinybvh_tpu_torch.core.rays import Hits, Rays, make_rays
from tinybvh_tpu_torch.core.vecmath import BVH_FAR, cross, norm
from tinybvh_tpu_torch.layouts.mbvh import BVH8, EMPTY_SLOT

TILE = 256
MAX_LEVELS = 32
_I32MAX = 2**31 - 1


def _tile_planes(o, d):
    """Per-tile frustum: 4 conservative planes bounding ALL tile
    directions, in gnomonic coordinates around the mean direction
    (≙ tiny_bvh.h:3545-3560, valid for any shared-origin bundle).

    o: (T, 3) shared origins (unused: planes pass through the origin);
    d: (T, 256, 3). Returns (T, 4, 3) inward normals n with
    dot(d_i, n) >= 0 for every ray of the tile; a bundle spanning >= 90
    degrees from its mean gets all-pass (zero) planes."""
    del o
    m = d.mean(dim=1)
    m = m / torch.clamp(norm(m, keepdim=True), min=1e-20)
    up = torch.tensor([0.0, 1.0, 0.0], device=d.device)
    side = torch.tensor([1.0, 0.0, 0.0], device=d.device)
    ref = torch.where((m[:, 1].abs() < 0.9)[:, None], up, side)
    u = cross(ref, m)
    u = u / torch.clamp(norm(u, keepdim=True), min=1e-20)
    v = cross(m, u)
    dm = (d * m[:, None, :]).sum(-1)
    da = (d * u[:, None, :]).sum(-1)
    db = (d * v[:, None, :]).sum(-1)
    wide = (dm <= 1e-9).any(dim=1)
    safe = torch.where(dm <= 1e-9, torch.ones_like(dm), dm)
    a = da / safe
    b = db / safe
    amin = a.amin(dim=1)[:, None]
    amax = a.amax(dim=1)[:, None]
    bmin = b.amin(dim=1)[:, None]
    bmax = b.amax(dim=1)[:, None]
    n = torch.stack([u - amin * m, amax * m - u,
                     v - bmin * m, bmax * m - v], dim=1)      # (T, 4, 3)
    return torch.where(wide[:, None, None], torch.zeros_like(n), n)


def _spread10(x):
    """Spread 10 bits to every 3rd position (morton helper)."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _morton3(q):
    """(R, 3) int32 10-bit cells -> (R,) 30-bit morton codes."""
    return (_spread10(q[:, 0]) | (_spread10(q[:, 1]) << 1)
            | (_spread10(q[:, 2]) << 2))


def inverse_permutation(order):
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(order.shape[0], dtype=order.dtype,
                                  device=order.device)
    return inverse


def sort_rays_coherent(o, d, scene_lo, scene_hi):
    """Coherence sort for incoherent rays: key = direction octant (3 bits)
    | origin morton (27 bits), stable. Returns (order, inverse); each
    consecutive 256 rays of `order` form one packet tile."""
    lo = torch.as_tensor(scene_lo, dtype=torch.float32, device=o.device)
    hi = torch.as_tensor(scene_hi, dtype=torch.float32, device=o.device)
    ext = torch.clamp(hi - lo, min=1e-20)
    q = torch.clamp(((o - lo) / ext * 1024.0).to(torch.int32), 0, 1023)
    octant = ((d[:, 0] < 0).to(torch.int32) * 4
              + (d[:, 1] < 0).to(torch.int32) * 2
              + (d[:, 2] < 0).to(torch.int32))
    key = (octant << 27) | (_morton3(q) >> 3)
    order = torch.argsort(key, stable=True)
    return order, inverse_permutation(order)


# --------------------------------------------------------------------------
# the v1 packet engine
# --------------------------------------------------------------------------

def _sum3(x):
    """x[..., 0] + x[..., 1] + x[..., 2], in that order."""
    return x[..., 0] + x[..., 1] + x[..., 2]


def _frontier_levels(bvh8: BVH8, planes, o_min, pair_cap_factor: int):
    """The level-synchronous frustum BFS of both phase-1 forms (≙ the
    while_loop bodies of JAX collect_tile_leaves[_flat]). planes (T, 4, 3);
    o_min (T, 4) each plane's offset over the tile's origins. Per level
    (at most MAX_LEVELS) yields (tile, leaf row) of every leaf child that
    passes, in (pair, child slot) order, and whether the next frontier was
    cut at the cap C = max(T * pair_cap_factor, 8192) pairs (the JAX
    overflow of every tile). The frontier holds only live pairs, in JAX's
    order; the cap keeps its meaning."""
    T = planes.shape[0]
    C = max(T * pair_cap_factor, 8192)
    dev = planes.device
    pos_n = torch.clamp(planes, min=0.0)
    neg_n = torch.clamp(planes, max=0.0)
    p_tile = torch.arange(T, device=dev)
    p_node = torch.zeros(T, dtype=torch.int64, device=dev)
    for _ in range(MAX_LEVELS):
        if p_tile.numel() == 0:
            break
        b = bvh8.bounds[p_node].reshape(-1, 6, 8)
        kids = bvh8.child[p_node]
        pp, pn = pos_n[p_tile], neg_n[p_tile]
        # farthest corner along each normal: hi where n > 0, else lo
        hi_part = (pp[:, :, 0, None] * b[:, None, 3]
                   + pp[:, :, 1, None] * b[:, None, 4]
                   + pp[:, :, 2, None] * b[:, None, 5])
        lo_part = (pn[:, :, 0, None] * b[:, None, 0]
                   + pn[:, :, 1, None] * b[:, None, 1]
                   + pn[:, :, 2, None] * b[:, None, 2])
        dist = hi_part + lo_part - o_min[p_tile][:, :, None]  # (P, 4, 8)
        valid = ~(dist < 0).any(dim=1) & (kids != EMPTY_SLOT)
        flat_kids = kids.reshape(-1)
        is_node = valid & (kids >= 0)
        li = torch.nonzero((valid & (kids < 0)).reshape(-1))[:, 0]
        ni = torch.nonzero(is_node.reshape(-1))[:, 0]
        cut = ni.numel() > C
        yield p_tile[li // 8], -flat_kids[li] - 1, cut
        if cut:
            ni = _cut_frontier(ni, is_node, C)
        p_tile = p_tile[ni // 8]
        # JAX gathers wrap a negative node id once and clamp the rest
        # (reached only through the cut's last slot)
        M = bvh8.bounds.shape[0]
        p_node = flat_kids[ni].long()
        p_node = torch.clamp(torch.where(p_node < 0, p_node + M, p_node),
                             0, M - 1)


def _cut_frontier(ni, is_node, C: int):
    """The first C node children (flat pair*8+lane ids, in order) of a
    frontier that wants more, with JAX's last slot: its compaction
    (scatter-max of each pair's first offset clipped to C-1, then a
    running max) hands slot C-1 to the LAST pair with node children, at
    the lane of rank (C-1 - that pair's offset) mod 8 among them, lane 0
    past their count. Every tile is flagged when this happens."""
    p_last = int(ni[-1]) // 8
    off_last = int(torch.searchsorted(ni // 8, p_last))
    ni = ni[:C].clone()
    if off_last > C - 1:
        r = (C - 1 - off_last) % 8
        lanes = torch.nonzero(is_node[p_last])[:, 0]
        ni[C - 1] = p_last * 8 + (int(lanes[r]) if r < lanes.numel() else 0)
    return ni


def _rank_in_tile(tile, T: int):
    """Per-tile counts of a tile-sorted id list and each entry's rank
    among its tile's entries."""
    n_t = torch.bincount(tile, minlength=T)
    start = torch.cumsum(n_t, 0) - n_t
    return n_t, torch.arange(tile.numel(), device=tile.device) - start[tile]


def _no_pairs(dev):
    """Empty (tile ids, leaf rows) lists to start an append."""
    return ([torch.zeros(0, dtype=torch.int64, device=dev)],
            [torch.zeros(0, dtype=torch.int32, device=dev)])


def _scatter_lists(tile, pos, row, T: int, K: int):
    """(T, K) lists, I32MAX padded, with row[i] at [tile[i], pos[i]] where
    pos[i] < K."""
    lists = torch.full((T * K + 1,), _I32MAX, dtype=torch.int32,
                       device=tile.device)
    ok = pos < K
    lists[torch.where(ok, tile * K + pos, T * K)] = torch.where(
        ok, row, _I32MAX).to(torch.int32)
    return lists[:T * K].reshape(T, K)


def collect_tile_leaves(bvh8: BVH8, tile_o, tile_d, max_leaves: int = 128,
                        pair_cap_factor: int = 64, tile_ohi=None):
    """Phase 1: per-tile frustum BFS -> ((T, K) leaf rows, I32MAX padded,
    (T,) overflow mask) (≙ JAX collect_tile_leaves). Each tile's list
    holds its leaves level by level, in (pair, child slot) order within a
    level. tile_o (T, 3) each tile's origin, or with tile_ohi the low
    corner of its origin box: culling then uses the least n.o over the
    box, valid for sorted incoherent bundles. tile_d (T, 256, 3). A tile
    overflows when its list passes K; a frontier cut at the cap flags
    every tile."""
    T = tile_o.shape[0]
    K = max_leaves
    ohi = tile_o if tile_ohi is None else tile_ohi
    planes = _tile_planes(tile_o, tile_d)
    o_min = (_sum3(torch.clamp(planes, min=0.0) * tile_o[:, None, :])
             + _sum3(torch.clamp(planes, max=0.0) * ohi[:, None, :]))
    n_leaves = torch.zeros(T, dtype=torch.int64, device=tile_o.device)
    overflow = torch.zeros(T, dtype=torch.bool, device=tile_o.device)
    tiles, rows = _no_pairs(tile_o.device)
    poss = tiles[:]
    for ltile, lrow, cut in _frontier_levels(bvh8, planes, o_min,
                                             pair_cap_factor):
        n_t, rank = _rank_in_tile(ltile, T)
        tiles.append(ltile)
        poss.append(n_leaves[ltile] + rank)
        rows.append(lrow)
        n_leaves = n_leaves + n_t
        overflow |= n_leaves > K
        if cut:
            overflow[:] = True
    leaves = _scatter_lists(torch.cat(tiles), torch.cat(poss),
                            torch.cat(rows), T, K)
    return leaves, overflow


def collect_tile_leaves_flat(bvh8: BVH8, tile_o, tile_d,
                             max_leaves: int = 128,
                             pair_cap_factor: int = 64):
    """Phase 1 variant (≙ JAX collect_tile_leaves_flat): the BFS appends
    (tile, leaf) pairs to one flat buffer of T*K pairs with a running
    cursor, and one stable sort by tile resolves the per-tile lists (the
    same lists as collect_tile_leaves where nothing overflows). Culls
    with planes . tile_o. Every tile is flagged when the buffer or the
    frontier overflows."""
    T = tile_o.shape[0]
    K = max_leaves
    P = T * K
    planes = _tile_planes(tile_o, tile_d)
    o_min = _sum3(planes * tile_o[:, None, :])
    tiles, rows = _no_pairs(tile_o.device)
    cursor, all_overflow = 0, False
    for ltile, lrow, cut in _frontier_levels(bvh8, planes, o_min,
                                             pair_cap_factor):
        keep = max(0, min(ltile.numel(), P - cursor))
        tiles.append(ltile[:keep])
        rows.append(lrow[:keep])
        cursor += ltile.numel()
        all_overflow = all_overflow or cursor > P or cut
    tile_all = torch.cat(tiles)
    order = torch.argsort(tile_all, stable=True)
    tile_s = tile_all[order]
    n_t, rank = _rank_in_tile(tile_s, T)
    leaves = _scatter_lists(tile_s, rank, torch.cat(rows)[order], T, K)
    overflow = (n_t > K) | all_overflow
    return leaves, overflow


def _finish(bvh8: BVH8, rays: Rays, best_t, best_pk):
    """≙ JAX _finish with kuv=None: (prim, u, v) of each ray's winning
    packed leafrow*4+lane, u/v by re-intersecting the winner. best_t
    (T, 256), BVH_FAR on a miss."""
    R = rays.o.shape[0]
    ok = best_t < BVH_FAR
    wl = torch.where(ok, best_pk >> 2, 0).long().reshape(-1)
    wk = torch.where(ok, best_pk & 3, 0).long().reshape(-1)
    okf = ok.reshape(-1)
    v0, e1, e2 = tri_edges(bvh8.leaf_tris[wl, wk])
    _, _, uu, vv = moller_trumbore(
        rays.o, rays.d, v0, e1, e2,
        torch.full((R,), BVH_FAR, dtype=torch.float32, device=rays.o.device))
    return Hits(
        t=torch.where(okf, best_t.reshape(-1), BVH_FAR),
        u=torch.where(okf, uu, 0.0),
        v=torch.where(okf, vv, 0.0),
        prim=torch.where(okf, bvh8.leaf_prim[wl, wk], -1),
        inst=torch.full((R,), -1, dtype=torch.int32, device=rays.o.device),
    )


def _resolve_chunks(bvh8: BVH8, o, d, leaves, chunk: int):
    """Phase 2 in plain torch (≙ the JAX `step` scan): each ray against
    its tile's leaves, `chunk` leaves at a time, as a (T, 256, chunk, 4)
    Möller–Trumbore. Returns (best_t, packed leafrow*4+lane), (T, 256)."""
    T, K = leaves.shape
    lt = bvh8.leaf_tris
    dev = o.device
    best_t = torch.full((T, TILE), BVH_FAR, dtype=torch.float32, device=dev)
    best_pk = torch.zeros((T, TILE), dtype=torch.int32, device=dev)
    dd = d[:, :, None, None, :]
    oo = o[:, :, None, None, :]
    for c0 in range(0, K, chunk):
        kchunk = leaves[:, c0:c0 + chunk]
        rows = torch.clamp(kchunk, 0, lt.shape[0] - 1)      # (T, chunk)
        live = kchunk != _I32MAX
        tri = lt[rows.long()]                               # (T, c, 4, 3, 3)
        v0 = tri[:, :, :, 0]
        e1 = tri[:, :, :, 1] - v0
        e2 = tri[:, :, :, 2] - v0
        h = cross(dd, e2[:, None])
        det = (e1[:, None] * h).sum(-1)
        okd = det.abs() > 1e-9
        inv = 1.0 / torch.where(okd, det, 1.0)
        sv = oo - v0[:, None]
        u = (sv * h).sum(-1) * inv
        q = cross(sv, e1[:, None])
        v = (dd * q).sum(-1) * inv
        tt = (e2[:, None] * q).sum(-1) * inv
        hit = (okd & (u >= 0) & (v >= 0) & (u + v <= 1) & (tt > 0)
               & live[:, None, :, None])
        tt = torch.where(hit, tt, BVH_FAR)
        m, am = tt.reshape(T, TILE, -1).min(dim=-1)         # first argmin
        rowsel = torch.gather(rows, 1, am // 4)
        pk = rowsel * 4 + (am % 4).to(torch.int32)
        better = m < best_t
        best_t = torch.where(better, m, best_t)
        best_pk = torch.where(better, pk, best_pk)
    return best_t, best_pk


def _resolve_kernel(bvh8: BVH8, o, d, leaves):
    """Phase 2 through kernel D (≙ the use_pallas branch of JAX
    intersect_packets): gather each tile's triangle rows into
    (T, K*4, 12) with dead rows zeroed, resolve, then map the winning list
    position back to leaf row and lane."""
    from tinybvh_tpu_torch.traverse.leaf_resolve import (
        leaf_resolve_v2, pack_tri_geom,
    )

    T, K = leaves.shape
    tri_geom = pack_tri_geom(bvh8)                          # (4L, 12)
    rows_t = torch.clamp(leaves, 0, bvh8.leaf_tris.shape[0] - 1)
    live_t = leaves != _I32MAX
    lanes4 = torch.arange(4, dtype=torch.int32, device=leaves.device)
    tri_idx = (rows_t[:, :, None] * 4 + lanes4).long()
    geom_t = torch.where(live_t[:, :, None, None], tri_geom[tri_idx],
                         0.0).reshape(T, K * 4, 12)
    best_t, best_li = leaf_resolve_v2(o.permute(0, 2, 1).contiguous(),
                                      d.permute(0, 2, 1).contiguous(),
                                      geom_t)
    row = torch.gather(rows_t, 1, (best_li >> 2).long())
    return best_t, row * 4 + (best_li & 3)


def intersect_packets(bvh8: BVH8, rays: Rays, max_leaves: int = 128,
                      chunk: int = 16, leaf_kernel: bool = False,
                      pair_cap_factor: int = 32, walk_kernel: bool = False,
                      phase1_flat: bool = False):
    """Full v1 packet trace (≙ JAX intersect_packets). Rays are (T*256,)
    in 16x16 tile scan order, each tile sharing one origin. Returns (Hits,
    (T,) overflow mask); an overflowed tile's hits may miss geometry.

    Phase 1 (the leaf lists): by default the frontier BFS over each tile's
    origin box (collect_tile_leaves on o.min / o.max); phase1_flat the
    flat-buffer BFS; walk_kernel (≙ JAX phase1_pallas) kernel F, with
    ndoto = planes . origin of the tile's first ray. Phase 2: leaf_kernel
    (≙ JAX use_pallas) kernel D over the gathered, dead-zeroed rows
    (max_leaves a multiple of 8); else the chunked plain-torch loop
    (max_leaves a multiple of chunk). There is no `interpret`: the
    tensors' device picks the kernel or its plain twin."""
    R = rays.o.shape[0]
    if R % TILE:
        raise ValueError(f"ray count {R} is not a multiple of {TILE}")
    K = max_leaves
    if leaf_kernel and K % 8:
        raise ValueError(f"leaf_kernel needs max_leaves ({K}) a multiple "
                         "of 8 (K*4 rows in whole 32-row blocks)")
    if not leaf_kernel and (chunk < 1 or K % chunk):
        raise ValueError(f"max_leaves ({K}) must be a multiple of chunk "
                         f"({chunk})")
    T = R // TILE
    o = rays.o.reshape(T, TILE, 3)
    d = rays.d.reshape(T, TILE, 3)
    tile_o = o[:, 0]
    if walk_kernel:
        from tinybvh_tpu_torch.traverse.frustum_walk import (
            collect_tile_leaves_kernel,
        )

        planes = _tile_planes(tile_o, d).contiguous()
        ndoto = _sum3(planes * tile_o[:, None, :]).reshape(T, 1, 4)
        leaves, counts = collect_tile_leaves_kernel(
            bvh8.bounds, bvh8.child, planes, ndoto.contiguous(), K)
        overflow = counts < 0
    elif phase1_flat:
        leaves, overflow = collect_tile_leaves_flat(bvh8, tile_o, d, K,
                                                    pair_cap_factor)
    else:
        leaves, overflow = collect_tile_leaves(
            bvh8, o.amin(dim=1), d, K, pair_cap_factor,
            tile_ohi=o.amax(dim=1))
    if leaf_kernel:
        best_t, best_pk = _resolve_kernel(bvh8, o, d, leaves)
    else:
        best_t, best_pk = _resolve_chunks(bvh8, o, d, leaves, chunk)
    return _finish(bvh8, rays, best_t, best_pk), overflow


def is_occluded_packets(bvh8: BVH8, origin, points,
                        cutoff: float = 1.0 - 1e-3, max_leaves: int = 128,
                        chunk: int = 16, leaf_kernel: bool = False,
                        pair_cap_factor: int = 32):
    """Any-hit occlusion of R segments origin -> points sharing ONE origin
    (≙ JAX is_occluded_packets; shadow rays traced light -> surface so that
    each tile is a coherent shared-origin packet). points in 16x16 tile
    order; directions stay unnormalized so the hit parameter is the
    segment fraction, and cutoff < 1 excludes the surface itself. origin
    and points go to the BVH's device. Returns ((R,) occluded, (T,)
    overflow)."""
    dev = bvh8.bounds.device
    points = torch.as_tensor(points, dtype=torch.float32, device=dev)
    origin = torch.as_tensor(origin, dtype=torch.float32, device=dev)
    d = points - origin[None, :]
    rays = make_rays(origin[None, :].expand_as(d), d)
    hits, overflow = intersect_packets(
        bvh8, rays, max_leaves=max_leaves, chunk=chunk,
        leaf_kernel=leaf_kernel, pair_cap_factor=pair_cap_factor)
    return (hits.prim >= 0) & (hits.t < cutoff), overflow


def intersect_packets_sorted(bvh8: BVH8, rays: Rays, scene_lo, scene_hi,
                             max_leaves: int = 128, chunk: int = 16,
                             leaf_kernel: bool = False,
                             pair_cap_factor: int = 32):
    """Packet tracing for incoherent rays (≙ JAX intersect_packets_sorted):
    coherence-sort into tiles, trace with origin-box culling, scatter the
    hits back. Returns (Hits in input order, (R,) overflow mask of each
    ray's tile)."""
    order, inverse = sort_rays_coherent(rays.o, rays.d, scene_lo, scene_hi)
    hits, overflow = intersect_packets(
        bvh8, rays.take(order), max_leaves=max_leaves, chunk=chunk,
        leaf_kernel=leaf_kernel, pair_cap_factor=pair_cap_factor)
    return hits.take(inverse), torch.repeat_interleave(overflow,
                                                       TILE)[inverse]
