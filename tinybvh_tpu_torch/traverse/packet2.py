"""Packet traversal v2 on PyTorch: frustum cull -> near-to-far fused MT
(≙ tinybvh_tpu/traverse/packet2.py, the main path of BVH.intersect).

Two hand-written CUDA kernels carry the pipeline, each with a plain
PyTorch twin of the same signature beside it:

  kernel A, `cull` (csrc/cull.cu; replaces `_cull_kernel`): the fine
      frustum cull of each tile group's worklist of 128-segment blocks,
      with per-tile survivor keys appended in worklist order;
  kernel B, `mt_fused` (csrc/mt_fused.cu; replaces `_mt_fused_kernel`):
      per 256-ray tile, walk the pre-decoded segment row offsets in
      near-to-far super-blocks and run the triple-product Möller–Trumbore
      with a tile-wide distance-gate early exit.

A wrapper runs the plain twin only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises. `LAUNCHES` counts kernel
launches (never plain-twin calls).

Everything around the kernels (tile frusta, the coarse block tier, the
worklist compaction, block ordering, offset pre-decode, hit assembly,
the escalated packet retrace) is plain torch, as it is XLA in the JAX
package. Not ported yet (raise NotImplementedError): `fused=False`,
`sort=True`, the wavefront retrace, opacity micromaps.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tinybvh_tpu_torch import _build
from tinybvh_tpu_torch.core.rays import Hits, Rays, make_rays
from tinybvh_tpu_torch.core.vecmath import BVH_FAR, cross, norm
from tinybvh_tpu_torch.layouts.mbvh import BVH8
from tinybvh_tpu_torch.traverse.packet import (
    TILE, _morton3, _tile_planes, inverse_permutation, sort_rays_coherent,
)

_I32MAX = 2**31 - 1
_LEAF_BITS = 18          # segment id in the low bits of a cull key
TB = 8                   # tiles per cull group
LANES = 128              # segments per cull block
TRI_BLK = 128            # default MT super-block rows
SPAN = 4                 # leaves per cull segment
SEG_ROWS = 4 * SPAN      # triangles per segment
M_MAX = 8                # span_mult cap (gtab_pad's zero tail covers it)

# tile-descriptor lanes of the (T, 128) cull descriptor rows
_D_POSN = 0      # 12 lanes: max(plane, 0), [p*3+k]
_D_NEGN = 12     # 12 lanes: min(plane, 0)
_D_THR = 24      # 4 lanes: plane thresholds
_D_OLO = 28      # 3 lanes: tile origin-box lo
_D_OHI = 31      # 3 lanes: tile origin-box hi
_D_TCAP = 34     # 1 lane: reach cap (world distance)
_D_LANES = 35

LAUNCHES = {"cull": 0, "mt_fused": 0}


@dataclass
class PacketAux:
    """Per-BVH8 packet tables (≙ the JAX PacketAux; same layout).

    leaf_lo/hi (3, Spad) segment boxes (+-FAR padding); blk_lo/hi
    (3, NBpad) union boxes of 128-segment blocks; gtab_pad (rows, 128)
    triangle rows [G_det|G_u|G_v|G_t] (pack=2: [A 0:48 | B 48:96 |
    pidA 96 | pidB 97]) followed by zero rows (padding leaves and the
    dead-key sentinel segment); center (3,) subtracted from the rows."""

    leaf_lo: torch.Tensor
    leaf_hi: torch.Tensor
    blk_lo: torch.Tensor
    blk_hi: torch.Tensor
    gtab_pad: torch.Tensor
    center: torch.Tensor
    n_leaf_rows: int = 0
    pack: int = 1
    omap_s: int = 0

    @property
    def n_segs(self):
        return -(-self.n_leaf_rows // SPAN)

    @property
    def n_blocks(self):
        return self.leaf_lo.shape[1] // LANES


def build_packet_aux_host(bvh8_host: dict, pack: int = 2,
                          device="cpu") -> PacketAux:
    """Numpy build of the packet tables from the native collapse's host
    dict, then one upload to `device`. Same numpy as the JAX package's
    build_packet_aux_host, so the tables are bit-identical."""
    lt = np.asarray(bvh8_host["leaf_tris"], np.float32)   # (L, 4, 3, 3)
    lp = np.asarray(bvh8_host["leaf_prim"])
    valid = (lp >= 0)[..., None, None]
    lo = np.where(valid, lt, BVH_FAR).min(axis=(1, 2))
    hi = np.where(valid, lt, -BVH_FAR).max(axis=(1, 2))
    center = ((lo.min(axis=0) + hi.max(axis=0)) * 0.5).astype(np.float32)

    L = lt.shape[0]
    lpad = -(-L // (LANES * SPAN)) * (LANES * SPAN)
    lo_lp = np.concatenate(
        [lo, np.full((lpad - L, 3), BVH_FAR, np.float32)], axis=0)
    hi_lp = np.concatenate(
        [hi, np.full((lpad - L, 3), -BVH_FAR, np.float32)], axis=0)
    lo_p = lo_lp.reshape(-1, SPAN, 3).min(axis=1)       # (Spad, 3)
    hi_p = hi_lp.reshape(-1, SPAN, 3).max(axis=1)

    v0 = lt[:, :, 0] - center
    e1 = lt[:, :, 1] - lt[:, :, 0]
    e2 = lt[:, :, 2] - lt[:, :, 0]
    n = np.cross(e1, e2)
    k = np.sum(n * v0, axis=-1, keepdims=True)
    tri_ok = (lp >= 0).reshape(4 * L, 1)

    lseg = -(-L // SPAN) * SPAN
    rows = (4 * lseg) // pack + 2 * M_MAX * (SEG_ROWS // pack)
    gtab_pad = np.zeros((rows, 128), np.float32)

    def put(col, arr, width=3):
        a = np.where(tri_ok, arr.reshape(4 * L, width), 0.0)
        if pack == 2:
            gtab_pad[:2 * L, col:col + width] = a[0::2]
            gtab_pad[:2 * L, 48 + col:48 + col + width] = a[1::2]
        else:
            gtab_pad[:4 * L, col:col + width] = a

    put(0, n)                      # G_det = [n, 0...]
    put(12, -np.cross(v0, e2))     # G_u = [-(v0 x e2), -e2, 0...]
    put(15, -e2)
    put(24, np.cross(v0, e1))      # G_v = [(v0 x e1), e1, 0...]
    put(27, e1)
    put(42, -n)                    # G_t = [0, 0, -n, n.v0, 0, 0]
    put(45, k, width=1)

    nb = lpad // (LANES * SPAN)
    blo = lo_p.reshape(nb, LANES, 3).min(axis=1)
    bhi = hi_p.reshape(nb, LANES, 3).max(axis=1)
    nbpad = -(-nb // LANES) * LANES
    blo = np.concatenate(
        [blo, np.full((nbpad - nb, 3), BVH_FAR, np.float32)], axis=0)
    bhi = np.concatenate(
        [bhi, np.full((nbpad - nb, 3), -BVH_FAR, np.float32)], axis=0)
    # global prim id, bit-cast into an f32 lane
    pidf = lp.reshape(4 * L, 1).astype(np.int32).view(np.float32)
    if pack == 2:
        gtab_pad[:2 * L, 96:97] = pidf[0::2]
        gtab_pad[:2 * L, 97:98] = pidf[1::2]
    else:
        gtab_pad[:4 * L, 48:49] = pidf

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return PacketAux(leaf_lo=up(lo_p.T), leaf_hi=up(hi_p.T),
                     blk_lo=up(blo.T), blk_hi=up(bhi.T),
                     gtab_pad=up(gtab_pad), center=up(center),
                     n_leaf_rows=L, pack=pack)


def _on_cuda(name, *tensors) -> bool:
    """True when every tensor lies on one CUDA device, False when all lie
    on the CPU; raises on a mix."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{name}: tensors on several devices {devs}")
    dev = devs.pop()
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {dev}")


def _check(name, t, dtype, shape):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


# --------------------------------------------------------------------------
# kernel A: fine frustum cull
# --------------------------------------------------------------------------

_CULL_GROUPS = 16   # plain twin: tile groups per chunk (bounds temporaries)


def _cull_plain(nblk, wl, desc, llo, lhi, n_leaves: int, k_cap: int,
                leaf_bits: int):
    """Plain twin of kernel A. nblk (G,) i32 live worklist lengths (<=
    max_blocks); wl (G, max_blocks) i32 block ids; desc (G*TB, 128) f32
    tile descriptors (_D_* lanes); llo/lhi (3, Spad) f32 segment boxes.
    Returns keys (G*TB, k_cap) i32 — each tile's survivors in worklist
    order, I32MAX padded — and cnt (G*TB,) i32 true survivor counts
    (past k_cap too). Separate multiplies and adds in the JAX kernel's
    order, as the CUDA kernel rounds them."""
    G = wl.shape[0]
    dev = desc.device
    keys = torch.full((G * TB, k_cap + 1), _I32MAX, dtype=torch.int32,
                      device=dev)
    cnt = torch.zeros(G * TB, dtype=torch.int32, device=dev)
    lanes = torch.arange(LANES, dtype=torch.int32, device=dev)
    dsc = desc.view(G, TB, 128)
    for g0 in range(0, G, _CULL_GROUPS):
        g1 = min(G, g0 + _CULL_GROUPS)
        nb_c = nblk[g0:g1]
        J = int(nb_c.max())
        if J == 0:
            continue
        bvalid = (torch.arange(J, device=dev)[None, :] < nb_c[:, None])
        blk = torch.where(bvalid, wl[g0:g1, :J], 0)
        seg = blk[..., None] * LANES + lanes                 # (g, J, 128)
        lo = llo[:, seg][:, :, None]                         # (3,g,1,J,128)
        hi = lhi[:, seg][:, :, None]
        d = dsc[g0:g1][..., None, None]                      # (g,TB,128,1,1)
        outside = None
        for p in range(4):
            dist = -d[:, :, _D_THR + p]
            for k in range(3):
                q = p * 3 + k
                dist = (dist + d[:, :, _D_POSN + q] * hi[k]
                        + d[:, :, _D_NEGN + q] * lo[k])
            o_p = dist < 0.0
            outside = o_p if outside is None else outside | o_p
        passed = ~outside & ((seg < n_leaves) & bvalid[..., None])[:, None]
        # conservative origin-box -> segment-box distance
        g2 = None
        for k in range(3):
            gk = torch.maximum(d[:, :, _D_OLO + k] - hi[k],
                               lo[k] - d[:, :, _D_OHI + k])
            gk = torch.clamp(gk, min=0.0)
            g2 = gk * gk if g2 is None else g2 + gk * gk
        lb = torch.sqrt(g2)
        passed &= lb < d[:, :, _D_TCAP]
        key = (((lb.view(torch.int32) >> leaf_bits) << leaf_bits)
               | seg[:, None])
        rows = (g1 - g0) * TB
        pf = passed.reshape(rows, J * LANES)
        pos = torch.cumsum(pf, dim=1, dtype=torch.int32) - 1
        ok = pf & (pos < k_cap)
        keys[g0 * TB:g1 * TB].scatter_(
            1, torch.where(ok, pos, k_cap).long(),
            torch.where(ok, key.reshape(rows, J * LANES), _I32MAX))
        cnt[g0 * TB:g1 * TB] = pf.sum(dim=1, dtype=torch.int32)
    return keys[:, :k_cap].contiguous(), cnt


def _cull_cuda(nblk, wl, desc, llo, lhi, n_leaves: int, k_cap: int,
               leaf_bits: int):
    """Kernel A launch (csrc/cull.cu); same contract as _cull_plain."""
    G, max_blocks = wl.shape
    spad = llo.shape[1]
    _check("cull nblk", nblk, torch.int32, (G,))
    _check("cull wl", wl, torch.int32, (G, max_blocks))
    _check("cull desc", desc, torch.float32, (G * TB, 128))
    _check("cull llo", llo, torch.float32, (3, spad))
    _check("cull lhi", lhi, torch.float32, (3, spad))
    if spad % LANES or k_cap < 1 or not 0 < leaf_bits < 31:
        raise ValueError("cull: bad spad/k_cap/leaf_bits")
    keys = torch.empty((G * TB, k_cap), dtype=torch.int32,
                       device=desc.device)
    cnt = torch.empty((G * TB,), dtype=torch.int32, device=desc.device)
    if G == 0:
        return keys, cnt
    lib = _build.kernels()
    stream = torch.cuda.current_stream(desc.device).cuda_stream
    err = lib.tbvh_cull(nblk.data_ptr(), wl.data_ptr(), desc.data_ptr(),
                        llo.data_ptr(), lhi.data_ptr(), keys.data_ptr(),
                        cnt.data_ptr(), G, max_blocks, spad, n_leaves,
                        k_cap, leaf_bits, stream)
    _build.check(err, "tbvh_cull")
    LAUNCHES["cull"] += 1
    return keys, cnt


def cull(nblk, wl, desc, llo, lhi, n_leaves: int, k_cap: int,
         leaf_bits: int = _LEAF_BITS):
    """Kernel A on CUDA tensors, its plain twin on CPU tensors."""
    if _on_cuda("cull", nblk, wl, desc, llo, lhi):
        return _cull_cuda(nblk, wl, desc, llo, lhi, n_leaves, k_cap,
                          leaf_bits)
    return _cull_plain(nblk, wl, desc, llo, lhi, n_leaves, k_cap, leaf_bits)


def _full3(n, val, dev):
    return torch.full((3, n), val, dtype=torch.float32, device=dev)


def cull_tiles(aux: PacketAux, posn, negn, thresh, olo, ohi, tcap=None,
               k_cap: int = 256, max_blocks: int = 128,
               leaf_bits: int = _LEAF_BITS, span_mult: int = 1):
    """Two-level frustum cull (≙ JAX cull_tiles): per tile the (lb|segment)
    keys of every segment whose union box meets the tile frustum (live
    keys first, I32MAX padded; order inside a tile is free) and the
    survivor counts. Tier 1 tests 128-segment block boxes per group of TB
    tiles (torch ops); a cumsum/scatter-amax compacts surviving block ids
    into per-group worklists; tier 2 is kernel A. Groups whose worklist
    overflows max_blocks report count = k_cap+1 on all their tiles.

    posn/negn (T, 4, 3), thresh (T, 4), olo/ohi (T, 3), tcap (T,).
    span_mult: each key covers span_mult consecutive segments (their
    union box)."""
    if not (1 <= span_mult <= M_MAX and 128 % span_mult == 0):
        raise ValueError(f"span_mult must divide 128 and be <= {M_MAX}")
    dev = posn.device
    T = posn.shape[0]
    if tcap is None:
        tcap = torch.full((T,), BVH_FAR, dtype=torch.float32, device=dev)
    pad = (-T) % TB
    if pad:
        # always-culling tiles: zero planes, positive threshold
        def z(*s):
            return torch.zeros(s, dtype=torch.float32, device=dev)
        posn = torch.cat([posn, z(pad, 4, 3)])
        negn = torch.cat([negn, z(pad, 4, 3)])
        thresh = torch.cat([thresh, z(pad, 4) + 1.0])
        olo = torch.cat([olo, z(pad, 3)])
        ohi = torch.cat([ohi, z(pad, 3)])
        tcap = torch.cat([tcap, z(pad)])
    tp = posn.shape[0]
    G = tp // TB
    if span_mult == 1:
        llo, lhi = aux.leaf_lo, aux.leaf_hi
        blo_t, bhi_t = aux.blk_lo, aux.blk_hi
        n_segs = aux.n_segs
        nb = aux.n_blocks
    else:
        m = span_mult
        Sf = aux.leaf_lo.shape[1]
        llo = aux.leaf_lo.reshape(3, Sf // m, m).amin(dim=2)
        lhi = aux.leaf_hi.reshape(3, Sf // m, m).amax(dim=2)
        n_segs = -(-aux.n_segs // m)
        padw = (-llo.shape[1]) % LANES
        llo = torch.cat([llo, _full3(padw, BVH_FAR, dev)], dim=1)
        lhi = torch.cat([lhi, _full3(padw, -BVH_FAR, dev)], dim=1)
        nbm = llo.shape[1] // LANES
        blo_t = llo.reshape(3, nbm, LANES).amin(dim=2)
        bhi_t = lhi.reshape(3, nbm, LANES).amax(dim=2)
        nbp = -(-nbm // LANES) * LANES
        blo_t = torch.cat([blo_t, _full3(nbp - nbm, BVH_FAR, dev)], dim=1)
        bhi_t = torch.cat([bhi_t, _full3(nbp - nbm, -BVH_FAR, dev)], dim=1)
        nb = -(-n_segs // LANES)
    nbpad = blo_t.shape[1]

    desc = torch.cat([
        posn.reshape(tp, 12), negn.reshape(tp, 12), thresh, olo, ohi,
        tcap.reshape(tp, 1),
        torch.zeros((tp, 128 - _D_LANES), dtype=torch.float32, device=dev),
    ], dim=1).contiguous()

    # tier 1: coarse block mask per group (explicit broadcasts, no einsum)
    dist = -thresh[:, :, None]                             # (tp, 4, 1)
    for k in range(3):
        dist = (dist + posn[:, :, k, None] * bhi_t[None, k, :]
                + negn[:, :, k, None] * blo_t[None, k, :])
    inb = torch.arange(nbpad, device=dev) < nb
    blkmask = ((~(dist < 0.0).any(dim=1)) & inb).reshape(
        G, TB, nbpad).any(dim=1)

    # worklist compaction: surviving block ids per group, in block order
    # (the JAX .at[].max scatter; ranks past the depth pile into the last
    # slot, as there — such groups are flagged below)
    mi = blkmask.to(torch.int32)
    rank = torch.cumsum(mi, dim=1, dtype=torch.int32) - mi
    blk_ids = torch.arange(nbpad, dtype=torch.int32,
                           device=dev).expand(G, nbpad)
    wl = torch.full((G, max_blocks + 1), -1, dtype=torch.int32, device=dev)
    wl.scatter_reduce_(
        1, torch.where(blkmask, torch.clamp(rank, max=max_blocks - 1),
                       max_blocks).long(),
        torch.where(blkmask, blk_ids, -1), reduce="amax")
    wl = wl[:, :max_blocks].contiguous()
    n_blk_g = mi.sum(dim=1, dtype=torch.int32)
    nblk = torch.clamp(n_blk_g, max=max_blocks).contiguous()

    keys, cnt = cull(nblk, wl, desc, llo.contiguous(), lhi.contiguous(),
                     n_segs, k_cap, leaf_bits)
    over = torch.repeat_interleave(n_blk_g > max_blocks, TB)
    counts = torch.where(over, k_cap + 1, cnt)
    return keys[:T], counts[:T]


# --------------------------------------------------------------------------
# kernel B: fused gather + triple-product Möller–Trumbore
# --------------------------------------------------------------------------

_MT_TILES = 64   # plain twin: tiles per chunk (bounds temporaries)


def _mt_half(g, f, base, pcol, live):
    """MT of the triangles at lanes [base, base+48) of rows g (n, rows,
    128) against feature rows f (n, 12, 256): -> (tt, u, v, prim), each
    (n, rows, 256), tt = BVH_FAR where there is no hit. Separate
    multiplies and adds in lane order, as kernel B rounds them."""
    acc = []
    for q in range(4):
        a = torch.zeros((g.shape[0], g.shape[1], f.shape[2]),
                        dtype=torch.float32, device=g.device)
        for kk in range(12):
            a = a + g[:, :, base + 12 * q + kk, None] * f[:, None, kk, :]
        acc.append(a)
    det, up, vp, tp = acc
    s = torch.where(det >= 0, 1.0, -1.0)
    ad = det * s
    us = up * s
    vs = vp * s
    ts = tp * s
    hit = (us >= 0) & (vs >= 0) & (us + vs <= ad) & (ts > 0) & (ad > 0)
    inv_ad = 1.0 / torch.where(ad > 0, ad, 1.0)
    tt = torch.where(hit & live[..., None], ts * inv_ad, BVH_FAR)
    prim = g[:, :, pcol].contiguous().view(torch.int32)[..., None]
    return tt, us * inv_ad, vs * inv_ad, prim.expand_as(tt)


def _mt_fused_plain(offs, counts, lbg, tmax, ff, t0, gtab, k_cap: int,
                    tri_blk: int, rps: int, pack: int, any_hit: bool):
    """Plain twin of kernel B. offs (T, k_cap) i32 pre-decoded gtab row
    offsets (each key covers rps rows); counts (T,) i32 live keys; lbg
    (T, nb) f32 super-block gates; tmax (T,) f32 any-hit cutoff; ff
    (T, 12, 256) f32 ray features [d, o x d, o, 1, 0, 0]; t0 (T, 256)
    f32 initial t; gtab (rows, 128) f32. Returns (t, idx, u, v, prim),
    each (T, 256): idx = super_block * tri_blk + row of the winner."""
    T = offs.shape[0]
    nb = lbg.shape[1]
    kpb = tri_blk // rps
    dev = offs.device
    t_out = t0.clone()
    i_out = torch.zeros((T, TILE), dtype=torch.int32, device=dev)
    u_out = torch.zeros((T, TILE), dtype=torch.float32, device=dev)
    v_out = torch.zeros((T, TILE), dtype=torch.float32, device=dev)
    p_out = torch.full((T, TILE), -1, dtype=torch.int32, device=dev)
    rows = torch.arange(tri_blk, device=dev)
    for c0 in range(0, T, _MT_TILES):
        c1 = min(T, c0 + _MT_TILES)
        cnt = torch.clamp(counts[c0:c1], max=k_cap)
        nsb = (cnt + kpb - 1) // kpb
        active = nsb > 0
        sb = 0
        while bool(active.any()):
            a = torch.nonzero(active)[:, 0]
            ta = a + c0
            # gate with the tile's t_far before this block (NaN passes)
            t_far = t_out[ta].amax(dim=1)
            gate_n = lbg[ta, min(sb + 1, nb - 1)]
            nxt = (sb + 1 < nsb[a]) & ~(gate_n > t_far)
            if any_hit:
                nxt &= t_far >= tmax[ta]
            addr = offs[ta][:, sb * kpb + rows // rps] + rows % rps
            g = gtab[addr]                                  # (n, rows, 128)
            live = (sb * tri_blk + rows)[None, :] < (cnt[a] * rps)[:, None]
            f = ff[ta]
            tt, uu, vv, pp = _mt_half(g, f, 0, 96 if pack == 2 else 48,
                                      live)
            if pack == 2:
                ttB, uB, vB, pB = _mt_half(g, f, 48, 97, live)
                isB = ttB < tt
                tt = torch.where(isB, ttB, tt)
                uu = torch.where(isB, uB, uu)
                vv = torch.where(isB, vB, vv)
                pp = torch.where(isB, pB, pp)
            m, am = tt.min(dim=1)                           # first argmin
            better = m < t_out[ta]
            pick = am[:, None]
            t_out[ta] = torch.where(better, m, t_out[ta])
            i_out[ta] = torch.where(better, (sb * tri_blk + am).to(
                torch.int32), i_out[ta])
            u_out[ta] = torch.where(better, uu.gather(1, pick)[:, 0],
                                    u_out[ta])
            v_out[ta] = torch.where(better, vv.gather(1, pick)[:, 0],
                                    v_out[ta])
            p_out[ta] = torch.where(better, pp.gather(1, pick)[:, 0],
                                    p_out[ta])
            active[a] = nxt
            sb += 1
    return t_out, i_out, u_out, v_out, p_out


def _mt_fused_cuda(offs, counts, lbg, tmax, ff, t0, gtab, k_cap: int,
                   tri_blk: int, rps: int, pack: int, any_hit: bool):
    """Kernel B launch (csrc/mt_fused.cu); same contract as the plain
    twin."""
    T = offs.shape[0]
    nb = lbg.shape[1]
    _check("mt offs", offs, torch.int32, (T, k_cap))
    _check("mt counts", counts, torch.int32, (T,))
    _check("mt lbg", lbg, torch.float32, (T, nb))
    _check("mt tmax", tmax, torch.float32, (T,))
    _check("mt ff", ff, torch.float32, (T, 12, TILE))
    _check("mt t0", t0, torch.float32, (T, TILE))
    _check("mt gtab", gtab, torch.float32, (gtab.shape[0], 128))
    if pack not in (1, 2):
        raise ValueError(f"mt_fused: pack must be 1 or 2, got {pack}")
    outs = [torch.empty((T, TILE), dtype=dt, device=offs.device)
            for dt in (torch.float32, torch.int32, torch.float32,
                       torch.float32, torch.int32)]
    if T == 0:
        return tuple(outs)
    lib = _build.kernels()
    stream = torch.cuda.current_stream(offs.device).cuda_stream
    ins = (offs, counts, lbg, tmax, ff, t0, gtab)
    err = lib.tbvh_mt_fused(*[x.data_ptr() for x in ins + tuple(outs)],
                            T, k_cap, nb, tri_blk, rps, pack, int(any_hit),
                            stream)
    _build.check(err, "tbvh_mt_fused")
    LAUNCHES["mt_fused"] += 1
    return tuple(outs)


def mt_fused(offs, counts, lbg, tmax, ff, t0, gtab, k_cap: int,
             tri_blk: int, rps: int, pack: int, any_hit: bool):
    """Kernel B on CUDA tensors, its plain twin on CPU tensors."""
    args = (offs, counts, lbg, tmax, ff, t0, gtab, k_cap, tri_blk, rps,
            pack, any_hit)
    if _on_cuda("mt_fused", offs, counts, lbg, tmax, ff, t0, gtab):
        return _mt_fused_cuda(*args)
    return _mt_fused_plain(*args)


def mt_resolve_fused(offs, counts, lbg, tmax, o_t, d_t, gtab_flat,
                     k_cap: int, omap_s: int = 0, any_hit: bool = False,
                     tri_blk: int = TRI_BLK, t0=None, pack: int = 1,
                     rps: int | None = None):
    """≙ JAX mt_resolve_fused. offs (T, k_cap) i32 pre-decoded gtab row
    offsets (each key covers rps rows; dead keys -> the zero sentinel
    segment); counts (T,) i32; lbg (T, 1, nb) f32 super-block gates;
    tmax (T, 1) f32; o_t/d_t (T, 3, 256) centered origins/directions;
    gtab_flat (rows, 128) f32 with `pack` triangles per row; t0 optional
    (T, 256) initial t (default: tmax). Returns (t, idx, u, v, prim),
    each (T, 256); prim = -1 is the miss signal."""
    if omap_s:
        raise NotImplementedError(
            "opacity micromaps are not ported yet (ROADMAP queue 1, "
            "item 5c)")
    T = offs.shape[0]
    if rps is None:
        rps = SEG_ROWS // pack
    if not (0 < rps <= tri_blk and tri_blk % rps == 0
            and k_cap % (tri_blk // rps) == 0):
        raise ValueError(f"mt_resolve_fused: need rps <= tri_blk, rps | "
                         f"tri_blk and kpb | k_cap (rps={rps}, "
                         f"tri_blk={tri_blk}, k_cap={k_cap})")
    tmax = tmax.reshape(T).contiguous()
    if t0 is None:
        t0 = tmax[:, None].expand(T, TILE)
    ones = torch.ones((T, 1, TILE), dtype=torch.float32, device=o_t.device)
    ff = torch.cat([d_t, cross(o_t, d_t, dim=1), o_t, ones,
                    torch.zeros_like(ones), torch.zeros_like(ones)], dim=1)
    return mt_fused(offs.contiguous(), counts.to(torch.int32).contiguous(),
                    lbg.reshape(T, -1).contiguous(), tmax, ff.contiguous(),
                    t0.contiguous(), gtab_flat, k_cap, tri_blk, rps, pack,
                    any_hit)


# --------------------------------------------------------------------------
# full pipeline
# --------------------------------------------------------------------------

def _tile_frusta(aux: PacketAux, rays: Rays, t_max):
    """Per-tile frustum descriptors for the cull. t_max: scalar or (R,).
    Returns (posn, negn, thresh, olo, ohi, tcap, dlen, tmax_rt, t0); t0
    (T, 256) is each ray's initial MT bound min(t_max, scene-box exit t)
    with a small conservative margin."""
    R = rays.o.shape[0]
    T = R // TILE
    o = rays.o.reshape(T, TILE, 3)
    d = rays.d.reshape(T, TILE, 3)
    olo = o.amin(dim=1)
    ohi = o.amax(dim=1)
    planes = _tile_planes(o[:, 0], d)
    posn = torch.clamp(planes, min=0.0)
    negn = torch.clamp(planes, max=0.0)
    thresh = ((posn * olo[:, None, :]).sum(-1)
              + (negn * ohi[:, None, :]).sum(-1))
    # reach cap: world distance every ray's own bound allows
    dlen = norm(d)                                          # (T, 256)
    tmax_rt = torch.broadcast_to(
        torch.as_tensor(t_max, dtype=torch.float32, device=o.device),
        (R,)).reshape(T, TILE)
    root_lo = aux.blk_lo.amin(dim=1)
    root_hi = aux.blk_hi.amax(dim=1)
    rdr = rays.rd.reshape(T, TILE, 3)
    tfar_ax = torch.maximum((root_lo - o) * rdr, (root_hi - o) * rdr)
    tfar_ax = torch.where(torch.isnan(tfar_ax), BVH_FAR, tfar_ax)
    t_exit = torch.clamp(tfar_ax.amin(dim=-1), min=0.0)
    reach = torch.minimum(tmax_rt, t_exit) * dlen
    tcap = reach.amax(dim=1)
    tcap = torch.where(torch.isfinite(tcap), tcap * 1.001 + 1e-4, BVH_FAR)
    t0 = torch.minimum(tmax_rt, t_exit * 1.0005 + 1e-4)
    return posn, negn, thresh, olo, ohi, tcap, dlen, tmax_rt, t0


def _decode_keys(keys, leaf_bits: int = _LEAF_BITS):
    lb = ((keys >> leaf_bits) << leaf_bits).view(torch.float32)
    return lb, keys & ((1 << leaf_bits) - 1)


def _check_modes(retrace, fused=True, sort=False):
    if not fused:
        raise NotImplementedError(
            "fused=False (the gathered-layout kernel C) is not ported yet "
            "(ROADMAP queue 1 item 5b, queue 2 kernel C)")
    if sort:
        raise NotImplementedError(
            "sort=True (full key sort) is not ported yet (ROADMAP queue 1, "
            "item 5e)")
    if retrace not in ("packet", False):
        raise NotImplementedError(
            f"retrace={retrace!r}: the wavefront retrace is not ported yet "
            "(ROADMAP queue 1, item 5a)")


def intersect_packets2(bvh8: BVH8, aux: PacketAux, rays: Rays,
                       max_leaves: int = 256, t_max=BVH_FAR,
                       retrace="packet", sort: bool = False,
                       fused: bool = True, max_blocks: int = 128,
                       any_hit: bool = False, tri_blk: int = 256,
                       retrace_ml: int = 0, retrace_blocks: int = 0,
                       span_mult: int = 1):
    """Packet trace v2 (≙ JAX intersect_packets2, fused path). Rays are
    (T*256,) grouped into tiles sharing an origin box. Returns (Hits,
    (T,) overflow mask).

    retrace: "packet" re-traces overflowed tiles in an escalated second
    pass (retrace_ml keys, default 4*max_leaves; retrace_blocks worklist
    depth) with t_max = 0 on every other tile, and the mask then flags
    only RESIDUAL overflow; False flags the approximate tiles.
    span_mult: each cull key covers span_mult segments."""
    _check_modes(retrace, fused, sort)
    K = max_leaves
    if K % (SPAN * span_mult) or K < SPAN * span_mult:
        raise ValueError("max_leaves must be a multiple of 4*span_mult")
    Kk = K // (SPAN * span_mult)        # cull-key (segment) budget
    rps = (SEG_ROWS // aux.pack) * span_mult
    kpb = max(1, tri_blk // rps)
    while Kk % kpb:
        kpb //= 2
    tb_eff = kpb * rps
    R = rays.o.shape[0]
    if R % TILE:
        raise ValueError(f"ray count {R} is not a multiple of {TILE}")
    T = R // TILE
    o = rays.o.reshape(T, TILE, 3)
    d = rays.d.reshape(T, TILE, 3)
    (posn, negn, thresh, olo, ohi, tcap, dlen,
     tmax_rt, t0_rt) = _tile_frusta(aux, rays, t_max)

    # segment ids must fit the key's low bits (scenes beyond 2^18 segments
    # trade distance-ordering granularity for id range)
    leaf_bits = max(_LEAF_BITS,
                    (aux.leaf_lo.shape[1] // span_mult - 1).bit_length())
    keys, counts = cull_tiles(aux, posn, negn, thresh, olo, ohi, tcap,
                              k_cap=Kk, max_blocks=max_blocks,
                              leaf_bits=leaf_bits, span_mult=span_mult)
    overflow = counts > Kk

    # near-to-far super-block order: sort each tile's Kk/kpb blocks by
    # their least entry distance, so the kernel's gate early exit is
    # correct mid-list
    nbk = Kk // kpb
    lb0, _ = _decode_keys(keys, leaf_bits)
    lbmin = torch.where(keys != _I32MAX, lb0, BVH_FAR).reshape(
        T, nbk, kpb).amin(dim=2)
    order = torch.argsort(lbmin, dim=1, stable=True)
    keys_s = torch.take_along_dim(keys.reshape(T, nbk, kpb),
                                  order[..., None], dim=1).reshape(T, Kk)
    lb, segs = _decode_keys(keys_s, leaf_bits)
    live = keys_s != _I32MAX

    # gates in ray-t units: entry distance / max |d| over the tile; dead
    # blocks gate at +inf, non-finite gates degrade to 0 (always pass)
    maxd = torch.clamp(dlen.amax(dim=1), min=1e-20)
    blk_live = live.reshape(T, nbk, kpb).any(dim=2)
    gate = (torch.where(live, lb, BVH_FAR).reshape(T, nbk, kpb).amin(dim=2)
            / maxd[:, None])
    gate = torch.where(torch.isfinite(gate), gate, 0.0)
    lbg = torch.where(blk_live, gate, float("inf")).reshape(T, 1, nbk)

    o_c = (o - aux.center).permute(0, 2, 1)              # (T, 3, 256)
    d_t = d.permute(0, 2, 1)
    tmax = tmax_rt.amax(dim=1).reshape(T, 1)
    tmax_r = tmax_rt.reshape(R)
    # the block reorder scatters live keys out of prefix order: count
    # covers every live block (dead keys inside are masked or hit the
    # zero sentinel segment)
    n_live_blk = blk_live.sum(dim=1, dtype=torch.int32)
    cnt_k = torch.where(torch.clamp(counts, max=Kk) > 0, n_live_blk * kpb, 0)
    # pre-decoded row offsets; dead keys -> the all-zero sentinel segment
    sent_seg = -(-aux.n_segs // span_mult)
    offs = (torch.where(live, torch.clamp(segs, max=sent_seg), sent_seg)
            * rps).to(torch.int32)
    # any-hit keeps the scalar cutoff init: its early stop compares t_far
    # against the cutoff
    best_t, _, ku, kv, kp = mt_resolve_fused(
        offs, cnt_k, lbg, tmax, o_c, d_t, aux.gtab_pad, k_cap=Kk,
        omap_s=aux.omap_s, any_hit=any_hit, tri_blk=tb_eff,
        t0=None if any_hit else t0_rt, pack=aux.pack, rps=rps)
    # misses settle at their exit-t init with prim = -1: prim, not t, is
    # the miss signal
    okf = ((kp >= 0) & (best_t < tmax_r.reshape(T, TILE))).reshape(-1)
    hits = Hits(
        t=torch.where(okf, best_t.reshape(-1), BVH_FAR),
        u=torch.where(okf, ku.reshape(-1), 0.0),
        v=torch.where(okf, kv.reshape(-1), 0.0),
        prim=torch.where(okf, kp.reshape(-1), -1),
        inst=torch.full((R,), -1, dtype=torch.int32, device=o.device),
    )

    if retrace == "packet" and bool(overflow.any()):
        ov_ray = torch.repeat_interleave(overflow, TILE)
        h2, ov2 = intersect_packets2(
            bvh8, aux, rays, max_leaves=retrace_ml or 4 * max_leaves,
            t_max=torch.where(ov_ray, tmax_r, 0.0), retrace=False,
            max_blocks=retrace_blocks or max_blocks, any_hit=any_hit,
            tri_blk=tri_blk, span_mult=span_mult)
        hits = Hits(t=torch.where(ov_ray, h2.t, hits.t),
                    u=torch.where(ov_ray, h2.u, hits.u),
                    v=torch.where(ov_ray, h2.v, hits.v),
                    prim=torch.where(ov_ray, h2.prim, hits.prim),
                    inst=hits.inst)
        # only tiles whose escalated budget also overflowed stay flagged
        overflow = overflow & ov2
    return hits, overflow


def intersect_packets2_sorted(bvh8: BVH8, aux: PacketAux, rays: Rays,
                              scene_lo, scene_hi, max_leaves: int = 256,
                              retrace="packet", any_hit: bool = False,
                              t_max_static: float = BVH_FAR,
                              max_blocks: int = 128, retrace_ml: int = 0,
                              retrace_blocks: int = 0, tri_blk: int = 256,
                              span_mult: int = 1):
    """Packet trace for incoherent rays: coherence-sort into tiles, trace,
    scatter back. Returns (Hits in input order, (R,) overflow mask)."""
    order, inverse = sort_rays_coherent(rays.o, rays.d, scene_lo, scene_hi)
    hits, overflow = intersect_packets2(
        bvh8, aux, rays.take(order), max_leaves=max_leaves,
        retrace=retrace, any_hit=any_hit, t_max=t_max_static,
        max_blocks=max_blocks, retrace_ml=retrace_ml,
        retrace_blocks=retrace_blocks, tri_blk=tri_blk, span_mult=span_mult)
    return hits.take(inverse), torch.repeat_interleave(overflow,
                                                       TILE)[inverse]


def is_occluded_packets2(bvh8: BVH8, aux: PacketAux, origin, points,
                         cutoff: float = 1.0 - 1e-3, max_leaves: int = 256,
                         retrace="packet", max_blocks: int = 128,
                         retrace_ml: int = 0, retrace_blocks: int = 0,
                         tri_blk: int = 256, span_mult: int = 1):
    """Any-hit occlusion of segments origin -> points sharing ONE origin,
    points in tile order (≙ IsOccluded, tiny_bvh.h:3382-3453). t is the
    segment fraction. Returns ((R,) occluded, (T,) overflow)."""
    d = points - origin[None, :]
    rays = make_rays(origin[None, :].expand_as(d), d)
    hits, overflow = intersect_packets2(
        bvh8, aux, rays, max_leaves=max_leaves, t_max=cutoff,
        retrace=retrace, max_blocks=max_blocks, any_hit=True,
        retrace_ml=retrace_ml, retrace_blocks=retrace_blocks,
        tri_blk=tri_blk, span_mult=span_mult)
    return (hits.prim >= 0) & (hits.t < cutoff), overflow


def is_occluded_packets2_sorted(bvh8: BVH8, aux: PacketAux, origin, points,
                                cutoff: float = 1.0 - 1e-3,
                                max_leaves: int = 256, retrace="packet",
                                max_blocks: int = 128, retrace_ml: int = 0,
                                retrace_blocks: int = 0, tri_blk: int = 256,
                                span_mult: int = 1):
    """is_occluded_packets2 with bundles regrouped by quantized-direction
    morton order: for a shared origin, direction order is frustum
    tightness. Returns ((R,) occluded, (R,) overflow) in input order."""
    d = points - origin[None, :]
    return occluded_direction_sorted(
        bvh8, aux, make_rays(origin[None, :].expand_as(d), d), cutoff,
        max_leaves=max_leaves, retrace=retrace, max_blocks=max_blocks,
        retrace_ml=retrace_ml, retrace_blocks=retrace_blocks,
        tri_blk=tri_blk, span_mult=span_mult)


def occluded_direction_sorted(bvh8: BVH8, aux: PacketAux, rays: Rays,
                              cutoff: float, **kw):
    """Any hit in (0, cutoff) for rays sharing one origin, bundled by
    quantized-direction morton order. Returns ((R,) occluded, (R,)
    overflow) in input order; kw as intersect_packets2."""
    d = rays.d
    dn = d / torch.clamp(norm(d, keepdim=True), min=1e-20)
    q = torch.clamp(((dn + 1.0) * 0.5 * 1024.0).to(torch.int32), 0, 1023)
    order = torch.argsort(_morton3(q), stable=True)
    inverse = inverse_permutation(order)
    hits, overflow = intersect_packets2(bvh8, aux, rays.take(order),
                                        t_max=cutoff, any_hit=True, **kw)
    occ = (hits.prim >= 0) & (hits.t < cutoff)
    return occ[inverse], torch.repeat_interleave(overflow, TILE)[inverse]
