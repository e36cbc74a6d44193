"""LBVH: Morton-code radix-tree builder on the BVH's device, in plain
torch (≙ tinybvh_tpu/builders/lbvh.py, step for step).

The fast builder for dynamic geometry: a parallel binary radix tree over
sorted Morton codes (quality below binned SAH). The JAX package leaves
it to XLA, so here it is plain torch ops on the triangles' device, with
no host sync. The tree is the Cartesian tree (min at the root) of the
adjacent prefix deltas D[0..N-2] of the sorted keys; every internal
node's leaf range and parent follow from its two nearest-smaller values
(ANSV), found by 65-channel cumulative scans (the augmented deltas take
the values 0..64):

  a[i] = nearest j < i with D[j] <= D[i]   (channel cummax, exclusive)
  b[i] = nearest j > i with D[j] <  D[i]   (reverse channel cummin)
  range  = leaves [a+1, b]   (sentinels -1 / N-1)
  parent = the deeper of splits a, b (larger D; tie -> b)
  children = the parent pointers inverted by two scatter-max

Internal boxes come from a sparse table of range minima / maxima (one
gather per bound). Canonical BVH2 layout: node 0 the root, node 1
reserved, internal radix node i's children at the pair (2 + 2i, 3 + 2i).

Torch has no comparison or shift for uint32, so the Morton keys
(core/vecmath.py morton_encode_3d, uint32 as in JAX) are sorted and
compared as int64: they are under 2^30, so the order is the same. The
65-channel tables are int32, as JAX's, and freed as the build goes."""

from __future__ import annotations

import numpy as np
import torch

from tinybvh_tpu_torch.core.rays import default_device
from tinybvh_tpu_torch.core.vecmath import morton_encode_3d
from tinybvh_tpu_torch.layouts.bvh2 import BVH2

# augmented prefix-delta values: 0..31 (code prefix) and 33..64 (equal
# codes, index prefix) -> 65 scan channels
_N_CHAN = 65
_BIG = 2**30


def _bit_length(x):
    """Per-element bit length of non-negative int64 values below 2^32
    (0 -> 0), by the same halving steps as JAX's _bit_length_u32."""
    n = torch.zeros_like(x)
    v = x
    for shift in (16, 8, 4, 2, 1):
        big = v >= (1 << shift)
        n = n + torch.where(big, shift, 0)
        v = torch.where(big, v >> shift, v)
    return n + (x > 0).long()


def _as_tris(tris, device):
    """(N, 3, 3) float32 triangles on `device`; a tensor keeps its own
    device when `device` is None."""
    if isinstance(tris, torch.Tensor):
        dev = tris.device if device is None else torch.device(device)
        return tris.detach().to(dev, torch.float32)
    return torch.from_numpy(np.asarray(tris, np.float32)).to(
        default_device(device))


def build_lbvh(tris, device=None) -> BVH2:
    """A BVH2 over (N, 3, 3) triangles, one leaf per primitive, built on
    `device` (default: a tensor's own device, else the card).

    Node pool of 2N + 2 slots: slot 0 the root, slot 1 reserved; internal
    radix node i's children at the pair (2 + 2i, 3 + 2i)."""
    tris = _as_tris(tris, device)
    dev = tris.device
    N = tris.shape[0]
    if N == 1:
        # degenerate: the root is a single leaf
        cap = 4
        node_min = torch.full((cap, 3), 1e30, device=dev)
        node_max = torch.full((cap, 3), -1e30, device=dev)
        node_min[0] = tris.amin(dim=(0, 1))
        node_max[0] = tris.amax(dim=(0, 1))
        count = torch.zeros(cap, dtype=torch.int32, device=dev)
        count[0] = 1
        return BVH2(node_min=node_min, node_max=node_max,
                    left_first=torch.zeros(cap, dtype=torch.int32,
                                           device=dev),
                    count=count,
                    prim_idx=torch.zeros(1, dtype=torch.int32, device=dev),
                    n_nodes=2)

    fmin = tris.amin(dim=1)
    fmax = tris.amax(dim=1)
    cent = (fmin + fmax) * 0.5
    smin = cent.amin(dim=0)
    smax = cent.amax(dim=0)
    # a true division: torch's `scalar / tensor` is reciprocal-then-multiply
    scale = torch.div(torch.full_like(smin, 1023.0),
                      torch.clamp(smax - smin, min=1e-20))
    q = torch.clamp((cent - smin) * scale, 0, 1023).to(torch.int64)
    codes = morton_encode_3d(q).to(torch.int64)

    # sort prims by code (stable: the sorted position breaks ties)
    order = torch.argsort(codes, stable=True)
    scode = codes[order]
    del codes, q

    # ---- adjacent augmented deltas: D[i] = common-prefix length of keys
    # i, i+1; equal codes fall back to position bits. Values in [0, 64]
    idx = torch.arange(N - 1, device=dev)
    x = scode[:-1] ^ scode[1:]
    y = idx ^ (idx + 1)
    D = torch.where(x == 0, 64 - _bit_length(y), 32 - _bit_length(x))
    D = D.to(torch.int32)
    idx32 = idx.to(torch.int32)
    del x, y, scode

    # ---- ANSV by 65-channel scans (C, N-1), lanes along splits ---------
    chan = torch.arange(_N_CHAN, dtype=torch.int32, device=dev)[:, None]
    onehot = D[None, :] == chan
    # a[i] = max{ j < i : D[j] <= D[i] }: exclusive running last position
    pos = torch.where(onehot, idx32[None, :], -1)
    lastpos = torch.cummax(pos, dim=1).values
    del pos
    lastpos = torch.cat([torch.full((_N_CHAN, 1), -1, dtype=torch.int32,
                                    device=dev), lastpos[:, :-1]], dim=1)
    a = torch.where(chan <= D[None, :], lastpos, -1).amax(dim=0)
    del lastpos
    # b[i] = min{ j > i : D[j] < D[i] }: exclusive reverse next position
    posr = torch.where(onehot, idx32[None, :], _BIG)
    del onehot
    nextpos = torch.cummin(posr.flip(1), dim=1).values.flip(1)
    del posr
    nextpos = torch.cat([nextpos[:, 1:], torch.full(
        (_N_CHAN, 1), _BIG, dtype=torch.int32, device=dev)], dim=1)
    b_raw = torch.where(chan < D[None, :], nextpos, _BIG).amin(dim=0)
    del nextpos
    no_b = b_raw >= _BIG
    a = a.long()
    b = torch.where(no_b, N - 1, b_raw.long())   # leaf-inclusive right bound

    # ---- parent pointers, then their inversion by two scatter-max ------
    Dpad = torch.cat([D, torch.full((1,), -1, dtype=torch.int32,
                                    device=dev)])  # D[-1] sentinel
    Da = torch.where(a >= 0, Dpad[torch.clamp(a, min=0)], -1)
    Db = torch.where(no_b, -1, Dpad[torch.clamp(b, max=N - 2)])
    # the deeper bounding split is the parent; tie -> b (the right split
    # is the left one's descendant under the leftmost-min-root rule)
    par_is_b = Db >= Da
    parent_i = torch.where(par_is_b, b, a)
    side_i = torch.where(par_is_b, 0, 1)
    is_root = (a < 0) & no_b
    # the leftmost bound-free split, kept on the device as a (1,) index
    root = torch.where(is_root, idx, _BIG).amin().reshape(1)

    # leaves: leaf k is bounded by splits k-1 and k; the deeper adopts it
    lk = torch.arange(N, device=dev)
    Dl = torch.where(lk > 0, Dpad[torch.clamp(lk - 1, min=0)], -1)
    Dr = torch.where(lk < N - 1, Dpad[torch.clamp(lk, max=N - 2)], -1)
    par_is_r = Dr >= Dl
    parent_k = torch.where(par_is_r, lk, lk - 1)
    side_k = torch.where(par_is_r, 0, 1)

    # inv[p, s] = child of internal p on side s: leaves hold their sorted
    # position, internals N + id (the two scatters hit disjoint slots)
    inv = torch.full(((N - 1) * 2,), -1, dtype=torch.int64, device=dev)
    inv.scatter_reduce_(
        0, torch.where(is_root, 2 * (N - 1) - 1, parent_i * 2 + side_i),
        torch.where(is_root, -1, N + idx), "amax")
    inv.scatter_reduce_(0, parent_k * 2 + side_k, lk, "amax")

    # ---- internal boxes: range min / max over the sorted leaf boxes, by
    # a sparse table of doubling windows and one gather per bound
    sorted_fmin = fmin[order]
    sorted_fmax = fmax[order]
    rlo = a + 1
    rhi = b
    klev = _bit_length(rhi - rlo + 1) - 1               # floor(log2(len))
    K = max(1, int(np.ceil(np.log2(max(N, 2)))) + 1)
    Tmin, Tmax = sorted_fmin, sorted_fmax
    mins, maxs = [Tmin], [Tmax]
    for k in range(K - 1):
        if (1 << (k + 1)) <= N:
            sh = 1 << k
            Tmin = torch.minimum(Tmin, torch.cat(
                [Tmin[sh:], Tmin[-1:].expand(sh, 3)]))
            Tmax = torch.maximum(Tmax, torch.cat(
                [Tmax[sh:], Tmax[-1:].expand(sh, 3)]))
        mins.append(Tmin)
        maxs.append(Tmax)
    TM = torch.stack(mins).reshape(K * N, 3)
    del mins, Tmin
    TX = torch.stack(maxs).reshape(K * N, 3)
    del maxs, Tmax
    base = klev * N
    # clamped as JAX's gathers clamp (every index is in range here)
    lo_ix = torch.clamp(base + rlo, 0, K * N - 1)
    hi_ix = torch.clamp(base + rhi - (1 << klev) + 1, 0, K * N - 1)
    amin = torch.minimum(TM[lo_ix], TM[hi_ix])          # (N-1, 3)
    amax = torch.maximum(TX[lo_ix], TX[hi_ix])
    del TM, TX

    # ---- slot assembly: slot s >= 2 holds the child of internal
    # (s-2) >> 1 on side (s-2) & 1, which is inv[s-2] (a contiguous slice)
    cap = 2 * N + 2
    c = torch.cat([torch.zeros(2, dtype=torch.int64, device=dev), inv,
                   torch.zeros(cap - 2 * N, dtype=torch.int64, device=dev)])
    slots = torch.arange(cap, device=dev)
    live = (slots >= 2) & (slots < 2 * N) & (c >= 0)
    is_leaf_child = live & (c < N)
    tab_min = torch.cat([sorted_fmin, amin])            # (2N-1, 3)
    tab_max = torch.cat([sorted_fmax, amax])
    ci = torch.clamp(c, 0, 2 * N - 2)
    node_min = torch.where(live[:, None], tab_min[ci], 1e30)
    node_max = torch.where(live[:, None], tab_max[ci], -1e30)
    left_first = torch.where(is_leaf_child, c, torch.where(
        live, 2 + 2 * torch.clamp(c - N, min=0), 0))
    count = is_leaf_child.to(torch.int32)

    # the root: the leftmost bound-free split (slot 0 is never live, so
    # its count is already 0; device-to-device copies, no host sync)
    node_min[0] = amin.index_select(0, root)[0]
    node_max[0] = amax.index_select(0, root)[0]
    left_first[0:1] = 2 + 2 * root
    return BVH2(node_min=node_min, node_max=node_max,
                left_first=left_first.to(torch.int32), count=count,
                prim_idx=order.to(torch.int32), n_nodes=2 * N)
