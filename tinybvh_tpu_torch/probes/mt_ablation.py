"""Kernel I: kernel B's tile loop in eight variants, one part taken out
at a time, to split B's time on the card by subtraction (≙
benchmarks/mt_ablation_probe.py `_ablation_kernel`). The kernel is
csrc/mt_ablation.cu (one template, the variant a parameter of its one C
entry); `_ablation_plain` beside it is its plain PyTorch twin.

Per tile of 256 rays: the tile's leaf keys (per-leaf keys, 4 rows of
gtab_pad each) are walked in super-blocks of 128 rows; each (row, ray)
pair runs the triple-product Möller–Trumbore of kernel B (four 12-lane
dots in lane order, sign flip, hit test, t = ts * (1 / ad)); each ray
keeps its best t and row. The next super-block runs only while sb + 1 <
nsb and not lbg[min(sb + 1, nb - 1)] > the tile's max best t. Variants:

  full      rows of each key's leaf (low 18 bits, clamped to the last
            leaf row group of gtab_pad)
  seg8/32   rows of 8 / 32 leaves from each group's first key
  bigdma    rows 0:128 whatever the keys
  nodma     no copy: the rows staged before the loop, rows 0:128
  mathonly  no copy; best t = min(best t, min over rows of det + u' + v' +
            t'), every super-block walked, best row 0
  bf16      no copy; rows and ray features rounded to bf16, the dots on
            the tensor cores (the twin: exact products summed in lane
            order in f32); then the full epilogue
  skeleton  no walk: t = tmax + d.x, row = count

The TPU kernel's no-copy variants read a buffer that nothing wrote; the
port defines it as rows 0:128 in both ring slots, so nodma equals bigdma.

    python -m tinybvh_tpu_torch.probes.mt_ablation [kpt...] [--scattered]

(kpt: keys a tile) runs every variant on the card at the reference's
shapes: random_tris(65536, seed=0) and the port's packet tables, T =
1,600 tiles, k_cap 256, clustered keys (keys_per_tile consecutive
leaves from a random base per tile), seeded random rays; without a kpt
at 16, 64 and 256 keys a tile (1, 2 and 8 super-blocks). Its bases come
from [0, max_leaf_row + 1 - keys_per_tile), so that every row it copies
is a real one: the reference draws them from [0, n_leaves -
keys_per_tile), and with pack-2 tables most of those keys clamp to the
last row group. With --scattered
each tile's keys spread over the whole table instead (make_inputs). It
prints each variant's time and the split of the tile loop by
subtraction.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from tinybvh_tpu_torch import _build
from tinybvh_tpu_torch.core.rays import default_device
from tinybvh_tpu_torch._timing import events_ms, graph_ms, once_ms
from tinybvh_tpu_torch.traverse.packet import TILE
from tinybvh_tpu_torch.traverse.packet2 import (
    _I32MAX, _LEAF_BITS, _check, _count, _features, _on_cuda,
)

VARIANTS = ("full", "seg8", "seg32", "bigdma", "nodma", "mathonly", "bf16",
            "skeleton")
TRI_BLK = 128               # rows per super-block
LPB = TRI_BLK // 4          # leaf keys per super-block
_SPAN = {"seg8": 8, "seg32": 32}
_TILES = 64                 # plain twin: tiles per chunk (bounds temporaries)
LAUNCHES = {"mt_ablation": 0}
N_TIMED = 10                # launches timed by events and by a CUDA graph
# the split of the tile loop: (what, minuend, subtrahend)
SPLIT = (("scattered copies", "full", "bigdma"),
         ("one bulk copy", "bigdma", "nodma"),
         ("epilogue", "nodma", "mathonly"),
         ("dots", "mathonly", "skeleton"),
         ("fixed per tile", "skeleton", None))


def _check_args(keys, counts, lbg, tmax, o_t, d_t, gtab, variant):
    T, k_cap = keys.shape
    if variant not in VARIANTS:
        raise ValueError(f"mt_ablation: variant {variant!r} not in "
                         f"{VARIANTS}")
    if k_cap % LPB or k_cap == 0:
        raise ValueError(f"mt_ablation: k_cap {k_cap} not a multiple of "
                         f"{LPB}")
    if gtab.shape[0] < TRI_BLK:
        raise ValueError(f"mt_ablation: gtab has {gtab.shape[0]} rows, "
                         f"fewer than {TRI_BLK}")
    _check("ablation keys", keys, torch.int32, (T, k_cap))
    _check("ablation counts", counts, torch.int32, (T,))
    _check("ablation lbg", lbg, torch.float32, (T, lbg.shape[1]))
    _check("ablation tmax", tmax, torch.float32, (T,))
    _check("ablation o_t", o_t, torch.float32, (T, 3, TILE))
    _check("ablation d_t", d_t, torch.float32, (T, 3, TILE))
    _check("ablation gtab", gtab, torch.float32, (gtab.shape[0], 128))
    if lbg.shape[1] == 0:
        raise ValueError("mt_ablation: lbg needs at least one gate")


def _src_rows(keys, sb, variant, max_leaf_row):
    """(n, 128) gtab rows that super-block sb stages for tiles with keys
    (n, k_cap)."""
    r = torch.arange(TRI_BLK, device=keys.device)
    mask = (1 << _LEAF_BITS) - 1
    if variant == "full":
        leaf = torch.clamp(keys[:, sb * LPB + r // 4] & mask,
                           max=max_leaf_row)
        return leaf * 4 + r % 4
    span = _SPAN.get(variant)
    if span:
        grp = r // (4 * span)
        leaf = torch.clamp(keys[:, sb * LPB + grp * span] & mask,
                           max=max_leaf_row - (span - 1))
        return leaf * 4 + r - grp * 4 * span
    return r.expand(keys.shape[0], -1)   # bigdma, and the no-copy buffer


def _live(counts, sb, k_cap):
    """(n, 128) mask of super-block sb's rows inside each tile's count
    (the rows whose hits the epilogue keeps)."""
    r = torch.arange(TRI_BLK, device=counts.device)
    cnt4 = torch.clamp(counts, max=k_cap).long() * 4
    return (sb * TRI_BLK + r)[None, :] < cnt4[:, None]


def tested_pairs(counts, n_sb, k_cap, variant):
    """(row, ray) pairs the variant's result needs on these inputs, with
    n_sb the super-blocks each tile walked (the twin's third output): the
    live rows of each walked super-block times 256 rays; mathonly, which
    masks nothing, every row it walks; skeleton none."""
    if variant == "skeleton" or not bool((n_sb > 0).any()):
        return 0
    rows = 0
    for sb in range(int(n_sb.max())):
        on = n_sb > sb
        rows += (int(on.sum()) * TRI_BLK if variant == "mathonly"
                 else int(_live(counts[on], sb, k_cap).sum()))
    return rows * TILE


def bytes_moved(args, gtab, variant, n_sb, outs):
    """Bytes the variant's result needs on these inputs, with n_sb as in
    tested_pairs: each input read once (of gtab, lanes 0:48 of each
    distinct row that a walked super-block stages where it is live, or
    anywhere for mathonly), each output written once. skeleton reads
    counts, tmax and d.x alone."""
    keys, counts, lbg, tmax, o_t, d_t = args

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    if variant == "skeleton":
        return nbytes((counts, tmax, d_t[:, 0])) + nbytes(outs)
    max_leaf_row = gtab.shape[0] // 4 - 1
    rows = []
    for sb in range(int(n_sb.max()) if n_sb.numel() else 0):
        on = n_sb > sb
        src = _src_rows(keys[on], sb, variant, max_leaf_row)
        if variant != "mathonly":
            src = src[_live(counts[on], sb, keys.shape[1])]
        rows.append(src.reshape(-1))
    n_rows = int(torch.unique(torch.cat(rows)).numel()) if rows else 0
    return nbytes(args) + n_rows * 48 * 4 + nbytes(outs)


def _dots(g, f):
    """det, u', v', t' (each (n, rows, 256)) of rows g (n, rows, 48) with
    features f (n, 12, 256): 12-lane dots, each product and sum rounded
    on its own, in lane order."""
    out = []
    for q in range(4):
        a = torch.zeros((g.shape[0], g.shape[1], f.shape[2]),
                        dtype=torch.float32, device=g.device)
        for k in range(12):
            a = a + g[:, :, 12 * q + k, None] * f[:, None, k, :]
        out.append(a)
    return out


def _ablation_plain(keys, counts, lbg, tmax, o_t, d_t, gtab,
                    variant: str):
    """Plain twin of kernel I. keys (T, k_cap) i32 per-leaf keys; counts
    (T,) i32; lbg (T, nb) f32 super-block gates; tmax (T,) f32 initial
    best t; o_t, d_t (T, 3, 256) f32; gtab (rows, 128) f32. Returns (t,
    i), each (T, 256), and the super-blocks each tile walked ((T,) i64;
    the kernel's work, which the wrapper drops)."""
    T, k_cap = keys.shape
    nb = lbg.shape[1]
    dev = keys.device
    cnt = torch.clamp(counts, max=k_cap)
    n_sb = torch.zeros(T, dtype=torch.int64, device=dev)
    if variant == "skeleton":
        t = (torch.zeros((T, TILE), dtype=torch.float32, device=dev)
             + tmax[:, None]) + d_t[:, 0]
        return t, cnt[:, None].expand(T, TILE).contiguous(), n_sb
    max_leaf_row = gtab.shape[0] // 4 - 1
    t_out = tmax[:, None].expand(T, TILE).contiguous()
    i_out = torch.zeros((T, TILE), dtype=torch.int32, device=dev)
    for c0 in range(0, T, _TILES):
        c1 = min(T, c0 + _TILES)
        nsb = torch.div(cnt[c0:c1] + LPB - 1, LPB, rounding_mode="floor")
        active = nsb > 0
        sb = 0
        while bool(active.any()):
            a = torch.nonzero(active)[:, 0]
            ta = a + c0
            n_sb[ta] += 1
            if variant == "mathonly":
                nxt = sb + 1 < nsb[a]
            else:
                t_far = t_out[ta].amax(dim=1)        # NaN passes the gate
                gate_n = lbg[ta, min(sb + 1, nb - 1)]
                nxt = (sb + 1 < nsb[a]) & ~(gate_n > t_far)
            g = gtab[_src_rows(keys[ta], sb, variant, max_leaf_row)][..., :48]
            f = _features(o_t[ta], d_t[ta])
            if variant == "bf16":
                g = g.to(torch.bfloat16).float()
                f = f.to(torch.bfloat16).float()
            det, up, vp, tp = _dots(g, f)
            if variant == "mathonly":
                m0 = (((det + up) + vp) + tp).amin(dim=1)
                t_out[ta] = torch.minimum(t_out[ta], m0)
            else:
                s = torch.where(det >= 0, 1.0, -1.0)
                ad, us, vs, ts = det * s, up * s, vp * s, tp * s
                live = _live(cnt[ta], sb, k_cap)[..., None]
                hit = ((us >= 0) & (vs >= 0) & (us + vs <= ad) & (ts > 0)
                       & (ad > 0))
                inv = 1.0 / torch.where(ad > 0, ad, 1.0)
                tt = torch.where(hit & live, ts * inv, 1e30)
                m, am = tt.min(dim=1)                 # the first minimum
                better = m < t_out[ta]
                t_out[ta] = torch.where(better, m, t_out[ta])
                i_out[ta] = torch.where(better, (sb * TRI_BLK + am).to(
                    torch.int32), i_out[ta])
            active[a] = nxt
            sb += 1
    return t_out, i_out, n_sb


def _ablation_cuda(keys, counts, lbg, tmax, o_t, d_t, gtab, variant: str):
    """Kernel I launch (csrc/mt_ablation.cu): the twin's outputs without
    its work count."""
    T, k_cap = keys.shape
    if gtab.data_ptr() % 16:
        raise ValueError("mt_ablation: gtab must be 16-byte aligned")
    t = torch.empty((T, TILE), dtype=torch.float32, device=keys.device)
    i = torch.empty((T, TILE), dtype=torch.int32, device=keys.device)
    if T == 0:
        return t, i
    ins = (keys, counts, lbg, tmax, o_t, d_t, gtab, t, i)
    err = _build.kernels().tbvh_mt_ablation(
        *[x.data_ptr() for x in ins], T, k_cap, lbg.shape[1], gtab.shape[0],
        VARIANTS.index(variant),
        torch.cuda.current_stream(keys.device).cuda_stream)
    _build.check(err, "tbvh_mt_ablation")
    _count(LAUNCHES, "mt_ablation")
    return t, i


def ablation(keys, counts, lbg, tmax, o_t, d_t, gtab, variant: str):
    """Kernel I on CUDA tensors, its plain twin on CPU tensors: (t, i),
    each (T, 256)."""
    args = (keys, counts, lbg, tmax, o_t, d_t, gtab)
    _check_args(*args, variant)
    if _on_cuda("mt_ablation", *args):
        return _ablation_cuda(*args, variant)
    return _ablation_plain(*args, variant)[:2]


def make_inputs(n_leaves: int, T: int = 1600, keys_per_tile: int = 64,
                k_cap: int = 256, seed: int = 0, device=None,
                scattered: bool = False):
    """The reference's inputs (mt_ablation_probe.py:40-54) from
    np.random.RandomState(seed): per tile keys_per_tile consecutive leaf
    keys from a base drawn from [0, n_leaves - keys_per_tile), the rest
    I32MAX; counts keys_per_tile; gates 0 for the super-blocks the keys
    fill and +inf after; tmax 1e30; o_t, d_t standard normal (T, 3, 256).
    With `scattered`, each tile's keys are instead drawn from [0,
    n_leaves) and sorted (keys spread over the table, as a packet pass's
    segment keys are; not the reference's recipe). Returns (keys,
    counts, lbg, tmax, o_t, d_t) on `device`."""
    dev = default_device(device)
    rng = np.random.RandomState(seed)
    keys = np.full((T, k_cap), _I32MAX, np.int32)
    if scattered:
        keys[:, :keys_per_tile] = np.sort(
            rng.randint(0, n_leaves, (T, keys_per_tile)), axis=1)
    else:
        base = rng.randint(0, max(1, n_leaves - keys_per_tile), (T, 1))
        keys[:, :keys_per_tile] = base + np.arange(keys_per_tile)
    counts = np.full((T,), keys_per_tile, np.int32)
    lbg = np.zeros((T, k_cap // LPB), np.float32)
    lbg[:, (keys_per_tile + LPB - 1) // LPB:] = np.inf
    tmax = np.full((T,), 1e30, np.float32)
    o_t = rng.randn(T, 3, TILE).astype(np.float32)
    d_t = rng.randn(T, 3, TILE).astype(np.float32)
    return tuple(torch.from_numpy(x).to(dev)
                 for x in (keys, counts, lbg, tmax, o_t, d_t))


def check(args, gtab, variant, got):
    """The twin on the same inputs against the kernel's output `got`:
    torch.equal for every variant but bf16; bf16 (the mma's order of
    additions is the hardware's): row equal on >= 99.9% of rays and t
    within rtol = atol = 1e-4 where it is. Raises on a mismatch. Returns
    (largest |t - t_twin| where the rows agree, the twin's ms on the card
    (None on the CPU), super-blocks walked per tile)."""
    call = lambda: _ablation_plain(*args, gtab, variant)  # noqa: E731
    if got[0].is_cuda:
        (t, i, n_sb), plain_ms = once_ms(call)
    else:
        (t, i, n_sb), plain_ms = call(), None
    if variant == "bf16":
        same = got[1] == i
        if float(same.float().mean()) < 0.999:
            raise AssertionError("mt_ablation bf16: rows differ on "
                                 f"{int((~same).sum())} rays")
        if not torch.allclose(got[0][same], t[same], rtol=1e-4, atol=1e-4):
            raise AssertionError("mt_ablation bf16: t differs")
    else:
        same = torch.ones_like(i, dtype=torch.bool)
        if not (torch.equal(got[0], t) and torch.equal(got[1], i)):
            raise AssertionError(f"mt_ablation {variant} differs from its "
                                 "plain twin")
    err = float((got[0][same].double() - t[same].double()).abs().max())
    return err, plain_ms, n_sb


def run(device=None, keys_per_tile=(16, 64, 256), T: int = 1600,
        k_cap: int = 256, bvh=None, scattered: bool = False):
    """Every variant at each keys_per_tile on the card (on the CPU: the
    twin): the output, its time from CUDA events over N_TIMED launches
    and its device time from one CUDA graph of N_TIMED launches (None off
    the card), the wrapper's launches (the graph's aren't counted) and
    the kernel's runs from the graph's two replays; then the twin on the
    same inputs (`check`). `bvh` defaults to the port's BVH of
    random_tris(65536, seed=0) on `device`; `scattered` as in
    make_inputs. Returns {kpt: {"inputs": ..., "gtab": ..., variant:
    {...}}}."""
    from tinybvh_tpu_torch import BVH
    from tinybvh_tpu_torch.io.loaders import random_tris

    dev = default_device(device)
    if bvh is None:
        bvh = BVH(random_tris(65536, seed=0), device=dev)
    gtab = bvh.packet_aux.gtab_pad
    max_leaf_row = gtab.shape[0] // 4 - 1
    res = {}
    for kpt in keys_per_tile:
        args = make_inputs(max_leaf_row + 1, T, kpt, k_cap, 0, dev,
                           scattered)
        out = {"inputs": args, "gtab": gtab}
        for v in VARIANTS:
            before = LAUNCHES["mt_ablation"]
            got = ablation(*args, gtab, v)
            fn = lambda: ablation(*args, gtab, v)  # noqa: E731
            on_gpu = got[0].is_cuda
            out[v] = dict(out=got,
                          ms=events_ms(fn, N_TIMED) if on_gpu else None,
                          device_ms=graph_ms(fn, N_TIMED) if on_gpu else None,
                          launches=LAUNCHES["mt_ablation"] - before,
                          graph_runs=2 * N_TIMED if on_gpu else 0)
        for v in VARIANTS:
            err, plain_ms, n_sb = check(args, gtab, v, out[v]["out"])
            out[v].update(max_abs_err=err, plain_ms=plain_ms, n_sb=n_sb)
        res[kpt] = out
    return res


def split(r):
    """The tile loop's split by subtraction at one keys_per_tile: [(what,
    ms)], from the variants' device times."""
    return [(what, r[a]["device_ms"] - (r[b]["device_ms"] if b else 0.0))
            for what, a, b in SPLIT]


def main(argv) -> int:
    dev = default_device(None)
    scattered = "--scattered" in argv
    kpts = tuple(int(a) for a in argv if a != "--scattered") or (16, 64, 256)
    res = run(dev, kpts, scattered=scattered)
    name = torch.cuda.get_device_name(dev)
    keys = "scattered" if scattered else "clustered"
    for kpt, r in res.items():
        T = r["inputs"][0].shape[0]
        for v in VARIANTS:
            x = r[v]
            print(f"mt_ablation kpt {kpt} {keys} {v:8s} kernel "
                  f"{x['ms']:.4f} ms, device {x['device_ms']:.4f} ms "
                  f"({x['device_ms'] / T * 1e3:.3f} us/tile), twin "
                  f"{x['plain_ms']:.1f} ms, max_abs_err {x['max_abs_err']}"
                  f" ({name})", flush=True)
        print(f"mt_ablation kpt {kpt} {keys} split (device ms): " + ", ".join(
            f"{what} {ms:.4f}" for what, ms in split(r)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
