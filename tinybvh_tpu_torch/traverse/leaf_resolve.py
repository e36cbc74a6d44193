"""Dense per-tile leaf resolve of the v1 packet engine (≙
tinybvh_tpu/traverse/pallas_leaf.py): every ray of a 256-ray tile tested
against the tile's candidate triangles, closest hit kept.

Two hand-written CUDA kernels in csrc/leaf_resolve.cu, each with a plain
PyTorch twin of the same signature beside it:

  kernel D, `leaf_resolve_v2` (replaces `_kernel_v2` and, with
      wide=True, `_kernel_v3`): per-triangle rows (T, K4, 12) with dead
      rows zeroed -> closest t and its row position in the list;
  kernel E, `leaf_resolve` (replaces `_kernel`): x-major leaf rows
      (T, K, 48) with a live flag per leaf -> closest t and the packed
      winner rows[j] * 4 + lane.

Both run the classic Möller–Trumbore of the JAX kernels; the kernels share
one device function (csrc/common.cuh classic_mt) and the twins one torch
function (`_classic_mt`), each product and sum rounded on its own in the
JAX order, so kernel and twin agree bit for bit. A wrapper runs the twin
only for tensors on the CPU; for CUDA tensors it launches the kernel or
raises. `LAUNCHES` counts kernel launches (never twin calls, nor calls
a CUDA graph captures).

Kernel D tests only the rows that can hit (e2 not zero: the engine's
lists pad each tile with zero rows after its live leaves), two rays a
thread, the rows streamed through shared memory by cp.async; the twin
tests every row, and both give the same result (a dead row only misses).
"""

from __future__ import annotations

import torch

from tinybvh_tpu_torch import _build
from tinybvh_tpu_torch.core.vecmath import BVH_FAR
from tinybvh_tpu_torch._trace import count_launch, launch_table
from tinybvh_tpu_torch.traverse.packet2 import _check, _on_cuda

TILE = 256
LAUNCHES = launch_table(__name__, ("leaf_resolve_v2", "leaf_resolve_v3",
                                   "leaf_resolve"))
_TILES = 8   # plain twins: tiles per chunk (bounds temporaries)


def pack_tri_geom(bvh8) -> torch.Tensor:
    """(4L, 12) per-triangle kernel rows: [v0 | e1 | e2 | pad]."""
    lt = bvh8.leaf_tris                           # (L, 4, 3, 3)
    v0 = lt[:, :, 0]
    e1 = lt[:, :, 1] - v0
    e2 = lt[:, :, 2] - v0
    g = torch.cat([v0, e1, e2, torch.zeros_like(v0)], dim=-1)  # (L, 4, 12)
    return g.reshape(-1, 12)


def pack_leaf_geom(bvh8) -> torch.Tensor:
    """(L, 48) kernel-layout leaf geometry: [v0x*4|v0y*4|v0z*4|e1..|e2..|
    pad]."""
    lt = bvh8.leaf_tris
    v0 = lt[:, :, 0]
    e1 = lt[:, :, 1] - v0
    e2 = lt[:, :, 2] - v0
    parts = [v[..., k] for v in (v0, e1, e2) for k in range(3)]
    packed = torch.cat(parts, dim=1)              # (L, 36)
    return torch.cat([packed, torch.zeros_like(packed[:, :12])], dim=1)


def _classic_mt(o, d, g):
    """Classic Möller–Trumbore of kernels D and E (≙ pallas_leaf.py:
    120-135): o, d 3-tuples of ray components, g the 9 triangle fields
    (v0, e1, e2 components), all broadcast against each other. Returns t,
    BVH_FAR where there is no hit. Separate multiplies and adds in the JAX
    order, as the kernels round them (csrc/common.cuh classic_mt)."""
    ox, oy, oz = o
    dx, dy, dz = d
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = g
    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    det = e1x * hx + e1y * hy + e1z * hz
    okd = det.abs() > 1e-9
    inv = 1.0 / torch.where(okd, det, 1.0)
    sx = ox - v0x
    sy = oy - v0y
    sz = oz - v0z
    u = (sx * hx + sy * hy + sz * hz) * inv
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv
    tt = (e2x * qx + e2y * qy + e2z * qz) * inv
    hit = okd & (u >= 0) & (v >= 0) & (u + v <= 1) & (tt > 0)
    return torch.where(hit, tt, BVH_FAR)


def _rays(o_t, d_t):
    """(n, 3, 256) -> 3-tuples of (n, 1, 256) components."""
    return (tuple(o_t[:, k, None] for k in range(3)),
            tuple(d_t[:, k, None] for k in range(3)))


def _first_min(tt):
    """(n, rows, 256) t -> (t, first row of the minimum), both (n, 256),
    with (BVH_FAR, 0) where no row hits: the sequential strict-< scan from
    (BVH_FAR, 0) of the kernels."""
    m, am = tt.min(dim=1)
    ok = m < BVH_FAR
    return torch.where(ok, m, BVH_FAR), torch.where(ok, am, 0).to(torch.int32)


def _v3_block(k4: int) -> int:
    """The JAX v3 kernel's block B (pallas_leaf.py:164)."""
    return 256 if k4 % 256 == 0 else (128 if k4 % 128 == 0 else 32)


# --------------------------------------------------------------------------
# kernel D
# --------------------------------------------------------------------------

def _resolve_v2_plain(o_t, d_t, geom, wide: bool = False):
    """Plain twin of kernel D. o_t/d_t (T, 3, 256); geom (T, K4, 12) rows
    [v0|e1|e2|pad], dead rows zero. Returns (t (T, 256) f32, idx (T, 256)
    i32): v2 the first row of the minimum; wide (v3) the least key
    (t, idx % B, idx // B)."""
    T, K4 = geom.shape[:2]
    B = _v3_block(K4)
    t_out = torch.empty((T, TILE), dtype=torch.float32, device=geom.device)
    i_out = torch.empty((T, TILE), dtype=torch.int32, device=geom.device)
    for c0 in range(0, T, _TILES):
        c1 = min(T, c0 + _TILES)
        g = geom[c0:c1]
        o, d = _rays(o_t[c0:c1], d_t[c0:c1])
        tt = _classic_mt(o, d, tuple(g[:, :, k, None] for k in range(9)))
        if wide:
            # per sublane s: its first block j of the minimum; then the
            # first sublane of the minimum over those
            bt, bj = tt.reshape(c1 - c0, K4 // B, B, TILE).min(dim=1)
            m, s = _first_min(bt)
            j = torch.gather(bj, 1, s[:, None].long())[:, 0]
            idx = torch.where(m < BVH_FAR, j * B + s, 0)
        else:
            m, idx = _first_min(tt)
        t_out[c0:c1] = m
        i_out[c0:c1] = idx.to(torch.int32)
    return t_out, i_out


def _resolve_v2_cuda(o_t, d_t, geom, wide: bool = False):
    """Kernel D launch (csrc/leaf_resolve.cu); same contract as the plain
    twin."""
    T, K4 = geom.shape[:2]
    _check("leaf_resolve_v2 o_t", o_t, torch.float32, (T, 3, TILE))
    _check("leaf_resolve_v2 d_t", d_t, torch.float32, (T, 3, TILE))
    _check("leaf_resolve_v2 geom", geom, torch.float32, (T, K4, 12))
    if geom.data_ptr() % 16:
        raise ValueError("leaf_resolve_v2: geom must be 16-byte aligned")
    t = torch.empty((T, TILE), dtype=torch.float32, device=geom.device)
    idx = torch.empty((T, TILE), dtype=torch.int32, device=geom.device)
    if T == 0:
        return t, idx
    lib = _build.kernels()
    stream = torch.cuda.current_stream(geom.device).cuda_stream
    err = lib.tbvh_leaf_resolve_v2(o_t.data_ptr(), d_t.data_ptr(),
                                   geom.data_ptr(), t.data_ptr(),
                                   idx.data_ptr(), T, K4, int(wide),
                                   _v3_block(K4), stream)
    _build.check(err, "tbvh_leaf_resolve_v2")
    count_launch(LAUNCHES, "leaf_resolve_v3" if wide else "leaf_resolve_v2")
    return t, idx


def leaf_resolve_v2(o_t, d_t, geom, wide: bool = False):
    """≙ JAX leaf_resolve_v2: kernel D on CUDA tensors, its plain twin on
    CPU tensors. o_t, d_t (T, 3, 256); geom (T, K4, 12) with dead rows
    zeroed, K4 % 32 == 0 -> (t (T, 256), tri list position (T, 256)).
    wide=True selects the v3 body's tie rule (256-, 128- or 32-row
    blocks); False the v2 body's."""
    K4 = geom.shape[1]
    if K4 == 0 or K4 % 32:
        raise ValueError(f"leaf_resolve_v2: K4 ({K4}) must be a positive "
                         "multiple of 32")
    if _on_cuda("leaf_resolve_v2", o_t, d_t, geom):
        return _resolve_v2_cuda(o_t, d_t, geom, wide)
    return _resolve_v2_plain(o_t, d_t, geom, wide)


# --------------------------------------------------------------------------
# kernel E
# --------------------------------------------------------------------------

def _resolve_plain(o_t, d_t, geom, live, rows):
    """Plain twin of kernel E. o_t/d_t (T, 3, 256); geom (T, K, 48)
    x-major leaf rows; live (T, K) i32 (> 0: the leaf may hit); rows
    (T, K) i32 leaf row ids. Returns (t (T, 256) f32, packed (T, 256)
    i32 = rows[j] * 4 + lane of the first (leaf, lane) of the minimum)."""
    T, K = geom.shape[:2]
    t_out = torch.empty((T, TILE), dtype=torch.float32, device=geom.device)
    p_out = torch.empty((T, TILE), dtype=torch.int32, device=geom.device)
    for c0 in range(0, T, _TILES):
        c1 = min(T, c0 + _TILES)
        g = geom[c0:c1]                                   # (n, K, 48)
        o, d = _rays(o_t[c0:c1], d_t[c0:c1])
        fields = tuple(g[:, :, 4 * f:4 * f + 4].reshape(c1 - c0, 4 * K, 1)
                       for f in range(9))                  # (n, K*4, 1)
        tt = _classic_mt(o, d, fields)
        tt = torch.where((live[c0:c1] > 0).repeat_interleave(4, dim=1)[
            ..., None], tt, BVH_FAR)
        m, flat = _first_min(tt)                           # flat = j*4+lane
        row = torch.gather(rows[c0:c1], 1, (flat >> 2).long())
        pk = row * 4 + (flat & 3)
        t_out[c0:c1] = m
        p_out[c0:c1] = torch.where(m < BVH_FAR, pk, 0).to(torch.int32)
    return t_out, p_out


def _resolve_cuda(o_t, d_t, geom, live, rows):
    """Kernel E launch (csrc/leaf_resolve.cu); same contract as the plain
    twin."""
    T, K = geom.shape[:2]
    _check("leaf_resolve o_t", o_t, torch.float32, (T, 3, TILE))
    _check("leaf_resolve d_t", d_t, torch.float32, (T, 3, TILE))
    _check("leaf_resolve geom", geom, torch.float32, (T, K, 48))
    _check("leaf_resolve live", live, torch.int32, (T, K))
    _check("leaf_resolve rows", rows, torch.int32, (T, K))
    if geom.data_ptr() % 16:
        raise ValueError("leaf_resolve: geom must be 16-byte aligned")
    t = torch.empty((T, TILE), dtype=torch.float32, device=geom.device)
    pk = torch.empty((T, TILE), dtype=torch.int32, device=geom.device)
    if T == 0:
        return t, pk
    lib = _build.kernels()
    stream = torch.cuda.current_stream(geom.device).cuda_stream
    err = lib.tbvh_leaf_resolve(o_t.data_ptr(), d_t.data_ptr(),
                                geom.data_ptr(), live.data_ptr(),
                                rows.data_ptr(), t.data_ptr(), pk.data_ptr(),
                                T, K, stream)
    _build.check(err, "tbvh_leaf_resolve")
    count_launch(LAUNCHES, "leaf_resolve")
    return t, pk


def leaf_resolve(o_t, d_t, geom, live, rows):
    """≙ JAX leaf_resolve: kernel E on CUDA tensors, its plain twin on CPU
    tensors. o_t, d_t (T, 3, 256); geom (T, K, 48) (pack_leaf_geom rows);
    live (T, K) i32; rows (T, K) i32 -> (t (T, 256), packed (T, 256)).
    No caller in the package, as in the JAX package."""
    if geom.shape[1] == 0:
        raise ValueError("leaf_resolve: needs at least one leaf per tile")
    if _on_cuda("leaf_resolve", o_t, d_t, geom, live, rows):
        return _resolve_cuda(o_t, d_t, geom, live, rows)
    return _resolve_plain(o_t, d_t, geom, live, rows)
