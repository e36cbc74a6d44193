"""Phase 1 of the v1 packet engine as one kernel: a depth-first BVH8 walk
per tile against its frustum planes (≙
tinybvh_tpu/traverse/pallas_frustum.py).

Kernel F, `collect_tile_leaves_kernel` (csrc/frustum_walk.cu; replaces
`_kernel`, wrapped there by `collect_tile_leaves_pallas`): per tile the
leaf list of a 64-entry stack walk that tests each popped node's 8 child
boxes against the tile's 4 planes and lists the surviving leaves in visit
order. The kernel expands each tile's visible tree breadth first and
places every leaf at its position in that order; a tile whose stack
overflows walks pop by pop inside the kernel (`sequential_tiles` counts
them). The plain PyTorch twin `_walk_plain` steps every tile's walk in
lockstep, one pop per tile per step, and gives the same lists, overflow
included. A
wrapper runs the twin only for tensors on the CPU; for CUDA tensors it
launches the kernel or raises. `LAUNCHES` counts kernel launches (not
calls a CUDA graph captures)."""

from __future__ import annotations

import torch

from tinybvh_tpu_torch import _build
from tinybvh_tpu_torch.layouts.mbvh import EMPTY_SLOT
from tinybvh_tpu_torch.traverse.packet2 import _check, _count, _on_cuda

STACK = 64
_I32MAX = 2**31 - 1
LAUNCHES = {"frustum_walk": 0}


def _max_steps(n_nodes: int) -> int:
    """Pops a walk may make: each node is pushed at most once (by its one
    parent), so a well-formed tree needs at most n_nodes; the bound only
    guards the kernel against a malformed one (overflow is reported)."""
    return 8 * n_nodes + STACK


def _walk_plain(bounds, child, planes, ndoto, max_leaves: int):
    """Plain twin of kernel F. bounds (M, 48) f32 (rows 0-2 of the (6, 8)
    view lo, 3-5 hi); child (M, 8) i32; planes (T, 4, 3) f32; ndoto
    (T, 1, 4) f32 = plane . origin. Returns (leaves (T, K) i32, I32MAX
    padded, counts (T,) i32, -1 where the stack or the list overflowed,
    and the pops each tile made (T,) i64: the kernel's work, which the
    wrapper drops). Separate multiplies and adds in the JAX kernel's
    order, as the CUDA kernel rounds them."""
    T = planes.shape[0]
    K = max_leaves
    dev = planes.device
    b3 = bounds.reshape(-1, 6, 8)
    nd = -ndoto.reshape(T, 4)
    max_steps = _max_steps(bounds.shape[0])
    tiles = torch.arange(T, device=dev)
    sp = torch.ones(T, dtype=torch.int64, device=dev)
    cnt = torch.zeros(T, dtype=torch.int64, device=dev)
    ovf = torch.zeros(T, dtype=torch.bool, device=dev)
    # one spare column each takes the writes that fall past the end
    stack = torch.zeros((T, STACK + 1), dtype=torch.int32, device=dev)
    lst = torch.full((T, K + 1), _I32MAX, dtype=torch.int32, device=dev)
    pops = torch.zeros(T, dtype=torch.int64, device=dev)
    step = 0
    while True:
        active = sp > 0
        if not bool(active.any()):
            break
        if step >= max_steps:
            ovf |= active
            break
        step += 1
        pops += active.long()
        sp = sp - active.long()
        node = stack[tiles, sp].long()
        b = b3[node]                                        # (T, 6, 8)
        kids = child[node]                                  # (T, 8)
        outside = torch.zeros((T, 8), dtype=torch.bool, device=dev)
        for p in range(4):
            dist = nd[:, p, None]
            for k in range(3):
                npk = planes[:, p, k, None]
                dist = dist + npk * torch.where(npk > 0, b[:, 3 + k],
                                                b[:, k])
            outside |= dist < 0
        valid = active[:, None] & ~outside & (kids != EMPTY_SLOT)
        leafc = valid & (kids < 0)
        nodec = valid & (kids >= 0)
        lpos = cnt[:, None] + torch.cumsum(leafc, 1) - leafc.long()
        lok = leafc & (lpos < K)
        lst.scatter_(1, torch.where(lok, lpos, K),
                     torch.where(lok, -kids - 1, _I32MAX))
        npos = sp[:, None] + torch.cumsum(nodec, 1) - nodec.long()
        nok = nodec & (npos < STACK)
        stack.scatter_(1, torch.where(nok, npos, STACK),
                       torch.where(nok, kids, 0))
        cnt = cnt + leafc.sum(1)
        sp = sp + nodec.sum(1)
        ovf |= (sp >= STACK) | (cnt > K)
        sp = torch.clamp(sp, max=STACK - 1)
    counts = torch.where(ovf | (cnt > K), -1, cnt).to(torch.int32)
    return lst[:, :K].contiguous(), counts, pops


def _walk_cuda(bounds, child, planes, ndoto, max_leaves: int, seq=None):
    """Kernel F launch (csrc/frustum_walk.cu); the plain twin's outputs
    without its pop count. With seq (a device int32 (1,)), the kernel adds
    to it the tiles that took its sequential walk."""
    M = bounds.shape[0]
    T = planes.shape[0]
    _check("frustum_walk bounds", bounds, torch.float32, (M, 48))
    _check("frustum_walk child", child, torch.int32, (M, 8))
    _check("frustum_walk planes", planes, torch.float32, (T, 4, 3))
    _check("frustum_walk ndoto", ndoto, torch.float32, (T, 1, 4))
    leaves = torch.empty((T, max_leaves), dtype=torch.int32,
                         device=planes.device)
    counts = torch.empty((T,), dtype=torch.int32, device=planes.device)
    if T == 0:
        return leaves, counts
    lib = _build.kernels()
    stream = torch.cuda.current_stream(planes.device).cuda_stream
    args = (bounds.data_ptr(), child.data_ptr(), planes.data_ptr(),
            ndoto.data_ptr(), leaves.data_ptr(), counts.data_ptr(), T,
            max_leaves, _max_steps(M))
    if seq is None:
        err = lib.tbvh_frustum_walk(*args, stream)
    else:
        err = lib.tbvh_frustum_walk_seq(*args, seq.data_ptr(), stream)
    _build.check(err, "tbvh_frustum_walk")
    _count(LAUNCHES, "frustum_walk")
    return leaves, counts


def sequential_tiles(bounds, child, planes, ndoto, max_leaves: int) -> int:
    """Tiles of one kernel F launch on these CUDA tensors that took the
    kernel's sequential walk (stack overflow, or a visible tree past the
    kernel's record capacity)."""
    if not _on_cuda("sequential_tiles", bounds, child, planes, ndoto):
        raise ValueError("sequential_tiles: the kernel runs on CUDA tensors")
    seq = torch.zeros((1,), dtype=torch.int32, device=planes.device)
    _walk_cuda(bounds, child, planes, ndoto, max_leaves, seq)
    return int(seq.item())


def collect_tile_leaves_kernel(bounds, child, planes, ndoto,
                               max_leaves: int = 256):
    """≙ JAX pallas_frustum.collect_tile_leaves_pallas: kernel F on CUDA
    tensors, its plain twin on CPU tensors. bounds (M, 48) f32 as the
    BVH8 holds them (JAX reshapes them to (M, 6, 8): rows 0-2 lo, 3-5
    hi); child (M, 8) i32 (EMPTY_SLOT padded); planes (T, 4, 3); ndoto
    (T, 1, 4) = plane . origin per tile. Returns (leaves (T, K) i32,
    I32MAX padded, counts (T,) i32; -1 marks a stack or list overflow)."""
    if max_leaves < 1:
        raise ValueError(f"max_leaves must be >= 1, got {max_leaves}")
    if bounds.shape[0] == 0:
        raise ValueError("collect_tile_leaves_kernel: the BVH8 has no nodes")
    if _on_cuda("collect_tile_leaves_kernel", bounds, child, planes, ndoto):
        return _walk_cuda(bounds, child, planes, ndoto, max_leaves)
    return _walk_plain(bounds, child, planes, ndoto, max_leaves)[:2]
