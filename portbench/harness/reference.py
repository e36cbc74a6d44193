"""The plain reference: brute-force Möller–Trumbore over every triangle,
closest hit and any hit, in plain PyTorch on the rays' device. It
imports nothing of the program and takes nothing the program made: only
the benchmark's own triangles and rays.

Each ray / triangle test is Möller–Trumbore's (tinybvh's
MOLLER_TRUMBORE, tiny_bvh.h:1644-1656; a hit needs |det| > 1e-9,
u >= 0, v >= 0, u + v <= 1 and 0 < t < t_max), with its four scalar
triple products written as dot products of per-ray and per-triangle
rows of 10 numbers, so that a block of rays meets a block of triangles
in one matrix product:

    ray row  [o', d, o' x d, 1]          o' = o - c, c a pivot point
    det    = e1 . (d x e2)       = -d . n                 n = e1 x e2
    t det  = (o - v0) . n        = o' . n - v0' . n       v0' = v0 - c
    u det  = (o - v0) . (d x e2) = (o' x d) . e2 - d . (e2 x v0')
    v det  = d . ((o - v0) x e1) = -(o' x d) . e1 - d . (v0' x e1)

The rays are put in Morton order of their origins and cut into blocks;
each block's pivot is its middle ray's origin, so rays that share one
origin (a camera, a light) meet the triangles with o' = 0, and others
close to it. The closest hit's t is then worked out again with the
classic form, (o - v0) first, on that triangle alone.

precision "fp32" computes every product in IEEE float32 with TF32 off.
precision "tf32" is the control of the output check: the same sums with
every factor rounded to TF32 (10 mantissa bits, round to nearest even),
as the tensor cores' TF32 mode multiplies, and on the card the matrix
products allowed to run on them."""

from __future__ import annotations

import contextlib

import torch

PRECISIONS = ("fp32", "tf32")


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to the nearest TF32 value (ties to even)."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


@contextlib.contextmanager
def _matmul_precision(precision: str):
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}")
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    on = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _mul(a, b, precision):
    if precision == "tf32":
        return round_tf32(a) * round_tf32(b)
    return a * b


def _cross(a, b, precision):
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack([_mul(ay, bz, precision) - _mul(az, by, precision),
                        _mul(az, bx, precision) - _mul(ax, bz, precision),
                        _mul(ax, by, precision) - _mul(ay, bx, precision)],
                       -1)


def _dot(a, b, precision):
    return _mul(a, b, precision).sum(-1)


def classic_t(tri, o, d, precision="fp32"):
    """t of each ray against its own triangle (R, 3, 3) by the classic
    Möller–Trumbore order of operations, inf where it misses."""
    v0, e1, e2 = tri[:, 0], tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]
    h = _cross(d, e2, precision)
    det = _dot(e1, h, precision)
    valid = det.abs() > 1e-9
    inv = 1.0 / torch.where(valid, det, torch.ones_like(det))
    s = o - v0
    u = _dot(s, h, precision) * inv
    q = _cross(s, e1, precision)
    v = _dot(d, q, precision) * inv
    t = _dot(e2, q, precision) * inv
    hit = valid & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0)
    return torch.where(hit, t, float("inf"))


def morton_order(o):
    """A permutation that puts the origins in Morton order (10 bits an
    axis over their bounding box)."""
    lo = o.amin(0)
    span = (o.amax(0) - lo).clamp_min(1e-30)
    q = ((o - lo) / span * 1023.0).to(torch.int64).clamp(0, 1023)
    key = torch.zeros_like(q[:, 0])
    for bit in range(10):
        for axis in range(3):
            key |= ((q[:, axis] >> bit) & 1) << (3 * bit + axis)
    return torch.argsort(key, stable=True)


def _ray_rows(o, d, c):
    op = o - c
    return torch.cat([op, d, torch.linalg.cross(op, d),
                      torch.ones_like(o[:, :1])], dim=1)         # (R, 10)


def _tri_rows(tris, c):
    """(10, 4N): the det, t, u and v columns of each triangle."""
    v0 = tris[:, 0] - c
    e1 = tris[:, 1] - tris[:, 0]
    e2 = tris[:, 2] - tris[:, 0]
    n = torch.linalg.cross(e1, e2)
    z3 = torch.zeros_like(n)
    z1 = torch.zeros_like(n[:, :1])
    det = torch.cat([z3, -n, z3, z1], dim=1)
    t = torch.cat([n, z3, z3, -(v0 * n).sum(1, keepdim=True)], dim=1)
    u = torch.cat([z3, -torch.linalg.cross(e2, v0), e2, z1], dim=1)
    v = torch.cat([z3, -torch.linalg.cross(v0, e1), -e1, z1], dim=1)
    return torch.cat([det, t, u, v], dim=0).T.contiguous()


def _block_hits(tris, o, d, t_max, precision):
    """(hit, t) of each ray of the block against each triangle: (R, N)."""
    c = o[o.shape[0] // 2][None]
    a, b = _ray_rows(o, d, c), _tri_rows(tris, c)
    if precision == "tf32":
        a, b = round_tf32(a), round_tf32(b)
    with _matmul_precision(precision):
        prod = a @ b                                              # (R, 4N)
    det, tn, un, vn = prod.view(prod.shape[0], 4, -1).unbind(1)
    valid = det.abs() > 1e-9
    inv = 1.0 / torch.where(valid, det, torch.ones_like(det))
    u = un * inv
    v = vn * inv
    t = tn * inv
    hit = (valid & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0)
           & (t < t_max[:, None]))
    return hit, t


def _blocks(R, N, ray_block, tri_block):
    for r0 in range(0, R, ray_block):
        for n0 in range(0, N, tri_block):
            yield slice(r0, min(r0 + ray_block, R)), slice(n0, n0 + tri_block)


def _t_max(t_max, o):
    return torch.as_tensor(t_max, dtype=torch.float32,
                           device=o.device).expand(o.shape[0])


@torch.no_grad()
def closest(tris, o, d, t_max=1e30, precision="fp32", ray_block=512,
            tri_block=65536):
    """(t, prim) of the closest hit of each ray: t = 1e30 and prim = -1
    on a miss; prim is the index into `tris`."""
    R, N = o.shape[0], tris.shape[0]
    order = morton_order(o)
    tm = _t_max(t_max, o)[order]
    o, d = o[order], d[order]
    best_t = torch.full((R,), float("inf"), device=o.device)
    best_p = torch.full((R,), -1, dtype=torch.int64, device=o.device)
    for rs, ns in _blocks(R, N, ray_block, tri_block):
        hit, t = _block_hits(tris[ns], o[rs], d[rs], tm[rs], precision)
        t = torch.where(hit, t, float("inf"))
        bt, bi = t.min(dim=1)
        better = bt < best_t[rs]
        best_t[rs] = torch.where(better, bt, best_t[rs])
        best_p[rs] = torch.where(better, bi + ns.start, best_p[rs])
    hit = best_p >= 0
    t = classic_t(tris[best_p.clamp_min(0)], o, d, precision)
    # the classic form decides t; where it finds no hit on the edge of the
    # triangle that the products chose, their t stands
    t = torch.where(hit & torch.isfinite(t), t, best_t)
    t = torch.where(hit, t, 1e30)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(R, device=o.device)
    return t[inv], best_p[inv]


@torch.no_grad()
def occluded(tris, o, d, t_max, precision="fp32", ray_block=512,
             tri_block=65536):
    """(R,) bool: any hit with 0 < t < t_max."""
    R, N = o.shape[0], tris.shape[0]
    order = morton_order(o)
    tm = _t_max(t_max, o)[order]
    o, d = o[order], d[order]
    occ = torch.zeros((R,), dtype=torch.bool, device=o.device)
    for rs, ns in _blocks(R, N, ray_block, tri_block):
        hit, _ = _block_hits(tris[ns], o[rs], d[rs], tm[rs], precision)
        occ[rs] |= hit.any(dim=1)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(R, device=o.device)
    return occ[inv]
