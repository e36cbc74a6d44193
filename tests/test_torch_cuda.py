"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Marked `cuda`: every test skips without a CUDA device. This file imports
no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

Every kernel is held to bit equality with its twin (torch.equal on
every output): A (survivor keys in worklist order, counts), B (t, row
index, u, v, prim), C (t, row index), G (block mask), and D, E and F of
the v1 packet engine (t, row position or packed winner; leaf lists and
counts), and the probes' kernels H (each gather form) and I (each
variant of B's tile loop; bf16 within a tolerance, since the order of
its tensor-core additions is the hardware's). All the fp32 kernels round
every multiply and add separately in the twins' order. Against the
brute-force oracle: prim equal, t within rtol = atol = 1e-4.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tinybvh_tpu_torch import BVH, _build  # noqa: E402
from tinybvh_tpu_torch.core.intersect import brute_force_closest  # noqa: E402
from tinybvh_tpu_torch.core.rays import make_rays  # noqa: E402
from tinybvh_tpu_torch.io.loaders import random_tris  # noqa: E402
from tinybvh_tpu_torch.probes import gather as hg  # noqa: E402
from tinybvh_tpu_torch.probes import mt_ablation as ma  # noqa: E402
from tinybvh_tpu_torch.traverse import frustum_walk as fw  # noqa: E402
from tinybvh_tpu_torch.traverse import leaf_resolve as lr  # noqa: E402
from tinybvh_tpu_torch.traverse import packet as pk  # noqa: E402
from tinybvh_tpu_torch.traverse import packet2  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def scene():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    tris = random_tris(3000, seed=0)
    bvh = BVH(tris, device="cuda")
    return tris, bvh


def _camera_rays(T=16, seed=3):
    rng = np.random.default_rng(seed)
    eye = np.array([5.0, 5.0, -8.0], np.float32)
    d = []
    for _ in range(T):
        cx, cy = rng.uniform(-0.3, 0.3, 2)
        gx, gy = np.meshgrid((np.arange(16) + 0.5) / 16 * 0.05,
                             (np.arange(16) + 0.5) / 16 * 0.05)
        dd = np.stack([cx + gx, cy + gy, np.ones_like(gx)], -1)
        dd /= np.linalg.norm(dd, axis=-1, keepdims=True)
        d.append(dd.reshape(-1, 3))
    d = np.concatenate(d).astype(np.float32)
    return np.broadcast_to(eye, d.shape).copy(), d


def _capture(monkeypatch, name):
    """Record the arguments of every packet2.<name> call."""
    calls = []
    real = getattr(packet2, name)

    def rec(*args):
        calls.append(args)
        return real(*args)

    monkeypatch.setattr(packet2, name, rec)
    return calls


def _trace(bvh, rays, **kw):
    return packet2.intersect_packets2(bvh.bvh8, bvh.packet_aux, rays,
                                      retrace=False, **kw)


@pytest.mark.parametrize("span_mult,max_leaves",
                         [(1, 256), (2, 512), (1, 16)])
def test_cull_kernel_matches_plain(scene, monkeypatch, span_mult,
                                   max_leaves):
    """Kernel A: per-tile survivor keys (in worklist order) and counts
    equal the plain twin's; max_leaves=16 overflows k_cap."""
    _, bvh = scene
    o, d = _camera_rays()
    calls = _capture(monkeypatch, "cull")
    _trace(bvh, make_rays(o, d, device="cuda"), max_leaves=max_leaves,
           span_mult=span_mult)
    (args,) = calls
    k_gpu, c_gpu = packet2._cull_cuda(*args)
    k_ref, c_ref = packet2._cull_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(c_gpu, c_ref)
    assert torch.equal(k_gpu, k_ref)
    if max_leaves == 16:
        assert bool((c_ref > args[6]).any())


@pytest.mark.parametrize("case", ["empty_group", "max_blocks_256"])
def test_cull_kernel_edge_groups_match_plain(scene, monkeypatch, case):
    """Kernel A on a group whose worklist is empty (nblk 0: every tile of
    it gets count 0 and an all-I32MAX list), and on worklists of depth 256
    with max_leaves 16 (k_cap 4 overflows; counting goes on past it)."""
    _, bvh = scene
    o, d = _camera_rays()
    calls = _capture(monkeypatch, "cull")
    kw = (dict(max_leaves=256) if case == "empty_group"
          else dict(max_leaves=16, max_blocks=256))
    _trace(bvh, make_rays(o, d, device="cuda"), **kw)
    args = list(calls[0])
    if case == "empty_group":
        assert int(args[0][0]) > 0
        args[0] = args[0].clone()
        args[0][0] = 0
    else:
        assert args[1].shape[1] == 256
    k_ref, c_ref = packet2._cull_plain(*args)
    _assert_equal_outputs(packet2._cull_cuda(*args), (k_ref, c_ref))
    if case == "empty_group":
        assert not bool(c_ref[:packet2.TB].any())
        assert bool((k_ref[:packet2.TB] == packet2._I32MAX).all())
    else:
        assert bool((c_ref > args[6]).any())


def _assert_equal_outputs(got, ref):
    """Every output of a kernel equals its twin's (torch.equal)."""
    torch.cuda.synchronize()
    assert len(got) == len(ref)
    for k, (g, r) in enumerate(zip(got, ref)):
        assert torch.equal(g, r), f"output {k} differs from the twin"


def _mt_args(bvh, monkeypatch, any_hit, pack, tri_blk=256):
    """Kernel B's arguments from one packet trace of the camera tiles."""
    o, d = _camera_rays()
    aux = (bvh.packet_aux if pack == 2 else
           packet2.build_packet_aux(bvh.bvh8, pack=1))
    calls = _capture(monkeypatch, "mt_fused")
    packet2.intersect_packets2(bvh.bvh8, aux, make_rays(o, d, device="cuda"),
                               max_leaves=512, retrace=False,
                               any_hit=any_hit, tri_blk=tri_blk,
                               t_max=20.0 if any_hit else 1e30)
    (args,) = calls
    assert args[8] == tri_blk
    return args


@pytest.mark.parametrize("any_hit,pack", [(False, 2), (True, 2),
                                          (False, 1)])
def test_mt_kernel_matches_plain(scene, monkeypatch, any_hit, pack):
    """Kernel B on the same offsets/gates as the plain twin, every output
    bit for bit; pack=1 is the one-triangle-per-row table layout."""
    _, bvh = scene
    args = _mt_args(bvh, monkeypatch, any_hit, pack)
    _assert_equal_outputs(packet2._mt_fused_cuda(*args),
                          packet2._mt_fused_plain(*args)[:5])


def _edge_tiles(args):
    """Kernel B's arguments with five tiles edited: tile 0 has no key,
    tile 1 a ragged last super-block (count not a multiple of tri_blk //
    rps), tile 2 NaN gates, tile 3 its rays reversed (no ray hits), tile
    4 an initial t of +inf (a miss of kFar then wins, and zero triangles
    may not be skipped)."""
    (offs, counts, lbg, tmax, ff, t0, gtab, k_cap, tri_blk, rps, pack,
     any_hit, omap_s) = args
    counts, lbg, ff, t0 = (x.clone() for x in (counts, lbg, ff, t0))
    kpb = tri_blk // rps
    counts[0] = 0
    counts[1] = kpb + kpb // 2 + 1
    assert counts[1] <= k_cap and counts[1] % kpb
    lbg[2] = float("nan")
    ff[3, :6] = -ff[3, :6]
    t0[4] = float("inf")
    return (offs, counts, lbg, tmax, ff, t0, gtab, k_cap, tri_blk, rps,
            pack, any_hit, omap_s)


@pytest.mark.parametrize("tri_blk,pack,any_hit", [
    (128, 2, False), (256, 2, False), (128, 1, True), (256, 1, True)])
def test_mt_kernel_edge_tiles_match_plain(scene, monkeypatch, tri_blk, pack,
                                          any_hit):
    """Kernel B on tiles that reach its skips and gates (_edge_tiles),
    tri_blk 128 and 256, pack 2 closest hit and pack 1 any-hit: every
    output bit for bit."""
    _, bvh = scene
    args = _edge_tiles(_mt_args(bvh, monkeypatch, any_hit, pack, tri_blk))
    ref = packet2._mt_fused_plain(*args)[:5]
    _assert_equal_outputs(packet2._mt_fused_cuda(*args), ref)
    t, _, _, _, p = ref
    assert torch.equal(t[0], args[5][0]) and bool((p[0] == -1).all())
    assert bool((p[3] == -1).all())
    assert bool((t[4] <= 1e30).all())
    assert bool((p[5:] >= 0).any())


def leaf_alpha(prim, u, v):
    """Opaque inside a disc of the barycentric domain whose radius comes
    from a hash of the prim id (about half the cells)."""
    h = (np.asarray(prim, np.int64) * 2654435761) % 4096 / 4096.0
    return (u - 0.3) ** 2 + (v - 0.3) ** 2 < (0.2 + 0.25 * h) ** 2


def _omap_args(bvh, monkeypatch, S, any_hit):
    """Kernel B's arguments from one packet trace of the camera tiles on
    tables with S x S micromaps (pack 2 up to S = 15, pack 1 above), and
    those tables."""
    from tinybvh_tpu_torch.ops.omap import bake_omap, leaf_align

    om = bake_omap(bvh.tris.shape[0], leaf_alpha, S=S, device="cuda")
    aux = packet2.build_packet_aux(bvh.bvh8, omap=leaf_align(om, bvh.bvh8))
    assert aux.omap_s == S and aux.pack == (2 if S <= 15 else 1)
    o, d = _camera_rays()
    calls = _capture(monkeypatch, "mt_fused")
    before = packet2.LAUNCHES["mt_fused_omap"]
    packet2.intersect_packets2(bvh.bvh8, aux, make_rays(o, d, device="cuda"),
                               max_leaves=512, retrace=False,
                               any_hit=any_hit,
                               t_max=20.0 if any_hit else 1e30)
    assert packet2.LAUNCHES["mt_fused_omap"] == before + 1
    (args,) = calls
    assert args[12] == S
    return args, aux


@pytest.mark.parametrize("S,any_hit", [(4, False), (4, True), (8, False),
                                       (8, True), (16, False), (16, True)])
def test_mt_omap_kernel_matches_plain(scene, monkeypatch, S, any_hit):
    """Kernel B's micromap instantiation on the same offsets and gates as
    the plain twin, every output bit for bit: pack 2 at S = 4 and 8, pack
    1 at S = 16, closest hit and any hit."""
    _, bvh = scene
    args, _ = _omap_args(bvh, monkeypatch, S, any_hit)
    ref = packet2._mt_fused_plain(*args)[:5]
    _assert_equal_outputs(packet2._mt_fused_cuda(*args), ref)
    assert bool((ref[4] >= 0).any())


@pytest.mark.parametrize("S", [8, 16])
def test_mt_omap_kernel_edge_tiles_match_plain(scene, monkeypatch, S):
    """Kernel B's micromap instantiation on _edge_tiles's tiles, and on
    two tiles whose every key points at the zero sentinel segment (they
    walk only zero rows, which the kernel skips): every output bit for
    bit."""
    _, bvh = scene
    args, aux = _omap_args(bvh, monkeypatch, S, False)
    args = list(_edge_tiles(args))
    rps = args[9]
    offs, counts = args[0].clone(), args[1].clone()
    offs[5:7] = aux.n_segs * rps
    counts[5:7] = args[7]
    args[0], args[1] = offs, counts
    ref = packet2._mt_fused_plain(*args)[:5]
    _assert_equal_outputs(packet2._mt_fused_cuda(*args), ref)


def test_mt_kernel_many_tiles_match_plain(scene, monkeypatch):
    """Kernel B on 2,080 tiles (the 16 camera tiles repeated, each cut to
    a random count of keys): more tiles than the tile-order pre-pass has
    threads, with every super-block count from 0 to k_cap / kpb. Every
    output bit for bit."""
    _, bvh = scene
    args = list(_mt_args(bvh, monkeypatch, False, 2, 128))
    T = args[0].shape[0]
    reps = 130
    for k in range(6):
        args[k] = args[k].repeat((reps,) + (1,) * (args[k].dim() - 1))
    rng = np.random.default_rng(11)
    args[1] = torch.from_numpy(rng.integers(
        0, args[7] + 1, T * reps).astype(np.int32)).cuda()
    assert args[0].shape[0] > 2048
    _assert_equal_outputs(packet2._mt_fused_cuda(*args),
                          packet2._mt_fused_plain(*args)[:5])


def far_hit_rows(pack):
    """gtab rows of two segment keys (rps = 16 // pack rows each): key 0's
    triangles are hit by every ray at t = 1e31, past BVH_FAR (only the
    constant feature's lane 9 of each dot is set: det 1, u' = v' = 0.25,
    t' = 1e31), prim id 7; key 1's triangles are all zero, prim id 99.
    Returns (gtab (2 rps, 128) f32, rps). Also used by
    tests/test_torch_packet2.py."""
    rps = 16 // pack
    g = np.zeros((2 * rps, 128), np.float32)
    for base in ((0, 48) if pack == 2 else (0,)):
        for lane, val in ((9, 1.0), (21, 0.25), (33, 0.25), (45, 1e31)):
            g[:rps, base + lane] = val
    pid = np.array([7, 99], np.int32).view(np.float32)
    for col in ((96, 97) if pack == 2 else (48,)):
        g[:rps, col], g[rps:, col] = pid
    return g, rps


@pytest.mark.parametrize("pack", [1, 2])
def test_mt_kernel_far_hits_take_the_first_dead_row(pack):
    """Kernel B on one tile whose only live key holds triangles hit at
    t = 1e31, past kFar, with an initial t of +inf: the kernel walks no
    dead row, yet the first one must win as in the twin (t = kFar, its
    row and prim id; tests/test_torch_packet2.py holds the twin to JAX)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    g, rps = far_hit_rows(pack)
    gtab = torch.zeros((2 * rps + 8, 128), device="cuda")
    gtab[:2 * rps] = torch.from_numpy(g)
    k_cap = 128 // rps
    offs = torch.full((1, k_cap), rps, dtype=torch.int32, device="cuda")
    offs[0, 0] = 0
    rng = np.random.default_rng(5)
    ff = torch.from_numpy(rng.normal(size=(1, 12, 256)).astype(np.float32))
    ff[:, 9], ff[:, 10:] = 1.0, 0.0
    args = (offs, torch.ones(1, dtype=torch.int32, device="cuda"),
            torch.zeros((1, 1), device="cuda"),
            torch.full((1,), 1e30, device="cuda"), ff.cuda(),
            torch.full((1, 256), float("inf"), device="cuda"), gtab, k_cap,
            128, rps, pack, False)
    ref = packet2._mt_fused_plain(*args)[:5]
    _assert_equal_outputs(packet2._mt_fused_cuda(*args), ref)
    assert bool((ref[1] == rps).all()) and bool((ref[4] == 99).all())


def test_launch_rejects_bad_inputs(scene, monkeypatch):
    """A wrong dtype, a mix of devices or a bad shape raises; nothing
    falls back to the CPU."""
    _, bvh = scene
    o, d = _camera_rays(T=8)
    calls = _capture(monkeypatch, "mt_fused")
    _trace(bvh, make_rays(o, d, device="cuda"))
    args = list(calls[0])
    bad = list(args)
    bad[0] = args[0].float()
    with pytest.raises(TypeError):
        packet2.mt_fused(*bad)
    bad = list(args)
    bad[1] = args[1].cpu()
    with pytest.raises(ValueError):
        packet2.mt_fused(*bad)
    bad = list(args)
    bad[4] = args[4][:, :6].contiguous()
    with pytest.raises(ValueError):
        packet2.mt_fused(*bad)


def test_tf32_forced_on_changes_nothing(scene):
    _, bvh = scene
    o, d = _camera_rays()
    rays = make_rays(o, d, device="cuda")
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        h0, _ = _trace(bvh, rays)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        h1, _ = _trace(bvh, rays)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
    assert torch.equal(h0.prim, h1.prim)
    assert torch.equal(h0.t, h1.t)


def test_api_on_cuda_matches_oracle(scene):
    tris, bvh = scene
    o, d = _camera_rays()
    rays = make_rays(o, d, device="cuda")
    before = dict(packet2.LAUNCHES)
    h = bvh.intersect(rays)
    assert packet2.LAUNCHES["cull"] > before["cull"]
    assert packet2.LAUNCHES["mt_fused"] > before["mt_fused"]
    ref = brute_force_closest(rays, bvh.tris)
    hp, rp = h.prim.cpu().numpy(), ref.prim.cpu().numpy()
    np.testing.assert_array_equal(hp, rp)
    m = rp >= 0
    assert 0.0 < m.mean() < 1.0
    np.testing.assert_allclose(h.t.cpu().numpy()[m], ref.t.cpu().numpy()[m],
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("sort", [False, True])
def test_mt_gathered_kernel_matches_plain(scene, monkeypatch, sort):
    """Kernel C on the gathered rows and gates of the fused=False path
    (zero gates; with sort=True, distance gates from the sorted keys)."""
    _, bvh = scene
    o, d = _camera_rays()
    calls = _capture(monkeypatch, "mt_resolve")
    _trace(bvh, make_rays(o, d, device="cuda"), max_leaves=512,
           fused=False, sort=sort)
    (args,) = calls
    assert args[2].shape[1] == 2048
    t, i = packet2._mt_cuda(*args)
    tr, ir, _ = packet2._mt_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(i, ir)
    assert torch.equal(t, tr)
    assert bool((tr < 1e30).any())


@pytest.mark.parametrize("span_mult", [1, 2])
def test_cull_blocks_kernel_matches_plain(scene, monkeypatch, span_mult):
    """Kernel G on the cull's own descriptors: the block mask equals the
    plain twin's (cull_tiles' coarse tier), and through _worklists gives
    the worklists the cull handed kernel A."""
    _, bvh = scene
    o, d = _camera_rays()
    calls = _capture(monkeypatch, "cull")
    _trace(bvh, make_rays(o, d, device="cuda"), span_mult=span_mult)
    nblk0, wl0, desc = calls[0][:3]
    aux = bvh.packet_aux
    got = packet2._cull_blocks_cuda(desc, aux.blk_lo, aux.blk_hi,
                                    aux.n_blocks)
    ref = packet2._cull_blocks_plain(desc, aux.blk_lo, aux.blk_hi,
                                     aux.n_blocks)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert bool(got.any())
    if span_mult == 1:
        nblk, wl, _ = packet2._worklists(got[:, 0] > 0, wl0.shape[1])
        assert torch.equal(nblk, nblk0) and torch.equal(wl, wl0)


def test_cull_blocks_kernel_strides_past_128_blocks(scene, monkeypatch):
    """Kernel G over nbpad = 384 block ids (three CTAs of 128 ids a group)
    with n_blocks = 301, inside the last chunk: random boxes around the
    scene, bit equal to the plain twin."""
    _, bvh = scene
    o, d = _camera_rays()
    calls = _capture(monkeypatch, "cull")
    _trace(bvh, make_rays(o, d, device="cuda"))
    desc = calls[0][2]
    rng = np.random.default_rng(7)
    lo, hi = (np.asarray(x, np.float32) for x in bvh.aabb)
    c = rng.uniform(lo, hi, (384, 3)).astype(np.float32)
    r = rng.uniform(0.0, 0.2, (384, 3)).astype(np.float32) * (hi - lo)
    blo = torch.from_numpy(np.ascontiguousarray((c - r).T)).cuda()
    bhi = torch.from_numpy(np.ascontiguousarray((c + r).T)).cuda()
    got = packet2._cull_blocks_cuda(desc, blo, bhi, 301)
    ref = packet2._cull_blocks_plain(desc, blo, bhi, 301)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert bool(got[..., 128:301].any())
    assert not bool(got[..., 301:].any())


def test_new_wrappers_reject_bad_inputs(scene, monkeypatch):
    """Kernels C and G: a wrong dtype, a mix of devices or a bad shape
    raises; nothing falls back to the plain twin."""
    _, bvh = scene
    o, d = _camera_rays(T=8)
    calls = _capture(monkeypatch, "mt_resolve")
    _trace(bvh, make_rays(o, d, device="cuda"), fused=False)
    args = list(calls[0])
    before = dict(packet2.LAUNCHES)
    bad = list(args)
    bad[2] = args[2].double()
    with pytest.raises(TypeError):
        packet2.mt_resolve(*bad)
    bad = list(args)
    bad[4] = args[4].cpu()
    with pytest.raises(ValueError):
        packet2.mt_resolve(*bad)
    bad = list(args)
    bad[2] = args[2][:, :100].contiguous()
    with pytest.raises(ValueError):
        packet2.mt_resolve(*bad)
    aux = bvh.packet_aux
    desc = torch.zeros((16, 128), dtype=torch.float32, device="cuda")
    with pytest.raises(TypeError):
        packet2.cull_blocks(desc.half(), aux.blk_lo, aux.blk_hi, 1)
    with pytest.raises(ValueError):
        packet2.cull_blocks(desc, aux.blk_lo.cpu(), aux.blk_hi, 1)
    with pytest.raises(ValueError):
        packet2.cull_blocks(desc, aux.blk_lo[:, :100].contiguous(),
                            aux.blk_hi[:, :100].contiguous(), 1)
    assert packet2.LAUNCHES == before


def test_unfused_and_wavefront_retrace_on_cuda(scene):
    """fused=False and the wavefront retrace of a tiny budget on the
    card: the same hits as the fused path and the oracle."""
    _, bvh = scene
    o, d = _camera_rays()
    rays = make_rays(o, d, device="cuda")
    before = dict(packet2.LAUNCHES)
    hf, _ = _trace(bvh, rays, max_leaves=512)
    hu, _ = _trace(bvh, rays, max_leaves=512, fused=False)
    # every tile overflows 32 leaves; their frontier peaks near 8.3 pairs
    # per ray, past the default cap of 8
    hw, ov = packet2.intersect_packets2(bvh.bvh8, bvh.packet_aux, rays,
                                        max_leaves=32, retrace=True,
                                        wf_cap_factor=16)
    assert packet2.LAUNCHES["mt_gathered"] > before["mt_gathered"]
    assert not bool(ov.any())
    ref = brute_force_closest(rays, bvh.tris)
    for h in (hf, hu, hw):
        assert torch.equal(h.prim, ref.prim)
        np.testing.assert_allclose(h.t.cpu().numpy(), ref.t.cpu().numpy(),
                                   rtol=1e-4, atol=1e-4)


def _v1_inputs(bvh, max_leaves):
    """Tile rays (T, 3, 256) on the card and each tile's leaf list from
    the v1 engine's phase 1."""
    o, d = _camera_rays()
    rays = make_rays(o, d, device="cuda")
    T = rays.o.shape[0] // 256
    o3 = rays.o.reshape(T, 256, 3)
    d3 = rays.d.reshape(T, 256, 3)
    leaves, _ = pk.collect_tile_leaves(bvh.bvh8, o3.amin(1), d3, max_leaves,
                                       64, tile_ohi=o3.amax(1))
    return (leaves, o3.permute(0, 2, 1).contiguous(),
            d3.permute(0, 2, 1).contiguous(), o3, d3)


@pytest.mark.parametrize("wide,max_leaves", [(False, 512), (True, 512),
                                             (False, 40), (True, 40)])
def test_leaf_resolve_v2_kernel_matches_plain(scene, wide, max_leaves):
    """Kernel D, both bodies' tie rules, on the engine's gathered rows:
    K4 = 2048 (8 chunks; v3 block 256) and K4 = 160 (a partial chunk; v3
    block 32)."""
    _, bvh = scene
    leaves, o_t, d_t, _, _ = _v1_inputs(bvh, max_leaves)
    T, K = leaves.shape
    rows = torch.clamp(leaves, 0, bvh.bvh8.leaf_tris.shape[0] - 1)
    idx = (rows[:, :, None] * 4
           + torch.arange(4, device="cuda")).long()
    geom = torch.where((leaves != 2**31 - 1)[:, :, None, None],
                       lr.pack_tri_geom(bvh.bvh8)[idx],
                       0.0).reshape(T, 4 * K, 12)
    t, i = lr._resolve_v2_cuda(o_t, d_t, geom, wide)
    tr, ir = lr._resolve_v2_plain(o_t, d_t, geom, wide)
    torch.cuda.synchronize()
    assert torch.equal(i, ir) and torch.equal(t, tr)
    assert bool((tr < 1e30).any())


# Kernel D's edge cases (also held against JAX on the CPU by
# tests/test_torch_leaf_edges.py): T = 2 tiles of 256 rays from z = -4
# towards +z, K4 = 512 rows (v3 block 256); rows [v0 | e1 | e2 | 0].
LEAF_EDGE_CASES = ("all_dead", "last_chunk", "zero_tris", "ties")
# the winning row of every ray in the ties case, per tile: v2 the first
# copy, v3 the least (sublane idx % 256, block idx // 256)
LEAF_TIE_ROWS = {False: (10, 3), True: (265, 258)}


def leaf_edge_inputs(case, seed=0):
    """(o_t, d_t (2, 3, 256), geom (2, 512, 12)) numpy f32 of one case:
    all_dead: tile 0 all zero rows, tile 1 live rows 0-99 then zeros;
    last_chunk: live rows only in the last 128-row chunk (tile 0: the
    last 40 rows; tile 1: rows 384-415);
    zero_tris: rows 0-299 live but for the zero rows r % 4 == 3 or r % 7
    == 0 (short leaves), zeros after;
    ties: one large triangle at z = 0.5 in front of every ray, copied to
    rows 10, 265 and 300 (tile 0) and 3 and 258 (tile 1), random
    triangles behind it in rows 0-199: exact ties in t across rows and
    across v3 sublanes."""
    rng = np.random.default_rng(seed)
    T, K4 = 2, 512
    o = np.zeros((T, 3, 256), np.float32)
    o[:, :2] = rng.uniform(-0.05, 0.05, (T, 2, 256))
    o[:, 2] = -4.0
    d = np.ones((T, 3, 256))
    d[:, :2] = rng.uniform(-0.1, 0.1, (T, 2, 256))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)

    def tris(n, z=(0.0, 3.0)):
        c = np.stack([rng.uniform(-0.4, 0.4, n), rng.uniform(-0.4, 0.4, n),
                      rng.uniform(*z, n)], -1)
        v = c[:, None] + rng.uniform(-0.6, 0.6, (n, 3, 3)) * [1, 1, 0.2]
        return np.concatenate([v[:, 0], v[:, 1] - v[:, 0], v[:, 2] - v[:, 0],
                               np.zeros((n, 3))], -1)

    g = np.zeros((T, K4, 12))
    if case == "all_dead":
        g[1, :100] = tris(100)
    elif case == "last_chunk":
        g[0, K4 - 40:] = tris(40)
        g[1, 384:416] = tris(32)
    elif case == "zero_tris":
        r = np.arange(300)
        for t in range(T):
            g[t, :300] = tris(300)
            g[t, r[(r % 4 == 3) | (r % 7 == 0)]] = 0.0
    elif case == "ties":
        big = np.array([-3, -3, 0.5, 8, 0, 0, 0, 8, 0, 0, 0, 0])
        for t, rows in enumerate(((10, 265, 300), (3, 258))):
            g[t, :200] = tris(200, z=(1.0, 3.0))
            g[t, list(rows)] = big
    else:
        raise ValueError(case)
    return o, d, g.astype(np.float32)


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("case", LEAF_EDGE_CASES)
def test_leaf_resolve_v2_kernel_edge_cases(case, wide):
    """Kernel D (it skips the rows whose e2 is zero) against its twin
    (which tests every row) on the edge cases, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    o_t, d_t, geom = (torch.from_numpy(x).cuda()
                      for x in leaf_edge_inputs(case))
    t, i = lr._resolve_v2_cuda(o_t, d_t, geom, wide)
    tr, ir = lr._resolve_v2_plain(o_t, d_t, geom, wide)
    torch.cuda.synchronize()
    assert torch.equal(i, ir) and torch.equal(t, tr)
    if case == "ties":
        want = torch.tensor(LEAF_TIE_ROWS[wide], dtype=torch.int32,
                            device="cuda")[:, None]
        assert bool((i == want).all())
    if case == "all_dead":
        assert bool((t[0] == 1e30).all()) and not bool(i[0].any())


def test_leaf_resolve_v2_kernel_at_the_shadow_budget(scene):
    """Kernel D at K4 = 8,192 rows (2,048 leaves a tile, the v1 engine's
    shadow budget V1_SHADOW), both bodies (v3 block 256)."""
    _, bvh = scene
    leaves, o_t, d_t, _, _ = _v1_inputs(bvh, 2048)
    T, K = leaves.shape
    rows = torch.clamp(leaves, 0, bvh.bvh8.leaf_tris.shape[0] - 1)
    idx = (rows[:, :, None] * 4
           + torch.arange(4, device="cuda")).long()
    geom = torch.where((leaves != 2**31 - 1)[:, :, None, None],
                       lr.pack_tri_geom(bvh.bvh8)[idx],
                       0.0).reshape(T, 4 * K, 12)
    assert geom.shape[1] == 8192
    for wide in (False, True):
        t, i = lr._resolve_v2_cuda(o_t, d_t, geom, wide)
        tr, ir = lr._resolve_v2_plain(o_t, d_t, geom, wide)
        torch.cuda.synchronize()
        assert torch.equal(i, ir) and torch.equal(t, tr)
    assert bool((tr < 1e30).any())


@pytest.mark.parametrize("max_leaves", [512, 40])
def test_leaf_resolve_kernel_matches_plain(scene, max_leaves):
    """Kernel E on pack_leaf_geom rows gathered by the tile lists, with
    the live mask and the rows (8 chunks of 64 leaves; a partial one)."""
    _, bvh = scene
    leaves, o_t, d_t, _, _ = _v1_inputs(bvh, max_leaves)
    live = (leaves != 2**31 - 1).to(torch.int32)
    rows = torch.clamp(leaves, 0, bvh.bvh8.leaf_tris.shape[0] - 1)
    geom = lr.pack_leaf_geom(bvh.bvh8)[rows.long()].contiguous()
    t, p = lr._resolve_cuda(o_t, d_t, geom, live, rows)
    tr, pr = lr._resolve_plain(o_t, d_t, geom, live, rows)
    torch.cuda.synchronize()
    assert torch.equal(p, pr) and torch.equal(t, tr)
    assert bool((tr < 1e30).any())


# Kernels C and E on constructed inputs (also held against JAX on the CPU
# by tests/test_torch_resolve_edges.py): rays from z = -4 towards +z, two
# rays a thread as the kernels take them; triangles between z = 0 and 3.
MT_EDGE_CASES = ("interleaved", "empty_blocks", "misses_at_inf", "nan",
                 "ties", "k4_128", "k4_384_gates", "nonfinite_rays")
# the winning row of every ray in the ties case, per tile: the first copy
MT_TIE_ROWS = (10, 200)
LEAF_RESOLVE_EDGE_CASES = ("interleaved", "last_chunk", "zero_tris", "ties",
                           "one_tile")
# the packed winner of every ray in the ties case, per tile: rows[leaf] * 4
# + lane of the first (leaf, lane) holding the copy
LEAF_RESOLVE_TIE_LEAVES = ((5, 2), (10, 1))


def _edge_rays(rng, T):
    """(o_t, d_t) (T, 3, 256) f32: origins near (0, 0, -4), directions near
    +z, every ray in front of the triangles of _edge_tris."""
    o = np.zeros((T, 3, 256), np.float32)
    o[:, :2] = rng.uniform(-0.05, 0.05, (T, 2, 256))
    o[:, 2] = -4.0
    d = np.ones((T, 3, 256))
    d[:, :2] = rng.uniform(-0.1, 0.1, (T, 2, 256))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d


def _edge_tris(rng, n, z=(0.0, 3.0), x=(-0.4, 0.4)):
    """n random triangles (n, 3, 3) around the rays' paths."""
    c = np.stack([rng.uniform(*x, n), rng.uniform(-0.4, 0.4, n),
                  rng.uniform(*z, n)], -1)
    return c[:, None] + rng.uniform(-0.6, 0.6, (n, 3, 3)) * [1, 1, 0.2]


def mt_rows(tris):
    """(n, 48) kernel C rows [G_det | G_u | G_v | G_t] of triangles (n, 3,
    3), in build_packet_aux's form: G_det = [n, 0...], G_u = [-(v0 x e2),
    -e2, 0...], G_v = [v0 x e1, e1, 0...], G_t = [0, 0, -n, n.v0, 0, 0]."""
    v0 = tris[:, 0]
    e1 = tris[:, 1] - v0
    e2 = tris[:, 2] - v0
    nrm = np.cross(e1, e2)
    g = np.zeros((len(tris), 48))
    g[:, 0:3] = nrm
    g[:, 12:15] = -np.cross(v0, e2)
    g[:, 15:18] = -e2
    g[:, 24:27] = np.cross(v0, e1)
    g[:, 27:30] = e1
    g[:, 42:45] = -nrm
    g[:, 45] = (nrm * v0).sum(-1)
    return g


def _far_rows(n):
    """Rows that every ray hits at t = 1e31, past BVH_FAR (only lane 9 of
    each part is set: det 1, u' = v' = 0.25, t' = 1e31)."""
    g = np.zeros((n, 48))
    g[:, 9], g[:, 21], g[:, 33], g[:, 45] = 1.0, 0.25, 0.25, 1e31
    return g


def mt_edge_inputs(case, seed=0):
    """(o_t, d_t (T, 3, 256), geom (T, K4, 48), lbg (T, 1, K4 / 128),
    tmax (T, 1, 1)) numpy f32 of one kernel C case. Dead rows are zero;
    gates are 0, tmax 1e30 unless a case says otherwise.
    interleaved: rows 0-399 live where r % 3 != 1, a third of them off
      build_packet_aux's form (det lane 5 set), rows 9 and 50 with a
      non-finite lane 10 (they miss every ray);
    empty_blocks: tile 0's block 1 holds no live row; tile 1 no live row
      at all; tile 2 none either, with tmax = +inf (row 0 of block 0
      then wins at kFar);
    misses_at_inf: tmax = +inf; tile 0's block 0 holds only triangles
      beside the rays, block 1 hits; tile 1's rows 0-1 are hit past kFar,
      row 2 is missed and row 3 dead (row 2 wins at kFar); tile 2's rows
      0-1 are hit past kFar and row 2 is dead (row 2 wins);
    nan: tile 0's block 0 holds a row hit at t = NaN (inf / inf) beside
      real hits, which it hides; tile 1 has tmax = NaN; tile 2 a NaN gate
      at block 1;
    ties: one large triangle copied to rows 10, 70 and 130 (tile 0) and
      200 and 300 (tile 1) in front of random ones: exact ties within a
      block and across blocks;
    k4_128: K4 = 128, one block; k4_384_gates: K4 = 384 (an odd number of
      blocks) with distance gates 0, 4 and 6.5: block 0 hits every ray
      near t = 4.2, so block 1 runs and block 2 does not;
    nonfinite_rays: tile 0's ray 17 has o.x = inf and ray 18 d.y = NaN
      (their features are not finite), tile 1 is plain."""
    rng = np.random.default_rng(seed)
    T, K4 = {"empty_blocks": 3, "nan": 3, "misses_at_inf": 3}.get(case,
                                                                  2), 512
    if case == "k4_128":
        K4 = 128
    elif case == "k4_384_gates":
        K4 = 384
    o, d = _edge_rays(rng, T)
    g = np.zeros((T, K4, 48))
    lbg = np.zeros((T, 1, K4 // 128))
    tmax = np.full((T, 1, 1), 1e30)
    if case == "interleaved":
        r = np.arange(400)
        live = r[r % 3 != 1]
        for t in range(T):
            g[t, live] = mt_rows(_edge_tris(rng, len(live)))
            g[t, live[::3], 5] = 1e-3
            g[t, [9, 50], 22 + 12 * t] = np.inf
    elif case == "empty_blocks":
        g[0, :128] = mt_rows(_edge_tris(rng, 128))
        g[0, 256:300] = mt_rows(_edge_tris(rng, 44))
        tmax[2] = np.inf
    elif case == "misses_at_inf":
        tmax[:] = np.inf
        g[0, :100] = mt_rows(_edge_tris(rng, 100, x=(5.0, 6.0)))
        g[0, 128:228] = mt_rows(_edge_tris(rng, 100))
        g[1, :2] = _far_rows(2)
        g[1, 2] = mt_rows(_edge_tris(rng, 1, x=(5.0, 6.0)))[0]
        g[1, 4:100] = mt_rows(_edge_tris(rng, 96, x=(5.0, 6.0)))
        g[2, :2] = _far_rows(2)
        g[2, 3:60] = mt_rows(_edge_tris(rng, 57, x=(5.0, 6.0)))
    elif case == "nan":
        for t in range(T):
            g[t, :256] = mt_rows(_edge_tris(rng, 256))
        g[0, 5] = 0.0
        g[0, 5, 9], g[0, 5, 45] = np.inf, np.inf
        tmax[1] = np.nan
        lbg[2, 0, 1] = np.nan
    elif case == "ties":
        big = mt_rows(np.array([[[-3, -3, 0.5], [5, -3, 0.5], [-3, 5, 0.5]]]))
        for t, rows in enumerate(((10, 70, 130), (200, 300))):
            g[t, :400] = mt_rows(_edge_tris(rng, 400, z=(1.0, 3.0)))
            g[t, list(rows)] = big[0]
    elif case == "k4_128":
        r = np.arange(K4)
        for t in range(T):
            live = r[(r * 7 + t) % 5 < 3]
            g[t, live] = mt_rows(_edge_tris(rng, len(live)))
    elif case == "k4_384_gates":
        near = np.array([[[-3, -3, 0.2], [5, -3, 0.2], [-3, 5, 0.2]]])
        for t in range(T):
            g[t] = mt_rows(_edge_tris(rng, K4, z=(0.5, 3.0)))
            g[t, 60] = mt_rows(near)[0]
        lbg[:, 0] = (0.0, 4.0, 6.5)
    elif case == "nonfinite_rays":
        for t in range(T):
            g[t, :300] = mt_rows(_edge_tris(rng, 300))
        o[0, 0, 17] = np.inf
        d[0, 1, 18] = np.nan
    else:
        raise ValueError(case)
    return (o, d, g.astype(np.float32), lbg.astype(np.float32),
            tmax.astype(np.float32))


def leaf_resolve_edge_inputs(case, seed=0):
    """(o_t, d_t (T, 3, 256), geom (T, K, 48), live (T, K), rows (T, K))
    numpy of one kernel E case: x-major leaves [v0x*4 | v0y*4 | v0z*4 |
    e1.. | e2.. | pad], live flags, and leaf row ids (a permutation of
    1000 + leaf).
    interleaved: K = 100 (not a multiple of the 32-leaf chunk), leaves with
      j % 3 == 1 dead though they hold triangles;
    last_chunk: K = 100, live leaves only in the last, partial chunk;
    zero_tris: K = 96, every leaf's lane 3 zero and lane 1 zero in every
      other leaf;
    ties: K = 128, one large triangle at leaf 5 lanes 2 and 3 and leaf 40
      lane 0 (tile 0), at leaf 10 lane 1 and leaf 70 lane 0 (tile 1), in
      front of random ones: ties across lanes and across leaves;
    one_tile: T = 1, K = 64."""
    rng = np.random.default_rng(seed)
    T, K = {"ties": (2, 128), "zero_tris": (2, 96),
            "one_tile": (1, 64)}.get(case, (2, 100))
    o, d = _edge_rays(rng, T)
    tris = _edge_tris(rng, T * K * 4).reshape(T, K, 4, 3, 3)
    live = np.ones((T, K), np.int32)
    if case == "interleaved":
        live[:, np.arange(K) % 3 == 1] = 0
    elif case == "last_chunk":
        live[:, :96] = 0
    elif case == "zero_tris":
        tris[:, :, 3] = 0.0
        tris[:, ::2, 1] = 0.0
    elif case == "ties":
        tris[..., 2] = np.maximum(tris[..., 2], 1.0)
        big = np.array([[-3, -3, 0.5], [5, -3, 0.5], [-3, 5, 0.5]])
        for t, spots in enumerate((((5, 2), (5, 3), (40, 0)),
                                   ((10, 1), (70, 0)))):
            for leaf, lane in spots:
                tris[t, leaf, lane] = big
    elif case != "one_tile":
        raise ValueError(case)
    v0 = tris[..., 0, :]
    e1 = tris[..., 1, :] - v0
    e2 = tris[..., 2, :] - v0
    fields = [f[..., k] for f in (v0, e1, e2) for k in range(3)]
    geom = np.concatenate(fields + [np.zeros((T, K, 12))], axis=-1)
    rows = np.stack([rng.permutation(K) + 1000 for _ in range(T)])
    return (o, d, geom.astype(np.float32), live, rows.astype(np.int32))


def _bits(x):
    """A float tensor's bits (so that NaN outputs compare equal)."""
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("case", MT_EDGE_CASES)
def test_mt_gathered_kernel_edge_cases(case):
    """Kernel C (it skips rows that can only miss, the zero lanes of
    build_packet_aux rows and the rest of a row no ray of a warp can hit)
    against its twin (every row, all 12 lanes) on the edge cases: t bit
    for bit (NaN included) and rows equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    args = tuple(torch.from_numpy(x).cuda() for x in mt_edge_inputs(case))
    t, i = packet2._mt_cuda(*args)
    tr, ir, _ = packet2._mt_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(i, ir) and torch.equal(_bits(t), _bits(tr))
    if case == "ties":
        want = torch.tensor(MT_TIE_ROWS, dtype=torch.int32,
                            device="cuda")[:, None]
        assert bool((i == want).all())


@pytest.mark.parametrize("case", LEAF_RESOLVE_EDGE_CASES)
def test_leaf_resolve_kernel_edge_cases(case):
    """Kernel E (it skips dead leaves and zero triangles, and orders the
    tiles by their live leaves) against its twin on the edge cases, bit
    for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    o_t, d_t, geom, live, rows = (torch.from_numpy(x).cuda() for x in
                                  leaf_resolve_edge_inputs(case))
    t, p = lr._resolve_cuda(o_t, d_t, geom, live, rows)
    tr, pr = lr._resolve_plain(o_t, d_t, geom, live, rows)
    torch.cuda.synchronize()
    assert torch.equal(p, pr) and torch.equal(t, tr)
    if case == "ties":
        want = [int(rows[k, leaf]) * 4 + lane for k, (leaf, lane) in
                enumerate(LEAF_RESOLVE_TIE_LEAVES)]
        assert bool((p == torch.tensor(want, device="cuda")[:, None]).all())


@pytest.mark.parametrize("max_leaves", [512, 16])
def test_frustum_walk_kernel_matches_plain(scene, max_leaves):
    """Kernel F: every tile's list and count equal the twin's; at 16
    leaves the overflow path (count -1, first 16 leaves kept) runs on
    most tiles."""
    _, bvh = scene
    _, _, _, o3, d3 = _v1_inputs(bvh, 16)
    tile_o = o3[:, 0]
    planes = pk._tile_planes(tile_o, d3).contiguous()
    ndoto = pk._sum3(planes * tile_o[:, None, :]).reshape(-1, 1, 4)
    args = (bvh.bvh8.bounds, bvh.bvh8.child, planes, ndoto.contiguous(),
            max_leaves)
    leaves, counts = fw._walk_cuda(*args)
    lref, cref, _ = fw._walk_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(counts, cref) and torch.equal(leaves, lref)
    if max_leaves == 16:
        assert int((cref == -1).sum()) > cref.shape[0] // 2
    else:
        assert bool((cref > 0).all())


# ---- kernels F and G on constructed edge cases -------------------------

WALK_EDGE_CASES = ("stack_overflow", "exact_k", "k_plus_1", "empty_slots",
                   "reject_all", "oblique_planes", "touching")
# malformed trees (a node that points back at the root): JAX's walk has no
# step bound and never ends on them, so only the kernel meets its twin
WALK_CYCLE_CASES = ("cycle_chain", "cycle_fork")
_EMPTY = -2147483647        # layouts/mbvh.py EMPTY_SLOT
_IN = ((0.25, 0.25, 0.0), (0.5, 0.5, 1.0))   # inside the unit window


class _Tree:
    """BVH8 tables built node by node (node 0 is the root): bounds (M, 48),
    each node's (6, 8) rows lo x, y, z, hi x, y, z with a column a child
    slot; child (M, 8): a node id, -(leaf id) - 1, or EMPTY_SLOT."""

    def __init__(self):
        self.bounds, self.child, self.n_leaves = [], [], 0

    def node(self):
        self.bounds.append(np.zeros((6, 8), np.float32))
        self.child.append(np.full(8, _EMPTY, np.int32))
        return len(self.child) - 1

    def put(self, node, slot, kid, box=_IN):
        self.child[node][slot] = kid
        self.bounds[node][:3, slot] = box[0]
        self.bounds[node][3:, slot] = box[1]

    def leaf(self, node, slot, box=_IN):
        self.put(node, slot, -self.n_leaves - 1, box)
        self.n_leaves += 1

    def tables(self):
        return np.stack(self.bounds).reshape(-1, 48), np.stack(self.child)


def _windows(wins):
    """planes (T, 4, 3) and ndoto (T, 1, 4) of axis windows (x0, x1, y0,
    y1): a box is inside when it meets x0 <= x <= x1 and y0 <= y <= y1
    (z free); the normals have zero and negative components."""
    n = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0]], np.float32)
    nd = np.array([[x0, -x1, y0, -y1] for x0, x1, y0, y1 in wins],
                  np.float32)
    return np.broadcast_to(n, (len(wins), 4, 3)).copy(), nd[:, None, :]


def _random_tree(rng, depth=3):
    """Every slot of node j (breadth first) holds (slot + j) % 3: EMPTY_SLOT,
    a leaf or a node (a leaf at the last level), so that each slot position
    holds each kind somewhere; every box random inside [0, 1]^3."""
    t = _Tree()
    level = [t.node()]
    for dep in range(depth + 1):
        nxt = []
        for j in level:
            for s in range(8):
                c = rng.uniform(0.0, 1.0, 3)
                r = rng.uniform(0.02, 0.2, 3)
                box = (c - r, c + r)
                kind = (s + j) % 3
                if kind == 0:
                    t.put(j, s, _EMPTY, box)
                elif kind == 1 or dep == depth:
                    t.leaf(j, s, box)
                else:
                    k = t.node()
                    t.put(j, s, k, box)
                    nxt.append(k)
        level = nxt
    return t


def walk_edge_inputs(case, seed=0):
    """(bounds (M, 48), child (M, 8), planes (T, 4, 3), ndoto (T, 1, 4))
    numpy and max_leaves of one case:
    stack_overflow: a chain of 12 nodes, each pushing 7 side nodes (one
    leaf each) and the next chain node in its highest slot, so that sp
    passes 64 at the 9th (tile 0) and the clamp to 63 runs; tile 1 sees
    only 4 side nodes a level and stays below 64;
    exact_k / k_plus_1: 20 visible leaves in tile 0 (12 in tile 1) at
    max_leaves 20 and 19;
    empty_slots: EMPTY_SLOT children mixed with leaves and nodes in every
    slot (_random_tree), three windows;
    reject_all: the same tree, windows beside the scene on each side;
    oblique_planes: the same tree, planes of random normals with zero and
    negative components, each a random margin behind the scene's centre;
    touching: boxes whose face lies on a plane (dist == 0, inside) beside
    boxes one ulp outside it;
    cycle_chain / cycle_fork: node 1 points back at the root once / twice
    (malformed: only the step bound or the stack overflow ends the walk)."""
    rng = np.random.default_rng(seed)
    K = 128
    if case == "stack_overflow":
        t = _Tree()
        chain = [t.node() for _ in range(12)]
        for i, c in enumerate(chain):
            for s in range(7):
                side = t.node()
                box = ((s / 8, 0.25, 0.0), (s / 8 + 0.1, 0.5, 1.0))
                t.put(c, s, side, box)
                t.leaf(side, 0, box)
            if i + 1 < len(chain):
                t.put(c, 7, chain[i + 1], ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)))
            else:
                t.leaf(c, 7)
        planes, ndoto = _windows([(0, 1, 0, 1), (0, 0.45, 0, 1)])
    elif case in ("exact_k", "k_plus_1"):
        t = _Tree()
        root, a, b, c = (t.node() for _ in range(4))
        far = ((0.8, 0.8, 0.0), (0.9, 0.9, 1.0))     # outside window 1
        t.leaf(root, 0)
        t.put(root, 1, a, far)
        t.leaf(root, 3)
        t.put(root, 4, b)
        t.leaf(root, 5)
        for s in range(8):
            t.leaf(a, s, far)
        for s in range(4):
            t.leaf(b, s)
        t.put(b, 5, c)
        for s in (0, 2, 3, 6, 7):
            t.leaf(c, s)
        planes, ndoto = _windows([(0, 1, 0, 1), (0, 0.6, 0, 0.6)])
        K = 20 if case == "exact_k" else 19
    elif case in ("empty_slots", "reject_all", "oblique_planes"):
        t = _random_tree(rng)
        if case == "empty_slots":
            planes, ndoto = _windows([(0, 1, 0, 1), (0.4, 1, 0, 1),
                                      (0.2, 0.7, 0.3, 1)])
        elif case == "reject_all":
            planes, ndoto = _windows([(1.5, 2, 0, 1), (-2, -1.5, 0, 1),
                                      (0, 1, 1.5, 2), (0, 1, -2, -1.5)])
        else:
            normals = np.array([[0.6, -0.8, 0.0], [-0.6, 0.0, 0.8],
                                [0.0, 0.8, -0.6], [-0.8, -0.6, 0.0],
                                [0.0, 0.0, -1.0], [0.8, 0.0, 0.6]],
                               np.float32)
            T = 4
            planes = normals[rng.integers(0, len(normals), (T, 4))]
            # each plane a random margin behind the scene's centre
            ndoto = ((planes * 0.5).sum(-1) - rng.uniform(0.05, 0.3, (T, 4))
                     ).astype(np.float32)[:, None, :]
    elif case == "touching":
        t = _Tree()
        root, inner = t.node(), t.node()
        below = np.nextafter(np.float32(0.5), np.float32(0))
        above = np.nextafter(np.float32(0.75), np.float32(1))
        boxes = [((0.25, 0.25, 0), (0.5, 0.5, 1)),       # hi.x on x = 0.5
                 ((0.25, 0.25, 0), (below, 0.5, 1)),      # one ulp out
                 ((0.75, 0.25, 0), (0.9, 0.5, 1)),        # lo.x on x = 0.75
                 ((above, 0.25, 0), (0.9, 0.5, 1)),
                 ((0.6, 0.0, 0), (0.7, 0.5, 1)),          # hi.y on y = 0.5
                 ((0.6, 0.0, 0), (0.7, below, 1)),
                 ((0.6, 0.75, 0), (0.7, 0.9, 1))]         # lo.y on y = 0.75
        for s, box in enumerate(boxes):
            t.leaf(root, s, box)
        t.put(root, 7, inner, ((0.75, 0.75, 0), (0.9, 0.9, 1)))  # a corner
        for s in range(3):
            t.leaf(inner, s, ((0.75, 0.75, 0), (0.8, 0.8, 1)))
        t.leaf(inner, 3, ((above, 0.75, 0), (0.8, 0.8, 1)))
        planes, ndoto = _windows([(0.5, 0.75, 0.5, 0.75),
                                  (0.5, 0.75, 0.0, 1.0)])
    elif case in ("cycle_chain", "cycle_fork"):
        t = _Tree()
        root, a = t.node(), t.node()
        t.leaf(root, 0)
        t.put(root, 1, a)
        t.leaf(a, 0)
        t.put(a, 3, root)
        if case == "cycle_fork":
            t.put(a, 5, root)
        planes, ndoto = _windows([(0, 1, 0, 1), (0, 0.3, 0, 1)])
        K = 64
    else:
        raise ValueError(case)
    bounds, child = t.tables()
    return (bounds, child, planes.astype(np.float32),
            np.ascontiguousarray(ndoto, np.float32)), K


# (nbpad, n_blocks): the mask at the first and last ids, at 128 and past it
CULL_BLOCKS_EDGE_CASES = ((128, 1), (128, 127), (128, 128), (768, 1),
                          (768, 127), (768, 128), (768, 129), (768, 767))
# and grids of 3 and 5 chunks of 128 block ids (the kernel's CTA)
CULL_BLOCKS_CUDA_CASES = CULL_BLOCKS_EDGE_CASES + ((384, 300), (640, 513))


def cull_blocks_edge_inputs(nbpad, n_blocks, seed=0):
    """(desc (24, 128), blk_lo, blk_hi (3, nbpad)) numpy f32: 3 groups of 8
    tiles, each tile the 4 planes of an axis window (desc lanes posn,
    negn, thresholds; the others random, which the tier does not read),
    random block boxes in [0, 4]^3, and in every group's tile 0 a window
    [1, 2] x [1, 2] that the boxes of ids 0, n_blocks - 1 and n_blocks
    (past the mask) touch exactly on a face (dist == 0, inside)."""
    rng = np.random.default_rng(seed)
    G = 3
    wins = []
    for _ in range(G):
        wins.append((1.0, 2.0, 1.0, 2.0))
        for _ in range(7):
            x0, y0 = rng.uniform(0.0, 3.5, 2)
            w, h = rng.uniform(0.05, 0.5, 2)
            wins.append((x0, x0 + w, y0, y0 + h))
    planes, ndoto = _windows(wins)
    desc = rng.uniform(-1.0, 1.0, (G * 8, 128)).astype(np.float32)
    desc[:, 0:12] = np.maximum(planes, 0).reshape(-1, 12)
    desc[:, 12:24] = np.minimum(planes, 0).reshape(-1, 12)
    desc[:, 24:28] = ndoto[:, 0]
    c = rng.uniform(0.0, 4.0, (nbpad, 3))
    r = rng.uniform(0.01, 0.1, (nbpad, 3))
    lo, hi = (c - r).astype(np.float32), (c + r).astype(np.float32)
    for i, face in ((0, "hi.x"), (n_blocks - 1, "lo.x"), (n_blocks, "hi.y")):
        if i >= nbpad:
            continue
        lo[i], hi[i] = (0.5, 1.2, 0.0), (1.0, 1.5, 1.0)
        if face == "lo.x":
            lo[i, 0], hi[i, 0] = 2.0, 2.5
        elif face == "hi.y":
            lo[i], hi[i] = (1.2, 0.5, 0.0), (1.5, 1.0, 1.0)
    return desc, np.ascontiguousarray(lo.T), np.ascontiguousarray(hi.T)


def _cuda(*xs):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).cuda() for x in xs)


@pytest.mark.parametrize("case", WALK_EDGE_CASES + WALK_CYCLE_CASES)
def test_frustum_walk_kernel_edge_cases(case):
    """Kernel F against its twin on the constructed trees, every list and
    count equal; the tiles whose stack overflows (and the malformed
    trees, past the kernel's record capacity or level bound) take the
    kernel's sequential walk and only those."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    (bounds, child, planes, ndoto), K = walk_edge_inputs(case)
    args = _cuda(bounds, child, planes, ndoto) + (K,)
    leaves, counts = fw._walk_cuda(*args)
    lref, cref, _ = fw._walk_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(counts, cref) and torch.equal(leaves, lref)
    seq = fw.sequential_tiles(*args)
    want = {"stack_overflow": 1, "cycle_chain": 2, "cycle_fork": 2}
    assert seq == want.get(case, 0)
    if case in want:
        assert int(cref[0]) == -1


@pytest.mark.parametrize("nbpad,n_blocks", CULL_BLOCKS_CUDA_CASES)
def test_cull_blocks_kernel_edge_cases(nbpad, n_blocks):
    """Kernel G against its twin on constructed descriptors and boxes: the
    n_blocks mask at its edges and past 128 ids, 2-D grids of 1 to 6
    chunks of 128 ids, n_blocks inside the last chunk or the middle one,
    and boxes on a plane (inside) at ids 0 and n_blocks - 1, and at
    n_blocks (masked)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    desc, lo, hi = _cuda(*cull_blocks_edge_inputs(nbpad, n_blocks))
    got = packet2._cull_blocks_cuda(desc, lo, hi, n_blocks)
    ref = packet2._cull_blocks_plain(desc, lo, hi, n_blocks)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert bool(got[:, 0, 0].all()) and bool(got[:, 0, n_blocks - 1].all())
    assert not bool(got[:, 0, n_blocks:].any())


def test_v1_engine_on_cuda_matches_oracle(scene):
    """intersect_packets through kernels F and D on the card: launches
    counted, hits equal to the oracle on every ray of a tile that fits."""
    tris, bvh = scene
    o, d = _camera_rays()
    rays = make_rays(o, d, device="cuda")
    before = (dict(lr.LAUNCHES), dict(fw.LAUNCHES))
    h, ov = pk.intersect_packets(bvh.bvh8, rays, max_leaves=512,
                                 leaf_kernel=True, walk_kernel=True)
    assert lr.LAUNCHES["leaf_resolve_v2"] > before[0]["leaf_resolve_v2"]
    assert fw.LAUNCHES["frustum_walk"] > before[1]["frustum_walk"]
    keep = ~torch.repeat_interleave(ov, 256)
    assert bool(keep.any())
    ref = brute_force_closest(rays, bvh.tris)
    assert torch.equal(h.prim[keep], ref.prim[keep])
    m = keep & (ref.prim >= 0)
    np.testing.assert_allclose(h.t[m].cpu().numpy(), ref.t[m].cpu().numpy(),
                               rtol=1e-4, atol=1e-4)


def test_v1_wrappers_reject_bad_inputs(scene):
    """Kernels D, E and F: a wrong dtype, a mix of devices or a bad shape
    raises; nothing falls back to the plain twin."""
    _, bvh = scene
    leaves, o_t, d_t, o3, d3 = _v1_inputs(bvh, 64)
    T = leaves.shape[0]
    geom = torch.zeros((T, 256, 12), device="cuda")
    before = (dict(lr.LAUNCHES), dict(fw.LAUNCHES))
    with pytest.raises(TypeError):
        lr.leaf_resolve_v2(o_t, d_t, geom.double())
    with pytest.raises(ValueError):
        lr.leaf_resolve_v2(o_t.cpu(), d_t, geom)
    with pytest.raises(ValueError):
        lr.leaf_resolve_v2(o_t[:, :2].contiguous(), d_t, geom)
    g48 = torch.zeros((T, 64, 48), device="cuda")
    live = torch.ones((T, 64), dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError):
        lr.leaf_resolve(o_t, d_t, g48, live.float(), live)
    with pytest.raises(ValueError):
        lr.leaf_resolve(o_t, d_t, g48[:, :, :40].contiguous(), live, live)
    planes = pk._tile_planes(o3[:, 0], d3).contiguous()
    ndoto = torch.zeros((T, 1, 4), device="cuda")
    b8 = bvh.bvh8
    with pytest.raises(TypeError):
        fw.collect_tile_leaves_kernel(b8.bounds, b8.child.long(), planes,
                                      ndoto, 64)
    with pytest.raises(ValueError):
        fw.collect_tile_leaves_kernel(b8.bounds, b8.child, planes.cpu(),
                                      ndoto, 64)
    with pytest.raises(ValueError):
        fw.collect_tile_leaves_kernel(b8.bounds, b8.child, planes,
                                      ndoto.reshape(T, 4), 64)
    assert (dict(lr.LAUNCHES), dict(fw.LAUNCHES)) == before


# ---- instancing (tlas/) and refit on the card ----------------------------

def _grid_camera(lo, hi, W=64):
    """W x W rays from one eye outside the box (lo, hi), over its whole
    front, in 16x16 tile order."""
    center = (lo + hi) * 0.5
    ext = float(np.max(hi - lo))
    eye = center + np.array([0.6, 0.35, 1.1]) * ext * 1.2
    fwd = (center - eye) / np.linalg.norm(center - eye)
    right = np.cross(fwd, [0, 1, 0])
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    xs = (np.arange(W) + 0.5) / W - 0.5
    gx, gy = np.meshgrid(xs, xs)
    d = fwd + 0.9 * gx[..., None] * right + 0.9 * gy[..., None] * up
    d /= np.linalg.norm(d, axis=2, keepdims=True)
    d = d.reshape(W // 16, 16, W // 16, 16, 3).transpose(0, 2, 1, 3, 4)
    d = d.reshape(-1, 3).astype(np.float32)
    return np.broadcast_to(eye.astype(np.float32), d.shape).copy(), d


@pytest.fixture(scope="module")
def inst64():
    """4x4x4 = 64 instances of random_tris(2000) spaced at 1.15 x its
    extent, built on the card, and 64x64 camera rays over the grid."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    from tinybvh_tpu_torch.tlas.packet import build_tlas_packet

    tris = random_tris(2000, seed=1)
    blas = BVH(tris, device="cuda")
    lo = tris.reshape(-1, 3).min(0)
    ex = tris.reshape(-1, 3).max(0) - lo
    mats = []
    for i in range(4):
        for j in range(4):
            for k in range(4):
                m = np.eye(4, dtype=np.float32)
                m[:3, 3] = ex * 1.15 * np.float32([i, j, k])
                mats.append(m)
    tp = build_tlas_packet([blas.bvh8], np.stack(mats))
    o, d = _grid_camera(lo, lo + ex * (1.15 * 3 + 1))
    n_segs = -(-blas.bvh8.leaf_tris.shape[0] // 4)
    return tp, make_rays(o, d, device="cuda"), 4 * (-(-n_segs // 8) * 8)


def _tie_equal(h, ref):
    """prim and inst equal except exact ties (t within a relative 1e-6)."""
    diff = (h.prim != ref.prim) | (h.inst != ref.inst)
    tie = (h.t - ref.t).abs() <= 1e-6 * ref.t.abs()
    assert not bool((diff & ~tie).any()), int((diff & ~tie).sum())


def test_bucketed_tlas_on_cuda_matches_lockstep(inst64):
    """The bucketed engine through kernels A and B on the card (rounds
    covering every tile's candidates, the escalation covering the whole
    BLAS): prim and inst equal to the lockstep two-level traversal on the
    card, no residual overflow."""
    from tinybvh_tpu_torch.tlas.instance import intersect_tlas8
    from tinybvh_tpu_torch.tlas.packet import (
        intersect_tlas_packets2_bucketed, tile_candidates,
    )

    tp, rays, full_ml = inst64
    (_, _, n_cand), = tile_candidates(tp, rays, 1)
    rounds = int(n_cand.max()) + 1
    before = dict(packet2.LAUNCHES)
    h, ovf = intersect_tlas_packets2_bucketed(
        tp, rays, rounds=rounds, max_leaves=256, retrace="packet",
        retrace_ml=full_ml, retrace_blocks=256, wf_cap_factor=64)
    assert packet2.LAUNCHES["cull"] > before["cull"]
    assert packet2.LAUNCHES["mt_fused"] > before["mt_fused"]
    assert not bool(ovf.any())
    ref = intersect_tlas8(tp.tlas, rays)
    assert 0.1 < float((ref.prim >= 0).float().mean()) < 1.0
    _tie_equal(h, ref)
    m = ref.prim >= 0
    np.testing.assert_allclose(h.t[m].cpu().numpy(), ref.t[m].cpu().numpy(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("case", ["dead_round", "escalation"])
def test_tlas_round_kernels_match_plain(inst64, monkeypatch, case):
    """Kernels A and B at the bucketed engine's shapes, bit for bit with
    their twins: on a round in which whole tiles are dead (t_max 0 on all
    their rays), and on an escalation pass whose budget is at least 1,024
    segments (a 16-leaf first budget overflows)."""
    from tinybvh_tpu_torch.tlas.packet import (
        intersect_tlas_packets2_bucketed,
    )

    tp, rays, _ = inst64
    a_calls = _capture(monkeypatch, "cull")
    b_calls = _capture(monkeypatch, "mt_fused")
    intersect_tlas_packets2_bucketed(tp, rays, rounds=8, max_leaves=16,
                                     retrace="packet", retrace_ml=4096,
                                     retrace_blocks=256, wf_cap_factor=64)
    assert len(a_calls) == len(b_calls) > 1
    if case == "dead_round":
        # a first pass (k_cap 4) in which some tiles are dead
        picks = [i for i, b in enumerate(b_calls)
                 if b[7] == 4 and bool((b[5] == 0).all(dim=1).any())
                 and bool((b[1] > 0).any())]
    else:
        picks = [i for i, b in enumerate(b_calls) if b[7] >= 1024]
    assert picks, f"no {case} call"
    a, b = a_calls[picks[0]], b_calls[picks[0]]
    if case == "escalation":
        assert a[6] >= 1024
    _assert_equal_outputs(packet2._cull_cuda(*a), packet2._cull_plain(*a))
    _assert_equal_outputs(packet2._mt_fused_cuda(*b),
                          packet2._mt_fused_plain(*b)[:5])


def test_refit_and_packet_tables_on_cuda_match_cpu(scene):
    """refit_bvh8 and build_packet_aux on the card equal the same calls on
    the CPU, bit for bit; BVH.refit then BVH.intersect on the card agrees
    with the oracle over the moved triangles."""
    from tinybvh_tpu_torch.builders.refit import bvh8_refit_plan, refit_bvh8
    from tinybvh_tpu_torch.layouts.mbvh import BVH8

    tris, bvh = scene
    rng = np.random.default_rng(3)
    moved = (tris * np.float32([1.3, 0.7, 1.0]) + np.float32([2, -1, 0.5])
             + rng.normal(scale=0.02, size=tris.shape).astype(np.float32))
    b8_cpu = BVH8(**{k: getattr(bvh.bvh8, k).cpu() for k in (
        "bounds", "child", "leaf_tris", "leaf_prim")})
    r_gpu = refit_bvh8(bvh.bvh8, moved, bvh8_refit_plan(bvh.bvh8.child))
    r_cpu = refit_bvh8(b8_cpu, moved)
    for k in ("bounds", "leaf_tris"):
        assert torch.equal(getattr(r_gpu, k).cpu(), getattr(r_cpu, k))
    a_gpu = packet2.build_packet_aux(r_gpu)
    a_cpu = packet2.build_packet_aux(r_cpu)
    for k in ("leaf_lo", "leaf_hi", "blk_lo", "blk_hi", "gtab_pad",
              "center"):
        g, c = getattr(a_gpu, k).cpu(), getattr(a_cpu, k)
        assert g.shape == c.shape
        assert g.view(torch.int32).equal(c.view(torch.int32)), k

    fresh = BVH(tris, device="cuda")
    fresh.refit(moved)
    o, d = _camera_rays()
    o = o * np.float32([1.3, 0.7, 1.0]) + np.float32([2, -1, 0.5])
    d = d * np.float32([1.3, 0.7, 1.0])
    rays = make_rays(o, d, device="cuda")
    h = fresh.intersect(rays)
    ref = brute_force_closest(rays, fresh.tris)
    _tie_equal(h, ref)


# ---- the probes: kernels H (gather forms) and I (B's ablation) ----------

@pytest.fixture(scope="module")
def gather_inputs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    return hg.make_inputs(seed=1, device="cuda")


@pytest.mark.parametrize("form", list(hg.FORMS))
def test_gather_kernel_matches_plain(gather_inputs, form):
    """Every H form equals its twin bit for bit (D too: each partial sum
    of its one-hot products is exact)."""
    f = hg.FORMS[form]
    args = gather_inputs[form]
    key = f.wrapper.__name__
    before = hg.LAUNCHES[key]
    got = f.wrapper(*args)
    torch.cuda.synchronize()
    assert hg.LAUNCHES[key] == before + 1
    assert torch.equal(got, f.plain(*args))


@pytest.mark.parametrize("N", [2048, 8192, 2064])
def test_onehot_kernel_slab_edges(N):
    """H-D (64-row slabs of t, one CTA per slab and 64 output rows) against
    its twin, with indices at 0, N - 1 and each side of slab edges, and at
    N = 2,064, which 64-row slabs do not divide (a last slab of 16 rows);
    the whole-function torch.mm that phase 14 times equals it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    rng = np.random.default_rng(N)
    t = torch.from_numpy(rng.random((N, 96), dtype=np.float32)).to(
        torch.bfloat16).cuda()
    idx = rng.integers(0, N, 256).astype(np.int32)
    edges = [0, N - 1, 63, 64, 127, 128, N - 16, N - 17, N - 64, N - 65]
    idx[:len(edges)] = edges
    idx = torch.from_numpy(idx).cuda()
    got = hg.onehot_gather(t, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, hg._onehot_plain(t, idx))
    oh10 = (torch.arange(N, device="cuda")[None] == idx[:, None]).float() * 10
    assert torch.equal(torch.mm(oh10, t.float()), got)


# H-A100 and H-C100 off the probes' shapes: the chain at several round
# counts on constructed index maps, the sum where its wrap is crossed at
# different steps (tests/test_torch_probes.py holds the twins' rules to
# numpy on the same cases)
CHAIN_ROUNDS = (0, 1, 2, 3, 7, 64, 100, 101)
CHAIN_MAPS = ("random", "identity", "cycle128", "fixed_points")
SUM_EDGES = (0, 411, 412, 511)   # 511: the wrap at step 1; 412: none


def chain_map(case, seed=0):
    """An (8, 128) int32 index map, each row its own: uniform at random;
    the identity; one cycle through all 128 lanes; or half of the lanes
    fixed points and the rest a random map into the row."""
    rng = np.random.default_rng(seed)
    F, W = hg.F, hg.W
    if case == "random":
        return rng.integers(0, W, (F, W), dtype=np.int32)
    if case == "identity":
        return np.tile(np.arange(W, dtype=np.int32), (F, 1))
    if case == "cycle128":
        m = np.empty((F, W), np.int32)
        for f in range(F):
            order = rng.permutation(W)
            m[f, order] = np.roll(order, -1)
        return m
    m = rng.integers(0, W, (F, W), dtype=np.int32)
    fixed = rng.random((F, W)) < 0.5
    m[fixed] = np.broadcast_to(np.arange(W, dtype=np.int32), (F, W))[fixed]
    return m


def sum_inputs(edge, seed=0):
    """C100's (512, 128) table and an (8, 128) index block with every
    other lane at `edge`, the rest uniform."""
    rng = np.random.default_rng(seed)
    t = rng.random((512, hg.W), dtype=np.float32)
    i = rng.integers(0, 512, (hg.F, hg.W), dtype=np.int32)
    i[:, ::2] = edge
    return t, i


def _gather_loop(t, idx, rounds, dim):
    """`rounds` chained gathers of t by idx along dim 1 (the chain's rule)
    or, along dim 0, the sum of t at idx + s mod N for s < rounds (the
    sum's), in order of s from zero."""
    if dim == 1:
        acc = t
        for _ in range(rounds):
            acc = acc.gather(1, idx.long())
        return acc
    acc = torch.zeros(idx.shape, dtype=torch.float32, device=t.device)
    for s in range(rounds):
        acc = acc + t.gather(0, ((idx + s) % t.shape[0]).long())
    return acc


@pytest.mark.parametrize("rounds", CHAIN_ROUNDS)
@pytest.mark.parametrize("case", CHAIN_MAPS)
def test_chain_kernel_at_any_rounds(case, rounds):
    """H-A100 through its C entry's `rounds`: equal to `rounds` chained
    torch.gather calls."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    rng = np.random.default_rng(rounds)
    t, i = _cuda(rng.random((hg.F, hg.W), dtype=np.float32),
                 chain_map(case))
    out = torch.empty_like(t)
    hg._launch("chain_gather", "tbvh_gather_chain", t, i, out, rounds)
    torch.cuda.synchronize()
    assert torch.equal(out, _gather_loop(t, i, rounds, 1))


@pytest.mark.parametrize("rounds", [0, 1, 100])
@pytest.mark.parametrize("edge", SUM_EDGES)
def test_sum_kernel_wraps_and_rounds(edge, rounds):
    """H-C100 at the probe's R = 100 (the staged path) and at 0 and 1 (the
    general one), with lanes whose rows wrap at different steps: equal to
    the twin's rule at `rounds`."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    t, i = _cuda(*sum_inputs(edge))
    out = torch.empty(i.shape, dtype=torch.float32, device="cuda")
    hg._launch("sum_gather", "tbvh_gather_sum", t, i, out, hg.F, hg.W, 512,
               rounds)
    torch.cuda.synchronize()
    assert torch.equal(out, _gather_loop(t, i, rounds, 0))
    if rounds == hg.ROUNDS:
        assert torch.equal(out, hg._sum_plain(t, i))


@pytest.mark.parametrize("N,Wt,S,rounds", [
    (64, 128, 5, 100), (512, 100, 5, 37), (1500, 128, 5, 100),
    (1024, 8, 5, 300), (512, 16, 40, 100)])
def test_sum_kernel_other_shapes(N, Wt, S, rounds):
    """H-C100 off the staged path's shapes, through the general path:
    rounds exceeding N (several wraps), a width no multiple of 8, N past
    the staged path's 1,024 rows, rounds other than 100 on a one-slice
    table, and more outputs a slice than a staged CTA has threads: equal
    to the twin's rule."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    rng = np.random.default_rng(N + Wt)
    t, i = _cuda(rng.random((N, Wt), dtype=np.float32),
                 rng.integers(0, N, (S, Wt), dtype=np.int32))
    out = torch.empty(i.shape, dtype=torch.float32, device="cuda")
    hg._launch("sum_gather", "tbvh_gather_sum", t, i, out, S, Wt, N, rounds)
    torch.cuda.synchronize()
    assert torch.equal(out, _gather_loop(t, i, rounds, 0))


# The lane kernel (one CTA per row and output slice: 128 outputs at width
# 128, H-A; 256 at 1,024, H-B and H-B2) on constructed indices, at output
# widths whose last slice is partial or whose grid passes the probes'
# (tests/test_torch_probes.py holds the twin to the JAX probe's kA / kB /
# kB2 on the same cases at the probes' widths)
LANE_EDGE_CASES = ("ends", "one_index", "reversed", "per_row")
LANE_OWS = (1, 100, 128, 129, 256, 1024, 2048)
LANE_OWS_128 = (1, 31, 32, 33, 100, 128, 129, 256, 1024)


def lane_edge_inputs(case, OW, seed=0, TW=1024):
    """(t (8, TW) f32, i (8, OW) int32) numpy: t uniform plus its row
    number, so that rows differ everywhere and a wrong row shows; i
    alternating 0 and TW - 1; one index for each whole row (0, TW - 1,
    TW / 2 - 1, TW / 2, 1, TW - 2, TW / 4 - 1, 3 TW / 4); the reversed
    permutation (repeated past TW outputs); or a different permutation in
    each row, l * (2f + 1) + 37f mod TW."""
    rng = np.random.default_rng(seed)
    t = (rng.random((hg.F, TW), dtype=np.float32)
         + np.arange(hg.F, dtype=np.float32)[:, None])
    f = np.arange(hg.F)[:, None]
    l = np.arange(OW)[None]
    if case == "ends":
        i = np.where((f + l) % 2 == 0, 0, TW - 1)
    elif case == "one_index":
        one = (0, TW - 1, TW // 2 - 1, TW // 2, 1, TW - 2, TW // 4 - 1,
               3 * TW // 4)
        i = np.broadcast_to(np.array(one)[:, None], (hg.F, OW))
    elif case == "reversed":
        i = np.broadcast_to(TW - 1 - l % TW, (hg.F, OW))
    else:
        i = (l * (2 * f + 1) + 37 * f) % TW
    return t, np.ascontiguousarray(i, dtype=np.int32)


def _counted_and_replayed(key, fn, ref):
    """fn() (a wrapper's call) equals ref bit for bit and counts one launch
    of `key`; the same call captured in a CUDA graph counts none, and the
    graph's replay computes ref."""
    before = hg.LAUNCHES[key]
    got = fn()
    torch.cuda.synchronize()
    assert hg.LAUNCHES[key] == before + 1
    assert torch.equal(got, ref)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    assert hg.LAUNCHES[key] == before + 1
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


@pytest.mark.parametrize("OW", LANE_OWS)
@pytest.mark.parametrize("case", LANE_EDGE_CASES)
def test_lane_kernel_1024_edge_cases(case, OW):
    """H-B and H-B2's kernel equals the twin bit for bit and counts one
    launch; a call captured in a CUDA graph is not counted, and the
    graph's replay computes the same."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    t, i = _cuda(*lane_edge_inputs(case, OW))
    _counted_and_replayed("lane_gather", lambda: hg.lane_gather(t, i),
                          hg._lane_plain(t, i))


@pytest.mark.parametrize("OW", LANE_OWS_128)
@pytest.mark.parametrize("case", LANE_EDGE_CASES)
def test_lane_kernel_128_edge_cases(case, OW):
    """H-A's kernel (8 rows of 128 lanes, one CTA per row and 128 outputs)
    equals the twin bit for bit and counts one launch; a call captured in
    a CUDA graph is not counted, and the graph's replay computes the
    same."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    t, i = _cuda(*lane_edge_inputs(case, OW, TW=hg.W))
    _counted_and_replayed("lane_gather", lambda: hg.lane_gather(t, i),
                          hg._lane_plain(t, i))


def test_lane_kernel_128_takes_any_alignment():
    """H-A stages its row by scalar loads: a 128-wide t one float past a
    16-byte boundary is taken, and the result equals the twin."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    t, i = lane_edge_inputs("per_row", 129, TW=hg.W)
    base = torch.zeros(t.size + 1, device="cuda")
    odd = base[1:].view(hg.F, hg.W)
    odd.copy_(torch.from_numpy(t))
    i = torch.from_numpy(i).cuda()
    assert odd.data_ptr() % 16
    _counted_and_replayed("lane_gather", lambda: hg.lane_gather(odd, i),
                          hg._lane_plain(odd, i))


# H-E's kernel (flat take) on both of its paths: staged where the table
# is at most FLAT_STAGE_MAX floats, a multiple of 4 and 16-byte aligned,
# else read from L2 (tests/test_torch_probes.py holds the twin to the JAX
# probe's kE on the same cases)
FLAT_STAGE_MAX = 8192    # kFlatStageMax of csrc/gather_probe.cu
FLAT_TABLES = {"staged-4": 4, "staged-2048": 2048,
               "staged-max": FLAT_STAGE_MAX, "general-2049": 2049,
               "general-max+4": FLAT_STAGE_MAX + 4,
               "general-offset": 2048}   # a view one float past 16 bytes
FLAT_SHAPES = ((8, 128), (1,), (1000,), (8, 129))


def flat_edge_inputs(table, shape, seed=0):
    """(flat (N,) f32, i `shape` int32) numpy for FLAT_TABLES[table]: flat
    uniform; i uniform in [0, N) with N - 1, 0, N - 2, N - 3, N - 4, 1, 2
    and 3 first (as many as fit: a single index is N - 1)."""
    N = FLAT_TABLES[table]
    rng = np.random.default_rng(seed)
    flat = rng.random(N, dtype=np.float32)
    i = rng.integers(0, N, shape, dtype=np.int32)
    ends = np.array([N - 1, 0, N - 2, N - 3, N - 4, 1, 2, 3]) % N
    i.flat[:min(i.size, ends.size)] = ends[:i.size]
    return flat, i


@pytest.mark.parametrize("shape", FLAT_SHAPES)
@pytest.mark.parametrize("table", list(FLAT_TABLES))
def test_flat_kernel_edge_cases(table, shape):
    """H-E's kernel on its staged path (N = 4, 2,048 and FLAT_STAGE_MAX)
    and its general one (N = 2,049, FLAT_STAGE_MAX + 4, a misaligned
    view): equal to the twin bit for bit, one launch counted, none for a
    call captured in a CUDA graph, whose replay computes the same."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    flat, i = flat_edge_inputs(table, shape)
    if table == "general-offset":
        base = torch.zeros(flat.size + 1, device="cuda")
        t = base[1:]
        t.copy_(torch.from_numpy(flat))
        assert t.data_ptr() % 16
    else:
        t = torch.from_numpy(flat).cuda()
    i = torch.from_numpy(i).cuda()
    _counted_and_replayed("flat_take", lambda: hg.flat_take(t, i),
                          hg._flat_plain(t, i))


@pytest.mark.parametrize("N,n", [(FLAT_STAGE_MAX, 131072),
                                 (FLAT_STAGE_MAX, 131073),
                                 (2048, 1048576)])
def test_flat_kernel_at_the_copies_limit(N, n):
    """The staged path's copies (a whole table a CTA of 256 outputs) stop
    at 2^22 floats in all: 131,072 outputs of an 8,192-float table are
    staged, one more and 1,048,576 of 2,048 take the general path; each
    equal to the twin."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    rng = np.random.default_rng(n)
    t, i = _cuda(rng.random(N, dtype=np.float32),
                 rng.integers(0, N, n, dtype=np.int32))
    got = hg.flat_take(t, i)
    torch.cuda.synchronize()
    assert torch.equal(got, hg._flat_plain(t, i))


# H-C's kernel (one output a thread of a (W / 128, S) grid with index rows
# past SUB_GRID_Y_MAX in grid z; any alignment), also where W is below a
# lane slice of SUB_LANES; and
# H-col's on both of its paths: rows where C is a multiple of 4 and at most
# COL_ROW_MAX, a is 16-byte aligned and R * C is at most COL_ROW_FLOATS,
# else the general one (tests/test_torch_probes.py holds the twins to the
# JAX probe's kC and to pallas_gather_probe.py's numpy expression on the
# same cases)
SUB_LANES = 128              # kSubThreads of csrc/gather_probe.cu
SUB_GRID_Y_MAX = 65535       # kGridYMax
COL_ROW_MAX = 32             # kColRowMax
COL_ROW_FLOATS = 1 << 18     # kColRowFloats
SUB_CASES = {"probe": (512, 128, 8), "S1": (512, 128, 1),
             "S7": (512, 128, 7), "S32": (512, 128, 32),
             "N100": (100, 128, 8), "N1024": (1024, 128, 8),
             "N1025": (1025, 128, 8), "W130": (512, 130, 8),
             "offset": (512, 128, 8),   # a view one float past 16 bytes
             "grid-z": (64, SUB_LANES, SUB_GRID_Y_MAX + 10),
             "W127": (512, SUB_LANES - 1, 8),
             "W3": (64, 3, 1000),
             "W1-grid-z": (512, 1, SUB_GRID_Y_MAX + 8)}
COL_CASES = {"rows-probe": (4096, 32), "rows-C4": (4096, 4),
             "rows-C8": (4096, 8), "rows-R1": (1, 32),
             "rows-R129": (129, 32),
             "rows-max": (COL_ROW_FLOATS // 32, 32),
             "general-max+1": (COL_ROW_FLOATS // 32 + 1, 32),
             "general-R131072": (131072, 32), "general-C48": (4096, 48),
             "general-C33": (4096, 33),
             "general-offset": (4096, 32)}   # a view one float past 16 B


def sub_edge_inputs(case, seed=0):
    """(t (N, W) f32, i (S, W) int32) numpy for SUB_CASES[case]: t uniform
    plus its row number, so that a wrong row shows; i uniform in [0, N)
    with 0 in the first index row and N - 1 in the last (one index row:
    0 and N - 1 alternating)."""
    N, W, S = SUB_CASES[case]
    rng = np.random.default_rng(seed)
    t = (rng.random((N, W), dtype=np.float32)
         + np.arange(N, dtype=np.float32)[:, None])
    i = rng.integers(0, N, (S, W), dtype=np.int32)
    if S == 1:
        i[0] = np.where(np.arange(W) % 2 == 0, 0, N - 1)
    else:
        i[0], i[-1] = 0, N - 1
    return t, i


def col_edge_inputs(case, seed=0):
    """(a (R, C) f32, col (R,) int32) numpy for COL_CASES[case]: a uniform
    plus its row number mod 1,024; col uniform in [0, C) with 0 and C - 1
    on every third row each (one row: C - 1)."""
    R, C = COL_CASES[case]
    rng = np.random.default_rng(seed)
    a = (rng.random((R, C), dtype=np.float32)
         + (np.arange(R) % 1024).astype(np.float32)[:, None])
    col = rng.integers(0, C, R, dtype=np.int32)
    col[::3] = C - 1
    col[1::3] = 0
    return a, col


def offset_view(x, device):
    """numpy x copied into a tensor on `device` that starts one float past
    a 16-byte boundary."""
    base = torch.zeros(x.size + 1, device=device)
    view = base[1:].view(x.shape)
    view.copy_(torch.from_numpy(x))
    assert view.data_ptr() % 16
    return view


@pytest.mark.parametrize("case", list(SUB_CASES))
def test_sublane_kernel_edge_cases(case):
    """H-C's kernel at the probe's shape, at 1, 7, 32 and 65,545 index
    rows (grid z), at N = 100, 1,024 and 1,025, at W = 130, 127, 3 and 1
    (65,543 index rows) and on a misaligned table: equal to the twin bit
    for bit, one launch counted, none for a call captured in a CUDA graph,
    whose replay computes the same."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    t, i = sub_edge_inputs(case)
    t = (offset_view(t, "cuda") if case == "offset"
         else torch.from_numpy(t).cuda())
    i = torch.from_numpy(i).cuda()
    _counted_and_replayed("sublane_gather", lambda: hg.sublane_gather(t, i),
                          hg._sublane_plain(t, i))


@pytest.mark.parametrize("case", list(COL_CASES))
def test_col_kernel_edge_cases(case):
    """H-col's kernel on its rows path (C = 32, 4 and 8; R = 1, 129 and
    COL_ROW_FLOATS / 32) and its general one (one row more, R = 131,072,
    C = 48 and 33, a misaligned a): equal to the twin bit for bit, one
    launch counted, none for a call captured in a CUDA graph, whose replay
    computes the same."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    a, col = col_edge_inputs(case)
    a = (offset_view(a, "cuda") if case == "general-offset"
         else torch.from_numpy(a).cuda())
    col = torch.from_numpy(col).cuda()
    _counted_and_replayed("col_gather", lambda: hg.col_gather(a, col),
                          hg._col_plain(a, col))


# H-row's kernel on both of its paths: rows where C is a multiple of 4 up
# to ROW_MAX_C, the table and its output 16-byte aligned and M * C and
# R * C below 2^31, else the general one (tests/test_torch_probes.py holds
# the twin to the JAX probe's `kernel` on the same cases)
ROW_MAX_C = 1024             # kRowMaxC of csrc/gather_probe.cu
# case -> (M, C, R, indices)
ROW_CASES = {"probe": (8192, 48, 4096, "uniform"),
             "R1": (8192, 48, 1, "uniform"), "R31": (8192, 48, 31, "uniform"),
             "R33": (8192, 48, 33, "uniform"),
             "R4097": (8192, 48, 4097, "uniform"),
             "zeros": (8192, 48, 4096, "zeros"),
             "last": (8192, 48, 4096, "last"),
             "reversed": (4096, 48, 4096, "reversed"),
             "same": (8192, 48, 4096, "same"),
             "C4": (8192, 4, 4096, "uniform"),
             "C12": (8192, 12, 4096, "uniform"),
             "C1024": (512, ROW_MAX_C, 300, "uniform"),
             "C6": (8192, 6, 4096, "uniform"),
             "C47": (8192, 47, 4096, "uniform"),
             "C1": (8192, 1, 4096, "uniform"),
             "C1028": (512, ROW_MAX_C + 4, 300, "uniform"),
             "offset": (8192, 48, 4096, "uniform")}  # one float past 16 B
ROW_GENERAL = ("C6", "C47", "C1", "C1028", "offset")  # the shape's path


def row_edge_inputs(case, seed=0):
    """(table (M, C) f32, idx (R,) int32) numpy for ROW_CASES[case]: table
    uniform plus its row number mod 1,024; idx uniform in [0, M) with 0
    first and M - 1 last (one index: M - 1), all 0, all M - 1, the
    reversed permutation of the M rows (R = M), or one row for all."""
    M, C, R, kind = ROW_CASES[case]
    rng = np.random.default_rng(seed)
    table = (rng.random((M, C), dtype=np.float32)
             + (np.arange(M) % 1024).astype(np.float32)[:, None])
    if kind == "uniform":
        idx = rng.integers(0, M, R, dtype=np.int32)
        idx[0], idx[-1] = 0, M - 1
    elif kind == "zeros":
        idx = np.zeros(R, np.int32)
    elif kind == "last":
        idx = np.full(R, M - 1, np.int32)
    elif kind == "reversed":
        idx = (M - 1 - np.arange(R) % M).astype(np.int32)
    else:
        idx = np.full(R, M // 2 + 1, np.int32)
    return table, idx


@pytest.mark.parametrize("case,path", [
    (c, p) for c in ROW_CASES
    for p in ("shape", "general")
    + (() if c in ROW_GENERAL else ("earlier",))])
def test_row_kernel_edge_cases(case, path):
    """H-row's kernel on the path its shape takes (rows, or general at C =
    6, 47, 1 and 1,028 and on a misaligned table), forced onto its general
    path, and where the shape allows it its earlier design: equal to the
    twin bit for bit, one launch counted, none for a call captured in a
    CUDA graph, whose replay computes the same."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    table, idx = row_edge_inputs(case)
    t = (offset_view(table, "cuda") if case == "offset"
         else torch.from_numpy(table).cuda())
    i = torch.from_numpy(idx).cuda()
    _counted_and_replayed("row_gather",
                          lambda: hg.row_gather(t, i, path=path),
                          hg._row_plain(t, i))


def test_row_kernel_past_32_bit_offsets():
    """A table of more than 2^31 floats (8.6 GB) takes the general path,
    64-bit offsets; its rows at the start, the middle and the end equal
    the twin's, and the earlier design, on the rows path's shapes only,
    refuses it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    M, C = (1 << 31) // 48 + 2, 48
    t = torch.empty((M, C), device="cuda")
    rows = torch.tensor([0, 1, M // 2, M - 2, M - 1], device="cuda")
    t[rows] = torch.arange(rows.numel() * C, dtype=torch.float32,
                           device="cuda").view(-1, C)
    i = rows[torch.tensor([4, 0, 3, 2, 1, 4, 4, 0], device="cuda")].int()
    before = hg.LAUNCHES["row_gather"]
    got = hg.row_gather(t, i)
    torch.cuda.synchronize()
    assert hg.LAUNCHES["row_gather"] == before + 1
    assert torch.equal(got, hg._row_plain(t, i))
    with pytest.raises(RuntimeError):   # the rows path's shapes only
        hg.row_gather(t, i, path="earlier")
    del t
    torch.cuda.empty_cache()


def test_launch_floor_is_measured():
    """The empty kernel launches and its device time is above zero."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    before = dict(hg.LAUNCHES)
    assert hg.launch_floor_ms("cuda") > 0.0
    assert hg.LAUNCHES == before


def test_probe_launches_captured_in_a_graph_are_not_counted(scene,
                                                            gather_inputs):
    """A call captured into a CUDA graph is recorded, not launched: the
    wrappers don't count it, and the graph's replay computes the form."""
    _, bvh = scene
    t, i = gather_inputs["A"]
    args, gtab = _ablation_inputs(bvh, 8)
    hg.lane_gather(t, i)
    ma.ablation(*args, gtab, "full")
    torch.cuda.synchronize()
    before = (dict(hg.LAUNCHES), dict(ma.LAUNCHES))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = hg.lane_gather(t, i)
        ma.ablation(*args, gtab, "full")
    assert (hg.LAUNCHES, ma.LAUNCHES) == before
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, hg.FORMS["A"].plain(t, i))


def _ablation_inputs(bvh, T, seed=2):
    """The driver's recipe at 64 keys a tile (2 super-blocks), k_cap 256,
    with tile 0 empty, tile 1 at count = k_cap (8 super-blocks, its last
    keys past the clamp), tile 2 stopped by a finite gate, tile 3's keys
    all at the clamp, tile 4 over k_cap, and origins near the soup in
    the odd tiles (more hits)."""
    gtab = bvh.packet_aux.gtab_pad
    mlr = gtab.shape[0] // 4 - 1
    keys, counts, lbg, tmax, o_t, d_t = ma.make_inputs(
        mlr + 1, T, 64, 256, seed=seed, device="cuda")
    ar = torch.arange(256, dtype=torch.int32, device="cuda")
    counts[0] = 0
    counts[1] = 256
    keys[1] = mlr - 200 + ar
    lbg[1] = 0.0
    tmax[2] = 5.0
    lbg[2, 1] = 10.0
    keys[3, :64] = mlr + ar[:64]
    counts[4] = 1000
    o_t[1::2] *= 0.2
    return (keys, counts, lbg, tmax, o_t, d_t), gtab


@pytest.mark.parametrize("T", [32, 1600])
@pytest.mark.parametrize("variant", ma.VARIANTS)
def test_ablation_kernel_matches_plain(scene, variant, T):
    """Every I variant against its twin (ma.check): torch.equal, and for
    bf16 (the mma's order of additions is the hardware's) the row equal
    on >= 99.9% of rays and t within rtol = atol = 1e-4 where it is."""
    _, bvh = scene
    args, gtab = _ablation_inputs(bvh, T)
    before = ma.LAUNCHES["mt_ablation"]
    got = ma.ablation(*args, gtab, variant)
    torch.cuda.synchronize()
    assert ma.LAUNCHES["mt_ablation"] == before + 1
    err, _, n_sb = ma.check(args, gtab, variant, got)
    if variant != "bf16":
        assert err == 0.0
    if variant not in ("mathonly", "skeleton"):
        assert n_sb[:3].tolist() == [0, 8, 1]
        assert int((got[0] < 1e30).sum()) > 0


def test_probe_wrappers_reject_bad_inputs(scene, gather_inputs):
    """A wrong dtype, shape or a mix of devices raises; nothing launches
    and nothing falls back to the twin. H-row takes every table the TPU
    kernel takes: a (M, 6) table and a misaligned view launch its kernel
    and give the twin's rows."""
    _, bvh = scene
    args, gtab = _ablation_inputs(bvh, 8)
    before = (dict(hg.LAUNCHES), dict(ma.LAUNCHES))
    with pytest.raises(ValueError):
        ma.ablation(args[0].cpu(), *args[1:], gtab, "full")
    with pytest.raises(TypeError):
        ma.ablation(*args[:4], args[4].double(), args[5], gtab, "full")
    t, i = gather_inputs["A"]
    with pytest.raises(TypeError):
        hg.lane_gather(t, i.long())
    with pytest.raises(ValueError):
        hg.lane_gather(torch.zeros((8, 256), device="cuda"), i)
    with pytest.raises(ValueError):
        hg.row_gather(t, i[0].cpu())
    t, i = gather_inputs["B"]
    odd = torch.zeros(hg.F * 1024 + 1, device="cuda")[1:].view(hg.F, 1024)
    with pytest.raises(ValueError):   # 1024-wide tables 16-byte aligned
        hg.lane_gather(odd, i)
    with pytest.raises(RuntimeError):  # the C entry's own check
        hg._launch("lane_gather", "tbvh_gather_lane", odd, i,
                   torch.empty(i.shape, device="cuda"), 1024, 1024)
    flat, i = gather_inputs["E"]
    with pytest.raises(TypeError):
        hg.flat_take(flat.double(), i)
    with pytest.raises(RuntimeError):  # a table of at least one float
        hg._launch("flat_take", "tbvh_gather_flat", flat, i,
                   torch.empty(i.shape, device="cuda"), i.numel(), 0)
    for entry, arg in (("tbvh_gather_lane_occupancy", 256),
                       ("tbvh_gather_flat_occupancy", FLAT_STAGE_MAX + 4)):
        with pytest.raises(RuntimeError):  # no such kernel or path
            _build.occupancy(entry, arg)
    t, i = gather_inputs["C"]
    with pytest.raises(TypeError):
        hg.sublane_gather(t.double(), i)
    with pytest.raises(ValueError):   # index rows as wide as the table
        hg.sublane_gather(t, i[:, :100].contiguous())
    for S, Wt in ((0, hg.W), (hg.F, 0), (-1, hg.W)):
        with pytest.raises(RuntimeError):  # the C entry's own check
            hg._launch("sublane_gather", "tbvh_gather_sublane", t, i,
                       torch.empty(i.shape, device="cuda"), S, Wt)
    a, col = gather_inputs["col"]
    with pytest.raises(TypeError):
        hg.col_gather(a, col.long())
    with pytest.raises(ValueError):   # one index a row
        hg.col_gather(a, col[:100].contiguous())
    for R, C in ((0, 32), (a.shape[0], 0), (a.shape[0], -4)):
        with pytest.raises(RuntimeError):  # the C entry's own check
            hg._launch("col_gather", "tbvh_gather_col", a, col,
                       torch.empty(col.shape, device="cuda"), R, C)
    t, idx = gather_inputs["D2048"]
    with pytest.raises(TypeError):
        hg.onehot_gather(t.float(), idx)
    with pytest.raises(ValueError):
        hg.onehot_gather(t, idx[:100].contiguous())
    with pytest.raises(ValueError):   # 64-row output blocks
        hg.onehot_gather(t, idx[:80].contiguous())
    with pytest.raises(ValueError):   # 96 columns only
        hg.onehot_gather(t[:, :64].contiguous(), idx)
    with pytest.raises(ValueError):   # N a multiple of 16
        hg.onehot_gather(t[:2040].contiguous(), idx)
    t, i = gather_inputs["C100"]
    with pytest.raises(RuntimeError):  # rounds >= 0 at the C entries
        hg._launch("sum_gather", "tbvh_gather_sum", t, i,
                   torch.empty(i.shape, device="cuda"), hg.F, hg.W, 512, -1)
    with pytest.raises(RuntimeError):
        hg._launch("chain_gather", "tbvh_gather_chain", *gather_inputs["A100"],
                   torch.empty((hg.F, hg.W), device="cuda"), -1)
    t, i = gather_inputs["row"]
    with pytest.raises(TypeError):
        hg.row_gather(t.double(), i)
    with pytest.raises(TypeError):
        hg.row_gather(t, i.long())
    with pytest.raises(ValueError):   # a CPU index
        hg.row_gather(t, i.cpu())
    with pytest.raises(ValueError):   # a non-contiguous table
        hg.row_gather(t[:, ::2], i)
    with pytest.raises(ValueError):   # no such path
        hg.row_gather(t, i, path="staged")
    six = t[:, :6].contiguous()
    with pytest.raises(RuntimeError):   # the rows path's shapes only
        hg.row_gather(six, i, path="earlier")
    out = torch.empty((i.shape[0], 48), device="cuda")
    for M, R, C, path in ((t.shape[0], 0, 48, 0), (0, i.shape[0], 48, 0),
                          (t.shape[0], i.shape[0], 0, 0),
                          (t.shape[0], i.shape[0], 48, 3)):
        with pytest.raises(RuntimeError):  # the C entry's own check
            hg._launch("row_gather", "tbvh_gather_row", t, i, out, M, R, C,
                       path)
    empty = hg.row_gather(t, i[:0])   # no indices: no launch
    assert empty.shape == (0, 48) and empty.is_cuda
    assert (hg.LAUNCHES, ma.LAUNCHES) == before
    # what the TPU kernel takes and the rows path does not: accepted
    odd = torch.zeros(t.numel() + 1, device="cuda")[1:].view(t.shape)
    odd.copy_(t)
    assert odd.data_ptr() % 16
    for table in (six, odd):
        got = hg.row_gather(table, i)
        torch.cuda.synchronize()
        assert torch.equal(got, hg._row_plain(table, i))
    assert hg.LAUNCHES["row_gather"] == before[0]["row_gather"] + 2


# ---- kernels I and B-omap on constructed cases -----------------------------

ABLATION_EDGE_CASES = ("partial_last", "no_keys", "inf_tmax")
# inf_tmax: keys a tile, and the tiles whose keys point at the far leaves
ABLATION_INF_COUNTS = (13, 13, 45, 77, 32, 45, 0, 40)
ABLATION_INF_FAR_TILES = (0, 2, 4, 5, 7)
_REAL_LEAVES, _FAR_LEAVES = 128, 32


def ablation_edge_inputs(case, seed=0):
    """(keys (8, 128), counts (8,), lbg (8, 4), tmax (8,), o_t, d_t (8, 3,
    256), gtab (640, 128)) numpy of one kernel I case: gtab holds 128
    leaves (4 rows each) of random triangles in front of the rays (mt_rows
    of _edge_tris in lanes 0:48), then 32 leaves of rows every ray hits at
    t = 1e31, past BVH_FAR (_far_rows); each tile's keys run over the real
    leaves from a random base; gates 0, tmax 1e30 unless a case says
    otherwise.
    partial_last: counts 40, 33, 95, 7, 64, 128, 1 and 100: last
      super-blocks live in 8, 1, 31, 7, 32, 32, 1 and 4 of their keys;
    no_keys: tiles 0, 2, 4 and 6 without a key (their keys still point at
      leaves), the others with 20, 64, 5 and 128;
    inf_tmax: tmax = +inf, counts ABLATION_INF_COUNTS; the keys of
      ABLATION_INF_FAR_TILES point at the far leaves, so every live row
      of theirs gives 1e31 and the first dead row, where there is one,
      wins at kFar (tile 0: row 52; tiles 2 and 5: row 180, tile 2 past
      a gate of +inf, which does not stop a tile whose max best t before
      its first super-block is +inf, tile 5 past a NaN gate); tile 4 has
      no dead row (1e31 at row 0); tile 6 no key (+inf); tile 7's key 35
      points at a real leaf, whose rows give the first t below 1e31 (rows
      140-143)."""
    rng = np.random.default_rng(seed)
    T, k_cap = 8, 128
    n_real = _REAL_LEAVES * 4
    gtab = np.zeros(((_REAL_LEAVES + _FAR_LEAVES) * 4, 128), np.float32)
    gtab[:n_real, :48] = mt_rows(_edge_tris(rng, n_real))
    gtab[n_real:, :48] = _far_rows(_FAR_LEAVES * 4)
    o, d = _edge_rays(rng, T)
    base = rng.integers(0, _REAL_LEAVES, (T, 1))
    keys = ((base + np.arange(k_cap)) % _REAL_LEAVES).astype(np.int32)
    lbg = np.zeros((T, k_cap // 32), np.float32)
    tmax = np.full(T, 1e30, np.float32)
    if case == "partial_last":
        counts = (40, 33, 95, 7, 64, 128, 1, 100)
    elif case == "no_keys":
        counts = (0, 20, 0, 64, 0, 5, 0, 128)
    elif case == "inf_tmax":
        counts = ABLATION_INF_COUNTS
        tmax[:] = np.inf
        for t in ABLATION_INF_FAR_TILES:
            keys[t] = _REAL_LEAVES + np.arange(k_cap) % _FAR_LEAVES
        keys[7, 35] = 3
        lbg[2, 1] = np.inf
        lbg[5, 1] = np.nan
    else:
        raise ValueError(case)
    return (keys, np.array(counts, np.int32), lbg, tmax, o, d, gtab)


OMAP_EDGE_CASES = {  # case -> (pack, S)
    "transparent_inf": (2, 8), "transparent_inf_p1": (1, 16),
    "zero_words": (2, 8), "zero_words_p1": (1, 16),
    "s5": (2, 5), "s12": (2, 12), "s12_p1": (1, 12)}
_OMAP_SEGS = 24


def omap_edge_inputs(case, seed=0):
    """(inputs, kw) of one case of kernel B's micromap mode, numpy: inputs
    of mt_resolve_fused (offs, counts, lbg (T, 1, nb), tmax (T, 1), o_t,
    d_t, gtab_flat) and its keywords (k_cap, tri_blk, pack, rps, omap_s,
    t0 (T, 256)). T = 4 tiles of _edge_rays, tri_blk 128, rps 16 // pack,
    k_cap two super-blocks of keys (kpb keys each), counts kpb + kpb / 4,
    2 kpb, kpb / 2 + 1 and kpb + 1 (ragged last super-blocks); 24 segments of random
    triangles (mt_rows of _edge_tris, prim ids 1000 + triangle) with
    random micromap words at OMAP_EDGE_CASES's pack and S, then the zero
    sentinel segment, where dead keys point; each tile's keys run over
    the segments from a random base; gates 0, tmax and t0 1e30 unless a
    case says otherwise.
    transparent_inf[_p1]: segments 0-11 with every word zero (their hits
      are transparent); tiles 0 and 1 start at t0 = +inf, tile 1's keys
      all in segments 0-11: there every pair gives kFar and the first
      (row 0, triangle A) wins;
    zero_words[_p1]: segments 0-3 hold zero triangles with every word's
      bits set, and each tile's first four keys point at them; tiles 0
      and 2 start at t0 = +inf, so their zero rows may not be skipped
      (row 0 wins at kFar where no real triangle is hit); tile 0 has
      those four keys alone, tile 2 kpb keys;
    s5, s12, s12_p1: S = 5 and 12, sizes the smoke's main path does not
      use."""
    pack, S = OMAP_EDGE_CASES[case]
    rng = np.random.default_rng(seed)
    T, tri_blk = 4, 128
    rps = 16 // pack
    kpb = tri_blk // rps
    k_cap = 2 * kpb
    nw = (S * S + 15) // 16
    rows = (_OMAP_SEGS + 1) * rps
    g = np.zeros((rows, 128), np.float32)
    n = _OMAP_SEGS * rps
    pid = np.arange(n * pack, dtype=np.int32).reshape(n, pack) + 1000
    words = rng.integers(0, 1 << 16, (n, pack, nw)).astype(np.float32)
    if case.startswith("transparent_inf"):
        words[:12 * rps] = 0.0
    for k in range(pack):
        g[:n, 48 * k:48 * k + 48] = mt_rows(_edge_tris(rng, n))
    if case.startswith("zero_words"):
        g[:4 * rps, :48 * pack] = 0.0
        words[:4 * rps] = 65535.0
    if pack == 2:
        g[:n, 96:98] = pid.view(np.float32)
        g[:n, 98:98 + 2 * nw] = words.reshape(n, 2 * nw)
    else:
        g[:n, 48:48 + nw] = words[:, 0]
        g[:n, 48 + nw] = pid[:, 0].view(np.float32)
    counts = np.array([kpb + kpb // 4, 2 * kpb, kpb // 2 + 1, kpb + 1],
                      np.int32)
    seg = (rng.integers(0, _OMAP_SEGS, (T, 1)) + np.arange(k_cap)) \
        % _OMAP_SEGS
    t0 = np.full((T, 256), 1e30, np.float32)
    if case.startswith("transparent_inf"):
        seg[1] = np.arange(k_cap) % 12
        t0[:2] = np.inf
    if case.startswith("zero_words"):
        seg[:, :4] = np.arange(4)
        counts[0], counts[2] = 4, kpb
        t0[[0, 2]] = np.inf
    seg[np.arange(k_cap)[None] >= counts[:, None]] = _OMAP_SEGS
    o, d = _edge_rays(rng, T)
    ins = dict(offs=(seg * rps).astype(np.int32), counts=counts,
               lbg=np.zeros((T, 1, 2), np.float32),
               tmax=np.full((T, 1), 1e30, np.float32), o_t=o, d_t=d,
               gtab_flat=g)
    return ins, dict(k_cap=k_cap, tri_blk=tri_blk, pack=pack, rps=rps,
                     omap_s=S, t0=t0)


def omap_edge_args(case, device):
    """omap_edge_inputs's case as kernel B's arguments (packet2.mt_fused's
    order, as mt_resolve_fused hands them over) on `device`."""
    ins, kw = omap_edge_inputs(case)
    x = {k: torch.from_numpy(v).to(device) for k, v in ins.items()}
    T = x["offs"].shape[0]
    return (x["offs"], x["counts"], x["lbg"].reshape(T, -1),
            x["tmax"].reshape(T),
            packet2._features(x["o_t"], x["d_t"]).contiguous(),
            torch.from_numpy(kw["t0"]).to(device), x["gtab_flat"],
            kw["k_cap"], kw["tri_blk"], kw["rps"], kw["pack"], False,
            kw["omap_s"])


@pytest.mark.parametrize("variant", ma.VARIANTS)
@pytest.mark.parametrize("case", ABLATION_EDGE_CASES)
def test_ablation_kernel_edge_cases(case, variant):
    """Kernel I (it walks only live rows, and gives the first dead row
    kFar where the live rows' minimum lies above it) against its twin on
    the edge cases: t bit for bit and rows equal; bf16 by ma.check's
    tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    *args, gtab = (torch.from_numpy(x).cuda()
                   for x in ablation_edge_inputs(case))
    before = ma.LAUNCHES["mt_ablation"]
    got = ma.ablation(*args, gtab, variant)
    torch.cuda.synchronize()
    assert ma.LAUNCHES["mt_ablation"] == before + 1
    if variant == "bf16":
        ma.check(args, gtab, variant, got)
        return
    t, i, _ = ma._ablation_plain(*args, gtab, variant)
    assert torch.equal(got[1], i) and torch.equal(_bits(got[0]), _bits(t))


@pytest.mark.parametrize("case", OMAP_EDGE_CASES)
def test_mt_omap_kernel_edge_cases(case):
    """Kernel B's micromap mode (its bit read only where a hit would win,
    its zero rows skipped, S = 5 and 12 beside the main path's sizes)
    against its twin on the edge cases: t, u and v bit for bit, rows
    and prims equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    args = omap_edge_args(case, "cuda")
    before = packet2.LAUNCHES["mt_fused_omap"]
    got = packet2.mt_fused(*args)
    torch.cuda.synchronize()
    assert packet2.LAUNCHES["mt_fused_omap"] == before + 1
    ref = packet2._mt_fused_plain(*args)[:5]
    for k in (1, 4):
        assert torch.equal(got[k], ref[k])
    for k in (0, 2, 3):
        assert torch.equal(_bits(got[k]), _bits(ref[k]))


# ---- the render and scene layers on the card ------------------------------

class _FixedDraws:
    """A render.pathtracer.Sampler stand-in whose draws are made once on
    the CPU (a seeded torch.Generator) and moved to each run's device, so
    a card run and a CPU run see the same numbers."""

    def __init__(self, seed):
        self.g = torch.Generator().manual_seed(seed)
        self.draws = []
        self.i = 0

    def bounce(self, n_rays, n_lights, device):
        if self.i == len(self.draws):
            self.draws.append(
                (torch.randint(0, n_lights, (n_rays,), generator=self.g),
                 *torch.rand((4, n_rays), generator=self.g)))
        out = [x.to(device) for x in self.draws[self.i]]
        self.i += 1
        return out

    def rewind(self):
        self.i = 0
        return self


def _lit_box(tris):
    """The scene with a floor below it and an emissive quad above it."""
    v = tris.reshape(-1, 3)
    lo, hi = v.min(0), v.max(0)
    c, ext = (lo + hi) / 2, hi - lo

    def quad(y, h):
        a, b = [c[0] - h[0], y, c[2] - h[2]], [c[0] + h[0], y, c[2] - h[2]]
        cc, dd = [c[0] + h[0], y, c[2] + h[2]], [c[0] - h[0], y, c[2] + h[2]]
        return np.array([[a, b, cc], [a, cc, dd]], np.float32)

    all_tris = np.concatenate([tris, quad(lo[1] - 1.0, ext),
                               quad(hi[1] + 3.0, 0.25 * ext)])
    emission = np.zeros((all_tris.shape[0], 3), np.float32)
    emission[-2:] = 8.0
    return all_tris.astype(np.float32), emission


def _pixels_close(got, ref, rtol, atol, frac, mean_rtol):
    got, ref = got.cpu().numpy(), ref.cpu().numpy()
    assert np.isfinite(got).all()
    close = np.isclose(got, ref, rtol=rtol, atol=atol).all(axis=1)
    assert close.mean() >= frac, f"only {close.mean():.4f} rays match"
    np.testing.assert_allclose(got.mean(), ref.mean(), rtol=mean_rtol)


@pytest.mark.parametrize("route", ["wavefront", "packets"])
def test_trace_paths_on_cuda_matches_cpu(scene, route):
    """trace_paths on the card (kernels A and B for route "packets")
    against the port's CPU run with the same draws: at least 0.999 of the
    rays within rtol 1e-3 / atol 1e-4 (tests/test_pathtracer.py:330-331;
    the two devices round sin, cos and divisions by a scalar
    differently, so a ray that grazes an edge may take another path),
    and the means within 1e-3."""
    from tinybvh_tpu_torch.render import camera, pathtracer
    from tinybvh_tpu_torch.traverse.packet2 import build_packet_aux

    tris, _ = scene
    all_tris, emission = _lit_box(tris)
    cam = camera.auto_camera(all_tris.reshape(-1, 3).min(0),
                             all_tris.reshape(-1, 3).max(0))
    draws = _FixedDraws(4)
    out = []
    for dev in ("cpu", "cuda"):
        bvh = BVH(all_tris, device=dev)
        sc = pathtracer.make_scene_arrays(bvh.tris, emissive=emission)
        rays = camera.primary_rays(*cam, 64, 64, device=dev)
        aux = build_packet_aux(bvh.bvh8) if route == "packets" else None
        rad, ovf = pathtracer.trace_paths(bvh.bvh8, sc, rays, draws.rewind(),
                                          bounces=2, aux=aux)
        assert rad.device.type == dev and not bool(ovf)
        out.append(rad)
    _pixels_close(out[1], out[0], 1e-3, 1e-4, 0.999, 1e-3)
    assert float(out[0].max()) > 0


@pytest.mark.parametrize("route", ["wavefront", "tpacket"])
def test_trace_paths_tlas_on_cuda_matches_cpu(route):
    """trace_paths_tlas on the card against the CPU with the same draws,
    at the standard of tests/test_pathtracer_tlas.py:152-157."""
    from tinybvh_tpu_torch.render.pathtracer_tlas import trace_paths_tlas
    from tinybvh_tpu_torch.tlas.instance import build_tlas
    from tinybvh_tpu_torch.tlas.packet import build_tlas_packet

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    rng = np.random.default_rng(5)
    tris, emission = _lit_box(random_tris(2000, seed=4))
    light = tris[-2:]
    mats = []
    for i in range(3):
        m = np.eye(4, dtype=np.float32)
        m[:3, 3] = [11.0 * i, 0, 0]
        mats.append((0, m))
    mats.append((1, np.eye(4, dtype=np.float32)))
    o = np.tile(np.float32([[16.0, 8.0, -25.0]]), (4096, 1))
    d = rng.normal(size=(4096, 3)).astype(np.float32) * 0.25
    d[:, 2] = 1.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    draws = _FixedDraws(6)
    out = []
    for dev in ("cpu", "cuda"):
        blases = [BVH(tris[:-2], device=dev).bvh8, BVH(light, device=dev).bvh8]
        tl = build_tlas(blases, mats, device=dev)
        tp = build_tlas_packet(blases, mats) if route == "tpacket" else None
        rad, ovf = trace_paths_tlas(
            tl, np.float32([[0.7] * 3] * 3 + [[0, 0, 0]]),
            np.float32([[0] * 3] * 3 + [[8, 8, 8]]), light,
            np.full((2, 3), 8.0, np.float32), make_rays(o, d, device=dev),
            draws.rewind(), bounces=2, tpacket=tp)
        assert rad.device.type == dev and not bool(ovf)
        out.append(rad)
    _pixels_close(out[1], out[0], 2e-2, 2e-3, 0.98, 2e-2)
    assert float(out[0].max()) > 0


def test_scene_update_refit_on_cuda_matches_cpu():
    """Scene.update of a rigid, morphing mesh under an animated root: on
    the card the refit BLAS (bounds and leaf triangles) and the TLAS
    equal the CPU's bit for bit, frame after frame."""
    from tinybvh_tpu_torch.scene.graph import Animation, Node, Scene
    from tinybvh_tpu_torch.scene.mesh import Mesh

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    tris = random_tris(3000, seed=2)
    rng = np.random.default_rng(2)
    delta = rng.normal(scale=0.3, size=tris.shape).astype(np.float32)
    scenes = []
    for dev in ("cpu", "cuda"):
        s = Scene(device=dev)
        m = Mesh(tris=tris.copy())
        m.base_tris = tris.copy()
        m.morph_targets = delta[None]
        mid = s.add_mesh(m, policy="rigid")
        root = s.add_node(Node(name="root"))
        for i in range(4):
            s.add_node(Node(mesh=mid, translation=np.float32([12.0 * i, 0,
                                                              0])),
                       parent=root)
        s.animations.append(Animation([
            dict(node=root, path="translation", times=np.array([0.0, 1.0]),
                 values=np.float32([[0, 0, 0], [3, 1, 0]]), interp="LINEAR"),
            dict(node=1, path="weights", times=np.array([0.0, 1.0]),
                 values=np.float32([[0.0], [1.0]]), interp="LINEAR")]))
        scenes.append(s)
    for t in (0.0, 0.3, 0.9):
        for s in scenes:
            s.update(t)
        c, g = scenes
        assert g.device.type == "cuda"
        for k in ("bounds", "leaf_tris", "child", "leaf_prim"):
            assert torch.equal(getattr(g._blas[0], k).cpu(),
                               getattr(c._blas[0], k)), k
        for k in ("bounds", "child", "inst_inv", "inst_root"):
            assert torch.equal(getattr(g.tlas, k).cpu(),
                               getattr(c.tlas, k)), k


@pytest.mark.parametrize("builder", ["lbvh", "binned_device"])
def test_device_builders_on_cuda_match_cpu(builder):
    """build_lbvh and build_binned_device on the card equal their CPU run
    array for array (the same torch ops; min, max and integer scatters
    do not depend on the order of the card's atomics), and the card's
    tree traces like brute force."""
    from tinybvh_tpu_torch.builders.binned_device import build_binned_device
    from tinybvh_tpu_torch.builders.lbvh import build_lbvh
    from tinybvh_tpu_torch.layouts.mbvh import collapse_bvh2
    from tinybvh_tpu_torch.traverse.wide import intersect_bvh8

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    build = build_lbvh if builder == "lbvh" else build_binned_device
    for n in (1, 2, 33, 3000, 65536):
        if builder != "lbvh" and n == 1:
            continue
        tris = random_tris(n, seed=n + 3)
        cpu = build(tris, device="cpu")
        gpu = build(torch.from_numpy(tris).cuda())
        assert gpu.node_min.device.type == "cuda"
        assert gpu.n_nodes == cpu.n_nodes, n
        for k in ("node_min", "node_max", "left_first", "count",
                  "prim_idx"):
            assert torch.equal(getattr(gpu, k).cpu(), getattr(cpu, k)), (n, k)
    o, d = _camera_rays(T=8)
    rays = make_rays(o, d, device="cuda")
    h = intersect_bvh8(collapse_bvh2(gpu, tris), rays)
    ref = brute_force_closest(rays, torch.from_numpy(tris).cuda())
    assert torch.equal(h.prim, ref.prim)


def test_bvh8q_wavefront_on_cuda_matches_cpu(scene):
    """The wavefront engine on a BVH8Q on the card: the same prims as
    its CPU run, closest and any hit, and the same prims and t as the
    float BVH8 on the card. Against the CPU's t, u and v ROADMAP's parity
    standard (t within rtol = atol = 1e-4, u and v within 1e-3): the two
    devices round the leaf test's products and sums each in their own
    order, and a grazing hit's cancellation magnifies that past 1e-6."""
    from tinybvh_tpu_torch.layouts.cwbvh import quantize_bvh8
    from tinybvh_tpu_torch.layouts.mbvh import BVH8
    from tinybvh_tpu_torch.traverse.wavefront import (
        intersect_wavefront, is_occluded_wavefront,
    )

    _, bvh = scene
    q = quantize_bvh8(bvh.bvh8)
    q_cpu = quantize_bvh8(BVH8(**{k: getattr(bvh.bvh8, k).cpu() for k in (
        "bounds", "child", "leaf_tris", "leaf_prim")}))
    assert torch.equal(q.qbounds.cpu(), q_cpu.qbounds)
    o, d = _camera_rays()
    h, ovf = intersect_wavefront(q, make_rays(o, d, device="cuda"),
                                 cap_factor=32)
    hc, ovfc = intersect_wavefront(q_cpu, make_rays(o, d, device="cpu"),
                                   cap_factor=32)
    h8, _ = intersect_wavefront(bvh.bvh8, make_rays(o, d, device="cuda"),
                                cap_factor=32)
    assert not ovf and not ovfc
    assert torch.equal(h.prim.cpu(), hc.prim)
    assert torch.equal(h.prim, h8.prim) and torch.equal(h.t, h8.t)
    for k, tol in (("t", 1e-4), ("u", 1e-3), ("v", 1e-3)):
        np.testing.assert_allclose(getattr(h, k).cpu().numpy(),
                                   getattr(hc, k).numpy(), rtol=tol,
                                   atol=tol)
    assert 0 < float((h.prim >= 0).float().mean()) < 1
    occ = is_occluded_wavefront(q, make_rays(o, d, device="cuda"), 12.0)
    occ_c = is_occluded_wavefront(q_cpu, make_rays(o, d, device="cpu"), 12.0)
    assert torch.equal(occ.cpu(), occ_c)


def _f64_instances(big):
    """4 instances of two BLASes, turned about y, scaled and moved near
    (big, big, big), one mask bit each (as tests/test_torch_f64.py)."""
    from tinybvh_tpu_torch.ops.f64 import BLASInstanceEx

    out = []
    for i in range(4):
        a = 0.4 * i + 0.1
        m = np.eye(4)
        m[:3, :3] = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                              [-np.sin(a), 0, np.cos(a)]]) * (0.5 + 0.3 * i)
        m[:3, 3] = [big + 6.0 * i, big + 2.0 * (i % 2), big - 3.0 * i]
        out.append(BLASInstanceEx(i % 2, m, mask=1 << i))
    return out


def test_f64_on_cuda_matches_cpu():
    """BVHDouble and TLASDouble on the card against their CPU run: prim
    and inst equal, t, u and v within rtol 1e-12, occlusion equal (each
    f64 op is a kernel of its own on either device)."""
    from tinybvh_tpu_torch.ops.f64 import BVHDouble, TLASDouble

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    big = 1e6
    tris = random_tris(2000, seed=3).astype(np.float64) + big
    rng = np.random.default_rng(5)
    o = big + rng.uniform(-2, 12, (4096, 3))
    d = rng.normal(size=(4096, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    gpu, cpu = BVHDouble(tris), BVHDouble(tris, device="cpu")
    assert gpu.device.type == "cuda"
    blas_g = [gpu, BVHDouble(random_tris(300, seed=9, extent=2.0).astype(
        np.float64))]
    blas_c = [cpu, BVHDouble(blas_g[1].tris, device="cpu")]
    tl_g = TLASDouble(_f64_instances(big), blas_g)
    tl_c = TLASDouble(_f64_instances(big), blas_c, device="cpu")
    masks = rng.integers(0, 16, 4096)
    for hg, hc in ((gpu.intersect(o, d), cpu.intersect(o, d)),
                   (tl_g.intersect(o, d, mask=masks),
                    tl_c.intersect(o, d, mask=masks))):
        assert hg["t"].device.type == "cuda"
        for k in ("prim", "inst"):
            if k in hc:
                assert torch.equal(hg[k].cpu(), hc[k]), k
        assert 0 < float((hc["prim"] >= 0).float().mean()) < 1
        for k in ("t", "u", "v"):
            np.testing.assert_allclose(hg[k].cpu().numpy(), hc[k].numpy(),
                                       rtol=1e-12, err_msg=k)
    assert torch.equal(gpu.is_occluded(o, d, 5.0).cpu(),
                       cpu.is_occluded(o, d, 5.0))
    assert torch.equal(tl_g.is_occluded(o, d, 30.0, mask=masks).cpu(),
                       tl_c.is_occluded(o, d, 30.0, mask=masks))


def test_one_rank_nccl_mesh_matches_intersect_packets2(scene, tmp_path):
    """A one-rank NCCL process group, mesh 1 x 1: trace_packets_dp and
    trace_packets_sharded over one shard equal intersect_packets2 on the
    card (on the same tables) in every field."""
    from datetime import timedelta

    import torch.distributed as dist
    from tinybvh_tpu_torch.parallel import mesh as pm

    tris, bvh = scene
    dist.init_process_group(
        "nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1, timeout=timedelta(seconds=60))
    try:
        mesh = pm.make_mesh(1, 1)
        assert mesh.device == torch.device("cuda", 0)
        o, d = _camera_rays()
        rays = make_rays(o, d, device="cuda")
        kw = dict(wf_cap_factor=64)
        b8s, auxes, gids = pm.shard_scene_packets(tris, 1)
        dev = mesh.device
        for got, (b8, aux) in (
                (pm.trace_packets_dp(mesh, bvh.bvh8, bvh.packet_aux, rays,
                                     **kw), (bvh.bvh8, bvh.packet_aux)),
                (pm.trace_packets_sharded(mesh, b8s, auxes, gids, rays, **kw),
                 (pm._shard(b8s, 0, dev), pm._shard(auxes, 0, dev)))):
            ref, _ = packet2.intersect_packets2(b8, aux, rays, **kw)
            for k in ("prim", "t", "u", "v"):
                assert torch.equal(getattr(got, k), getattr(ref, k)), k
        assert mesh.stats["collectives"] == 3
    finally:
        dist.destroy_process_group()
