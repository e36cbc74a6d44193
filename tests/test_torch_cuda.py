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

from tinybvh_tpu_torch import BVH  # noqa: E402
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
     any_hit) = args
    counts, lbg, ff, t0 = (x.clone() for x in (counts, lbg, ff, t0))
    kpb = tri_blk // rps
    counts[0] = 0
    counts[1] = kpb + kpb // 2 + 1
    assert counts[1] <= k_cap and counts[1] % kpb
    lbg[2] = float("nan")
    ff[3, :6] = -ff[3, :6]
    t0[4] = float("inf")
    return (offs, counts, lbg, tmax, ff, t0, gtab, k_cap, tri_blk, rps,
            pack, any_hit)


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
    """Kernel G over nbpad = 384 block ids (each thread strides over three
    of them) with n_blocks = 301, inside the last chunk: random boxes
    around the scene, bit equal to the plain twin."""
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
    and nothing falls back to the twin."""
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
    t, idx = gather_inputs["D2048"]
    with pytest.raises(TypeError):
        hg.onehot_gather(t.float(), idx)
    with pytest.raises(ValueError):
        hg.onehot_gather(t, idx[:100].contiguous())
    assert (hg.LAUNCHES, ma.LAUNCHES) == before
