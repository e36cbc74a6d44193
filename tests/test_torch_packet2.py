"""The port's packet2 pipeline against the JAX package, on the CPU.

Same inputs (numpy, from a seed) go through the JAX function (Pallas in
interpret mode, as tests/test_packet2.py runs it) and its counterpart in
tinybvh_tpu_torch (the kernels' plain twins, which the wrappers pick for
CPU tensors). Tolerances as tests/test_packet2.py:141-160: prim equal
except exact ties (both candidate hits within a relative 1e-6 in t), t
within rtol = atol = 1e-4, u and v within 1e-3; cull survivor sets and
counts, and the coarse block masks and worklists, exactly equal. The last four tests
mirror tests/test_packet2.py's tests of the same names against the
port's own wavefront engine and an f64 brute force.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import tinybvh_tpu as tb  # noqa: E402
from tinybvh_tpu.traverse import packet2 as jp2  # noqa: E402
from tinybvh_tpu.traverse.packet import _tile_planes as j_tile_planes  # noqa: E402
from tinybvh_tpu_torch import BVH as TBVH  # noqa: E402
from tinybvh_tpu_torch.convert import from_numpy_tables  # noqa: E402
from tinybvh_tpu_torch.core.intersect import (  # noqa: E402
    brute_force_any, brute_force_closest,
)
from tinybvh_tpu_torch.core.rays import make_rays  # noqa: E402
from tinybvh_tpu_torch.io.loaders import random_tris  # noqa: E402
from tinybvh_tpu_torch.traverse import packet2 as p2  # noqa: E402
from tinybvh_tpu_torch.traverse.packet import _tile_planes  # noqa: E402
from tinybvh_tpu_torch.traverse.wavefront import intersect_wavefront  # noqa: E402
from test_torch_cuda import far_hit_rows  # noqa: E402
from tests.test_torch_jax_native import jax_native  # noqa: E402,F401


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs one test file per worker process: keep torch's
    intra-op pool small so the workers do not oversubscribe the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def scene():
    """One scene, both packages: the JAX BVH8 + PacketAux, and the same
    tables carried into the port with from_numpy_tables."""
    tris = random_tris(3000, seed=0)
    jb = tb.BVH(tris)
    bvh8, aux = from_numpy_tables(jb.bvh8, jb.packet_aux, device="cpu")
    return tris, jb, bvh8, aux


def _camera_rays(T=4, seed=3):
    rng = np.random.default_rng(seed)
    eye = np.array([0.5, 0.5, -4.0], np.float32)
    d = []
    for _ in range(T):
        cx, cy = rng.uniform(0.2, 0.8, 2)
        gx, gy = np.meshgrid((np.arange(16) + 0.5) / 16 * 0.2,
                             (np.arange(16) + 0.5) / 16 * 0.2)
        dd = np.stack([cx + gx, cy + gy, np.full_like(gx, 4.0)], -1)
        dd /= np.linalg.norm(dd, axis=-1, keepdims=True)
        d.append(dd.reshape(-1, 3))
    d = np.concatenate(d).astype(np.float32)
    return np.broadcast_to(eye, d.shape).copy(), d


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def assert_hits_match(p, t, u, v, pr, tr, ur, vr):
    """prim equal except exact ties; t, u, v within the stated
    tolerances where prim agrees."""
    p, t, u, v, pr, tr, ur, vr = map(_np, (p, t, u, v, pr, tr, ur, vr))
    diff = p != pr
    tie = np.abs(t - tr) <= 1e-6 * np.maximum(np.abs(tr), 1e-30)
    assert not (diff & ~tie).any(), f"{int((diff & ~tie).sum())} prims"
    m = ~diff & (pr >= 0)
    np.testing.assert_allclose(t[m], tr[m], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(u[m], ur[m], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(v[m], vr[m], rtol=1e-3, atol=1e-3)


def test_tables_bit_identical(scene):
    """The port's own native build -> BVH8 host tables and PacketAux equal
    the JAX package's bit for bit (both compile builder.c)."""
    tris, jb, _, _ = scene
    pb = TBVH(tris, device="cpu")
    for k in ("bounds", "child", "leaf_tris", "leaf_prim"):
        a, b = _np(getattr(jb.bvh8, k)), _np(getattr(pb.bvh8, k))
        assert a.shape == b.shape and a.tobytes() == b.tobytes(), k
    ja, pa = jb.packet_aux, pb.packet_aux
    for k in ("leaf_lo", "leaf_hi", "blk_lo", "blk_hi", "gtab_pad",
              "center"):
        a, b = _np(getattr(ja, k)), _np(getattr(pa, k))
        assert a.shape == b.shape and a.tobytes() == b.tobytes(), k
    assert (ja.n_leaf_rows, ja.pack, ja.omap_s) == (
        pa.n_leaf_rows, pa.pack, pa.omap_s)


def test_tile_planes_and_frusta_match(scene):
    _, jb, _, aux = scene
    o, d = _camera_rays(T=8)
    T = 8
    got = _tile_planes(torch.from_numpy(o.reshape(T, 256, 3)[:, 0]),
                       torch.from_numpy(d.reshape(T, 256, 3)))
    want = j_tile_planes(jnp.asarray(o.reshape(T, 256, 3)[:, 0]),
                         jnp.asarray(d.reshape(T, 256, 3)))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)
    rays = make_rays(o, d, device="cpu")
    fr = p2._tile_frusta(aux, rays, 1e30)
    jfr = jp2._tile_frusta(jb.packet_aux, tb.make_rays(o, d), 1e30)
    for a, b in zip(fr, jfr):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-6)


def _cull_inputs(aux, T=8):
    o, d = _camera_rays(T=T)
    return p2._tile_frusta(aux, make_rays(o, d, device="cpu"), 1e30)[:6]


@pytest.mark.parametrize("span_mult,k_cap", [(1, 256), (2, 128), (1, 8)])
def test_cull_tiles_matches_jax(scene, span_mult, k_cap):
    """Equal survivor sets and counts per tile; k_cap=8 overflows (then
    the stored keys are k_cap of the survivors)."""
    _, jb, _, aux = scene
    args = _cull_inputs(aux)
    keys, cnt = p2.cull_tiles(aux, *args, k_cap=k_cap, span_mult=span_mult)
    jkeys, jcnt = jp2.cull_tiles(jb.packet_aux, *map(jnp.asarray, map(_np, args)),
                                 k_cap=k_cap, interpret=True,
                                 span_mult=span_mult)
    cnt, jcnt = _np(cnt), _np(jcnt)
    np.testing.assert_array_equal(cnt, jcnt)
    full, _ = p2.cull_tiles(aux, *args, k_cap=4096, span_mult=span_mult)
    for t in range(cnt.shape[0]):
        got = _np(keys[t])
        want = _np(jkeys[t])
        live = got[got != p2._I32MAX]
        assert len(live) == min(cnt[t], k_cap)
        if cnt[t] <= k_cap:
            assert set(live.tolist()) == set(
                want[want != jp2._I32MAX].tolist())
        else:
            allk = _np(full[t])
            assert set(live.tolist()) <= set(allk.tolist())
    if k_cap == 8:
        assert (cnt > k_cap).any()


@pytest.mark.parametrize("any_hit", [False, True])
def test_mt_resolve_fused_matches_jax(scene, monkeypatch, any_hit):
    """The port's mt_resolve_fused (plain twin) against the JAX kernel in
    interpret mode, on the same offsets, gates and rays."""
    _, _, bvh8, aux = scene
    o, d = _camera_rays(T=4)
    calls = []
    real = p2.mt_resolve_fused

    def rec(*a, **kw):
        calls.append((a, kw))
        return real(*a, **kw)

    monkeypatch.setattr(p2, "mt_resolve_fused", rec)
    p2.intersect_packets2(bvh8, aux, make_rays(o, d, device="cpu"), max_leaves=256,
                          retrace=False, any_hit=any_hit,
                          t_max=6.0 if any_hit else 1e30)
    (a, kw), = calls
    got = real(*a, **kw)
    jkw = dict(kw)
    jkw.pop("omap_s")
    if jkw["t0"] is not None:
        jkw["t0"] = jnp.asarray(_np(jkw["t0"]))
    want = jp2.mt_resolve_fused(*[jnp.asarray(_np(x)) for x in a],
                                interpret=True, **jkw)
    t, i, u, v, p = got
    tw, iw, uw, vw, pw = want
    assert_hits_match(p, t, u, v, pw, tw, uw, vw)
    assert (_np(p) >= 0).any()


@pytest.mark.parametrize("pack", [1, 2])
def test_far_hits_yield_to_the_first_dead_row(pack):
    """One tile with one live key (a ragged super-block of 128 rows) whose
    triangles every ray hits at t = 1e31, and an initial t of +inf: the
    first dead row (t = BVH_FAR, its prim id) then wins, in the JAX
    kernel and in the port's twin alike. Kernel B walks no dead rows and
    re-creates this win (tests/test_torch_cuda.py holds it to the twin)."""
    g, rps = far_hit_rows(pack)
    k_cap = 128 // rps
    rng = np.random.default_rng(5)
    o_t = rng.normal(size=(1, 3, 256)).astype(np.float32)
    d_t = rng.normal(size=(1, 3, 256)).astype(np.float32)
    offs = np.full((1, k_cap), rps, np.int32)
    offs[0, 0] = 0
    ins = dict(offs=offs, counts=np.ones(1, np.int32),
               lbg=np.zeros((1, 1, 1), np.float32),
               tmax=np.full((1, 1), 1e30, np.float32), o_t=o_t, d_t=d_t,
               gtab_flat=g)
    kw = dict(k_cap=k_cap, tri_blk=128, pack=pack, rps=rps)
    t0 = np.full((1, 256), np.inf, np.float32)
    got = p2.mt_resolve_fused(
        **{k: torch.from_numpy(v) for k, v in ins.items()},
        t0=torch.from_numpy(t0), **kw)
    want = jp2.mt_resolve_fused(
        **{k: jnp.asarray(v) for k, v in ins.items()}, t0=jnp.asarray(t0),
        interpret=True, **kw)
    for x in (got, want):
        t, i, u, v, p = map(_np, x)
        assert (t == np.float32(1e30)).all() and (i == rps).all()
        assert (p == 99).all() and (u == 0).all() and (v == 0).all()


def test_intersect_sorted_matches_jax_and_oracle(scene):
    tris, jb, bvh8, aux = scene
    rng = np.random.default_rng(5)
    o = rng.uniform(-1, 11, (512, 3)).astype(np.float32)
    d = rng.normal(size=(512, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = make_rays(o, d, device="cpu")
    h, ov = p2.intersect_packets2_sorted(bvh8, aux, rays, [0, 0, 0],
                                         [10, 10, 10], max_leaves=256,
                                         retrace="packet", retrace_ml=2048,
                                         retrace_blocks=256)
    assert not _np(ov).any()
    jh, _ = jp2.intersect_packets2_sorted(
        jb.bvh8, jb.packet_aux, tb.make_rays(o, d), [0.0, 0.0, 0.0],
        [10.0, 10.0, 10.0], max_leaves=256, interpret=True,
        retrace="packet", retrace_ml=2048, retrace_blocks=256)
    assert_hits_match(h.prim, h.t, h.u, h.v, jh.prim, jh.t, jh.u, jh.v)
    ref = brute_force_closest(rays, torch.from_numpy(tris))
    assert_hits_match(h.prim, h.t, h.u, h.v, ref.prim, ref.t, ref.u, ref.v)


def test_occluded_sorted_matches_jax_and_oracle(scene):
    tris, jb, bvh8, aux = scene
    o, d = _camera_rays(T=2)
    ref = brute_force_closest(make_rays(o, d, device="cpu"), torch.from_numpy(tris))
    pts = np.clip(_np(ref.t)[:, None] * d + o, -50, 50).astype(np.float32)
    light = np.array([5.0, 14.0, 5.0], np.float32)
    occ, ovf = p2.is_occluded_packets2_sorted(
        bvh8, aux, torch.from_numpy(light), torch.from_numpy(pts),
        retrace="packet", retrace_ml=2048, retrace_blocks=256)
    assert not _np(ovf).any()
    jocc, _ = jp2.is_occluded_packets2_sorted(
        jb.bvh8, jb.packet_aux, light, pts, interpret=True,
        retrace="packet", retrace_ml=2048, retrace_blocks=256)
    np.testing.assert_array_equal(_np(occ), _np(jocc))
    seg = make_rays(np.broadcast_to(light, pts.shape), pts - light, device="cpu")
    want = brute_force_any(seg, torch.from_numpy(tris), 1.0 - 1e-3)
    np.testing.assert_array_equal(_np(occ), _np(want))
    assert 0 < _np(occ).mean() < 1


def test_packet_retrace_restores_hits(scene):
    """A tiny first budget overflows a wide bundle; the escalated packet
    pass restores the exact hits and clears the mask, as in JAX."""
    tris, jb, bvh8, aux = scene
    rng = np.random.default_rng(0)
    dw = rng.normal(size=(256, 3)).astype(np.float32)
    dw /= np.linalg.norm(dw, axis=1, keepdims=True)
    ow = np.full((256, 3), 5.0, np.float32)
    rays = make_rays(ow, dw, device="cpu")
    _, ov0 = p2.intersect_packets2(bvh8, aux, rays, max_leaves=32,
                                   retrace=False)
    assert _np(ov0).all()
    h, ov = p2.intersect_packets2(bvh8, aux, rays, max_leaves=32,
                                  retrace="packet", retrace_ml=2048,
                                  retrace_blocks=256)
    assert not _np(ov).any()
    jh, _ = jp2.intersect_packets2(jb.bvh8, jb.packet_aux,
                                   tb.make_rays(ow, dw), max_leaves=32,
                                   interpret=True, retrace="packet",
                                   retrace_ml=2048, retrace_blocks=256)
    assert_hits_match(h.prim, h.t, h.u, h.v, jh.prim, jh.t, jh.u, jh.v)


@pytest.mark.parametrize("kw", [dict(fused=False), dict(sort=True),
                                dict(retrace=True),
                                dict(retrace="wavefront")])
def test_unported_modes_raise(scene, kw):
    """Of packet2's modes, only fused=False still raises for tables that
    carry opacity micromaps (kernel C has no micromap test; JAX's
    fused=False ignores them). The others trace them: with an all-opaque
    micromap, a 32-leaf budget and the wavefront retrace, their hits
    equal those of the tables without one."""
    from tinybvh_tpu_torch.ops.omap import leaf_align

    _, _, bvh8, aux = scene
    opaque = torch.ones((bvh8.leaf_prim.max() + 1, 4, 4), dtype=torch.bool)
    aux_o = p2.build_packet_aux(bvh8, omap=leaf_align(opaque, bvh8))
    o, d = _camera_rays(T=1)
    rays = make_rays(o, d, device="cpu")
    if kw.get("fused") is False:
        with pytest.raises(NotImplementedError, match="micromap"):
            p2.intersect_packets2(bvh8, aux_o, rays, **kw)
        return
    h, ov = p2.intersect_packets2(bvh8, aux_o, rays, max_leaves=32, **kw)
    ref, _ = p2.intersect_packets2(bvh8, aux, rays, max_leaves=32, **kw)
    assert not _np(ov).any()
    assert_hits_match(h.prim, h.t, h.u, h.v, ref.prim, ref.t, ref.u, ref.v)


@pytest.mark.parametrize("what", ["retrace", "occluded_retrace",
                                  "unfused_span_mult", "unfused_budget",
                                  "ragged_batch"])
def test_bad_arguments_raise(scene, what):
    """Arguments the JAX function asserts on or would misread raise
    ValueError before any work."""
    _, _, bvh8, aux = scene
    o, d = _camera_rays(T=1)
    rays = make_rays(o, d, device="cpu")
    with pytest.raises(ValueError):
        if what == "retrace":
            p2.intersect_packets2(bvh8, aux, rays, retrace="exact")
        elif what == "occluded_retrace":
            p2.is_occluded_packets2(bvh8, aux, torch.zeros(3),
                                    torch.from_numpy(d), retrace="exact")
        elif what == "unfused_span_mult":
            p2.intersect_packets2(bvh8, aux, rays, fused=False, span_mult=2)
        elif what == "unfused_budget":
            # 16 leaves = 4 keys: less than one 128-row block of kernel C
            p2.intersect_packets2(bvh8, aux, rays, fused=False,
                                  max_leaves=16)
        else:
            p2.intersect_packets2(bvh8, aux, make_rays(o[:200], d[:200], device="cpu"))


def test_tiny_scene_and_pack1_tables(scene):
    """A scene with fewer triangle rows than one MT super-block traces
    exactly (rows are fetched by offset, always in bounds), and the
    one-triangle-per-row tables (pack=1) equal the JAX package's and
    trace the same hits."""
    from tinybvh_tpu.traverse.packet2 import build_packet_aux_host as jbuild

    tris = random_tris(30, seed=3)
    pb = TBVH(tris, device="cpu")
    assert pb.packet_aux.gtab_pad.shape[0] < 256
    rng = np.random.default_rng(11)
    o = np.full((256, 3), -3.0, np.float32)
    d = (np.array([[0.5, 0.5, 0.5]])
         + 0.1 * rng.normal(size=(256, 3))).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = make_rays(o, d, device="cpu")
    ref = brute_force_closest(rays, pb.tris)
    aux1 = p2.build_packet_aux(pb.bvh8, pack=1)
    j1 = jbuild(pb._bvh8_host, pack=1)
    for k in ("leaf_lo", "blk_lo", "gtab_pad", "center"):
        assert _np(getattr(aux1, k)).tobytes() == _np(getattr(j1, k)).tobytes()
    for aux in (pb.packet_aux, aux1):
        h, ov = p2.intersect_packets2(pb.bvh8, aux, rays, max_leaves=512,
                                      retrace=False, max_blocks=32)
        assert not _np(ov).any()
        assert_hits_match(h.prim, h.t, h.u, h.v, ref.prim, ref.t, ref.u,
                          ref.v)


def _capture(monkeypatch, name):
    """Record the positional arguments of every p2.<name> call."""
    calls = []
    real = getattr(p2, name)

    def rec(*args):
        calls.append(args)
        return real(*args)

    monkeypatch.setattr(p2, name, rec)
    return calls


def _wide_bundle():
    """One tile of rays in every direction from the scene's middle: its
    frustum is all-pass, so small budgets overflow."""
    rng = np.random.default_rng(0)
    dw = rng.normal(size=(256, 3)).astype(np.float32)
    dw /= np.linalg.norm(dw, axis=1, keepdims=True)
    return np.full((256, 3), 5.0, np.float32), dw


@pytest.mark.parametrize("sort", [False, True])
def test_mt_resolve_matches_jax(scene, monkeypatch, sort):
    """Kernel C's twin against the JAX mt_resolve in interpret mode on the
    gathered rows and gates of the fused=False path."""
    _, _, bvh8, aux = scene
    o, d = _camera_rays(T=4)
    calls = _capture(monkeypatch, "mt_resolve")
    p2.intersect_packets2(bvh8, aux, make_rays(o, d, device="cpu"), max_leaves=256,
                          retrace=False, fused=False, sort=sort)
    (a,) = calls
    assert a[2].shape[1:] == (1024, 48)
    t, i = p2.mt_resolve(*a)
    tw, iw = jp2.mt_resolve(*[jnp.asarray(_np(x)) for x in a],
                            interpret=True)
    t, i, tw, iw = map(_np, (t, i, tw, iw))
    np.testing.assert_allclose(t, tw, rtol=1e-4, atol=1e-4)
    diff = i != iw
    tie = np.abs(t - tw) <= 1e-6 * np.maximum(np.abs(tw), 1e-30)
    assert not (diff & ~tie).any()
    assert (t < 1e30).any()


def test_cull_blocks_matches_jax_and_inline_tier(scene, monkeypatch):
    """Kernel G's twin against _cull_blocks_kernel under
    pl.pallas_call(interpret=True), built as
    benchmarks/packet2_probe.py:116-148 builds it, on the cull's own
    descriptors; through _worklists its mask gives exactly the worklists
    cull_tiles handed kernel A's twin."""
    from functools import partial

    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    _, _, bvh8, aux = scene
    o, d = _camera_rays(T=16)
    calls = _capture(monkeypatch, "cull")
    p2.intersect_packets2(bvh8, aux, make_rays(o, d, device="cpu"), retrace=False)
    desc = calls[0][2]
    got = p2.cull_blocks(desc, aux.blk_lo, aux.blk_hi, aux.n_blocks)
    tp = desc.shape[0]
    G, nbpad = tp // p2.TB, aux.blk_lo.shape[1]
    want = pl.pallas_call(
        partial(jp2._cull_blocks_kernel, n_blocks=aux.n_blocks),
        grid=(G,),
        in_specs=[
            pl.BlockSpec((p2.TB, 128), lambda g: (g, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((3, nbpad), lambda g: (0, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((3, nbpad), lambda g: (0, 0),
                         memory_space=pltpu.VMEM),
        ],
        out_shape=jax.ShapeDtypeStruct((G, 1, nbpad), jnp.int32),
        out_specs=pl.BlockSpec((1, 1, nbpad), lambda g: (g, 0, 0),
                               memory_space=pltpu.VMEM),
        interpret=True,
    )(*(jnp.asarray(_np(x)) for x in (desc, aux.blk_lo, aux.blk_hi)))
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    nblk, wl, _ = p2._worklists(got[:, 0] > 0, calls[0][1].shape[1])
    assert torch.equal(nblk, calls[0][0]) and torch.equal(wl, calls[0][1])
    assert _np(got).any()


@pytest.mark.parametrize("kw", [
    dict(fused=False), dict(sort=True), dict(sort=True, fused=False),
    dict(retrace=True, max_leaves=32, wf_cap_factor=24),
    dict(retrace=True, max_leaves=32, wf_cap_factor=24, fused=False),
    dict(retrace="packet", max_leaves=32, fused=False, return_counts=True,
         retrace_ml=2048, retrace_blocks=256),
    dict(retrace=False, max_leaves=32, return_counts=True),
], ids=["unfused", "sort", "sort_unfused", "wavefront_retrace",
        "wavefront_retrace_unfused", "packet_retrace_unfused_counts",
        "counts"])
def test_intersect_modes_match_jax(scene, kw):
    """intersect_packets2's modes against the JAX function in interpret
    mode: hits, overflow masks and (return_counts) raw cull counts. The
    max_leaves=32 cases trace an all-direction bundle that overflows
    every tile."""
    _, jb, bvh8, aux = scene
    kw = dict(dict(max_leaves=256), **kw)
    if kw["max_leaves"] == 32:
        o, d = _wide_bundle()
    else:
        o, d = _camera_rays(T=4)
    out = p2.intersect_packets2(bvh8, aux, make_rays(o, d, device="cpu"), **kw)
    jout = jp2.intersect_packets2(jb.bvh8, jb.packet_aux, tb.make_rays(o, d),
                                  interpret=True, **kw)
    assert len(out) == len(jout) == (3 if kw.get("return_counts") else 2)
    h, jh = out[0], jout[0]
    assert_hits_match(h.prim, h.t, h.u, h.v, jh.prim, jh.t, jh.u, jh.v)
    np.testing.assert_array_equal(_np(out[1]), _np(jout[1]))
    if kw.get("return_counts"):
        np.testing.assert_array_equal(_np(out[2]), _np(jout[2]))
        assert (_np(out[2]) > 8).all()
    if kw.get("retrace"):
        assert not _np(out[1]).any()
    assert (_np(h.prim) >= 0).any()


def test_primary_matches_wavefront(scene):
    _, _, bvh8, aux = scene
    o, d = _camera_rays(T=4)
    rays = make_rays(o, d, device="cpu")
    hits, ovf = p2.intersect_packets2(bvh8, aux, rays, max_leaves=256,
                                      retrace=False)
    ref, wovf = intersect_wavefront(bvh8, rays, cap_factor=16)
    assert not wovf
    assert not _np(ovf).any()
    hp, rp = _np(hits.prim), _np(ref.prim)
    assert (hp == rp).all()
    m = rp >= 0
    assert m.mean() > 0.3
    for name, tol in (("t", 1e-4), ("u", 1e-3), ("v", 1e-3)):
        np.testing.assert_allclose(_np(getattr(hits, name))[m],
                                   _np(getattr(ref, name))[m],
                                   rtol=tol, atol=tol)


def test_occlusion_vs_brute_force(scene):
    """Shadow segments to a light through the any-hit wavefront retrace,
    against an f64 Möller–Trumbore brute force."""
    tris, _, bvh8, aux = scene
    o, d = _camera_rays(T=2)
    ref, _ = intersect_wavefront(bvh8, make_rays(o, d, device="cpu"), cap_factor=16)
    pts = np.clip(_np(ref.t)[:, None] * d + o, -50, 50).astype(np.float32)
    light = np.array([5.0, 14.0, 5.0], np.float32)
    occ, ovf = p2.is_occluded_packets2(
        bvh8, aux, torch.from_numpy(light), torch.from_numpy(pts[:512]),
        retrace=True, wf_cap_factor=24)
    assert not _np(ovf).any()
    lt = np.asarray(tris, np.float64)
    v0 = lt[:, 0]
    e1 = lt[:, 1] - v0
    e2 = lt[:, 2] - v0
    oo = light.astype(np.float64)
    for i in range(0, 512, 17):
        dd = pts[i].astype(np.float64) - oo
        h = np.cross(dd, e2)
        det = (e1 * h).sum(1)
        ok = np.abs(det) > 1e-15
        inv = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
        s = oo - v0
        u = (s * h).sum(1) * inv
        q = np.cross(s, e1)
        v = (dd[None] * q).sum(1) * inv
        t = (e2 * q).sum(1) * inv
        hit = (ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 0)
               & (t < 1 - 1e-3))
        assert bool(_np(occ)[i]) == bool(hit.any())


def test_sorted_diffuse_matches_wavefront(scene):
    _, _, bvh8, aux = scene
    rng = np.random.default_rng(1234)
    o = rng.uniform(-1, 11, (2048, 3)).astype(np.float32)
    d = rng.normal(size=(2048, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = make_rays(o, d, device="cpu")
    hits, fb = p2.intersect_packets2_sorted(
        bvh8, aux, rays, [0.0, 0.0, 0.0], [10.0, 10.0, 10.0],
        max_leaves=256, retrace=True, wf_cap_factor=24)
    ref, wovf = intersect_wavefront(bvh8, rays, cap_factor=24)
    assert not wovf
    assert not _np(fb).any()
    assert (_np(hits.prim) == _np(ref.prim)).all()


def test_overflow_reported_and_retraced(scene):
    """A tiny leaf budget flags overflow; the wavefront retrace restores
    the hits and clears the mask."""
    _, _, bvh8, aux = scene
    rays = make_rays(*_wide_bundle(), device="cpu")
    _, ovf0 = p2.intersect_packets2(bvh8, aux, rays, max_leaves=32,
                                    retrace=False)
    assert _np(ovf0).all()
    hits1, ovf1 = p2.intersect_packets2(bvh8, aux, rays, max_leaves=32,
                                        retrace=True, wf_cap_factor=24)
    ref, _ = intersect_wavefront(bvh8, rays, cap_factor=24)
    assert (_np(hits1.prim) == _np(ref.prim)).all()
    assert not _np(ovf1).any()
