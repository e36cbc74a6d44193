"""The port's packet2 pipeline against the JAX package, on the CPU.

Same inputs (numpy, from a seed) go through the JAX function (Pallas in
interpret mode, as tests/test_packet2.py runs it) and its counterpart in
tinybvh_tpu_torch (the kernels' plain twins, which the wrappers pick for
CPU tensors). Tolerances as tests/test_packet2.py:141-160: prim equal
except exact ties (both candidate hits within a relative 1e-6 in t), t
within rtol = atol = 1e-4, u and v within 1e-3; cull survivor sets and
counts exactly equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

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
    bvh8, aux = from_numpy_tables(jb.bvh8, jb.packet_aux)
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
    rays = make_rays(o, d)
    fr = p2._tile_frusta(aux, rays, 1e30)
    jfr = jp2._tile_frusta(jb.packet_aux, tb.make_rays(o, d), 1e30)
    for a, b in zip(fr, jfr):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-6)


def _cull_inputs(aux, T=8):
    o, d = _camera_rays(T=T)
    return p2._tile_frusta(aux, make_rays(o, d), 1e30)[:6]


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
    p2.intersect_packets2(bvh8, aux, make_rays(o, d), max_leaves=256,
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


def test_intersect_sorted_matches_jax_and_oracle(scene):
    tris, jb, bvh8, aux = scene
    rng = np.random.default_rng(5)
    o = rng.uniform(-1, 11, (512, 3)).astype(np.float32)
    d = rng.normal(size=(512, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = make_rays(o, d)
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
    ref = brute_force_closest(make_rays(o, d), torch.from_numpy(tris))
    pts = np.clip(_np(ref.t)[:, None] * d + o, -50, 50).astype(np.float32)
    light = np.array([5.0, 14.0, 5.0], np.float32)
    occ, ovf = p2.is_occluded_packets2_sorted(
        bvh8, aux, torch.from_numpy(light), torch.from_numpy(pts),
        retrace_ml=2048, retrace_blocks=256)
    assert not _np(ovf).any()
    jocc, _ = jp2.is_occluded_packets2_sorted(
        jb.bvh8, jb.packet_aux, light, pts, interpret=True,
        retrace="packet", retrace_ml=2048, retrace_blocks=256)
    np.testing.assert_array_equal(_np(occ), _np(jocc))
    seg = make_rays(np.broadcast_to(light, pts.shape), pts - light)
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
    rays = make_rays(ow, dw)
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
    _, _, bvh8, aux = scene
    o, d = _camera_rays(T=1)
    with pytest.raises(NotImplementedError):
        p2.intersect_packets2(bvh8, aux, make_rays(o, d), **kw)


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
    rays = make_rays(o, d)
    ref = brute_force_closest(rays, pb.tris)
    aux1 = p2.build_packet_aux_host(pb._bvh8_host, pack=1)
    j1 = jbuild(pb._bvh8_host, pack=1)
    for k in ("leaf_lo", "blk_lo", "gtab_pad", "center"):
        assert _np(getattr(aux1, k)).tobytes() == _np(getattr(j1, k)).tobytes()
    for aux in (pb.packet_aux, aux1):
        h, ov = p2.intersect_packets2(pb.bvh8, aux, rays, max_leaves=512,
                                      retrace=False, max_blocks=32)
        assert not _np(ov).any()
        assert_hits_match(h.prim, h.t, h.u, h.v, ref.prim, ref.t, ref.u,
                          ref.v)
