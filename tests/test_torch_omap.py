"""The port's opacity micromaps against the JAX package, on the CPU.

Same inputs (numpy, from a seed) go through the JAX functions (kernel B
in interpret mode, as tests/test_omap_engines.py runs it) and their
counterparts in tinybvh_tpu_torch (kernel B's plain twin, which the
wrapper picks for CPU tensors): the bakers and leaf_align exactly; the
packet tables with micromaps bit for bit; kernel B's micromap mode on the
same offsets; the wavefront, lockstep, packet2 and TLAS packet engines
with micromaps. Tolerances are ROADMAP's parity standard: prim equal on
every ray (kernel B against JAX: but for exact ties, both t within a
relative 1e-6, as tests/test_torch_packet2.py); t within rtol = atol =
1e-4; u and v within 1e-3. The first five engine tests mirror
tests/test_omap_engines.py and tests/test_omap_f64.py's micromap tests
on the port, each also against the JAX result. Across engines (kernel B's
triple products against the wavefront's Möller–Trumbore) a ray near a
cell edge may land in the neighbouring cell, so those rays aim at cell
centres, as tests/test_omap_engines.py's do.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import tinybvh_tpu as tb  # noqa: E402
from tinybvh_tpu.builders.binned import build_binned  # noqa: E402
from tinybvh_tpu.layouts.mbvh import collapse_bvh2  # noqa: E402
from tinybvh_tpu.ops import omap as jom  # noqa: E402
from tinybvh_tpu.tlas import packet as jpk  # noqa: E402
from tinybvh_tpu.traverse import packet2 as jp2  # noqa: E402
from tinybvh_tpu.traverse import wavefront as jwf  # noqa: E402
from tinybvh_tpu.traverse import wide as jwd  # noqa: E402
from tinybvh_tpu_torch import BVH  # noqa: E402
from tinybvh_tpu_torch.convert import (  # noqa: E402
    from_numpy_bvh8, from_numpy_tables, from_numpy_tlas_packet,
)
from tinybvh_tpu_torch.core.rays import make_rays  # noqa: E402
from tinybvh_tpu_torch.io.loaders import random_tris, sphere_tris  # noqa: E402
from tinybvh_tpu_torch.ops import omap as pom  # noqa: E402
from tinybvh_tpu_torch.tlas import packet as ppk  # noqa: E402
from tinybvh_tpu_torch.traverse import packet2 as p2  # noqa: E402
from tinybvh_tpu_torch.traverse.wavefront import (  # noqa: E402
    intersect_wavefront, is_occluded_wavefront,
)
from tinybvh_tpu_torch.traverse.wide import intersect_bvh8  # noqa: E402
from tests.test_torch_jax_native import jax_native  # noqa: E402,F401


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """One test file per worker process: keep torch's pool small."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def leaf_alpha(prim, u, v):
    """A leaf-shaped alpha: opaque inside a disc of the barycentric
    domain whose radius (0.2-0.45) comes from a hash of the prim id."""
    h = (np.asarray(prim, np.int64) * 2654435761) % 4096 / 4096.0
    r = 0.2 + 0.25 * h
    return (u - 0.3) ** 2 + (v - 0.3) ** 2 < r * r


def assert_hits_match(p, t, u, v, pr, tr, ur, vr, ties=False):
    """prim equal (but exact ties where `ties`); t, u, v within the
    parity tolerances where prim agrees."""
    p, t, u, v, pr, tr, ur, vr = map(_np, (p, t, u, v, pr, tr, ur, vr))
    diff = p != pr
    if ties:
        diff &= ~(np.abs(t - tr) <= 1e-6 * np.maximum(np.abs(tr), 1e-30))
    assert not diff.any(), f"{int(diff.sum())} prims differ"
    m = (p == pr) & (pr >= 0)
    np.testing.assert_allclose(t[m], tr[m], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(u[m], ur[m], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(v[m], vr[m], rtol=1e-3, atol=1e-3)


def same_hits(h, jh, ties=False):
    assert_hits_match(h.prim, h.t, h.u, h.v, jh.prim, jh.t, jh.u, jh.v,
                      ties=ties)


@pytest.fixture(scope="module")
def scene():
    """random_tris(3000) in both packages (the JAX build carried into the
    port) and its micromaps at S = 4, 8 and 16, leaf-aligned: {S: (JAX
    table, port table)}."""
    tris = random_tris(3000, seed=0)
    jb = tb.BVH(tris)
    bvh8, _ = from_numpy_tables(jb.bvh8, jb.packet_aux, device="cpu")
    maps = {}
    for S in (4, 8, 16):
        jl = jom.leaf_align(jom.bake_omap(3000, leaf_alpha, S=S), jb.bvh8)
        pl = pom.leaf_align(pom.bake_omap(3000, leaf_alpha, S=S,
                                          device="cpu"), bvh8)
        maps[S] = (jl, pl)
    return tris, jb, bvh8, maps


def _camera(T=4, seed=3):
    """T 16x16 tiles of camera rays across the scene from one eye."""
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


# ---- bakers and tables ----------------------------------------------------

@pytest.mark.parametrize("S", [4, 8, 16])
def test_bake_and_align_match_jax(scene, S):
    """bake_omap, bake_omap_texture and leaf_align (from the device
    leaf_prim and from a host copy) equal the JAX functions'."""
    _, jb, bvh8, maps = scene
    jl, pl = maps[S]
    assert pl.dtype == torch.bool and pl.shape == (bvh8.leaf_prim.shape[0],
                                                   4, S, S)
    np.testing.assert_array_equal(_np(pl), _np(jl))
    om = pom.bake_omap(3000, leaf_alpha, S=S, device="cpu")
    host = pom.leaf_align(om, bvh8, leaf_prim_host=_np(jb.bvh8.leaf_prim))
    np.testing.assert_array_equal(_np(host), _np(jl))
    # about half of the cells inside the triangles are opaque
    iu, iv = np.meshgrid(np.arange(S), np.arange(S), indexing="ij")
    share = float(om[:, torch.from_numpy(iu + iv < S)].float().mean())
    assert 0.4 < share < 0.6
    rng = np.random.default_rng(S)
    uv = rng.uniform(-1, 2, (50, 3, 2)).astype(np.float32)
    tex = rng.uniform(0, 1, (16, 16)).astype(np.float32)
    np.testing.assert_array_equal(
        _np(pom.bake_omap_texture(uv, tex, S=S, device="cpu")),
        _np(jom.bake_omap_texture(uv, tex, S=S)))


@pytest.mark.parametrize("S", [4, 8, 16])
def test_omap_tables_match_jax(scene, S):
    """build_packet_aux(omap=): pack 2 at S = 4 and 8, pack 1 at S = 16
    (the fallback). The whole table equals JAX's numpy build bit for bit;
    against JAX's jitted build_packet_aux the micromap words and prim-id
    lanes (their NaN patterns included) are equal bit for bit and the
    triangle terms within 1e-6 (XLA may fuse their products)."""
    _, jb, bvh8, maps = scene
    jl, pl = maps[S]
    aux = p2.build_packet_aux(bvh8, omap=pl)
    jh = jp2.build_packet_aux_host(jb._bvh8_host, omap=_np(jl))
    jd = jp2.build_packet_aux(jb.bvh8, omap=jl)
    assert aux.pack == jh.pack == jd.pack == (2 if S <= 15 else 1)
    assert aux.omap_s == jh.omap_s == jd.omap_s == S
    np.testing.assert_array_equal(_np(aux.omap), _np(jl))
    x = _np(aux.gtab_pad)
    assert x.tobytes() == _np(jh.gtab_pad).tobytes()
    y = _np(jd.gtab_pad)
    assert x.shape == y.shape
    feat = 96 if aux.pack == 2 else 48
    assert (x[:, feat:].view(np.int32) == y[:, feat:].view(np.int32)).all()
    np.testing.assert_allclose(x[:, :feat], y[:, :feat], rtol=1e-6,
                               atol=1e-6)
    nw = (S * S + 15) // 16
    words = x[:, 98:98 + 2 * nw] if aux.pack == 2 else x[:, 48:48 + nw]
    assert (words > 0).any() and (words < 2 ** 16).all()


def test_omap_table_shape_checked(scene):
    """A table that is not (L, 4, S, S) for the BVH's L leaf rows raises."""
    _, _, bvh8, maps = scene
    with pytest.raises(ValueError):
        p2.build_packet_aux(bvh8, omap=maps[4][1][:-1])
    with pytest.raises(ValueError):
        intersect_wavefront(bvh8, make_rays(*_camera(T=1), device="cpu"),
                            omap=maps[4][1][..., :2])


# ---- kernel B's micromap mode -----------------------------------------------

@pytest.mark.parametrize("S,any_hit", [(4, False), (8, False), (8, True),
                                       (16, False), (16, True)])
def test_mt_resolve_fused_omap_matches_jax(scene, monkeypatch, S, any_hit):
    """The port's mt_resolve_fused with micromaps (kernel B's plain twin)
    against JAX's kernel in interpret mode, on the offsets, gates and rays
    of one port packet pass: t, u, v and prim."""
    _, _, bvh8, maps = scene
    aux = p2.build_packet_aux(bvh8, omap=maps[S][1])
    o, d = _camera(T=4)
    calls = []
    real = p2.mt_resolve_fused

    def rec(*a, **kw):
        calls.append((a, kw))
        return real(*a, **kw)

    monkeypatch.setattr(p2, "mt_resolve_fused", rec)
    p2.intersect_packets2(bvh8, aux, make_rays(o, d, device="cpu"),
                          max_leaves=256, retrace=False, any_hit=any_hit,
                          t_max=6.0 if any_hit else 1e30)
    (a, kw), = calls
    assert kw["omap_s"] == S and kw["pack"] == aux.pack
    t, _, u, v, p = real(*a, **kw)
    jkw = dict(kw)
    if jkw["t0"] is not None:
        jkw["t0"] = jnp.asarray(_np(jkw["t0"]))
    tw, _, uw, vw, pw = jp2.mt_resolve_fused(
        *[jnp.asarray(_np(x)) for x in a], interpret=True, **jkw)
    assert_hits_match(p, t, u, v, pw, tw, uw, vw, ties=True)
    # the micromaps removed hits that the tables without them keep
    kw0 = dict(kw, omap_s=0)
    a0 = list(a)
    a0[6] = p2.build_packet_aux(bvh8, pack=aux.pack).gtab_pad
    p0 = real(*a0, **kw0)[4]
    assert bool((p >= 0).any()) and not torch.equal(p, p0)


def test_mt_twin_transparent_pairs_give_far():
    """One tile whose one live key holds triangles every ray hits at t = 2,
    with all-zero micromaps (S = 2): every pair is transparent and gives
    BVH_FAR, which wins over an initial t of +inf at the first row, in the
    twin and in JAX's kernel alike."""
    from test_torch_cuda import far_hit_rows

    for pack in (1, 2):
        g, rps = far_hit_rows(pack)
        # far_hit_rows puts t' = 1e31; make the hit t = 2 instead
        for base in ((0, 48) if pack == 2 else (0,)):
            g[:rps, base + 45] = 2.0
        if pack == 1:   # S = 2: one word at lane 48, the prim id at 49
            g[:, 49] = g[:, 48]
        g[:, 98 if pack == 2 else 48] = 0.0
        if pack == 2:
            g[:, 99] = 0.0
        k_cap = 128 // rps
        offs = np.full((1, k_cap), rps, np.int32)
        offs[0, 0] = 0
        rng = np.random.default_rng(5)
        ins = dict(offs=offs, counts=np.ones(1, np.int32),
                   lbg=np.zeros((1, 1, 1), np.float32),
                   tmax=np.full((1, 1), 1e30, np.float32),
                   o_t=rng.normal(size=(1, 3, 256)).astype(np.float32),
                   d_t=rng.normal(size=(1, 3, 256)).astype(np.float32),
                   gtab_flat=g)
        kw = dict(k_cap=k_cap, tri_blk=128, pack=pack, rps=rps, omap_s=2)
        t0 = np.full((1, 256), np.inf, np.float32)
        got = p2.mt_resolve_fused(
            **{k: torch.from_numpy(x) for k, x in ins.items()},
            t0=torch.from_numpy(t0), **kw)
        want = jp2.mt_resolve_fused(
            **{k: jnp.asarray(x) for k, x in ins.items()},
            t0=jnp.asarray(t0), interpret=True, **kw)
        for x in (got, want):
            t, i, _, _, p = map(_np, x)
            assert (t == np.float32(1e30)).all() and (i == 0).all()
            assert (p == 7).all()
        for a, b in zip(got, want):
            assert _np(a).tobytes() == _np(b).tobytes()


# ---- the engines: tests/test_omap_engines.py and test_omap_f64.py ----------

def _quad(z, size=8.0):
    """Two triangles spanning [0, size]^2 at depth z."""
    return np.array(
        [[[0, 0, z], [size, 0, z], [0, size, z]],
         [[size, size, z], [0, size, z], [size, 0, z]]], np.float32)


@pytest.fixture(scope="module")
def alpha_quad():
    """An alpha-checkered quad at z=1 in front of a solid quad at z=3, in
    both packages (the port's micromaps from its own bakers)."""
    tris = np.concatenate([_quad(1.0), _quad(3.0)])
    jb8 = collapse_bvh2(build_binned(tris, max_leaf=4), tris)
    bvh8 = from_numpy_bvh8(jb8, device="cpu")
    tex = (np.indices((8, 8)).sum(axis=0) % 2 == 0).astype(np.float32)
    uv = np.zeros((4, 3, 2), np.float32)
    uv[0] = [[0, 0], [1, 0], [0, 1]]
    uv[1] = [[1, 1], [0, 1], [1, 0]]
    jom_full = np.concatenate([_np(jom.bake_omap_texture(uv[:2], tex, S=8)),
                               np.ones((2, 8, 8), bool)])
    pom_full = torch.cat([pom.bake_omap_texture(uv[:2], tex, S=8,
                                                device="cpu"),
                          torch.ones((2, 8, 8), dtype=torch.bool)])
    np.testing.assert_array_equal(_np(pom_full), jom_full)
    return (jb8, jom.leaf_align(jnp.asarray(jom_full), jb8), bvh8,
            pom.leaf_align(pom_full, bvh8))


def test_wavefront_omap_matches_lockstep(alpha_quad):
    jb8, jl, bvh8, pl = alpha_quad
    rng = np.random.default_rng(5)
    o = np.stack([rng.uniform(0.5, 7.5, 256), rng.uniform(0.5, 7.5, 256),
                  np.full(256, -2.0)], axis=1).astype(np.float32)
    d = np.tile(np.array([[0, 0, 1.0]], np.float32), (256, 1))
    rays = make_rays(o, d, device="cpu")
    ref = intersect_bvh8(bvh8, rays, omap=pl)            # validated engine
    h, _ = intersect_wavefront(bvh8, rays, omap=pl)
    np.testing.assert_array_equal(_np(h.prim), _np(ref.prim))
    # transparent cells reveal the back quad (prim 2/3), never a miss
    assert (_np(h.prim) >= 2).any() and (_np(h.prim) >= 0).all()
    occ = is_occluded_wavefront(bvh8, rays, t_max=2.0, omap=pl)
    np.testing.assert_array_equal(_np(occ), _np(ref.t) < 2.0)
    jr = tb.make_rays(o, d)
    same_hits(ref, jwd.intersect_bvh8(jb8, jr, omap=jl))
    jh, _ = jwf.intersect_wavefront(jb8, jr, omap=jl)
    same_hits(h, jh)
    np.testing.assert_array_equal(
        _np(occ), _np(jwf.is_occluded_wavefront(jb8, jr, 2.0, omap=jl)))


def test_packet2_omap_perforated_shadow(alpha_quad):
    """Kernel B's alpha test (its twin) agrees with the wavefront; the
    checkered quad casts a perforated shadow; both as JAX's."""
    jb8, jl, bvh8, pl = alpha_quad
    aux = p2.build_packet_aux(bvh8, omap=pl)
    jaux = jp2.build_packet_aux(jb8, omap=jl)
    assert aux.omap_s == 8
    g = (np.arange(16) + 0.5) / 16 * 8.0
    gx, gy = np.meshgrid(g, g)
    o = np.stack([gx, gy, np.full_like(gx, -2.0)], -1).reshape(-1, 3)
    o = o.astype(np.float32)
    d = np.tile(np.array([[0, 0, 1.0]], np.float32), (256, 1))
    rays = make_rays(o, d, device="cpu")
    ref, _ = intersect_wavefront(bvh8, rays, omap=pl)
    h, ovf = p2.intersect_packets2(bvh8, aux, rays, max_leaves=64,
                                   retrace=False)
    assert not _np(ovf).any()
    np.testing.assert_array_equal(_np(h.prim), _np(ref.prim))
    hit_front = _np(h.prim) < 2
    assert hit_front.any() and (~hit_front).any()       # perforated
    jh, _ = jp2.intersect_packets2(jb8, jaux, tb.make_rays(o, d),
                                   max_leaves=64, interpret=True,
                                   retrace=False)
    same_hits(h, jh)

    light = np.array([4.0, 4.0, -6.0], np.float32)
    pts = (o + np.array([0, 0, 4.5])).astype(np.float32)
    occ, ovf2 = p2.is_occluded_packets2(bvh8, aux, torch.from_numpy(light),
                                        torch.from_numpy(pts),
                                        max_leaves=64, retrace=False)
    assert not _np(ovf2).any()
    occ = _np(occ)
    assert occ.any() and (~occ).any()
    jocc, _ = jp2.is_occluded_packets2(jb8, jaux, light, pts, max_leaves=64,
                                       interpret=True, retrace=False)
    np.testing.assert_array_equal(occ, _np(jocc))


def test_packet2_omap_absent_is_noop():
    """An all-opaque micromap gives the prims of no micromap, as JAX's."""
    tris = random_tris(500, seed=3)
    jb8 = collapse_bvh2(build_binned(tris, max_leaf=4), tris)
    bvh8 = from_numpy_bvh8(jb8, device="cpu")
    om = pom.bake_omap(500, lambda p, u, v: np.ones_like(p, bool), S=4,
                       device="cpu")
    aux_o = p2.build_packet_aux(bvh8, omap=pom.leaf_align(om, bvh8))
    aux_p = p2.build_packet_aux(bvh8)
    rng = np.random.default_rng(7)
    o = rng.uniform(-1, 11, (256, 3)).astype(np.float32)
    c = np.float32([5, 5, 5]) - o
    d = (c / np.linalg.norm(c, axis=1, keepdims=True)).astype(np.float32)
    rays = make_rays(o, d, device="cpu")
    h1, _ = p2.intersect_packets2(bvh8, aux_o, rays, max_leaves=256,
                                  retrace=False)
    h2, _ = p2.intersect_packets2(bvh8, aux_p, rays, max_leaves=256,
                                  retrace=False)
    np.testing.assert_array_equal(_np(h1.prim), _np(h2.prim))
    jom_o = jom.leaf_align(jom.bake_omap(
        500, lambda p, u, v: np.ones_like(p, bool), S=4), jb8)
    jh, _ = jp2.intersect_packets2(jb8, jp2.build_packet_aux(jb8, omap=jom_o),
                                   tb.make_rays(o, d), max_leaves=256,
                                   interpret=True, retrace=False)
    same_hits(h1, jh)


def test_omap_half_transparent_triangle():
    tris = np.array([[[0, 0, 0], [4, 0, 0], [0, 4, 0]]], np.float32)
    jb8 = collapse_bvh2(build_binned(tris, max_leaf=4), tris)
    bvh8 = from_numpy_bvh8(jb8, device="cpu")
    om = pom.bake_omap(1, lambda p, u, v: u < 0.5, S=16, device="cpu")
    pl = pom.leaf_align(om, bvh8)
    o = np.array([[0.8, 0.4, -1.0], [3.2, 0.4, -1.0]], np.float32)
    d = np.array([[0, 0, 1.0], [0, 0, 1.0]], np.float32)
    rays = make_rays(o, d, device="cpu")
    assert (_np(intersect_bvh8(bvh8, rays).prim) >= 0).all()
    h = intersect_bvh8(bvh8, rays, omap=pl)
    assert int(h.prim[0]) == 0           # the opaque side still hits
    assert int(h.prim[1]) == -1          # the transparent side passes
    jl = jom.leaf_align(jom.bake_omap(1, lambda p, u, v: u < 0.5, S=16), jb8)
    same_hits(h, jwd.intersect_bvh8(jb8, tb.make_rays(o, d), omap=jl))


def test_omap_reveals_triangle_behind():
    tris = np.array(
        [[[0, 0, 0], [4, 0, 0], [0, 4, 0]],
         [[0, 0, 2], [4, 0, 2], [0, 4, 2]]], np.float32)
    jb8 = collapse_bvh2(build_binned(tris, max_leaf=4), tris)
    bvh8 = from_numpy_bvh8(jb8, device="cpu")
    alpha = (lambda p, u, v: p == 1)     # triangle 0 fully transparent
    pl = pom.leaf_align(pom.bake_omap(2, alpha, S=8, device="cpu"), bvh8)
    o, d = [[0.5, 0.5, -1.0]], [[0, 0, 1.0]]
    h = intersect_bvh8(bvh8, make_rays(o, d, device="cpu"), omap=pl)
    assert int(h.prim[0]) == 1
    np.testing.assert_allclose(float(h.t[0]), 3.0, rtol=1e-5)
    jl = jom.leaf_align(jom.bake_omap(2, alpha, S=8), jb8)
    same_hits(h, jwd.intersect_bvh8(jb8, tb.make_rays(o, d), omap=jl))


# ---- packet2 end to end ------------------------------------------------------

@pytest.mark.parametrize("case", ["wavefront_retrace", "packet_retrace",
                                  "shadow_wavefront", "sorted"])
def test_packet2_omap_matches_jax(scene, case):
    """intersect_packets2 / is_occluded_packets2 / the sorted entry points
    with micromaps (S = 8) against JAX's: a 32-leaf first budget that
    overflows tiles, retraced by the wavefront with the micromaps or by
    the escalated packet pass; shadow segments retraced by the any-hit
    wavefront; shuffled rays through intersect_packets2_sorted and shadow
    rays through is_occluded_packets2_sorted."""
    tris, jb, bvh8, maps = scene
    jl, pl = maps[8]
    aux = p2.build_packet_aux(bvh8, omap=pl)
    jaux = jp2.build_packet_aux_host(jb._bvh8_host, omap=_np(jl))
    o, d = _camera(T=2)
    if case in ("wavefront_retrace", "packet_retrace"):
        _, ov0 = p2.intersect_packets2(bvh8, aux, make_rays(o, d, device="cpu"),
                                       max_leaves=32, retrace=False)
        assert _np(ov0).any()           # the retrace has tiles to redo
        kw = dict(max_leaves=32, retrace=True, wf_cap_factor=16)
        if case == "packet_retrace":
            kw = dict(max_leaves=32, retrace="packet", retrace_ml=2048,
                      retrace_blocks=256)
        h, ov = p2.intersect_packets2(bvh8, aux, make_rays(o, d,
                                                           device="cpu"), **kw)
        jh, jov = jp2.intersect_packets2(jb.bvh8, jaux, tb.make_rays(o, d),
                                         interpret=True, **kw)
        assert not _np(ov).any()
        same_hits(h, jh, ties=True)
        np.testing.assert_array_equal(_np(ov), _np(jov))
        return
    light = np.array([5.0, 14.0, 5.0], np.float32)
    ref, _ = intersect_wavefront(bvh8, make_rays(o, d, device="cpu"),
                                 omap=pl)
    pts = np.clip(_np(ref.t)[:, None] * d + o, -50, 50).astype(np.float32)
    if case == "shadow_wavefront":
        _, ov0 = p2.is_occluded_packets2(
            bvh8, aux, torch.from_numpy(light), torch.from_numpy(pts),
            max_leaves=32, retrace=False)
        assert _np(ov0).any()
        occ, ov = p2.is_occluded_packets2(
            bvh8, aux, torch.from_numpy(light), torch.from_numpy(pts),
            max_leaves=32, retrace=True, wf_cap_factor=16)
        jocc, _ = jp2.is_occluded_packets2(
            jb.bvh8, jaux, light, pts, max_leaves=32, interpret=True,
            retrace=True, wf_cap_factor=16)
        assert not _np(ov).any()
        np.testing.assert_array_equal(_np(occ), _np(jocc))
        assert 0 < _np(occ).mean() < 1
        return
    perm = np.random.default_rng(2).permutation(o.shape[0])
    kw = dict(max_leaves=256, retrace="packet", retrace_ml=2048,
              retrace_blocks=256)
    h, _ = p2.intersect_packets2_sorted(
        bvh8, aux, make_rays(o[perm], d[perm], device="cpu"), [0, 0, 0],
        [10, 10, 10], **kw)
    jh, _ = jp2.intersect_packets2_sorted(
        jb.bvh8, jaux, tb.make_rays(o[perm], d[perm]), [0.0, 0.0, 0.0],
        [10.0, 10.0, 10.0], interpret=True, **kw)
    same_hits(h, jh, ties=True)
    occ, _ = p2.is_occluded_packets2_sorted(
        bvh8, aux, torch.from_numpy(light), torch.from_numpy(pts), **kw)
    jocc, _ = jp2.is_occluded_packets2_sorted(
        jb.bvh8, jaux, light, pts, interpret=True, **kw)
    np.testing.assert_array_equal(_np(occ), _np(jocc))


def cell_centre_rays(tris, omap, eye, n, seed):
    """n rays from `eye` aimed at the centres of micromap cells of random
    triangles (cells inside the triangle, iu + iv < S - 1): the engines'
    two barycentric forms then agree on every cell. omap (N, S, S)."""
    rng = np.random.default_rng(seed)
    S = omap.shape[-1]
    prim = rng.integers(0, tris.shape[0], n)
    iu = rng.integers(0, S - 1, n)
    iv = (rng.integers(0, S, n) % np.maximum(S - 1 - iu, 1))
    u = (iu + 0.5) / S
    v = (iv + 0.5) / S
    t = tris[prim].astype(np.float64)
    p = (1 - u - v)[:, None] * t[:, 0] + u[:, None] * t[:, 1] \
        + v[:, None] * t[:, 2]
    d = p - eye
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (np.broadcast_to(eye, d.shape).astype(np.float32).copy(),
            d.astype(np.float32))


def test_engines_agree_on_cell_centres(scene):
    """Kernel B's twin (no retrace), the wavefront and the lockstep engine
    with micromaps (S = 8) agree on every ray aimed at a cell centre, and
    the micromaps change some of those rays' hits."""
    tris, _, bvh8, maps = scene
    pl = maps[8][1]
    aux = p2.build_packet_aux(bvh8, omap=pl)
    om = pom.bake_omap(3000, leaf_alpha, S=8, device="cpu")
    o, d = cell_centre_rays(tris, om, np.array([5.0, 5.0, -9.0]), 512, 4)
    rays = make_rays(o, d, device="cpu")
    h, ov = p2.intersect_packets2(bvh8, aux, rays, max_leaves=1024,
                                  max_blocks=256, retrace=False)
    wf, _ = intersect_wavefront(bvh8, rays, omap=pl, cap_factor=16)
    ws = intersect_bvh8(bvh8, rays, omap=pl)
    assert not _np(ov).any()
    np.testing.assert_array_equal(_np(h.prim), _np(wf.prim))
    same_hits(wf, ws)
    plain = intersect_bvh8(bvh8, rays)
    assert (_np(plain.prim) != _np(ws.prim)).any()


# ---- TLAS ------------------------------------------------------------------

def _mat(translate=(0, 0, 0), scale=1.0, yaw=0.0):
    m = np.eye(4, dtype=np.float32)
    c, s = np.cos(yaw), np.sin(yaw)
    m[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]]) * scale
    m[:3, 3] = translate
    return m


_MATS = np.stack([_mat((0, 0, 0)),
                  _mat((2.5, 0, 0), scale=0.8, yaw=0.4),
                  _mat((0, 2.5, 0), scale=1.2, yaw=1.1),
                  _mat((2.5, 2.5, 0), scale=0.6, yaw=2.0)])


def _grid_arrays(n=32):
    """An n x n camera over the 2x2 grid, in 16x16 tile order."""
    eye = np.array([1.2, 1.2, -6.0], np.float32)
    xs = np.linspace(-0.36, 0.36, n)
    gx, gy = np.meshgrid(xs, xs)
    d = np.stack([gx, gy, np.ones_like(gx)], -1)
    d = d.reshape(n // 16, 16, n // 16, 16, 3).transpose(0, 2, 1, 3, 4)
    d = d.reshape(-1, 3)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return np.broadcast_to(eye, d.shape).copy(), d


@pytest.fixture(scope="module")
def inst_omap():
    """The 2x2 sphere grid of tests/test_tlas_packet.py with an S = 8
    leaf micromap on its one BLAS, in both packages."""
    tris = sphere_tris(8, 12, radius=0.8)
    jb = tb.BVH(tris)
    n = tris.shape[0]
    jl = jom.leaf_align(jom.bake_omap(n, leaf_alpha, S=8), jb.bvh8)
    jtp = jpk.build_tlas_packet([jb.bvh8], _MATS, omaps=[_np(jl)],
                                host8s=[jb._bvh8_host])
    return tris, jb, jtp, from_numpy_tlas_packet(jtp, device="cpu")


def test_build_tlas_packet_omaps_matches_jax(inst_omap):
    """The port's build_tlas_packet(omaps=) from its own BVH and bakers:
    packet tables (micromap words included) bit for bit as JAX's, and the
    carried table's micromaps as JAX's."""
    tris, _, jtp, ctp = inst_omap
    pb = BVH(tris, device="cpu")
    pl = pom.leaf_align(pom.bake_omap(tris.shape[0], leaf_alpha, S=8,
                                      device="cpu"), pb.bvh8)
    ptp = ppk.build_tlas_packet([pb.bvh8], _MATS, omaps=[pl])
    a, ja = ptp.auxes[0], jtp.auxes[0]
    assert a.omap_s == ja.omap_s == 8 and a.pack == ja.pack
    for k in ("gtab_pad", "leaf_lo", "blk_lo", "center"):
        assert _np(getattr(a, k)).tobytes() == _np(getattr(ja, k)).tobytes()
    np.testing.assert_array_equal(_np(a.omap), _np(ja.omap))
    np.testing.assert_array_equal(_np(ctp.auxes[0].omap), _np(ja.omap))


@pytest.mark.parametrize("case", ["per_instance", "bucketed_escalation"])
def test_tlas_packet_omaps_match_jax(inst_omap, case):
    """The per-instance engine (no retrace) and the bucketed engine with
    its escalation passes (retrace="packet", rounds covering every
    candidate: nothing left to the wavefront) with micromaps, against
    JAX's."""
    _, _, jtp, ptp = inst_omap
    o, d = _grid_arrays()
    rays = make_rays(o, d, device="cpu")
    if case == "per_instance":
        h, ovf = ppk.intersect_tlas_packets2(ptp, rays, retrace=False)
        jh, jovf = jpk.intersect_tlas_packets2(jtp, tb.make_rays(o, d),
                                               interpret=True, retrace=False)
    else:
        kw = dict(rounds=4, max_leaves=32, retrace="packet", retrace_ml=512,
                  retrace_blocks=8)
        h, ovf = ppk.intersect_tlas_packets2_bucketed(ptp, rays, **kw)
        jh, jovf = jpk.intersect_tlas_packets2_bucketed(
            jtp, tb.make_rays(o, d), interpret=True, **kw)
    assert not _np(ovf).any()
    np.testing.assert_array_equal(_np(ovf), _np(jovf))
    np.testing.assert_array_equal(_np(h.inst), _np(jh.inst))
    same_hits(h, jh, ties=True)
    assert (_np(h.prim) >= 0).mean() > 0.1


# ---- the two deliberate raises ---------------------------------------------

def test_fused_false_with_omaps_raises(scene):
    """JAX's fused=False resolves with kernel C, which has no micromap
    test (it returns hits through transparent cells): the port raises."""
    _, _, bvh8, maps = scene
    aux = p2.build_packet_aux(bvh8, omap=maps[8][1])
    with pytest.raises(NotImplementedError, match="micromap"):
        p2.intersect_packets2(bvh8, aux, make_rays(*_camera(T=1),
                                                   device="cpu"),
                              fused=False)


@pytest.mark.parametrize("engine", ["bucketed", "per_instance", "occluded"])
def test_tlas_retrace_with_omaps_raises(inst_omap, engine):
    """The two-level wavefront retrace takes no micromaps (JAX's returns
    hits through transparent cells): with micromaps each engine raises
    where a tile would go to it (one round for several candidates; a
    16-leaf budget)."""
    _, _, _, ptp = inst_omap
    o, d = _grid_arrays()
    rays = make_rays(o, d, device="cpu")
    with pytest.raises(NotImplementedError, match="micromaps"):
        if engine == "bucketed":
            ppk.intersect_tlas_packets2_bucketed(ptp, rays, rounds=1,
                                                 retrace=True)
        elif engine == "per_instance":
            ppk.intersect_tlas_packets2(ptp, rays, max_leaves=16,
                                        retrace=True)
        else:
            ppk.is_occluded_tlas_packets2(
                ptp, np.float32([1.2, 1.2, -6.0]),
                (o + 7.0 * d).astype(np.float32), max_leaves=16)
    # without the raise's trigger the same engines run
    _, ovf = ppk.intersect_tlas_packets2_bucketed(ptp, rays, rounds=4,
                                                  retrace=True)
    assert not _np(ovf).any()
