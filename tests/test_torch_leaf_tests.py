"""The port's leaf tests and substrate against the JAX package on the CPU
(mirrors tests/test_watertight.py, tests/test_core.py and
tests/test_config.py): the watertight and Baldwin–Weber triangle tests,
the slab test, Möller–Trumbore's backface cull, the Morton codes, the
AABB helpers, the blue-noise jitter and the config fields.

Function-level tolerances: the hit mask equal, t within rtol = atol =
1e-5, u and v within 1e-4, integers equal. The watertight guarantee
itself (no ray aimed at a shared edge misses both triangles) is checked
on the port alone, on the construction of tests/test_watertight.py:49-92,
through the function and through the wavefront and BVH2 engines."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import tinybvh_tpu as tb  # noqa: E402
from tinybvh_tpu.core import intersect as ji  # noqa: E402
from tinybvh_tpu.core import vecmath as jv  # noqa: E402
import tinybvh_tpu_torch as tt  # noqa: E402
from tinybvh_tpu_torch.config import get_config, use_config  # noqa: E402
from tinybvh_tpu_torch.core import intersect as pi  # noqa: E402
from tinybvh_tpu_torch.core import vecmath as pv  # noqa: E402
from tinybvh_tpu_torch.core.vecmath import BVH_FAR  # noqa: E402
from tinybvh_tpu_torch.io.loaders import random_tris  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """One test file per worker process: keep torch's pool small."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _aimed(n=512, seed=0):
    """tests/test_watertight.py _random_hits: one triangle a ray, each ray
    aimed at a point inside its triangle (and a few misses: every 8th ray
    turned around)."""
    rng = np.random.default_rng(seed)
    tris = random_tris(n, seed=seed)
    w = rng.dirichlet((1, 1, 1), n).astype(np.float32)
    target = np.einsum("nk,nkj->nj", w, tris)
    o = rng.uniform(-5, 15, (n, 3)).astype(np.float32)
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[::8] *= -1.0
    return tris, o, d.astype(np.float32)


def _assert_function(got, want, what, tol_t=1e-5, tol_uv=1e-4):
    """(hit, t, u, v) of the port against JAX's."""
    hit, t, u, v = (x.numpy() for x in got)
    jhit, jt, ju, jv_ = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(hit, jhit, err_msg=what)
    assert 0.25 < hit.mean() < 1.0, what
    np.testing.assert_allclose(t, jt, rtol=tol_t, atol=tol_t, err_msg=what)
    np.testing.assert_allclose(u[hit], ju[hit], rtol=tol_uv, atol=tol_uv,
                               err_msg=what)
    np.testing.assert_allclose(v[hit], jv_[hit], rtol=tol_uv, atol=tol_uv,
                               err_msg=what)


@pytest.mark.parametrize("test", ["watertight", "baldwin", "mt_backface"])
def test_triangle_tests_match_jax(test):
    tris, o, d = _aimed(seed={"watertight": 0, "baldwin": 7,
                              "mt_backface": 3}[test])
    rays = tt.make_rays(o, d, device="cpu")
    jrays = tb.make_rays(o, d)
    t_cur = np.full(o.shape[0], BVH_FAR, np.float32)
    t_cur[::5] = 3.0                               # some clipped hits
    pt, jt = torch.from_numpy(tris), jnp.asarray(tris)
    if test == "watertight":
        got = pi.moller_trumbore_watertight(
            rays.o, rays.d, rays.rd, pt[:, 0], pt[:, 1], pt[:, 2],
            torch.from_numpy(t_cur))
        want = ji.moller_trumbore_watertight(
            jrays.o, jrays.d, jrays.rd, jt[:, 0], jt[:, 1], jt[:, 2],
            jnp.asarray(t_cur))
    elif test == "baldwin":
        # the rows within 1e-5; the test then reads JAX's rows, the same
        # input for both: XLA contracts the normal's products into FMAs,
        # and a one-ulp row difference moves a grazing ray's t by 6e-5
        rows = pi.precompute_baldwin_weber(pt)
        jrows = ji.precompute_baldwin_weber(tris)
        np.testing.assert_allclose(rows.numpy(), np.asarray(jrows),
                                   rtol=1e-5, atol=1e-5)
        got = pi.intersect_baldwin_weber(
            rays.o, rays.d, torch.from_numpy(np.array(jrows)),
            torch.from_numpy(t_cur))
        want = ji.intersect_baldwin_weber(jrays.o, jrays.d, jrows,
                                          jnp.asarray(t_cur))
    else:
        v0, e1, e2 = pi.tri_edges(pt)
        got = pi.moller_trumbore(rays.o, rays.d, v0, e1, e2,
                                 torch.from_numpy(t_cur), backface_cull=True)
        jv0, je1, je2 = ji.tri_edges(jt)
        want = ji.moller_trumbore(jrays.o, jrays.d, jv0, je1, je2,
                                  jnp.asarray(t_cur), backface_cull=True)
        assert got[0].float().mean() < 0.75        # back faces culled
        # Möller–Trumbore is held to the repo's parity standard, as
        # everywhere (ROADMAP): XLA contracts its cross products into
        # FMAs, and grazing rays' t then move by up to 3e-5
        _assert_function(got, want, test, tol_t=1e-4, tol_uv=1e-3)
        return
    _assert_function(got, want, test)


def test_leaf_intersect_dispatch():
    """leaf_intersect picks each test; Baldwin–Weber needs its rows, an
    unknown name is a ValueError."""
    tris, o, d = _aimed(64, seed=2)
    rays = tt.make_rays(o, d, device="cpu")
    pt = torch.from_numpy(tris)
    far = torch.full((64,), BVH_FAR)
    args = (rays.o, rays.d, rays.rd, pt[:, 0], pt[:, 1], pt[:, 2], far)
    rows = pi.precompute_baldwin_weber(pt)
    v0, e1, e2 = pi.tri_edges(pt)
    for name, want in (
            ("mt", pi.moller_trumbore(rays.o, rays.d, v0, e1, e2, far)),
            ("watertight", pi.moller_trumbore_watertight(*args)),
            ("baldwin", pi.intersect_baldwin_weber(rays.o, rays.d, rows,
                                                   far))):
        got = pi.leaf_intersect(name, *args, bw_rows=rows)
        for g, w in zip(got, want):
            assert torch.equal(g, w), name
    with pytest.raises(ValueError):
        pi.leaf_intersect("baldwin", *args)
    with pytest.raises(ValueError):
        pi.leaf_intersect("woop", *args)


def test_slab_test_matches_jax():
    rng = np.random.default_rng(5)
    lo = rng.uniform(-2, 2, (1024, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.0, 2.0, (1024, 3)).astype(np.float32)
    o = rng.uniform(-4, 4, (1024, 3)).astype(np.float32)
    # aimed near the boxes; some rays parallel to an axis
    d = (lo + hi) * 0.5 - o + rng.normal(size=(1024, 3)).astype(np.float32)
    d[::7, 0] = 0.0
    t_cur = rng.uniform(0.5, 8.0, 1024).astype(np.float32)
    rays = tt.make_rays(o, d, device="cpu")
    jrays = tb.make_rays(o, d)
    got = pi.slab_test(rays.o, rays.rd, torch.from_numpy(t_cur),
                       torch.from_numpy(lo), torch.from_numpy(hi)).numpy()
    want = np.asarray(ji.slab_test(jrays.o, jrays.rd, jnp.asarray(t_cur),
                                   jnp.asarray(lo), jnp.asarray(hi)))
    hit = got < BVH_FAR
    np.testing.assert_array_equal(hit, want < BVH_FAR)
    assert 0.1 < hit.mean() < 0.9
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_morton_and_aabb_helpers_match_jax():
    rng = np.random.default_rng(6)
    q = rng.integers(0, 1024, (4096, 3)).astype(np.uint32)
    q[:4] = [[0, 0, 0], [1023, 1023, 1023], [1023, 0, 0], [0, 0, 1023]]
    got = pv.morton_encode_3d(torch.from_numpy(q.astype(np.int64)))
    want = np.asarray(jv.morton_encode_3d(jnp.asarray(q)))
    assert got.dtype == torch.uint32 and want.dtype == np.uint32
    np.testing.assert_array_equal(got.numpy(), want)
    # x's bits go to every third bit from bit 2 up, z's from bit 0 up
    assert int(got[1]) == (1 << 30) - 1
    assert (int(got[2]), int(got[3])) == (0x24924924, 0x09249249)
    a, b = (rng.normal(size=(2, 5, 3)).astype(np.float32) for _ in range(2))
    lo, hi = pv.aabb_union(*(torch.from_numpy(x) for x in (*a, *b)))
    jlo, jhi = jv.aabb_union(*(jnp.asarray(x) for x in (*a, *b)))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    for got_e, want_e in zip(pv.aabb_empty((2, 4), device="cpu"),
                             jv.aabb_empty((2, 4))):
        np.testing.assert_array_equal(got_e.numpy(), np.asarray(want_e))


def test_blue_noise_jitter_matches_jax():
    """On a synthetic (8, 128, 128) tile: the reference's tile file is not
    in this repository."""
    from tinybvh_tpu.io.loaders import blue_noise_jitter as jax_jitter
    from tinybvh_tpu_torch.io.loaders import blue_noise_jitter

    bn = np.random.default_rng(8).random((8, 128, 128)).astype(np.float32)
    for w, h, sample in ((64, 48, 0), (300, 130, 5), (128, 128, 11)):
        got = blue_noise_jitter(bn, w, h, sample)
        assert got.shape == (h, w, 2) and got.dtype == np.float32
        np.testing.assert_array_equal(got, jax_jitter(bn, w, h, sample))


def test_config_fields_match_jax():
    """The same fields with JAX's defaults; use_config restores them."""
    from tinybvh_tpu.config import Config as JaxConfig

    fields = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    got = {f.name: f.default for f in dataclasses.fields(type(get_config()))}
    assert got == fields
    with use_config(bins=12, hq_bins=8, c_trav=1.0) as c:
        assert (c.bins, c.hq_bins, c.c_trav) == (12, 8, 1.0)
    assert get_config().bins == 8


@pytest.mark.parametrize("name, value", [
    ("hq_bins", 16), ("c_trav", 2.0), ("c_int", 2.0), ("sbvh_slack", 0.25),
    ("stack_depth", 64), ("wavefront_cap", 16), ("packet_k", 64)])
def test_unread_config_fields_refuse_other_values(name, value):
    """A field that no engine reads refuses a value other than its
    default, naming what the port reads instead, and the scope is left
    as it was."""
    with pytest.raises(NotImplementedError, match=f"Config.{name} "):
        with use_config(**{name: value}):
            pass
    assert getattr(get_config(), name) != value


def test_debug_nans_gate():
    """Config.debug_nans: a NaN in the rays raises FloatingPointError from
    BVH.intersect and BVH.is_occluded; the scope restores silence."""
    bvh = tt.BVH(random_tris(50, seed=1), device="cpu")
    o = np.zeros((4, 3), np.float32)
    d = np.tile([[0, 0, 1.0]], (4, 1)).astype(np.float32)
    bad = tt.make_rays(o * np.nan, d, device="cpu")
    good = tt.make_rays(o + 5.0, d, device="cpu")
    with use_config(debug_nans=True):
        assert get_config().debug_nans
        bvh.intersect(good)
        with pytest.raises(FloatingPointError):
            bvh.intersect(bad)
        with pytest.raises(FloatingPointError):
            bvh.is_occluded(bad, 1.0)
    assert not get_config().debug_nans
    bvh.intersect(bad)                            # silent again


def _quad_edge_case(rng, n=8):
    """tests/test_watertight.py:49-92: a planar quad split along a
    diagonal and n rays aimed exactly at the shared edge."""
    p2d = np.array(
        [[rng.uniform(-0.5, 1.5), rng.uniform(0.2, 1.5)],
         [0.0, 0.0],
         [rng.uniform(0.8, 2.0), 0.0],
         [rng.uniform(-0.5, 1.5), -rng.uniform(0.2, 1.5)]], np.float32)
    basis = rng.normal(size=(3, 3)).astype(np.float32)
    basis[0] /= np.linalg.norm(basis[0])
    basis[1] -= basis[1] @ basis[0] * basis[0]
    basis[1] /= np.linalg.norm(basis[1])
    p = p2d @ basis[:2] + rng.uniform(-1, 1, 3).astype(np.float32)
    tris = np.stack([np.stack([p[0], p[1], p[2]]),
                     np.stack([p[1], p[3], p[2]])]).astype(np.float32)
    lam = rng.uniform(0.05, 0.95, n).astype(np.float32)
    target = lam[:, None] * p[1] + (1 - lam[:, None]) * p[2]
    o = rng.uniform(2, 4, (n, 3)).astype(np.float32)
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return tris, o, d.astype(np.float32)


def test_watertight_shared_edge_never_leaks():
    """64 quads, 8 edge rays each, through the function: every ray hits
    at least one of the two triangles."""
    rng = np.random.default_rng(3)
    leaks = 0
    for _ in range(64):
        tris, o, d = _quad_edge_case(rng)
        rays = tt.make_rays(o, d, device="cpu")
        far = torch.full((8,), BVH_FAR)
        hits = [pi.moller_trumbore_watertight(
            rays.o, rays.d, rays.rd,
            *(torch.from_numpy(np.broadcast_to(tri[k], (8, 3)).copy())
              for k in range(3)), far)[0] for tri in tris]
        leaks += int((~(hits[0] | hits[1])).sum())
    assert leaks == 0, f"{leaks} of 512 edge rays leaked"


def test_watertight_config_reaches_engines():
    """use_config(tri_test="watertight") makes the BVH2 engine and the
    wavefront engine watertight: 16 quads, no edge ray leaks."""
    from tinybvh_tpu_torch.builders.binned import build_binned
    from tinybvh_tpu_torch.layouts.mbvh import collapse_bvh2
    from tinybvh_tpu_torch.traverse.stack import intersect_bvh2, pack_tris
    from tinybvh_tpu_torch.traverse.wavefront import intersect_wavefront

    leaks_stack = leaks_wf = 0
    with use_config(tri_test="watertight"):
        for trial in range(16):
            tris, o, d = _quad_edge_case(np.random.default_rng(trial))
            rays = tt.make_rays(o, d, device="cpu")
            bvh, host = build_binned(tris, max_leaf=2, return_host=True,
                                     device="cpu")
            h1 = intersect_bvh2(bvh, pack_tris(bvh, tris), rays, leaf_max=2)
            leaks_stack += int((h1.prim < 0).sum())
            bvh8 = collapse_bvh2(bvh, tris, host=host)
            h2, _ = intersect_wavefront(bvh8, rays)
            leaks_wf += int((h2.prim < 0).sum())
    assert leaks_stack == 0, f"the BVH2 engine leaked {leaks_stack} rays"
    assert leaks_wf == 0, f"the wavefront leaked {leaks_wf} rays"
