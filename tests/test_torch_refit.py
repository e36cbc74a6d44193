"""The port's refit path against the JAX package, on the CPU.

Covers builders/binned.py (the numpy builder the TLAS build runs),
builders/refit.py (the BVH2 and the direct 8-wide refit),
layouts/bvh2.py, layouts/mbvh.py::collapse_bvh2, traverse/stack.py::
pack_tris, traverse/packet2.py::build_packet_aux (the device build of
the packet tables) and api.BVH.refit. The first five tests mirror the
refit tests of tests/test_builder.py (:64-89, :163-250) on the port; the
rest hold the port to the JAX functions on the same numpy inputs:
builder arrays, refit boxes, leaf_tris and collapsed tables bit for bit;
the device-built packet tables bit for bit against both host builds and,
like tests/test_host_paths.py, within 1e-6 against JAX's jitted build;
traced hits with prim equal and t within rtol = atol = 1e-4.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import tinybvh_tpu as tb  # noqa: E402
from tinybvh_tpu.builders import binned as jbinned  # noqa: E402
from tinybvh_tpu.builders import refit as jrefit  # noqa: E402
from tinybvh_tpu.layouts import bvh2 as jbvh2  # noqa: E402
from tinybvh_tpu.layouts.mbvh import collapse_bvh2 as jcollapse  # noqa: E402
from tinybvh_tpu.traverse import packet2 as jp2  # noqa: E402
from tinybvh_tpu.traverse.stack import pack_tris as jpack  # noqa: E402
from tinybvh_tpu_torch import BVH as TBVH  # noqa: E402
from tinybvh_tpu_torch.builders.binned import (  # noqa: E402
    build_binned, build_binned_aabbs,
)
from tinybvh_tpu_torch.builders.refit import (  # noqa: E402
    bvh8_refit_plan, refit, refit_bvh8, refit_plan,
)
from tinybvh_tpu_torch.convert import from_numpy_bvh2  # noqa: E402
from tinybvh_tpu_torch.core.intersect import brute_force_closest  # noqa: E402
from tinybvh_tpu_torch.core.rays import make_rays  # noqa: E402
from tinybvh_tpu_torch.io.loaders import random_tris, sphere_tris  # noqa: E402
from tinybvh_tpu_torch.layouts.bvh2 import (  # noqa: E402
    node_counts, node_depths_host, sah_cost, validate_host,
)
from tinybvh_tpu_torch.layouts.mbvh import collapse_bvh2  # noqa: E402
from tinybvh_tpu_torch.traverse import packet2 as p2  # noqa: E402
from tinybvh_tpu_torch.traverse.stack import pack_tris  # noqa: E402
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


def _same_bits(a, b, what=""):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert a.tobytes() == b.tobytes(), what


def _moved(tris, rng):
    """tests/test_builder.py:175-178: anisotropic scale, translation and
    a per-vertex jitter."""
    return (np.asarray(tris) * np.array([1.3, 0.7, 1.0], np.float32)
            + np.array([2.0, -1.0, 0.5], np.float32)
            + rng.normal(scale=0.02, size=tris.shape).astype(np.float32))


def _random_rays(rng, n, lo, hi):
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _assert_exact(hits, rays, tris):
    ref = brute_force_closest(rays, torch.as_tensor(tris))
    miss = _np(ref.prim) < 0
    np.testing.assert_array_equal(_np(hits.prim) < 0, miss)
    np.testing.assert_allclose(_np(hits.t)[~miss], _np(ref.t)[~miss],
                               rtol=1e-4, atol=1e-4)


# ---- mirrors of tests/test_builder.py ------------------------------------

def test_refit_restores_bounds():
    tris = random_tris(800, seed=7)
    bvh = build_binned(tris, max_leaf=8, device="cpu")
    moved = torch.as_tensor(tris) + torch.tensor([5.0, -3.0, 1.0])
    rbvh = refit(bvh, pack_tris(bvh, moved))
    validate_host(rbvh, moved)
    np.testing.assert_allclose(_np(rbvh.node_min[0]),
                               _np(moved.amin(dim=(0, 1))),
                               rtol=1e-5, atol=1e-5)


def test_refit_identity_keeps_bounds():
    tris = sphere_tris(12, 24)
    bvh = build_binned(tris, max_leaf=8, device="cpu")
    rbvh = refit(bvh, pack_tris(bvh, tris))
    # refit with unchanged geometry can only tighten bounds
    assert np.all(_np(rbvh.node_min) >= _np(bvh.node_min) - 1e-5)
    assert np.all(_np(rbvh.node_max) <= _np(bvh.node_max) + 1e-5)
    validate_host(rbvh, tris)


def test_refit_bvh8_matches_brute_force():
    rng = np.random.default_rng(17)
    tris = random_tris(900, seed=17)
    bvh2 = build_binned(tris, max_leaf=4, device="cpu")
    bvh8 = collapse_bvh2(bvh2, tris)
    moved = _moved(tris, rng)
    r8 = refit_bvh8(bvh8, moved, bvh8_refit_plan(bvh8.child))
    # topology untouched
    assert torch.equal(r8.child, bvh8.child)
    assert torch.equal(r8.leaf_prim, bvh8.leaf_prim)
    rays = make_rays(*_random_rays(rng, 256, -3, 14), device="cpu")
    _assert_exact(intersect_bvh8(r8, rays), rays, moved)


def test_refit_bvh8_identity_tightens():
    tris = sphere_tris(10, 20)
    bvh8 = collapse_bvh2(build_binned(tris, max_leaf=4, device="cpu"), tris)
    r8 = refit_bvh8(bvh8, tris)
    b0 = _np(bvh8.bounds).reshape(-1, 6, 8)
    b1 = _np(r8.bounds).reshape(-1, 6, 8)
    assert np.all(b1[:, :3] >= b0[:, :3] - 1e-5)   # mins tighten up
    assert np.all(b1[:, 3:] <= b0[:, 3:] + 1e-5)   # maxs tighten down
    assert torch.equal(r8.leaf_tris, bvh8.leaf_tris)


def test_refit_bvh8_packet_pipeline():
    """Per-frame rigid path: refit + the device build of the packet
    tables keeps the packet engine exact."""
    tris = sphere_tris(12, 24)
    bvh8 = collapse_bvh2(build_binned(tris, max_leaf=4, device="cpu"), tris)
    moved = np.asarray(tris) * 1.4 + np.array([0.3, 0.1, -0.2], np.float32)
    r8 = refit_bvh8(bvh8, moved)
    aux = p2.build_packet_aux(r8)
    xs = (np.arange(16) + 0.5) / 16 * 2 - 1
    gx, gy = np.meshgrid(xs, xs)
    o = np.stack([gx * 2, gy * 2, np.full_like(gx, -6.0)], -1).reshape(-1, 3)
    o = (o * 1.4 + np.array([0.3, 0.1, -0.2])).astype(np.float32)
    rays = make_rays(o, np.tile(np.float32([[0, 0, 1]]), (256, 1)),
                     device="cpu")
    hits, ovf = p2.intersect_packets2(r8, aux, rays, max_leaves=256)
    assert not bool(ovf.any())
    _assert_exact(hits, rays, moved.astype(np.float32))


# ---- parity with the JAX package -----------------------------------------

@pytest.mark.parametrize("n,strategy,max_leaf", [
    (1, "sah", None), (7, "sah", None), (100, "sah", 4), (2000, "sah", None),
    (500, "median", None), (33, "sah", 4)])
def test_build_binned_matches_jax(n, strategy, max_leaf):
    """The numpy builder's arrays equal the JAX package's bit for bit (the
    33-copy case forces the median fallback of identical centroids)."""
    tris = (np.repeat(random_tris(1, seed=9), n, axis=0) if n == 33
            else random_tris(n, seed=n))
    jb, jh = jbinned.build_binned(tris, strategy=strategy, max_leaf=max_leaf,
                                  return_host=True)
    pb, ph = build_binned(tris, strategy=strategy, max_leaf=max_leaf,
                          return_host=True, device="cpu")
    for k in ("node_min", "node_max", "left_first", "count", "prim_idx"):
        _same_bits(ph[k], jh[k], k)
        _same_bits(getattr(pb, k), getattr(jb, k), k)
    assert ph["n_nodes"] == jh["n_nodes"] == pb.n_nodes
    validate_host(pb, tris)


def test_build_binned_aabbs_matches_jax():
    """The TLAS entry point over raw boxes, max_leaf=1 as the TLAS uses."""
    rng = np.random.default_rng(4)
    lo = rng.uniform(-20, 20, (300, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.1, 3, (300, 3)).astype(np.float32)
    _, jh = jbinned.build_binned_aabbs(lo, hi, max_leaf=1, return_host=True)
    _, ph = build_binned_aabbs(lo, hi, max_leaf=1, return_host=True,
                               device="cpu")
    for k in ("node_min", "node_max", "left_first", "count", "prim_idx"):
        _same_bits(ph[k], jh[k], k)


def test_bvh2_metrics_match_jax():
    tris = random_tris(4096, seed=1)
    jb = jbinned.build_binned(tris)
    pb = from_numpy_bvh2(jb, device="cpu")
    assert float(sah_cost(pb)) == pytest.approx(float(jbvh2.sah_cost(jb)),
                                                rel=1e-6)
    assert [int(x) for x in node_counts(pb)] == [
        int(x) for x in jbvh2.node_counts(jb)]
    assert validate_host(pb, tris)
    np.testing.assert_array_equal(node_depths_host(pb),
                                  jbvh2.node_depths_host(jb))


@pytest.fixture(scope="module")
def deformed():
    """One BVH2 (JAX numpy builder, max_leaf=4), its moved triangles and
    the packed forms in both packages."""
    rng = np.random.default_rng(23)
    tris = random_tris(1500, seed=23)
    jb = jbinned.build_binned(tris, max_leaf=4)
    moved = _moved(tris, rng)
    return tris, moved, jb, from_numpy_bvh2(jb, device="cpu")


def test_refit_matches_jax(deformed):
    """BVH2 refit: plan, pack_tris and the refit boxes bit for bit."""
    _, moved, jb, pb = deformed
    jplan = jrefit.refit_plan(jb)
    pplan = refit_plan(pb)
    assert len(jplan) == len(pplan)
    for a, b in zip(jplan, pplan):
        np.testing.assert_array_equal(_np(a), _np(b))
    jpk, ppk = jpack(jb, moved), pack_tris(pb, moved)
    _same_bits(ppk, jpk, "pack_tris")
    jr = jrefit.refit(jb, jpk, jplan, leaf_max=4)
    pr = refit(pb, ppk, pplan, leaf_max=4)
    _same_bits(pr.node_min, jr.node_min, "node_min")
    _same_bits(pr.node_max, jr.node_max, "node_max")
    validate_host(pr, moved)


def test_collapse_and_refit_bvh8_match_jax(deformed):
    """collapse_bvh2 (host and device-gather forms), the BVH8 refit plan,
    and refit_bvh8's bounds and leaf_tris, bit for bit."""
    tris, moved, jb, pb = deformed
    j8 = jcollapse(jb, tris)
    p8 = collapse_bvh2(pb, tris)
    ph = collapse_bvh2(pb, tris, as_host=True)
    pd = collapse_bvh2(pb, None, tris_dev=torch.as_tensor(moved))
    jd = jcollapse(jb, None, tris_dev=jnp.asarray(moved))
    for k in ("bounds", "child", "leaf_tris", "leaf_prim"):
        _same_bits(getattr(p8, k), getattr(j8, k), k)
        _same_bits(ph[k], getattr(j8, k), k)
        _same_bits(getattr(pd, k), getattr(jd, k), k)
    jplan = jrefit.bvh8_refit_plan(np.asarray(j8.child))
    pplan = bvh8_refit_plan(p8.child)
    for a, b in zip(jplan, pplan, strict=True):
        np.testing.assert_array_equal(_np(a), _np(b))
    jr = jrefit.refit_bvh8(j8, moved, jplan)
    pr = refit_bvh8(p8, moved, pplan)
    _same_bits(pr.bounds, jr.bounds, "bounds")
    _same_bits(pr.leaf_tris, jr.leaf_tris, "leaf_tris")
    assert torch.equal(pr.child, p8.child)


def test_refit_bvh8_stale_plan_raises(deformed):
    """A plan of a larger collapse would write rows the BVH8 does not
    have: refused, as in JAX."""
    tris, moved, _, pb = deformed
    big = collapse_bvh2(pb, tris)
    small = collapse_bvh2(build_binned(tris[:200], max_leaf=4,
                                       device="cpu"), tris[:200])
    with pytest.raises(ValueError, match="stale plan"):
        refit_bvh8(small, tris[:200], bvh8_refit_plan(big.child))


def test_build_packet_aux_matches_host_and_jax(deformed):
    """The device build on the CPU equals the JAX package's host build
    bit for bit, on the native collapse's tables and on a refit BVH8;
    against JAX's jitted build the value lanes agree within 1e-6 and the
    prim-id lanes bit for bit."""
    tris, moved, jb, pb = deformed
    native = TBVH(tris, device="cpu")
    r8 = refit_bvh8(collapse_bvh2(pb, tris), moved)
    cases = [(native.bvh8, native._bvh8_host, tb.BVH(tris).bvh8),
             (r8, {k: _np(getattr(r8, k)) for k in (
                 "bounds", "child", "leaf_tris", "leaf_prim")},
              jrefit.refit_bvh8(jcollapse(jb, tris), moved))]
    for b8, h8, j8 in cases:
        for pack in (1, 2):
            dev = p2.build_packet_aux(b8, pack=pack)
            other = jp2.build_packet_aux_host(h8, pack=pack)
            for k in ("leaf_lo", "leaf_hi", "blk_lo", "blk_hi", "gtab_pad",
                      "center"):
                _same_bits(getattr(dev, k), getattr(other, k), k)
            assert (dev.n_leaf_rows, dev.pack) == (other.n_leaf_rows,
                                                   other.pack)
        jd = jp2.build_packet_aux(j8)
        dev = p2.build_packet_aux(b8)
        x, y = _np(dev.gtab_pad), _np(jd.gtab_pad)
        np.testing.assert_allclose(x[:, :96], y[:, :96], rtol=1e-6,
                                   atol=1e-6)
        assert (x[:, 96:].view(np.int32) == y[:, 96:].view(np.int32)).all()
        for k in ("leaf_lo", "leaf_hi", "blk_lo", "blk_hi", "center"):
            np.testing.assert_allclose(_np(getattr(dev, k)),
                                       _np(getattr(jd, k)), rtol=1e-6,
                                       atol=1e-6)


def test_build_packet_aux_omap_raises():
    """A micromap table that is not aligned with the BVH's leaf rows
    ((L, 4, S, S), ops.omap.leaf_align) raises."""
    tris = random_tris(64, seed=2)
    b = TBVH(tris, device="cpu")
    assert b.bvh8.leaf_prim.shape[0] > 1
    with pytest.raises(ValueError):
        p2.build_packet_aux(b.bvh8, omap=np.ones((1, 4, 2, 2), bool))


def test_api_refit_matches_jax():
    """BVH.refit through the API: the re-collapsed bvh8 equals the JAX
    BVH's bit for bit, the host copies and tables are dropped, and the
    wavefront engine and the packet path (its tables now built from the
    BVH8's tensors) trace the moved geometry exactly, with prim equal to
    the JAX BVH's hits."""
    rng = np.random.default_rng(5)
    tris = random_tris(2000, seed=5)
    moved = _moved(tris, rng)
    jb = tb.BVH(tris)
    pb = TBVH(tris, device="cpu")
    pb.packet_aux          # tables of the original geometry, to be dropped
    jb.refit(moved)
    assert pb.refit(moved) is pb
    for k in ("bounds", "child", "leaf_tris", "leaf_prim"):
        _same_bits(getattr(pb.bvh8, k), getattr(jb.bvh8, k), k)
    _same_bits(pb.bvh2.node_min, jb.bvh2.node_min, "node_min")
    assert pb._bvh8_host is None and pb._packet_aux is None
    np.testing.assert_array_equal(pb.aabb[0], moved.reshape(-1, 3).min(0))
    pb.validate()
    assert pb.sah_cost() == pytest.approx(jb.sah_cost(), rel=1e-6)
    assert pb.node_count() == jb.node_count()
    aux = pb.packet_aux
    _same_bits(aux.gtab_pad, p2.build_packet_aux(pb.bvh8).gtab_pad)

    o, d = _random_rays(rng, 512, -3, 14)
    rays = make_rays(o, d, device="cpu")
    h = pb.intersect(rays)
    _assert_exact(h, rays, moved)
    jh = jb.intersect(tb.make_rays(o, d))
    np.testing.assert_array_equal(_np(h.prim), _np(jh.prim))
    # the packet path on the refit tables, camera tiles from one eye
    lo, hi = pb.aabb
    eye = (lo + hi) * 0.5 - np.float32([0, 0, 20])
    gx, gy = np.meshgrid(np.linspace(lo[0], hi[0], 32),
                         np.linspace(lo[1], hi[1], 16))
    dd = np.stack([gx, gy, np.full_like(gx, lo[2])], -1).reshape(-1, 3) - eye
    dd = (dd / np.linalg.norm(dd, axis=1, keepdims=True)).astype(np.float32)
    prays = make_rays(np.broadcast_to(eye, dd.shape).copy(), dd,
                      device="cpu")
    hp, ovf = p2.intersect_packets2(pb.bvh8, aux, prays, max_leaves=256)
    assert not bool(ovf.any())
    _assert_exact(hp, prays, moved)


def test_bvh_without_c_compiler_takes_the_numpy_builder(monkeypatch):
    """With no C compiler, BVH builds with the numpy builder and the Python
    collapse (no leaf combining), as the JAX package does: its tables
    equal JAX's build_binned + collapse_bvh2 bit for bit, and it traces
    exactly."""
    from tinybvh_tpu_torch import native

    monkeypatch.setattr(native, "available", lambda: False)
    tris = random_tris(700, seed=13)
    pb = TBVH(tris, device="cpu")
    jb = jbinned.build_binned(tris, max_leaf=4)
    jh = jcollapse(jb, tris, as_host=True)
    for k in ("bounds", "child", "leaf_tris", "leaf_prim"):
        _same_bits(pb._bvh8_host[k], jh[k], k)
        _same_bits(getattr(pb.bvh8, k), jh[k], k)
    rng = np.random.default_rng(13)
    rays = make_rays(*_random_rays(rng, 256, -2, 12), device="cpu")
    _assert_exact(pb.intersect(rays), rays, tris)
