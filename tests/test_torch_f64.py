"""The port's double-precision BVH and TLAS (tinybvh_tpu_torch/ops/f64.py)
against the JAX package's, on the CPU (mirrors the five f64 tests of
tests/test_omap_f64.py and adds parity).

The build is a copy of JAX's numpy build: equal array for array. The
queries run the port's lockstep engine in torch float64; JAX loops over
rays in numpy. Their products and sums are the same, but numpy's dot of
two 3-vectors may round apart from three products summed in order, so:
prim and inst equal on every ray; t, u and v within rtol 1e-12 (for the
TLAS at a 1e6 offset, t within 1e-12 relative plus 1e-15 times the
largest coordinate, the transform's rounding); occlusion equal;
sah_cost within 1e-12."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tinybvh_tpu.core.intersect import brute_force_closest  # noqa: E402
from tinybvh_tpu.core.rays import make_rays  # noqa: E402
from tinybvh_tpu.ops import f64 as jf  # noqa: E402
from tests.test_torch_jax_native import jax_native  # noqa: E402,F401
from tinybvh_tpu_torch.io.loaders import random_tris  # noqa: E402
from tinybvh_tpu_torch.ops import f64 as pf  # noqa: E402

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _unit_quad64():
    return np.array([
        [[-0.5, 0, -0.5], [0.5, 0, -0.5], [0.5, 0, 0.5]],
        [[-0.5, 0, -0.5], [0.5, 0, 0.5], [-0.5, 0, 0.5]],
    ], np.float64)


def _coincident(n=10):
    """n triangles in one box, so with one centroid, in n planes through
    a corner: a leaf of n prims (best[1] < 0 in the build), past
    max_leaf."""
    k = np.linspace(0.1, 0.9, n)
    tris = np.zeros((n, 3, 3))
    tris[:, 1] = np.stack([np.ones(n), k, np.ones(n)], -1)
    tris[:, 2] = np.stack([1 - k, np.ones(n), np.full(n, 0.5)], -1)
    return tris + [2.0, 3.0, 4.0]


def _rays(seed, n, lo=-2, hi=12):
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (n, 3))
    d = rng.normal(size=(n, 3))
    return o, d / np.linalg.norm(d, axis=1, keepdims=True)


def _same_hits(got, ref, keys="tuv", rtol=1e-12, atol=0.0):
    np.testing.assert_array_equal(_np(got["prim"]), ref["prim"])
    if "inst" in ref:
        np.testing.assert_array_equal(_np(got["inst"]), ref["inst"])
    hit = ref["prim"] >= 0
    for k in keys:
        np.testing.assert_allclose(_np(got[k])[hit], ref[k][hit], rtol=rtol,
                                   atol=atol, err_msg=k)
    np.testing.assert_array_equal(_np(got["t"])[~hit], ref["t"][~hit])


@pytest.mark.parametrize("n", [1, 2, 3, 17, 300, "coincident"])
def test_sah_build_f64_matches_jax(n):
    tris = (_coincident() if n == "coincident"
            else random_tris(n, seed=5).astype(np.float64))
    fmin, fmax = tris.min(axis=1), tris.max(axis=1)
    want = jf._sah_build_f64(fmin, fmax)
    got = pf._sah_build_f64(fmin, fmax)
    assert got[5] == want[5]
    for a, b in zip(got[:5], want[:5]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    if n == "coincident":
        assert got[3].max() == 10   # one leaf over max_leaf = 4


@pytest.fixture(scope="module")
def soup():
    tris = random_tris(2000, seed=3).astype(np.float64)
    o, d = _rays(0, 256)
    return tris, jf.BVHDouble(tris), pf.BVHDouble(tris, device=CPU), o, d


def test_intersect_matches_jax(soup):
    tris, jb, pb, o, d = soup
    ref = jb.intersect(o, d)
    got = pb.intersect(o, d)
    assert got["t"].dtype == torch.float64 and got["prim"].dtype == torch.int64
    assert 0.05 < (ref["prim"] >= 0).mean() < 1.0
    _same_hits(got, ref)
    # a bounded query, tensor inputs
    ref = jb.intersect(o, d, t_max=4.0)
    _same_hits(pb.intersect(torch.from_numpy(o), torch.from_numpy(d),
                            t_max=4.0), ref)


def test_is_occluded_matches_jax(soup):
    tris, jb, pb, o, d = soup
    for t_max in (3.0, pf.FAR):
        ref = jb.is_occluded(o, d, t_max)
        got = pb.is_occluded(o, d, t_max)
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(_np(got), ref)
    assert 0 < ref.mean() < 1


def test_sah_cost_matches_jax(soup):
    _, jb, pb, _, _ = soup
    assert abs(pb.sah_cost() - jb.sah_cost()) <= 1e-12 * jb.sah_cost()


def test_leaf_over_max_leaf_traces_every_prim():
    """The coincident leaf (10 prims, max_leaf 4): every lane is tested,
    in JAX's order."""
    tris = _coincident()
    o, d = _rays(4, 256, lo=0, hi=6)
    c = np.array([2.5, 3.5, 4.5])
    d = (c + 0.3 * d) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ref = jf.BVHDouble(tris).intersect(o, d)
    got = pf.BVHDouble(tris, device=CPU).intersect(o, d)
    assert len(set(ref["prim"][ref["prim"] >= 0].tolist())) > 4
    _same_hits(got, ref)


def test_double_precision_matches_and_exceeds_f32():
    """≙ tests/test_omap_f64.py: at a 1e9 offset, against an f64 brute
    force and JAX's BVHDouble."""
    tris64_far = random_tris(300, seed=21).astype(np.float64) + 1e9
    offset = 1e9
    b = pf.BVHDouble(tris64_far, device=CPU)
    o = np.array([[offset + 5.0, offset + 5.0, offset - 50.0]])
    d = np.array([[0.0, 0.0, 1.0]])
    res = b.intersect(o, d)
    v0 = tris64_far[:, 0]
    e1 = tris64_far[:, 1] - v0
    e2 = tris64_far[:, 2] - v0
    h = np.cross(d, e2)
    det = (e1 * h).sum(1)
    ok = np.abs(det) > 1e-12
    inv = 1 / np.where(ok, det, 1)
    s = o - v0
    uu = (s * h).sum(1) * inv
    q = np.cross(s, e1)
    vv = (d * q).sum(1) * inv
    tt = (e2 * q).sum(1) * inv
    hit = ok & (uu >= 0) & (vv >= 0) & (uu + vv <= 1) & (tt > 0)
    if hit.any():
        ref_t = tt[hit].min()
        assert abs(float(res["t"][0]) - ref_t) / ref_t < 1e-12
    else:
        assert int(res["prim"][0]) == -1
    _same_hits(res, jf.BVHDouble(tris64_far).intersect(o, d))
    assert np.isfinite(b.sah_cost())


def test_double_precision_batch():
    """≙ tests/test_omap_f64.py: against JAX's f32 brute force (loose)."""
    tris = random_tris(200, seed=22).astype(np.float64)
    o, d = _rays(7, 32)
    res = pf.BVHDouble(tris, device=CPU).intersect(o, d)
    ref = brute_force_closest(make_rays(o.astype(np.float32),
                                        d.astype(np.float32)),
                              jnp.asarray(tris, jnp.float32))
    miss = np.asarray(ref.prim) < 0
    np.testing.assert_array_equal(_np(res["prim"]) < 0, miss)
    np.testing.assert_allclose(_np(res["t"])[~miss],
                               np.asarray(ref.t)[~miss], rtol=1e-4)


def test_tlas_double_instancing():
    """≙ tests/test_omap_f64.py: two translated instances at 1e9."""
    blas = pf.BVHDouble(_unit_quad64(), device=CPU)
    big = 1e9
    t0, t1 = np.eye(4), np.eye(4)
    t0[:3, 3] = [big, 0.0, 0.0]
    t1[:3, 3] = [big, 10.0, 0.0]
    tlas = pf.TLASDouble([pf.BLASInstanceEx(0, t0), pf.BLASInstanceEx(0, t1)],
                         [blas], device=CPU)
    o = np.array([[big, 5.0, 0.0], [big, 5.0, 0.0]])
    d = np.array([[0, -1.0, 0], [0, 1.0, 0]])
    h = tlas.intersect(o, d)
    np.testing.assert_allclose(_np(h["t"]), [5.0, 5.0], rtol=1e-12)
    assert _np(h["inst"]).tolist() == [0, 1]
    assert (_np(h["prim"]) >= 0).all()
    occ = tlas.is_occluded(o, np.array([[0, -1, 0], [1, 0, 0]], np.float64))
    assert _np(occ).tolist() == [True, False]


def test_tlas_double_mask_and_scale():
    """≙ tests/test_omap_f64.py: masks and a non-uniform scale."""
    blas = pf.BVHDouble(_unit_quad64(), device=CPU)
    i0 = pf.BLASInstanceEx(0, np.diag([3.0, 1.0, 3.0, 1.0]), mask=0x1)
    tlas = pf.TLASDouble([i0], [blas], device=CPU)
    o = np.array([[1.2, 4.0, 1.2]])
    d = np.array([[0, -1.0, 0]])
    np.testing.assert_allclose(_np(tlas.intersect(o, d, mask=0x1)["t"]),
                               [4.0], rtol=1e-12)
    assert _np(tlas.intersect(o, d, mask=0x2)["prim"]).tolist() == [-1]


def test_bvh_double_is_occluded():
    """≙ tests/test_omap_f64.py."""
    blas = pf.BVHDouble(_unit_quad64(), device=CPU)
    o = np.array([[0, 1.0, 0], [2.0, 1.0, 0]])
    d = np.array([[0, -1.0, 0], [0, -1.0, 0]])
    assert _np(blas.is_occluded(o, d)).tolist() == [True, False]


def _instances(mod, big=1e6):
    """4 instances of two BLASes, each turned about y, scaled and moved
    near (big, big, big), with one mask bit each."""
    out = []
    for i in range(4):
        a = 0.4 * i + 0.1
        m = np.eye(4)
        m[:3, :3] = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                              [-np.sin(a), 0, np.cos(a)]]) * (0.5 + 0.3 * i)
        m[:3, 3] = [big + 6.0 * i, big + 2.0 * (i % 2), big - 3.0 * i]
        out.append(mod.BLASInstanceEx(i % 2, m, mask=1 << i))
    return out


def _tlas_rays(instances, n=512):
    """Rays from about 30 units away at the instances' BLAS centers (the
    soup's (1, 1, 1), the quad's origin) with 0.3 units of spread, and a
    random 4-bit mask a ray."""
    rng = np.random.default_rng(8)
    centers = np.array([(i.transform @ (1.0, 1.0, 1.0, 1.0) if i.blas_id == 0
                         else i.transform[:, 3])[:3] for i in instances])
    aim = centers[rng.integers(0, len(centers), n)] + rng.normal(
        size=(n, 3)) * 0.3
    o = aim + rng.normal(size=(n, 3)) * 30.0
    d = aim - o
    return o, d / np.linalg.norm(d, axis=1, keepdims=True), rng.integers(
        0, 16, n)


def test_tlas_double_matches_jax():
    """4 turned, scaled and moved instances at a 1e6 offset, per-ray
    masks: closest hit (prim and inst equal) and occlusion against JAX."""
    big = 1e6
    blasses = [random_tris(400, seed=9, extent=2.0).astype(np.float64),
               _unit_quad64()]
    jt = jf.TLASDouble(_instances(jf, big), [jf.BVHDouble(b) for b in blasses])
    pt = pf.TLASDouble(_instances(pf, big),
                       [pf.BVHDouble(b, device=CPU) for b in blasses],
                       device=CPU)
    o, d, masks = _tlas_rays(_instances(jf, big))
    ref = jt.intersect(o, d, mask=masks)
    got = pt.intersect(o, d, mask=masks)
    assert 0.1 < (ref["prim"] >= 0).mean() < 1.0
    assert len(set(ref["inst"].tolist())) == 5      # 4 instances and -1
    _same_hits(got, ref, keys="t", rtol=1e-12, atol=1e-15 * 2 * big)
    _same_hits(got, ref, keys="uv", rtol=1e-9, atol=1e-9)
    for t_max in (20.0, pf.FAR):
        np.testing.assert_array_equal(
            _np(pt.is_occluded(o, d, t_max, mask=masks)),
            jt.is_occluded(o, d, t_max, mask=masks))


def test_coincident_instances_tie_as_in_jax():
    """Two instances with one transform: every hit goes to the instance
    that JAX's loop reaches first."""
    m = np.eye(4)
    m[:3, 3] = [5.0, 0.0, 0.0]
    blas = random_tris(200, seed=2, extent=2.0).astype(np.float64)
    jt = jf.TLASDouble([jf.BLASInstanceEx(0, m), jf.BLASInstanceEx(0, m)],
                       [jf.BVHDouble(blas)])
    pt = pf.TLASDouble([pf.BLASInstanceEx(0, m), pf.BLASInstanceEx(0, m)],
                       [pf.BVHDouble(blas, device=CPU)], device=CPU)
    o, d = _rays(3, 128, lo=-10, hi=10)
    d = ([6.0, 1.0, 1.0] + 0.5 * d) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ref = jt.intersect(o, d)
    got = pt.intersect(o, d)
    assert (ref["inst"] == 0).sum() > 10 and not (ref["inst"] == 1).any()
    _same_hits(got, ref)


def _coplanar_pair():
    """Two axis-aligned triangles in the plane z = 0 that overlap where
    1 < x < 2: prim 0's centroid lies at the larger x, so with
    max_leaf=1 the build puts prim 1 in the left child and prim 0 in the
    right one."""
    return np.array([[[1.0, 0, 0], [3.0, 0, 0], [1.0, 2.0, 0]],
                     [[0.0, 0, 0], [2.0, 0, 0], [0.0, 2.0, 0]]])


def _down_rays(x0, x1, n=8, z=5.0):
    """n x n rays straight down onto z = 0 over x0 < x < x1,
    0.05 < y < 0.3: every box they meet is entered at t = z."""
    g = np.linspace(0.0, 1.0, n + 2)[1:-1]
    x, y = np.meshgrid(x0 + (x1 - x0) * g, 0.05 + 0.25 * g)
    o = np.stack([x.ravel(), y.ravel(), np.full(n * n, z)], -1)
    return o, np.tile([0.0, 0.0, -1.0], (n * n, 1))


@pytest.mark.parametrize("case", ["bvh", "tlas_blas", "tlas_top"])
def test_equal_entry_distance_ties_as_in_jax(case):
    """Two coplanar triangles in different subtrees, hit by each ray at
    the same t from boxes it enters at the same distance: the child that
    JAX's loop pops first (the left one, hits.sort(reverse=True) over
    (tmin, ch)) holds the hit. bvh: a BVHDouble; tlas_blas: the same
    tree as the BLAS of one instance; tlas_top: three moved copies of
    one triangle, so that the tie lies between TLAS subtrees."""
    pair = _coplanar_pair()
    if case == "tlas_top":
        moves = []
        for dx in (0.0, 1.0, 2.0):
            m = np.eye(4)
            m[0, 3] = dx
            moves.append(m)
        jt = jf.TLASDouble([jf.BLASInstanceEx(0, m) for m in moves],
                           [jf.BVHDouble(pair[1:])])
        pt = pf.TLASDouble([pf.BLASInstanceEx(0, m) for m in moves],
                           [pf.BVHDouble(pair[1:], device=CPU)], device=CPU)
        o, d = _down_rays(1.05, 2.95)
    elif case == "tlas_blas":
        jt = jf.TLASDouble([jf.BLASInstanceEx(0)],
                           [jf.BVHDouble(pair, max_leaf=1)])
        pt = pf.TLASDouble([pf.BLASInstanceEx(0)],
                           [pf.BVHDouble(pair, max_leaf=1, device=CPU)],
                           device=CPU)
        o, d = _down_rays(1.05, 1.6)
    else:
        jt = jf.BVHDouble(pair, max_leaf=1)
        pt = pf.BVHDouble(pair, max_leaf=1, device=CPU)
        # the root's children are nodes 2 and 3, a leaf of one prim each
        np.testing.assert_array_equal(pt.count[[0, 2, 3]], [0, 1, 1])
        np.testing.assert_array_equal(pt.prim_idx, [1, 0])
        o, d = _down_rays(1.05, 1.6)
    ref = jt.intersect(o, d)
    got = pt.intersect(o, d)
    np.testing.assert_array_equal(ref["t"], 5.0)
    if case != "tlas_top":
        np.testing.assert_array_equal(ref["prim"], 1)
    else:
        assert len(set(ref["inst"].tolist())) >= 2
    _same_hits(got, ref)


def test_singular_transform_raises():
    with pytest.raises(np.linalg.LinAlgError):
        pf.BLASInstanceEx(0, np.diag([1.0, 0.0, 1.0, 1.0]))


def test_needs_a_card_or_cpu(monkeypatch):
    """Without a card and without device="cpu", both structures raise
    instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        pf.BVHDouble(_unit_quad64())
    blas = pf.BVHDouble(_unit_quad64(), device=CPU)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        pf.TLASDouble([pf.BLASInstanceEx(0)], [blas])
