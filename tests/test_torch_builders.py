"""The port's builders against the JAX package's on the same inputs, and
their trees' traversal against brute force (mirrors tests/test_lbvh.py,
test_binned_jax.py, test_builder.py::test_full_sweep_builder,
test_sbvh.py and test_optimize.py at their sizes).

Held to JAX array for array (node boxes, child / leaf words, counts,
prim_idx, n_nodes, dtypes): `build_lbvh` (the same integer steps and
IEEE float ops in the same order), and the numpy builders `build_sweep`,
`build_sbvh` and `optimize_reinsertion` in all three modes (copies of
the same numpy code, the same seeded generator). `epo_cost` within rtol
1e-6 (its SAH term sums float32 node costs in another order).

`build_binned_device`: XLA on the CPU contracts `a * b + c * d` into
`fma(a, b, c * d)` (checked by test_xla_cpu_contracts_the_area_sums),
in the node areas and the split costs, where torch rounds each product
alone. So a bin cost can round one ulp apart and pick another split.
The port is held array for array to JAX with its three sums computed as
XLA contracts them (`_xla_rounding`); as it stands, it is held to JAX's
SAH within 1e-4 relative, a valid tree, and traversal equal to brute
force, and where its arrays differ the test names the first node.
Traversal: prim equal to brute force on every ray, t within rtol = atol
= 1e-4.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tinybvh_tpu.builders import binned as j_binned  # noqa: E402
from tinybvh_tpu.builders import binned_jax as j_binned_dev  # noqa: E402
from tinybvh_tpu.builders import lbvh as j_lbvh  # noqa: E402
from tinybvh_tpu.builders import optimize as j_opt  # noqa: E402
from tinybvh_tpu.builders import sbvh as j_sbvh  # noqa: E402
from tinybvh_tpu.builders import sweep as j_sweep  # noqa: E402
from tinybvh_tpu.layouts.bvh2 import BVH2 as JBVH2  # noqa: E402
from tinybvh_tpu.layouts.bvh2 import sah_cost as j_sah_cost  # noqa: E402
from tinybvh_tpu_torch.builders import binned_device as bd  # noqa: E402
from tinybvh_tpu_torch.builders.binned import build_binned  # noqa: E402
from tinybvh_tpu_torch.builders.lbvh import build_lbvh  # noqa: E402
from tinybvh_tpu_torch.builders.optimize import (  # noqa: E402
    epo_cost, optimize_reinsertion,
)
from tinybvh_tpu_torch.builders.sbvh import build_sbvh  # noqa: E402
from tinybvh_tpu_torch.builders.sweep import build_sweep  # noqa: E402
from tinybvh_tpu_torch.core.intersect import brute_force_closest  # noqa: E402
from tinybvh_tpu_torch.core.rays import make_rays  # noqa: E402
from tinybvh_tpu_torch.io.loaders import random_tris, sphere_tris  # noqa: E402
from tinybvh_tpu_torch.layouts.bvh2 import (  # noqa: E402
    BVH2, sah_cost, validate_host,
)
from tinybvh_tpu_torch.layouts.mbvh import collapse_bvh2  # noqa: E402
from tinybvh_tpu_torch.traverse.stack import intersect_bvh2, pack_tris  # noqa: E402
from tinybvh_tpu_torch.traverse.wide import intersect_bvh8  # noqa: E402
from tests.test_sbvh import long_diagonal_tris  # noqa: E402
from tests.test_torch_jax_native import jax_native  # noqa: E402,F401

FIELDS = ("node_min", "node_max", "left_first", "count", "prim_idx")


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """One test file per worker process: keep torch's pool small."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def assert_same_bvh2(p, j):
    """Every array of the port's BVH2 equal to JAX's, dtype included."""
    for k in FIELDS:
        got, want = getattr(p, k).numpy(), np.asarray(getattr(j, k))
        assert got.dtype == want.dtype, (k, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=k)
    assert p.n_nodes == int(j.n_nodes)


def _rays(tris, seed, n):
    """n rays from around the soup, each aimed near the centroid of a
    random triangle (most hit, some miss)."""
    rng = np.random.default_rng(seed)
    c = tris.mean(axis=1)
    lo, hi = c.min(0) - 2.0, c.max(0) + 2.0
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    aim = c[rng.integers(0, len(c), n)] + rng.normal(
        scale=0.5, size=(n, 3))
    d = (aim - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return make_rays(o, d, device="cpu")


def assert_traces_like_brute_force(bvh, tris, seed=5, n=256, wide=False):
    """The BVH2 engine (or, with wide, the 8-wide lockstep engine on its
    collapse) against brute force: prim equal on every ray, t within
    1e-4."""
    rays = _rays(np.asarray(tris, np.float32), seed, n)
    t = torch.from_numpy(np.asarray(tris, np.float32))
    if wide:
        h = intersect_bvh8(collapse_bvh2(bvh, tris), rays)
    else:
        h = intersect_bvh2(bvh, pack_tris(bvh, t), rays,
                           leaf_max=max(int(bvh.count.max()), 1))
    ref = brute_force_closest(rays, t)
    np.testing.assert_array_equal(h.prim.numpy(), ref.prim.numpy())
    m = ref.prim.numpy() >= 0
    assert 0 < m.mean() < 1
    np.testing.assert_allclose(h.t.numpy()[m], ref.t.numpy()[m], rtol=1e-4,
                               atol=1e-4)


# ---- LBVH -------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 17, 256, 3000])
def test_lbvh_matches_jax(n):
    tris = random_tris(n, seed=n + 100)
    bvh = build_lbvh(tris, device="cpu")
    assert_same_bvh2(bvh, j_lbvh.build_lbvh(tris))
    validate_host(bvh, tris)


def test_lbvh_duplicate_centroids():
    """64 copies of one triangle: every Morton code ties, the index bits
    order the tree."""
    tris = np.repeat(random_tris(1, seed=1), 64, axis=0)
    bvh = build_lbvh(tris, device="cpu")
    assert_same_bvh2(bvh, j_lbvh.build_lbvh(tris))
    validate_host(bvh, tris)


def test_lbvh_traversal_matches_brute_force():
    tris = random_tris(2000, seed=31)
    bvh = build_lbvh(torch.from_numpy(tris))   # a tensor keeps its device
    assert bvh.node_min.device.type == "cpu"
    assert_traces_like_brute_force(bvh, tris)


def test_lbvh_quality_reasonable():
    """LBVH SAH within 3x of binned SAH (typically 1.3-2x)."""
    tris = sphere_tris(24, 48)
    c_lbvh = float(sah_cost(build_lbvh(tris, device="cpu")))
    c_sah = float(sah_cost(build_binned(tris, device="cpu")))
    assert c_lbvh < 3.0 * c_sah


# ---- the binned device builder ----------------------------------------------

def _fma(a, b, c):
    """a * b + c rounded once (the f64 product of two f32 is exact)."""
    return (a.double() * b.double() + c.double()).float()


def _xla_rounding(monkeypatch):
    """The port's three sums as XLA on the CPU contracts them (see
    test_xla_cpu_contracts_the_area_sums)."""

    def ha(mn, mx):
        e0, e1, e2 = torch.clamp(mx - mn, min=0.0).unbind(-1)
        return _fma(e2, e0, _fma(e0, e1, e1 * e2))

    monkeypatch.setattr(bd, "_ha", ha)
    monkeypatch.setattr(bd, "_cost", lambda a_l, n_l, a_r, n_r: _fma(
        a_l, n_l.float(), a_r * n_r))
    monkeypatch.setattr(bd, "_split_cost", lambda r_sav, best: _fma(
        r_sav, best, torch.ones_like(r_sav)))


def test_xla_cpu_contracts_the_area_sums():
    """What the binned device builder's tolerance rests on: jitted on the
    CPU, XLA computes a*b + c*d as fma(a, b, c*d), the three-term area as
    fma(e2, e0, fma(e0, e1, e1*e2)) and 1 + r*c as fma(r, c, 1), none
    as the rounded products torch adds."""
    rng = np.random.default_rng(0)
    a, b, c = (torch.from_numpy(rng.uniform(0, 10, 20000).astype(np.float32))
               for _ in range(3))
    n = torch.from_numpy(rng.integers(0, 50, 20000).astype(np.int32))
    ja, jb, jc, jn = (jnp.asarray(x.numpy()) for x in (a, b, c, n))
    cost = np.asarray(jax.jit(lambda a, n, b, c: a * n + b * c)(ja, jn, jb,
                                                                jc))
    np.testing.assert_array_equal(cost, _fma(a, n.float(), b * c).numpy())
    assert not np.array_equal(cost, (a * n + b * c).numpy())
    area = np.asarray(jax.jit(j_binned_dev._ha)(jnp.zeros((20000, 3)),
                                                jnp.stack([ja, jb, jc], -1)))
    np.testing.assert_array_equal(area, _fma(c, a, _fma(a, b, b * c)).numpy())
    assert not np.array_equal(area, (a * b + b * c + c * a).numpy())
    split = np.asarray(jax.jit(lambda r, c: 1.0 + 1.0 * r * c)(ja, jb))
    np.testing.assert_array_equal(split, _fma(a, b, torch.ones_like(a))
                                  .numpy())


def _first_difference(p, j):
    """The first node whose arrays differ from JAX's, or None."""
    bad = [np.nonzero((getattr(p, k).numpy() != np.asarray(getattr(j, k)))
                      .reshape(len(getattr(p, k)), -1).any(1))[0]
           for k in FIELDS if k != "prim_idx"]
    first = min((int(b[0]) for b in bad if b.size), default=None)
    if first is None and not np.array_equal(p.prim_idx.numpy(),
                                            np.asarray(j.prim_idx)):
        return "prim_idx only"
    return first


@pytest.mark.parametrize("case", ["random2", "random33", "random700",
                                  "sphere"])
def test_binned_device_matches_jax(case, monkeypatch):
    """Array for array under XLA's rounding; as the port rounds, SAH
    within 1e-4 of JAX's, the tree valid and traced like brute force.
    sphere_tris(24, 48) is a tree the two roundings split apart: its
    first differing node is named."""
    tris = (sphere_tris(24, 48) if case == "sphere"
            else random_tris(int(case[6:]), seed=int(case[6:]) + 50))
    ref = j_binned_dev.build_binned_device(tris)
    bvh = bd.build_binned_device(tris, device="cpu")
    first = _first_difference(bvh, ref)
    if case == "sphere":
        assert first is not None, "expected XLA's rounding to split apart"
    else:
        assert first is None, f"first differing node {first}"
    want = float(j_sah_cost(ref))
    assert abs(float(sah_cost(bvh)) - want) <= 1e-4 * want
    validate_host(bvh, tris)
    assert_traces_like_brute_force(bvh, tris, wide=True)
    with monkeypatch.context() as m:
        _xla_rounding(m)
        assert_same_bvh2(bd.build_binned_device(tris, device="cpu"), ref)


def test_binned_device_quality_parity():
    """Within 5% of the host binned builder's SAH (same algorithm, other
    tie-breaking)."""
    tris = sphere_tris(24, 48)
    c_host = float(sah_cost(build_binned(tris, max_leaf=4, device="cpu")))
    c_dev = float(sah_cost(bd.build_binned_device(tris, max_leaf=4,
                                                  device="cpu")))
    assert c_dev < c_host * 1.05


def test_binned_device_traversal():
    tris = random_tris(1200, seed=55)
    bvh = bd.build_binned_device(torch.from_numpy(tris))
    assert bvh.node_min.device.type == "cpu"
    assert_traces_like_brute_force(bvh, tris, wide=True)


# ---- the full sweep, SBVH ---------------------------------------------------

def test_sweep_matches_jax():
    tris = random_tris(600, seed=60)
    bvh = build_sweep(tris, max_leaf=4, device="cpu")
    assert_same_bvh2(bvh, j_sweep.build_sweep(tris, max_leaf=4))
    validate_host(bvh, tris)
    # exact SAH at least as good as 8-bin SAH
    assert float(sah_cost(bvh)) <= float(sah_cost(build_binned(
        tris, max_leaf=4, device="cpu"))) * 1.02
    assert_traces_like_brute_force(bvh, tris)


@pytest.mark.parametrize("n", [2, 50, 1000])
def test_sbvh_matches_jax(n):
    """Duplicate prim ids allowed (spatial splits): the structure is
    valid and every prim is present."""
    tris = random_tris(n, seed=n)
    bvh = build_sbvh(tris, device="cpu")
    assert_same_bvh2(bvh, j_sbvh.build_sbvh(tris))
    validate_host(bvh, strict_perm=False)
    np.testing.assert_array_equal(np.unique(bvh.prim_idx.numpy()),
                                  np.arange(n))


def test_sbvh_traversal_matches_brute_force():
    tris = long_diagonal_tris(800, seed=2)
    bvh = build_sbvh(tris, max_leaf=8, device="cpu")
    assert_same_bvh2(bvh, j_sbvh.build_sbvh(tris, max_leaf=8))
    assert_traces_like_brute_force(bvh, tris, n=512)


def test_sbvh_improves_sliver_scene():
    tris = long_diagonal_tris(2000, seed=3)
    c_obj = float(sah_cost(build_binned(tris, device="cpu")))
    c_sbvh = float(sah_cost(build_sbvh(tris, max_leaf=None, device="cpu")))
    assert c_sbvh < c_obj


def test_sbvh_to_bvh8_traversal():
    tris = long_diagonal_tris(500, seed=4)
    bvh = build_sbvh(tris, max_leaf=4, device="cpu")
    assert_traces_like_brute_force(bvh, tris, wide=True)


# ---- the reinsertion optimizer and EPO --------------------------------------

def _hand_case():
    """tests/test_optimize.py's mismatched pairing (0,10)/(1,11), as the
    port's BVH2 and JAX's."""
    def box(x):
        return (np.array([x, 0, 0], np.float32),
                np.array([x + 1, 1, 1], np.float32))

    mn = np.full((10, 3), 1e30, np.float32)
    mx = np.full((10, 3), -1e30, np.float32)
    lf = np.zeros(10, np.int32)
    ct = np.zeros(10, np.int32)
    mn[0], mx[0] = box(0)[0], box(11)[1]
    lf[0] = 2
    for slot, xs in ((4, 0), (5, 10), (6, 1), (7, 11)):
        mn[slot], mx[slot] = box(xs)
        ct[slot] = 1
        lf[slot] = {4: 0, 5: 1, 6: 2, 7: 3}[slot]
    mn[2], mx[2], lf[2] = np.minimum(mn[4], mn[5]), np.maximum(mx[4],
                                                               mx[5]), 4
    mn[3], mx[3], lf[3] = np.minimum(mn[6], mn[7]), np.maximum(mx[6],
                                                               mx[7]), 6
    h = dict(node_min=mn, node_max=mx, left_first=lf, count=ct,
             prim_idx=np.arange(4, dtype=np.int32), n_nodes=8)
    j = JBVH2(**{k: jnp.asarray(v) for k, v in h.items()})
    return BVH2.from_host(h, "cpu"), j


def test_optimize_regroups_hand_case():
    bvh, jbvh = _hand_case()
    before = float(sah_cost(bvh))
    opt = optimize_reinsertion(bvh, passes=8, batch=4)
    assert_same_bvh2(opt, j_opt.optimize_reinsertion(jbvh, passes=8,
                                                     batch=4))
    assert float(sah_cost(opt)) < before * 0.7   # 3.32 -> 1.88
    validate_host(opt, strict_perm=True)


def test_optimize_median_tree_matches_jax():
    """Never worse than its input (the rollback), JAX's tree, valid and
    traced like brute force."""
    tris = random_tris(1500, seed=8)
    bad = build_binned(tris, strategy="median", device="cpu")
    opt = optimize_reinsertion(bad, passes=6, batch=64)
    assert_same_bvh2(opt, j_opt.optimize_reinsertion(
        j_binned.build_binned(tris, strategy="median"), passes=6, batch=64))
    assert float(sah_cost(opt)) <= float(sah_cost(bad)) + 1e-4
    validate_host(opt, tris)
    assert_traces_like_brute_force(opt, tris)


def test_optimize_sah_tree_not_degraded():
    tris = random_tris(1000, seed=10)
    good = build_binned(tris, device="cpu")
    opt = optimize_reinsertion(good, passes=2, batch=24)
    assert float(sah_cost(opt)) <= float(sah_cost(good)) + 1e-3


@pytest.fixture(scope="module")
def shells():
    """Two interleaved sphere shells and a cloud (test_optimize.py's
    improvable binned-SAH tree), built by both packages."""
    tris = np.concatenate([
        sphere_tris(24, 48, radius=1.0), sphere_tris(24, 48, radius=1.02),
        random_tris(2000, seed=4, extent=2.0, size=0.05) - 1.0,
    ]).astype(np.float32)
    return build_binned(tris, device="cpu"), j_binned.build_binned(tris)


@pytest.mark.parametrize("mode,passes,batch", [("normal", 8, 128),
                                               ("stochastic", 3, 32),
                                               ("extreme", 3, 32)])
def test_optimize_modes_match_jax(shells, mode, passes, batch):
    """Each mode gives JAX's tree (the stochastic one from the same
    seeded generator); normal cuts SAH by more than 0.5%, the others do
    not raise it."""
    bvh, jbvh = shells
    opt = optimize_reinsertion(bvh, passes=passes, batch=batch, mode=mode)
    assert_same_bvh2(opt, j_opt.optimize_reinsertion(
        jbvh, passes=passes, batch=batch, mode=mode))
    before = float(sah_cost(bvh))
    if mode == "normal":
        assert 1.0 - float(sah_cost(opt)) / before > 0.005
    else:
        assert float(sah_cost(opt)) <= before + 1e-3


def test_epo_cost_matches_jax():
    tris = random_tris(200, seed=11)
    bvh = build_binned(tris, device="cpu")
    e = epo_cost(bvh, tris)
    np.testing.assert_allclose(e, j_opt.epo_cost(j_binned.build_binned(tris),
                                                 tris), rtol=1e-6)
    assert np.isfinite(e) and 0 < e < float(sah_cost(bvh))
