"""The port's BVH2 lockstep engines against the JAX package's and brute
force, on the CPU (mirrors tests/test_traverse.py and the engine half of
tests/test_watertight.py).

Both packages trace the same BVH2 (the JAX build carried into the port
with convert.from_numpy_bvh2) over the same packed triangles, with the
same per-ray t_max, in each of the three leaf tests. Tolerances: ROADMAP's
parity standard, prim equal on every ray, t within rtol = atol = 1e-4, u
and v within 1e-3; the traversal costs equal; occlusion equal."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import tinybvh_tpu as tb  # noqa: E402
from tinybvh_tpu.builders.binned import build_binned  # noqa: E402
from tinybvh_tpu.traverse import stack as jst  # noqa: E402
from tinybvh_tpu_torch.convert import from_numpy_bvh2  # noqa: E402
from tinybvh_tpu_torch.core.intersect import (  # noqa: E402
    brute_force_any, brute_force_closest,
)
from tinybvh_tpu_torch.core.rays import make_rays  # noqa: E402
from tinybvh_tpu_torch.core.vecmath import BVH_FAR  # noqa: E402
from tinybvh_tpu_torch.io.loaders import random_tris  # noqa: E402
from tinybvh_tpu_torch.traverse import stack as pst  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """One test file per worker process: keep torch's pool small."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def scene():
    """random_tris(2000) in leaves of 2 to 8 (a traversal cost of 4 makes
    SAH keep large leaves), 512 rays from around the cube, a per-ray
    t_max (a third of the rays unbounded)."""
    tris = random_tris(2000, seed=12)
    jbvh = build_binned(tris, max_leaf=8, c_trav=4.0)
    pbvh = from_numpy_bvh2(jbvh, device="cpu")
    leaf_max = int(np.asarray(jbvh.count).max())
    rng = np.random.default_rng(13)
    o = rng.uniform(-2, 12, (512, 3)).astype(np.float32)
    d = rng.normal(size=(512, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = rng.uniform(1.0, 12.0, 512).astype(np.float32)
    t_max[::3] = BVH_FAR
    return dict(tris=tris, jbvh=jbvh, pbvh=pbvh, leaf_max=leaf_max,
                jpacked=jst.pack_tris(jbvh, jnp.asarray(tris)),
                ppacked=pst.pack_tris(pbvh, tris),
                rays=make_rays(o, d, device="cpu"), jrays=tb.make_rays(o, d),
                t_max=t_max)


def _assert_same_hits(h, jh):
    p = h.prim.numpy()
    np.testing.assert_array_equal(p, np.asarray(jh.prim))
    m = p >= 0
    for name, tol in (("t", 1e-4), ("u", 1e-3), ("v", 1e-3)):
        np.testing.assert_allclose(getattr(h, name).numpy()[m],
                                   np.asarray(getattr(jh, name))[m],
                                   rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize("tri_test", ["mt", "watertight", "baldwin"])
def test_intersect_bvh2_matches_jax(scene, tri_test):
    s = scene
    assert s["leaf_max"] > 4
    h, cost = pst.intersect_bvh2(
        s["pbvh"], s["ppacked"], s["rays"], torch.from_numpy(s["t_max"]),
        leaf_max=s["leaf_max"], with_cost=True, tri_test=tri_test)
    jh, jcost = jst.intersect_bvh2(
        s["jbvh"], s["jpacked"], s["jrays"], jnp.asarray(s["t_max"]),
        leaf_max=s["leaf_max"], with_cost=True, tri_test=tri_test)
    _assert_same_hits(h, jh)
    np.testing.assert_array_equal(cost.numpy(), np.asarray(jcost))
    hit = h.prim.numpy() >= 0
    assert 0.1 < hit.mean() < 0.9
    assert (h.t.numpy()[hit] < s["t_max"][hit]).all()
    ref = brute_force_closest(s["rays"], torch.from_numpy(s["tris"]),
                              torch.from_numpy(s["t_max"]))
    assert np.mean(hit == (ref.prim.numpy() >= 0)) > 0.99


@pytest.mark.parametrize("tri_test", ["mt", "watertight", "baldwin"])
def test_is_occluded_bvh2_matches_jax(scene, tri_test):
    s = scene
    occ = pst.is_occluded_bvh2(
        s["pbvh"], s["ppacked"], s["rays"], torch.from_numpy(s["t_max"]),
        leaf_max=s["leaf_max"], tri_test=tri_test)
    jocc = jst.is_occluded_bvh2(
        s["jbvh"], s["jpacked"], s["jrays"], jnp.asarray(s["t_max"]),
        leaf_max=s["leaf_max"], tri_test=tri_test)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))
    ref = brute_force_any(s["rays"], torch.from_numpy(s["tris"]),
                          torch.from_numpy(s["t_max"])).numpy()
    assert np.mean(occ.numpy() == ref) > 0.99
    assert 0.1 < occ.numpy().mean() < 0.9


def test_scalar_t_max_and_loop_counts(scene):
    """A scalar t_max clips as the per-ray one does; the host loop reads
    the live flag once every 8 steps."""
    s = scene
    full = pst.intersect_bvh2(s["pbvh"], s["ppacked"], s["rays"],
                              leaf_max=s["leaf_max"])
    steps = pst.LAST_CALL["steps"]
    assert steps % 8 == 0 and pst.LAST_CALL["syncs"] == steps // 8 + 1
    clipped = pst.intersect_bvh2(s["pbvh"], s["ppacked"], s["rays"], 4.0,
                                 leaf_max=s["leaf_max"])
    keep = full.t.numpy() < 4.0
    np.testing.assert_array_equal(clipped.prim.numpy(),
                                  np.where(keep, full.prim.numpy(), -1))
    assert 0 < keep.mean() < 1
