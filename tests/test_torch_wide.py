"""The port's lockstep engine (traverse/wide.py) against the JAX package's
and brute force, on the CPU (mirrors tests/test_wide.py).

Both trace the same tables (the JAX collapse carried into the port with
convert.from_numpy_bvh8) on the same numpy rays. Tolerances as ROADMAP's
parity standard: prim equal on every ray, t within rtol = atol = 1e-4,
u and v within 1e-3; per-ray cost equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tinybvh_tpu as tb  # noqa: E402
from tinybvh_tpu.builders.binned import build_binned  # noqa: E402
from tinybvh_tpu.layouts.mbvh import EMPTY_SLOT, collapse_bvh2  # noqa: E402
from tinybvh_tpu.traverse import wide as jwd  # noqa: E402
from tinybvh_tpu_torch.convert import from_numpy_bvh8  # noqa: E402
from tinybvh_tpu_torch.core.intersect import (  # noqa: E402
    brute_force_any, brute_force_closest,
)
from tinybvh_tpu_torch.core.rays import make_rays  # noqa: E402
from tinybvh_tpu_torch.core.vecmath import BVH_FAR  # noqa: E402
from tinybvh_tpu_torch.io.loaders import random_tris, sphere_tris  # noqa: E402
from tinybvh_tpu_torch.traverse.wide import (  # noqa: E402
    intersect_bvh8, is_occluded_bvh8,
)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """One test file per worker process: keep torch's pool small."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _both(tris, width=8):
    jb8 = collapse_bvh2(build_binned(tris, max_leaf=4), tris, width=width)
    return jb8, from_numpy_bvh8(jb8, device="cpu")


def _rays(seed, n, extent=10.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-2, extent + 2, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def assert_same_hits(h, jh):
    p, jp = h.prim.numpy(), np.asarray(jh.prim)
    np.testing.assert_array_equal(p, jp)
    m = p >= 0
    for name, tol in (("t", 1e-4), ("u", 1e-3), ("v", 1e-3)):
        np.testing.assert_allclose(getattr(h, name).numpy()[m],
                                   np.asarray(getattr(jh, name))[m],
                                   rtol=tol, atol=tol)


def assert_matches_brute_force(h, rays, tris):
    ref = brute_force_closest(rays, torch.from_numpy(tris))
    miss = ref.prim.numpy() < 0
    np.testing.assert_array_equal(h.prim.numpy() < 0, miss)
    np.testing.assert_allclose(h.t.numpy()[~miss], ref.t.numpy()[~miss],
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n_tris", [1, 5, 80, 2000])
def test_bvh8_matches_jax_and_brute_force(n_tris):
    tris = random_tris(n_tris, seed=n_tris + 7)
    jb8, b8 = _both(tris)
    o, d = _rays(n_tris + 100, 256)
    rays = make_rays(o, d, device="cpu")
    hits, cost = intersect_bvh8(b8, rays, with_cost=True)
    jh, jcost = jwd.intersect_bvh8(jb8, tb.make_rays(o, d), with_cost=True)
    assert_same_hits(hits, jh)
    np.testing.assert_array_equal(cost.numpy(), np.asarray(jcost))
    assert_matches_brute_force(hits, rays, tris)


def test_bvh8_occlusion():
    tris = random_tris(800, seed=5)
    jb8, b8 = _both(tris)
    o, d = _rays(61, 512)
    rays = make_rays(o, d, device="cpu")
    for t_max in (1.0, BVH_FAR):
        occ = is_occluded_bvh8(b8, rays, t_max)
        ref = brute_force_any(rays, torch.from_numpy(tris), t_max)
        np.testing.assert_array_equal(occ.numpy(), ref.numpy())
        jocc = jwd.is_occluded_bvh8(jb8, tb.make_rays(o, d), t_max)
        np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))


def test_bvh8_sphere_closed_surface():
    tris = sphere_tris(16, 32)
    jb8, b8 = _both(tris)
    rng = np.random.default_rng(71)
    d = rng.normal(size=(256, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = np.zeros((256, 3), np.float32)
    hits = intersect_bvh8(b8, make_rays(o, d, device="cpu"))
    assert (hits.prim.numpy() >= 0).all()
    assert (np.abs(hits.t.numpy() - 1.0) < 0.05).all()
    assert_same_hits(hits, jwd.intersect_bvh8(jb8, tb.make_rays(o, d)))


def test_bvh4_width_collapse():
    """A width-4 collapse (at most 4 live slots per node) traverses
    identically (≙ MBVH<4>/BVH4_CPU)."""
    tris = random_tris(800, seed=91)
    jb8, b8 = _both(tris, width=4)
    assert (b8.child.numpy() != EMPTY_SLOT).sum(axis=1).max() <= 4
    o, d = _rays(81, 256)
    rays = make_rays(o, d, device="cpu")
    hits = intersect_bvh8(b8, rays)
    assert_same_hits(hits, jwd.intersect_bvh8(jb8, tb.make_rays(o, d)))
    assert_matches_brute_force(hits, rays, tris)


def test_per_ray_t_max():
    tris = random_tris(600, seed=12)
    jb8, b8 = _both(tris)
    o, d = _rays(91, 256)
    tm = np.random.default_rng(5).uniform(0.5, 8.0, 256).astype(np.float32)
    hits = intersect_bvh8(b8, make_rays(o, d, device="cpu"), torch.from_numpy(tm))
    assert_same_hits(hits, jwd.intersect_bvh8(jb8, tb.make_rays(o, d), tm))
    assert (hits.t.numpy()[hits.prim.numpy() >= 0] < tm[
        hits.prim.numpy() >= 0]).all()
