"""The port's wavefront engine against the JAX package's and brute force,
on the CPU (mirrors tests/test_wavefront.py).

Both engines trace the same BVH8 (the JAX collapse carried into the port
with convert.from_numpy_bvh8) on the same numpy rays. Tolerances as
ROADMAP's parity standard (tests/test_packet2.py:141-160): prim equal on
every ray, t within rtol = atol = 1e-4, u and v within 1e-3; against brute
force t within rtol 1e-4, atol 1e-5 as tests/test_wavefront.py. The
quantized CWBVH case (test_quantized_cwbvh_matches) is in
tests/test_torch_layouts.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import tinybvh_tpu as tb  # noqa: E402
from tinybvh_tpu.builders.binned import build_binned  # noqa: E402
from tinybvh_tpu.layouts.mbvh import collapse_bvh2  # noqa: E402
from tinybvh_tpu.traverse import wavefront as jwf  # noqa: E402
from tinybvh_tpu_torch.config import use_config  # noqa: E402
from tinybvh_tpu_torch.convert import from_numpy_bvh8  # noqa: E402
from tinybvh_tpu_torch.core.intersect import (  # noqa: E402
    brute_force_any, brute_force_closest,
)
from tinybvh_tpu_torch.core.rays import make_rays  # noqa: E402
from tinybvh_tpu_torch.core.vecmath import BVH_FAR  # noqa: E402
from tinybvh_tpu_torch.io.loaders import random_tris, sphere_tris  # noqa: E402
from tinybvh_tpu_torch.traverse.wavefront import (  # noqa: E402
    intersect_wavefront, is_occluded_wavefront,
)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """One test file per worker process: keep torch's pool small."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _both(tris):
    """The JAX BVH8 of tris and the same tables in the port."""
    jb8 = collapse_bvh2(build_binned(tris, max_leaf=4), tris)
    return jb8, from_numpy_bvh8(jb8, device="cpu")


def _rays(seed, n, extent=10.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-2, extent + 2, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def assert_same_hits(h, jh):
    """prim equal on every ray; t, u, v within the parity tolerances."""
    p, jp = h.prim.numpy(), np.asarray(jh.prim)
    np.testing.assert_array_equal(p, jp)
    m = p >= 0
    for name, tol in (("t", 1e-4), ("u", 1e-3), ("v", 1e-3)):
        np.testing.assert_allclose(getattr(h, name).numpy()[m],
                                   np.asarray(getattr(jh, name))[m],
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("n_tris", [1, 5, 80, 2000])
def test_wavefront_matches_jax_and_brute_force(n_tris):
    tris = random_tris(n_tris, seed=n_tris + 7)
    jb8, b8 = _both(tris)
    o, d = _rays(n_tris, 256)
    rays = make_rays(o, d, device="cpu")
    hits, overflow = intersect_wavefront(b8, rays)
    assert not overflow
    jh, jov = jwf.intersect_wavefront(jb8, tb.make_rays(o, d))
    assert not bool(jov)
    assert_same_hits(hits, jh)
    ref = brute_force_closest(rays, torch.from_numpy(tris))
    miss = ref.prim.numpy() < 0
    np.testing.assert_array_equal(hits.prim.numpy() < 0, miss)
    np.testing.assert_allclose(hits.t.numpy()[~miss], ref.t.numpy()[~miss],
                               rtol=1e-4, atol=1e-5)


def test_wavefront_sphere_interior():
    """Interior rays overlap nearly every node: a large frontier cap."""
    tris = sphere_tris(16, 32)
    jb8, b8 = _both(tris)
    rng = np.random.default_rng(21)
    d = rng.normal(size=(256, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = np.zeros((256, 3), np.float32)
    hits, overflow = intersect_wavefront(b8, make_rays(o, d, device="cpu"), cap_factor=16)
    assert not overflow
    assert (hits.prim.numpy() >= 0).all()
    assert (np.abs(hits.t.numpy() - 1.0) < 0.05).all()
    jh, _ = jwf.intersect_wavefront(jb8, tb.make_rays(o, d), cap_factor=16)
    assert_same_hits(hits, jh)


def test_wavefront_any_hit():
    tris = random_tris(900, seed=5)
    jb8, b8 = _both(tris)
    o, d = _rays(31, 512)
    rays = make_rays(o, d, device="cpu")
    for t_max in (1.0, BVH_FAR):
        occ = is_occluded_wavefront(b8, rays, t_max)
        ref = brute_force_any(rays, torch.from_numpy(tris), t_max)
        np.testing.assert_array_equal(occ.numpy(), ref.numpy())
        jocc = jwf.is_occluded_wavefront(jb8, tb.make_rays(o, d), t_max)
        np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))


def test_wavefront_t_max():
    """A scalar and a per-ray t_max clip hits exactly where the full trace
    lies beyond them."""
    tris = random_tris(400, seed=6)
    jb8, b8 = _both(tris)
    o, d = _rays(41, 256)
    rays = make_rays(o, d, device="cpu")
    full, _ = intersect_wavefront(b8, rays)
    clipped, _ = intersect_wavefront(b8, rays, t_max=3.0)
    ft = full.t.numpy()
    assert ((ft < 3.0) == (clipped.prim.numpy() >= 0)).all()
    per_ray = np.random.default_rng(4).uniform(0.5, 6.0, 256).astype(
        np.float32)
    h, _ = intersect_wavefront(b8, rays, t_max=torch.from_numpy(per_ray))
    assert ((ft < per_ray) == (h.prim.numpy() >= 0)).all()
    jh, _ = jwf.intersect_wavefront(jb8, tb.make_rays(o, d),
                                    t_max=jnp.asarray(per_ray))
    assert_same_hits(h, jh)


def test_wavefront_overflow_flag_matches_jax():
    """A frontier cap below the scene's need is reported, as in JAX."""
    tris = random_tris(2000, seed=9)
    jb8, b8 = _both(tris)
    o, d = _rays(51, 256)
    _, ovf = intersect_wavefront(b8, make_rays(o, d, device="cpu"), cap_factor=1)
    _, jovf = jwf.intersect_wavefront(jb8, tb.make_rays(o, d), cap_factor=1)
    assert ovf and bool(jovf)


@pytest.mark.parametrize("what", ["watertight", "baldwin"])
def test_leaf_tests_match_jax(what):
    """Config.tri_test="watertight" / "baldwin" through the wavefront
    engine, closest hit and any hit, against the JAX engine under the
    same config (prim equal, t / u / v within the parity tolerances,
    occlusion equal) and brute force (Möller–Trumbore: the hit masks
    agree but for razor-edge rays)."""
    from tinybvh_tpu.config import use_config as jax_config

    tris = random_tris(2000, seed=9)
    jb8, b8 = _both(tris)
    o, d = _rays(61, 512)
    rays = make_rays(o, d, device="cpu")
    jrays = tb.make_rays(o, d)
    with use_config(tri_test=what), jax_config(tri_test=what):
        hits, ovf = intersect_wavefront(b8, rays, cap_factor=8)
        jh, jovf = jwf.intersect_wavefront(jb8, jrays, cap_factor=8)
        occ = is_occluded_wavefront(b8, rays, 4.0)
        jocc = jwf.is_occluded_wavefront(jb8, jrays, 4.0)
    assert not ovf and not bool(jovf)
    assert_same_hits(hits, jh)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))
    ref = brute_force_closest(rays, torch.from_numpy(tris))
    hit = hits.prim.numpy() >= 0
    assert np.mean(hit == (ref.prim.numpy() >= 0)) > 0.99
    assert 0.1 < hit.mean() < 1.0 and 0.0 < occ.numpy().mean() < 1.0


@pytest.mark.parametrize("what", ["omap", "bvh8q"])
def test_unported_options_raise(what):
    """A layout other than BVH8 and the quantized BVH8Q (which the engine
    takes since it was ported) raises TypeError; a micromap table not
    aligned with the leaf rows raises ValueError."""
    tris = random_tris(20, seed=1)
    _, b8 = _both(tris)
    rays = make_rays(*_rays(1, 8), device="cpu")
    err = ValueError if what == "omap" else TypeError
    with pytest.raises(err):
        if what == "omap":
            intersect_wavefront(b8, rays, omap=torch.ones(
                (b8.leaf_prim.shape[0] + 1, 4, 2, 2), dtype=torch.bool))
        else:
            intersect_wavefront(object(), rays)
