"""tinybvh_tpu_torch.BVH's engines, builders and layouts against
tinybvh_tpu.BVH on the same calls, on the CPU (mirrors tests/test_api.py
test_engine_selection_parity and tests/test_config.py
test_config_drives_bvh_defaults).

Tolerances: ROADMAP's parity standard, prim equal on every ray, t
within rtol = atol = 1e-4, u and v within 1e-3; occlusion equal."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import tinybvh_tpu as tb  # noqa: E402
import tinybvh_tpu_torch as tt  # noqa: E402
from tinybvh_tpu_torch.core.intersect import (  # noqa: E402
    brute_force_any, brute_force_closest,
)
from tinybvh_tpu_torch.io.loaders import random_tris  # noqa: E402
from tests.test_torch_jax_native import jax_native  # noqa: E402,F401


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """One test file per worker process: keep torch's pool small."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def rays_np():
    """tests/test_api.py's 512 rays from around random_tris(400, seed=2)."""
    rng = np.random.default_rng(1234)
    o = rng.uniform(-2, 12, (512, 3)).astype(np.float32)
    d = rng.normal(size=(512, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


@pytest.fixture(scope="module")
def bvhs():
    tris = random_tris(400, seed=2)
    return tris, tt.BVH(tris, device="cpu"), tb.BVH(tris)


def _assert_hits(h, ref):
    p = h.prim.numpy()
    np.testing.assert_array_equal(p, np.asarray(ref.prim))
    m = p >= 0
    for name, tol in (("t", 1e-4), ("u", 1e-3), ("v", 1e-3)):
        want = getattr(ref, name)
        want = want.numpy() if isinstance(want, torch.Tensor) else \
            np.asarray(want)
        np.testing.assert_allclose(getattr(h, name).numpy()[m], want[m],
                                   rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize("engine", ["auto", "wavefront", "packets",
                                    "lockstep2", "rayloop"])
def test_engine_selection_parity(bvhs, rays_np, engine):
    """Every engine gives the port's lockstep hits, and JAX's same engine
    the same ones (tests/test_api.py:37); is_occluded likewise."""
    tris, pb, jb = bvhs
    o, d = rays_np
    rays, jrays = tt.make_rays(o, d, device="cpu"), tb.make_rays(o, d)
    base = pb.intersect(rays, engine="lockstep")
    h = pb.intersect(rays, engine=engine)
    _assert_hits(h, base)
    _assert_hits(h, jb.intersect(jrays, engine=engine))
    _assert_hits(h, brute_force_closest(rays, pb.tris))
    occ = pb.is_occluded(rays, 5.0, engine=engine).numpy()
    np.testing.assert_array_equal(
        occ, pb.is_occluded(rays, 5.0, engine="lockstep").numpy())
    np.testing.assert_array_equal(occ, brute_force_any(rays, pb.tris,
                                                       5.0).numpy())
    if engine != "packets":   # JAX's is_occluded has no packet route
        np.testing.assert_array_equal(
            occ, np.asarray(jb.is_occluded(jrays, 5.0, engine=engine)))
    assert 0 < occ.mean() < 1


@pytest.mark.parametrize("build", ["layout_bvh2", "max_leaf_16"])
def test_bvh2_path_matches_jax(rays_np, build):
    """Without a BVH8 (layout="bvh2", or leaves over 4 triangles) every
    engine takes the BVH2 engine, as in JAX; the packet and rayloop
    intersects raise ValueError, and is_occluded's rayloop and packets
    take the BVH2 engine too."""
    if build == "layout_bvh2":
        tris = random_tris(400, seed=2)
        kw = dict(layout="bvh2")
    else:
        # 64 copies of one triangle: SAH cannot split them, max_leaf does
        tris = np.broadcast_to(random_tris(1, seed=0), (64, 3, 3)).copy()
        kw = dict(max_leaf=16)
    pb, jb = tt.BVH(tris, device="cpu", **kw), tb.BVH(tris, **kw)
    assert pb.bvh8 is None and jb.bvh8 is None
    assert pb.leaf_max == jb.leaf_max
    if build == "max_leaf_16":
        assert 4 < pb.leaf_max <= 16
    o, d = rays_np
    if build == "max_leaf_16":   # aimed at the triangle
        c = tris[0].mean(0)
        d = (c - o + 0.05 * d).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays, jrays = tt.make_rays(o, d, device="cpu"), tb.make_rays(o, d)
    h = pb.intersect(rays)
    _assert_hits(h, jb.intersect(jrays))
    _assert_hits(h, brute_force_closest(rays, pb.tris))
    assert 0 < (h.prim.numpy() >= 0).mean()
    for engine in ("wavefront", "lockstep", "lockstep2"):
        _assert_hits(pb.intersect(rays, engine=engine), h)
    for engine in ("packets", "rayloop"):
        with pytest.raises(ValueError, match="bvh8"):
            pb.intersect(rays, engine=engine)
    t_max = 8.0
    occ = pb.is_occluded(rays, t_max).numpy()
    np.testing.assert_array_equal(occ, np.asarray(jb.is_occluded(jrays,
                                                                 t_max)))
    np.testing.assert_array_equal(occ, brute_force_any(rays, pb.tris,
                                                       t_max).numpy())
    for engine in ("rayloop", "packets", "lockstep2"):
        np.testing.assert_array_equal(
            pb.is_occluded(rays, t_max, engine=engine).numpy(), occ)
    with pytest.raises(ValueError, match="bvh8"):
        tt.TLAS([pb], np.eye(4, dtype=np.float32)[None])


def test_intersect_one_matches_jax(bvhs, rays_np):
    _, pb, jb = bvhs
    o, d = rays_np
    hit_rows = np.nonzero(pb.intersect(tt.make_rays(
        o, d, device="cpu")).prim.numpy() >= 0)[0]
    for i in (int(hit_rows[0]), int(hit_rows[-1])):
        got = pb.intersect_one(o[i], d[i])
        want = jb.intersect_one(o[i], d[i])
        assert set(got) == {"t", "u", "v", "prim"}
        assert got["prim"] == want["prim"] >= 0
        for k in ("t", "u", "v"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4)
    miss = pb.intersect_one(np.array([50.0, 50, 50]), np.array([0.0, 0, 1]))
    assert miss["prim"] == -1 and miss["t"] >= 1e29


def test_refit_without_bvh8_matches_jax():
    """refit on the BVH2 layout: the triangles repacked, no BVH8 made;
    the hits follow the moved triangles as in JAX."""
    tris = random_tris(400, seed=2)
    pb = tt.BVH(tris, layout="bvh2", device="cpu")
    jb = tb.BVH(tris, layout="bvh2")
    moved = (tris + np.float32(0.5)).astype(np.float32)
    pb.refit(moved)
    jb.refit(jnp.asarray(moved))
    assert pb.bvh8 is None
    np.testing.assert_array_equal(pb.packed_tris.numpy(),
                                  np.asarray(jb.packed_tris))
    rng = np.random.default_rng(5)
    o = rng.uniform(-2, 12, (256, 3)).astype(np.float32)
    d = rng.normal(size=(256, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    h = pb.intersect(tt.make_rays(o, d, device="cpu"))
    _assert_hits(h, jb.intersect(tb.make_rays(o, d)))
    _assert_hits(h, brute_force_closest(tt.make_rays(o, d, device="cpu"),
                                        torch.from_numpy(moved)))


def test_refit_drops_rayloop_tables(bvhs, rays_np):
    """After refit the rayloop tables are rebuilt from the refit BVH8: the
    rayloop engine follows the moved triangles."""
    tris, _, _ = bvhs
    pb = tt.BVH(tris, device="cpu")
    o, d = rays_np
    rays = tt.make_rays(o, d, device="cpu")
    pb.intersect(rays, engine="rayloop")
    assert pb._rayloop_tables is not None
    moved = (tris * np.float32(1.1)).astype(np.float32)
    pb.refit(moved)
    assert pb._rayloop_tables is None
    h = pb.intersect(rays, engine="rayloop")
    _assert_hits(h, brute_force_closest(rays, torch.from_numpy(moved)))


@pytest.mark.parametrize("anyhit", [False, True])
def test_rayloop_overflow_retraces_those_rays(bvhs, rays_np, monkeypatch,
                                              anyhit):
    """With a 2-entry rayloop stack most rays overflow; the API re-traces
    exactly those with the lockstep engine, and every ray comes back
    exact (JAX re-traces the whole call: the same hits)."""
    import functools

    from tinybvh_tpu_torch.traverse import rayloop, wide

    _, pb, jb = bvhs
    o, d = rays_np
    rays = tt.make_rays(o, d, device="cpu")
    seen, retraced = [], []
    real_loop = rayloop.is_occluded_rayloop if anyhit else \
        rayloop.intersect_rayloop
    real_deep = wide.is_occluded_bvh8 if anyhit else wide.intersect_bvh8

    def shallow(*a, **kw):
        out = functools.partial(real_loop, S=2)(*a, **kw)
        seen.append(out[1])
        return out

    def deep(bvh8, r, t_max):
        retraced.append(r.o.shape[0])
        return real_deep(bvh8, r, t_max)

    name = "is_occluded" if anyhit else "intersect"
    monkeypatch.setattr(rayloop, f"{name}_rayloop", shallow)
    monkeypatch.setattr(wide, "is_occluded_bvh8" if anyhit
                        else "intersect_bvh8", deep)
    tm = torch.from_numpy(np.random.default_rng(3).uniform(
        2.0, 12.0, 512).astype(np.float32))
    if anyhit:
        got = pb.is_occluded(rays, tm, engine="rayloop").numpy()
        np.testing.assert_array_equal(got, brute_force_any(rays, pb.tris,
                                                           tm).numpy())
    else:
        h = pb.intersect(rays, tm, engine="rayloop")
        _assert_hits(h, brute_force_closest(rays, pb.tris, tm))
        _assert_hits(h, jb.intersect(tb.make_rays(o, d), jnp.asarray(
            tm.numpy()), engine="lockstep"))
    n = int(seen[0].sum())
    assert 0 < n < 512 and retraced == [n]
