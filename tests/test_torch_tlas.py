"""The port's TLAS (tlas/instance.py, api.TLAS) against the JAX package,
on the CPU.

The first eight tests mirror tests/test_tlas.py (all but the voxel BLAS
test, which tests/test_torch_ops.py mirrors) on the port alone, against its
brute-force oracle and its own engines. The rest hold the port to the
JAX functions on the same numpy inputs: the TLAS tables (bounds, child,
inst_inv, inst_mask, inst_root, merged leaves) bit for bit, for the host
and the device merge and for singular transforms; intersect_tlas8 and
intersect_tlas_wavefront (closest hit, any hit, the packed winner, the
overflow flag) with prim and inst equal except exact ties (both t within
a relative 1e-6), t within rtol = atol = 1e-4, u and v within 1e-3.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import tinybvh_tpu as tb  # noqa: E402
from tinybvh_tpu.core import vecmath as jvm  # noqa: E402
from tinybvh_tpu.tlas import instance as ji  # noqa: E402
from tinybvh_tpu_torch import BVH, TLAS, make_rays  # noqa: E402
from tinybvh_tpu_torch.convert import from_numpy_tlas8  # noqa: E402
from tinybvh_tpu_torch.core import vecmath as pvm  # noqa: E402
from tinybvh_tpu_torch.core.intersect import brute_force_closest  # noqa: E402
from tinybvh_tpu_torch.io.loaders import random_tris, sphere_tris  # noqa: E402
from tinybvh_tpu_torch.tlas import instance as pi  # noqa: E402
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


def _mat(translate=(0, 0, 0), scale=1.0, yaw=0.0):
    m = np.eye(4, dtype=np.float32)
    c, s = np.cos(yaw), np.sin(yaw)
    m[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]]) * scale
    m[:3, 3] = translate
    return m


def _world_tris(tris, m):
    return (np.asarray(tris) @ m[:3, :3].T + m[:3, 3]).astype(np.float32)


def _ray_arrays(rng, n, lo=-5, hi=15):
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _rays(rng, n, lo=-5, hi=15):
    return make_rays(*_ray_arrays(rng, n, lo, hi), device="cpu")


def _bvh(tris):
    return BVH(tris, device="cpu")


def _brute(rays, world):
    return brute_force_closest(rays, torch.as_tensor(world))


def _assert_t(h, ref, rtol, atol):
    miss = _np(ref.prim) < 0
    np.testing.assert_array_equal(_np(h.prim) < 0, miss)
    np.testing.assert_allclose(_np(h.t)[~miss], _np(ref.t)[~miss],
                               rtol=rtol, atol=atol)
    return miss


# ---- mirrors of tests/test_tlas.py ---------------------------------------

def test_single_instance_identity():
    rng = np.random.default_rng(41)
    tris = random_tris(300, seed=41)
    tlas = TLAS([_bvh(tris)], np.eye(4, dtype=np.float32)[None])
    rays = _rays(rng, 128)
    h = tlas.intersect(rays)
    miss = _assert_t(h, _brute(rays, tris), 1e-4, 1e-5)
    assert (_np(h.inst)[~miss] == 0).all()


def test_grid_of_instances_matches_flattened():
    """2x2x2 instance grid (tiny_bvh_anim.cpp:147-165) equals brute force
    over the flattened world geometry."""
    rng = np.random.default_rng(50)
    tris = sphere_tris(8, 12, radius=0.8)
    mats, world = [], []
    for i in range(8):
        m = _mat(translate=(4.0 * (i & 1), 4.0 * ((i >> 1) & 1),
                            4.0 * (i >> 2)), scale=0.7 + 0.1 * i, yaw=0.3 * i)
        mats.append(m)
        world.append(_world_tris(tris, m))
    tlas = TLAS([_bvh(tris)], np.stack(mats))
    rays = _rays(rng, 256, -3, 8)
    h = tlas.intersect(rays)
    ref = _brute(rays, np.concatenate(world))
    miss = _assert_t(h, ref, 2e-4, 1e-4)
    # instance + local prim identify the same world triangle
    got = _np(h.inst) * tris.shape[0] + _np(h.prim)
    assert (got[~miss] == _np(ref.prim)[~miss]).mean() > 0.95


def test_mixed_blases():
    rng = np.random.default_rng(51)
    trisA = random_tris(200, seed=51)
    trisB = sphere_tris(8, 12, radius=1.2)
    pairs = [(0, _mat((0, 0, 0))), (1, _mat((12, 0, 0))),
             (1, _mat((0, 12, 0), scale=2.0))]
    tlas = TLAS([_bvh(trisA), _bvh(trisB)], pairs)
    world = np.concatenate([_world_tris(trisA, pairs[0][1]),
                            _world_tris(trisB, pairs[1][1]),
                            _world_tris(trisB, pairs[2][1])])
    rays = _rays(rng, 256, -3, 16)
    _assert_t(tlas.intersect(rays), _brute(rays, world), 2e-4, 1e-4)


def test_instance_masks():
    tris = sphere_tris(8, 12)
    mats = np.stack([_mat((0, 0, 0)), _mat((0, 0, 0))])  # co-located
    tlas = TLAS([_bvh(tris)], mats, masks=[0x0001, 0x0002])
    o = np.zeros((4, 3), np.float32)
    d = np.tile(np.float32([[1, 0, 0]]), (4, 1))

    def hits(mask):
        return tlas.intersect(make_rays(o, d, mask=np.full(4, mask, np.int32),
                                        device="cpu"))
    assert (_np(hits(0x0001).inst) == 0).all()
    assert (_np(hits(0x0002).inst) == 1).all()
    assert (_np(hits(0x0004).prim) == -1).all()   # sees nothing


def test_tlas_occlusion():
    tris = sphere_tris(10, 16)
    tlas = TLAS([_bvh(tris)], np.stack([_mat((0, 0, 0)), _mat((5, 0, 0))]))
    r = make_rays(np.float32([[-3, 0, 0]]), np.float32([[1, 0, 0]]),
                  device="cpu")
    assert bool(tlas.is_occluded(r, t_max=10.0)[0])
    assert not bool(tlas.is_occluded(r, t_max=1.0)[0])  # sphere at x=-1


def test_tlas_occlusion_early_exit_vs_brute_force():
    """The any-hit wavefront occlusion (≙ IsOccludedTLAS, tiny_bvh.h:3455)
    agrees with brute force over the flattened geometry."""
    rng = np.random.default_rng(52)
    tris = sphere_tris(6, 10)
    offs = [(0, 0, 0), (3, 1, 0), (-2, -1, 2)]
    tlas = TLAS([_bvh(tris)], np.stack([_mat(t) for t in offs]))
    world = np.concatenate([tris + np.array(t, np.float32) for t in offs])
    rays = _rays(rng, 256, -6, 6)
    ref = _brute(rays, world)
    for t_max in (0.5, 2.0, 1e30):
        np.testing.assert_array_equal(_np(tlas.is_occluded(rays, t_max)),
                                      _np(ref.t) < t_max)


def _mixed_scene():
    trisA = random_tris(300, seed=61)
    trisB = sphere_tris(8, 12, radius=1.2)
    pairs = [(0, _mat((0, 0, 0))), (1, _mat((12, 0, 0))),
             (1, _mat((0, 12, 0), scale=2.0))]
    return trisA, trisB, pairs


def test_tlas_wavefront_matches_lockstep():
    rng = np.random.default_rng(53)
    trisA, trisB, pairs = _mixed_scene()
    tlas = TLAS([_bvh(trisA), _bvh(trisB)], pairs)
    rays = _rays(rng, 512, -3, 16)
    h_ref = pi.intersect_tlas8(tlas._impl, rays)
    h_wf, ovf = pi.intersect_tlas_wavefront(tlas._impl, rays)
    assert not ovf
    _assert_t(h_wf, h_ref, 1e-5, 1e-6)
    np.testing.assert_array_equal(_np(h_wf.inst), _np(h_ref.inst))


def test_tlas_wavefront_masks():
    tris = sphere_tris(8, 12)
    tlas = TLAS([_bvh(tris)], np.stack([_mat(), _mat()]),
                masks=[0x0001, 0x0002])
    r2 = make_rays(np.zeros((4, 3), np.float32),
                   np.tile(np.float32([[1, 0, 0]]), (4, 1)),
                   mask=np.full(4, 0x0002, np.int32), device="cpu")
    h2, _ = pi.intersect_tlas_wavefront(tlas._impl, r2)
    assert (_np(h2.inst) == 1).all()


# ---- parity with the JAX package -----------------------------------------

def _same_bits(a, b, what=""):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert a.tobytes() == b.tobytes(), what


_TABLES = ("bounds", "child", "leaf_tris", "leaf_prim", "inst_inv",
           "inst_mask", "inst_root")


def _same_tables(p, j):
    for k in _TABLES:
        _same_bits(getattr(p, k), getattr(j, k), k)
    assert p.n_leaf_rows == j.n_leaf_rows


@pytest.fixture(scope="module")
def mixed():
    """The mixed two-BLAS scene with masks, in both packages."""
    trisA, trisB, pairs = _mixed_scene()
    masks = [0xFFFF, 0x0003, 0x0002]
    jt = tb.TLAS([tb.BVH(trisA), tb.BVH(trisB)], pairs, masks=masks)
    pt = TLAS([_bvh(trisA), _bvh(trisB)], pairs, masks=masks)
    return trisA, trisB, pairs, masks, jt, pt


@pytest.mark.parametrize("merge", ["host", "device"])
def test_build_tlas_tables_match_jax(mixed, merge):
    """Host merge (api.TLAS over BVHs with host copies) and device merge
    (raw BVH8s) give the JAX package's tables bit for bit."""
    trisA, trisB, pairs, masks, jt, pt = mixed
    if merge == "host":
        _same_tables(pt._impl, jt._impl)
    else:
        jb = [tb.BVH(t).bvh8 for t in (trisA, trisB)]
        pb = [_bvh(t).bvh8 for t in (trisA, trisB)]
        _same_tables(pi.build_tlas(pb, pairs, masks=masks, device="cpu"),
                     ji.build_tlas(jb, pairs, masks=masks))
        _same_tables(TLAS(pb, pairs, masks=masks)._impl, jt._impl)


def test_singular_transform_and_cached_merge_match_jax(mixed):
    """A zero-scale instance gets the identity inverse and mask 0 (never
    hit), in both packages; a cached merge rebuilds the TLAS rows per
    frame, on the host merge and after to_device, equal to JAX's."""
    trisA, trisB, pairs, masks, _, _ = mixed
    hosts = [_bvh(t)._bvh8_host for t in (trisA, trisB)]
    jb = [tb.BVH(t).bvh8 for t in (trisA, trisB)]
    pb = [_bvh(t).bvh8 for t in (trisA, trisB)]
    frames = [pairs, [(0, _mat((1, 2, 3), scale=0.0)), (1, _mat((5, 0, 0)))]]
    pm = pi.merge_blas_tables(pb, host8s=hosts)
    jm = ji.merge_blas_tables(jb, host8s=hosts)
    for i, tr in enumerate(frames):
        mk = masks[:len(tr)]
        _same_tables(pi.build_tlas_from_merged(pm, tr, masks=mk,
                                               device="cpu"),
                     ji.build_tlas_from_merged(jm, tr, masks=mk))
        if i == 0:
            pm.to_device("cpu")
    tl = pi.build_tlas_from_merged(pm, frames[1], device="cpu")
    assert _np(tl.inst_mask).tolist() == [0, 0xFFFF]
    np.testing.assert_array_equal(_np(tl.inst_inv[0]), np.eye(4))
    rays = make_rays(np.float32([[1, 2, -5]]), np.float32([[0, 0, 1]]),
                     device="cpu")
    assert int(pi.intersect_tlas8(tl, rays).prim[0]) == -1


def test_custom_tlas_builder(mixed):
    """builder(wlo, whi) -> BVH2 replaces the binned SAH over the
    instance boxes (here the median split), as in JAX."""
    from tinybvh_tpu.builders.binned import build_binned_aabbs as jbuild
    from tinybvh_tpu_torch.builders.binned import build_binned_aabbs

    trisA, trisB, pairs, _, _, _ = mixed
    pb = [_bvh(t).bvh8 for t in (trisA, trisB)]
    jb = [tb.BVH(t).bvh8 for t in (trisA, trisB)]
    got = pi.build_tlas(pb, pairs, device="cpu", builder=lambda lo, hi:
                        build_binned_aabbs(lo, hi, strategy="median",
                                           device="cpu"))
    want = ji.build_tlas(jb, pairs, builder=lambda lo, hi: jbuild(
        lo, hi, strategy="median"))
    _same_tables(got, want)


def _jax_rays(o, d, mask=None):
    return tb.make_rays(o, d) if mask is None else tb.make_rays(o, d,
                                                                mask=mask)


def assert_hits_match(h, j, inst=True):
    """prim (and inst) equal except exact ties; t, u, v within the
    tolerances where prim agrees."""
    p, pr = _np(h.prim), _np(j.prim)
    t, tr = _np(h.t), _np(j.t)
    diff = (p != pr) | ((_np(h.inst) != _np(j.inst)) if inst else False)
    tie = np.abs(t - tr) <= 1e-6 * np.maximum(np.abs(tr), 1e-30)
    assert not (diff & ~tie).any(), f"{int((diff & ~tie).sum())} rays"
    m = ~diff & (pr >= 0)
    np.testing.assert_allclose(t[m], tr[m], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(h.u)[m], _np(j.u)[m], rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_allclose(_np(h.v)[m], _np(j.v)[m], rtol=1e-3,
                               atol=1e-3)


def _mixed_rays(seed, n=512):
    """Rays from around the scene aimed into the instances' region, with
    mixed visibility masks."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 16, (n, 3)).astype(np.float32)
    d = (rng.uniform(-1, 13, (n, 3)) * np.float32([1, 1, 0.3])
         - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    mask = rng.choice(np.int32([0xFFFF, 0x0001, 0x0002]), n)
    return o, d, mask


@pytest.mark.parametrize("t_max", ["far", "per_ray"])
def test_intersect_tlas8_matches_jax(mixed, t_max):
    _, _, _, _, jt, pt = mixed
    o, d, mask = _mixed_rays(7)
    tm = (1e30 if t_max == "far"
          else np.random.default_rng(8).uniform(2, 20, 512).astype(
              np.float32))
    h, steps = pi.intersect_tlas8(pt._impl, make_rays(o, d, mask=mask,
                                                      device="cpu"),
                                  torch.as_tensor(tm), with_steps=True)
    j = ji.intersect_tlas8(jt._impl, _jax_rays(o, d, mask), jnp.asarray(tm))
    assert steps > 0
    assert (_np(h.prim) >= 0).mean() > 0.05
    assert_hits_match(h, j)


@pytest.mark.parametrize("mode", ["closest", "any_hit", "return_winner",
                                  "overflow"])
def test_intersect_tlas_wavefront_matches_jax(mode):
    """The two-level wavefront on a dense instance grid of a random soup:
    hits, the any-hit flags, the packed winner and, at cap 1, the
    overflow flag equal the JAX engine's."""
    tris = random_tris(400, seed=3, extent=4.0, size=0.5)
    mats = np.stack([_mat((3.0 * i, 3.0 * j, 0), yaw=0.5 * (i + j))
                     for i in range(3) for j in range(3)])
    jt = ji.build_tlas([tb.BVH(tris).bvh8], mats)
    pt = from_numpy_tlas8(jt, device="cpu")
    _same_tables(pt, jt)
    rng = np.random.default_rng(12)
    o = np.tile(np.float32([[5.0, 5.0, -12.0]]), (384, 1))
    d = np.column_stack([rng.uniform(-0.6, 0.6, (384, 2)),
                         np.ones(384)]).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pr, jr = make_rays(o, d, device="cpu"), _jax_rays(o, d)
    t_max = 14.0 if mode == "any_hit" else 1e30
    kw = dict(cap_factor=1 if mode == "overflow" else 24,
              any_hit=mode == "any_hit",
              return_winner=mode == "return_winner")
    got = pi.intersect_tlas_wavefront(pt, pr, t_max, **kw)
    want = ji.intersect_tlas_wavefront(jt, jr, t_max, **kw)
    assert got[-1] == bool(want[-1])
    if mode == "overflow":
        assert got[-1]
        return
    assert not got[-1]
    assert_hits_match(got[0], want[0])
    if mode == "any_hit":
        occ = _np(got[1])
        np.testing.assert_array_equal(occ, _np(want[1]))
        assert 0 < occ.mean() < 1
    if mode == "return_winner":
        np.testing.assert_array_equal(_np(got[1]), _np(want[1]))
    if mode != "any_hit":   # any-hit hits need not be the closest
        assert_hits_match(got[0], pi.intersect_tlas8(pt, pr, t_max))


def test_is_occluded_tlas8_matches_jax(mixed):
    _, _, _, _, jt, pt = mixed
    o, d, mask = _mixed_rays(9)
    for t_max, cap in ((3.0, 4), (1e30, 1)):
        got = pi.is_occluded_tlas8(pt._impl, make_rays(o, d, mask=mask,
                                                       device="cpu"),
                                   t_max, cap_factor=cap)
        want = ji.is_occluded_tlas8(jt._impl, _jax_rays(o, d, mask), t_max,
                                    cap_factor=cap)
        np.testing.assert_array_equal(_np(got), _np(want))


def test_api_tlas_matches_jax(mixed):
    """TLAS.intersect / is_occluded through the API: the same hits as the
    JAX TLAS's."""
    _, _, _, _, jt, pt = mixed
    o, d, mask = _mixed_rays(10)
    pr = make_rays(o, d, mask=mask, device="cpu")
    jr = _jax_rays(o, d, mask)
    assert_hits_match(pt.intersect(pr), jt.intersect(jr))
    np.testing.assert_array_equal(_np(pt.is_occluded(pr, 5.0)),
                                  _np(jt.is_occluded(jr, 5.0)))
    with pytest.raises(TypeError):
        TLAS([np.zeros(3)], np.eye(4, dtype=np.float32)[None])


def test_merge_leaf_attrs_matches_jax(mixed):
    trisA, trisB, _, _, _, _ = mixed
    jb = [tb.BVH(t).bvh8 for t in (trisA, trisB)]
    pb = [_bvh(t).bvh8 for t in (trisA, trisB)]
    attrs = [np.arange(t.shape[0] * 2, dtype=np.float32).reshape(-1, 2)
             for t in (trisA, trisB)]
    _same_bits(pi.merge_leaf_attrs(pb, attrs),
               ji.merge_leaf_attrs(jb, attrs))


def test_vecmath_transforms_match_jax():
    """mat3_apply and the transforms: products summed left to right in
    f32, as the JAX package's XLA reduction sums them on the CPU."""
    rng = np.random.default_rng(1)
    m = rng.normal(size=(64, 4, 4)).astype(np.float32) * 3
    p = rng.normal(size=(64, 3)).astype(np.float32) * 100
    lo = p - np.abs(rng.normal(size=(64, 3))).astype(np.float32)
    tm, tp, tlo = (torch.from_numpy(x) for x in (m, p, lo))
    _same_bits(pvm.mat3_apply(tm[:, :3, :3], tp),
               jvm.mat3_apply(jnp.asarray(m[:, :3, :3]), jnp.asarray(p)))
    _same_bits(pvm.transform_point(tm, tp),
               jvm.transform_point(jnp.asarray(m), jnp.asarray(p)))
    _same_bits(pvm.transform_vector(tm, tp),
               jvm.transform_vector(jnp.asarray(m), jnp.asarray(p)))
    for a, b in zip(pvm.transform_aabb(tm, tlo, tp),
                    jvm.transform_aabb(jnp.asarray(m), jnp.asarray(lo),
                                       jnp.asarray(p))):
        _same_bits(a, b)
    np.testing.assert_allclose(_np(pvm.mat4_inverse(tm)),
                               _np(jvm.mat4_inverse(jnp.asarray(m))),
                               rtol=1e-3, atol=1e-3)
    _same_bits(pvm.half_area(tlo, tp),
               jvm.half_area(jnp.asarray(lo), jnp.asarray(p)))
