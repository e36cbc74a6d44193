"""The port's ops (sphere queries, custom primitives, the voxel DDA, voxel
instances in a TLAS) against the JAX package, on the CPU.

Mirrors tests/test_ops.py's sphere, custom-primitive and voxel tests and
tests/test_tlas.py::test_voxel_blas_in_tlas: each runs the port against
its own oracle as the reference test does, and against the JAX function
on the same numpy inputs (the JAX BVH2 and VoxelSet carried into the
port with convert.from_numpy_bvh2 / from_numpy_voxels). Tolerances are
ROADMAP's parity standard: hits (prim, voxel, instance) equal on every
ray, t within rtol = atol = 1e-4; the sphere queries' booleans equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import tinybvh_tpu as tb  # noqa: E402
from tinybvh_tpu.builders.binned import (  # noqa: E402
    build_binned as j_build_binned, build_binned_aabbs as j_build_aabbs,
)
from tinybvh_tpu.core import intersect as jix  # noqa: E402
from tinybvh_tpu.ops import queries as jq  # noqa: E402
from tinybvh_tpu.ops import voxel as jvx  # noqa: E402
from tinybvh_tpu.tlas import voxel_blas as jvb  # noqa: E402
from tinybvh_tpu.traverse.stack import pack_tris as j_pack_tris  # noqa: E402
from tinybvh_tpu_torch import BVH, TLAS  # noqa: E402
from tinybvh_tpu_torch.convert import (  # noqa: E402
    from_numpy_bvh2, from_numpy_voxels,
)
from tinybvh_tpu_torch.core import intersect as pix  # noqa: E402
from tinybvh_tpu_torch.core.rays import make_rays  # noqa: E402
from tinybvh_tpu_torch.core.vecmath import BVH_FAR  # noqa: E402
from tinybvh_tpu_torch.io.loaders import random_tris, sphere_tris  # noqa: E402
from tinybvh_tpu_torch.ops import queries as pq  # noqa: E402
from tinybvh_tpu_torch.ops import voxel as pvx  # noqa: E402
from tinybvh_tpu_torch.tlas import voxel_blas as pvb  # noqa: E402
from tinybvh_tpu_torch.traverse.stack import pack_tris  # noqa: E402
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


# ---- core helpers ------------------------------------------------------------

def test_tri_aabb_and_sphere_overlap_match_jax():
    """tri_aabb exactly; sphere_tri_overlap on every pair of 64 spheres
    and 300 triangles (all of Ericson's regions reached) equal to JAX's."""
    rng = np.random.default_rng(1)
    tris = random_tris(300, seed=4)
    lo, hi = pix.tri_aabb(torch.from_numpy(tris))
    jlo, jhi = jix.tri_aabb(jnp.asarray(tris))
    np.testing.assert_array_equal(_np(lo), _np(jlo))
    np.testing.assert_array_equal(_np(hi), _np(jhi))
    c = rng.uniform(-1, 11, (64, 3)).astype(np.float32)
    r = rng.uniform(0.5, 4.0, 64).astype(np.float32)
    got = pix.sphere_tri_overlap(
        torch.from_numpy(c)[:, None], torch.from_numpy(r)[:, None],
        *(torch.from_numpy(tris)[None, :, k] for k in range(3)))
    want = jix.sphere_tri_overlap(
        jnp.asarray(c)[:, None], jnp.asarray(r)[:, None],
        *(jnp.asarray(tris)[None, :, k] for k in range(3)))
    np.testing.assert_array_equal(_np(got), _np(want))
    assert 0.01 < _np(got).mean() < 0.9


# ---- sphere query ------------------------------------------------------------

@pytest.mark.parametrize("leaf", [8, 4])
def test_sphere_query_matches_brute_force_and_jax(leaf):
    """intersect_sphere over a BVH2 (JAX's, carried over) equals brute
    force sphere_tri_overlap and the JAX function, sphere by sphere."""
    rng = np.random.default_rng(3)
    tris = random_tris(600, seed=3)
    jbvh = j_build_binned(tris, max_leaf=leaf)
    bvh = from_numpy_bvh2(jbvh, device="cpu")
    packed = pack_tris(bvh, tris)
    q = 128
    centers = rng.uniform(-1, 11, (q, 3)).astype(np.float32)
    radii = rng.uniform(0.05, 1.0, q).astype(np.float32)
    got = pq.intersect_sphere(bvh, packed, centers, radii, leaf_max=leaf)
    t = torch.from_numpy(tris)
    ref = pix.sphere_tri_overlap(
        torch.from_numpy(centers)[:, None], torch.from_numpy(radii)[:, None],
        t[None, :, 0], t[None, :, 1], t[None, :, 2]).any(dim=1)
    np.testing.assert_array_equal(_np(got), _np(ref))
    want = jq.intersect_sphere(jbvh, j_pack_tris(jbvh, jnp.asarray(tris)),
                               centers, radii, leaf_max=leaf)
    np.testing.assert_array_equal(_np(got), _np(want))
    assert 0 < _np(got).mean() < 1


# ---- custom primitives -------------------------------------------------------

def _spheres(rng, n=200):
    centers = rng.uniform(0, 10, (n, 3)).astype(np.float32)
    radii = rng.uniform(0.1, 0.4, n).astype(np.float32)
    return centers, radii


def _sphere_isect(xp, cs, rs):
    """The tiny_bvh_custom.cpp ray/sphere test in either array module."""
    def isect(o, d, pid, t_cur):
        c = cs[pid]
        r = rs[pid]
        oc = o[:, None, :] - c
        b = (oc * d[:, None, :]).sum(-1)
        cc = (oc * oc).sum(-1) - r * r
        disc = b * b - cc
        ok = disc >= 0
        sq = xp.sqrt(xp.maximum(disc, 0 * disc))
        t0 = -b - sq
        t1 = -b + sq
        th = xp.where(t0 > 1e-5, t0, t1)
        hit = ok & (th > 1e-5) & (th < t_cur[:, None])
        return hit, xp.where(hit, th, BVH_FAR), th * 0, th * 0
    return isect


def test_custom_sphere_primitives():
    """A BVH over sphere AABBs with the analytic ray/sphere test (the
    tiny_bvh_custom.cpp setup): brute force and the JAX function."""
    rng = np.random.default_rng(7)
    centers, radii = _spheres(rng)
    jbvh = j_build_aabbs(centers - radii[:, None], centers + radii[:, None],
                         max_leaf=4)
    bvh = from_numpy_bvh2(jbvh, device="cpu")
    o = rng.uniform(-2, 12, (256, 3)).astype(np.float32)
    d = rng.normal(size=(256, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    hits = pq.intersect_custom(
        bvh, make_rays(o, d, device="cpu"),
        _sphere_isect(torch, torch.from_numpy(centers),
                      torch.from_numpy(radii)), leaf_max=4)

    oc = o[:, None, :] - centers[None]
    b = np.einsum("rlk,rk->rl", oc, d)
    cc = np.einsum("rlk,rlk->rl", oc, oc) - radii[None] ** 2
    disc = b * b - cc
    sq = np.sqrt(np.maximum(disc, 0))
    th = np.where(-b - sq > 1e-5, -b - sq, -b + sq)
    th = np.where((disc >= 0) & (th > 1e-5), th, BVH_FAR)
    ref_t = th.min(axis=1)
    miss = ref_t >= BVH_FAR
    np.testing.assert_array_equal(_np(hits.prim) < 0, miss)
    np.testing.assert_allclose(_np(hits.t)[~miss], ref_t[~miss], rtol=1e-4,
                               atol=1e-5)

    jh = jq.intersect_custom(
        jbvh, tb.make_rays(o, d),
        _sphere_isect(jnp, jnp.asarray(centers), jnp.asarray(radii)),
        leaf_max=4)
    np.testing.assert_array_equal(_np(hits.prim), _np(jh.prim))
    np.testing.assert_allclose(_np(hits.t), _np(jh.t), rtol=1e-4, atol=1e-4)
    assert 0 < (~miss).mean() < 1


# ---- voxel DDA ----------------------------------------------------------------

def _both_voxels(xs, ys, zs):
    """The same voxels set in both packages' VoxelSets; returns (JAX
    frozen dict, port frozen dict); the grids and pools are equal."""
    jv, pv = jvx.VoxelSet(), pvx.VoxelSet()
    jv.set(xs, ys, zs)
    pv.set(xs, ys, zs)
    jf, pf = jv.freeze(), pv.freeze(device="cpu")
    for k in jf:
        np.testing.assert_array_equal(_np(pf[k]), _np(jf[k]), err_msg=k)
    return jf, pf


def _same_voxel_hits(got, want):
    t, n, v = map(_np, got)
    jt, jn, jv = map(_np, want)
    np.testing.assert_array_equal(t >= BVH_FAR, jt >= BVH_FAR)
    h = t < BVH_FAR
    np.testing.assert_allclose(t[h], jt[h], rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(v[h], jv[h])
    np.testing.assert_array_equal(n[h], jn[h])


def test_voxel_dda_axis_rays():
    jf, pf = _both_voxels([100], [128], [128])
    d = np.array([[1.0, 0.0, 0.0]], np.float32)
    o = np.array([[-1.0, 128.5 / 256, 128.5 / 256]], np.float32)
    t, n, v = pvx.intersect_voxels(pf, make_rays(o, d, device="cpu"))
    np.testing.assert_allclose(float(t[0]), 1.0 + 100 / 256, rtol=1e-4)
    np.testing.assert_array_equal(_np(v)[0], [100, 128, 128])
    np.testing.assert_allclose(_np(n)[0], [-1, 0, 0], atol=1e-6)
    _same_voxel_hits((t, n, v), jvx.intersect_voxels(jf, tb.make_rays(o, d)))
    o2 = np.array([[-1.0, 0.9, 0.5]], np.float32)
    t2, _, _ = pvx.intersect_voxels(pf, make_rays(o2, d, device="cpu"))
    assert float(t2[0]) >= BVH_FAR


def _march(o, d, occ, t_end=3.0, n=12000):
    """First occupied voxel along each ray by fine sampling (the
    reference test's ground truth): voxel coordinate or None."""
    out = []
    for i in range(o.shape[0]):
        ts = np.linspace(0, t_end, n)
        ip = np.floor((o[i][None] + ts[:, None] * d[i][None]) * 256)
        ip = ip.astype(int)
        ok = ((ip >= 0) & (ip < 256)).all(axis=1)
        c = ip.clip(0, 255)
        k = np.nonzero(ok & occ[c[:, 0], c[:, 1], c[:, 2]])[0]
        out.append(ip[k[0]] if k.size else None)
    return out


def test_voxel_dda_random_rays_vs_sampling():
    """The DDA's first voxel equals dense ray marching on a blob of 400
    voxels, and the JAX DDA's hits (t, normal, voxel)."""
    rng = np.random.default_rng(11)
    p = rng.integers(60, 196, (400, 3))
    jf, pf = _both_voxels(p[:, 0], p[:, 1], p[:, 2])
    occ = np.zeros((256, 256, 256), bool)
    occ[p[:, 0], p[:, 1], p[:, 2]] = True
    o = rng.uniform(-0.5, 1.5, (64, 3)).astype(np.float32)
    d = rng.normal(size=(64, 3)).astype(np.float32)
    # half the rays aim at voxel centres, so that some hit
    d[:32] = (p[rng.integers(0, 400, 32)] + 0.5) / 256.0 - o[:32]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    got = pvx.intersect_voxels(pf, make_rays(o, d, device="cpu"))
    t, v = _np(got[0]), _np(got[2])
    for i, first in enumerate(_march(o, d, occ)):
        if first is None:
            assert t[i] >= BVH_FAR, i
        else:
            assert t[i] < BVH_FAR, i
            np.testing.assert_array_equal(v[i], first, err_msg=str(i))
    _same_voxel_hits(got, jvx.intersect_voxels(jf, tb.make_rays(o, d)))
    assert (t < BVH_FAR).any() and (t >= BVH_FAR).any()


def test_voxel_topgrid_matches_two_level():
    """The three-level DDA (topgrid) returns exactly the hits of the
    two-level walk, and both equal the JAX DDA's."""
    rng = np.random.default_rng(13)
    pts = (rng.integers(0, 4, (40, 3)) * 64
           + rng.integers(0, 8, (40, 3))).astype(np.int64)
    jf, pf = _both_voxels(pts[:, 0], pts[:, 1], pts[:, 2])
    pf2 = {k: val for k, val in pf.items() if k != "top"}
    o = rng.uniform(-0.5, 1.5, (256, 3)).astype(np.float32)
    tgt = (pts[rng.integers(0, 40, 256)] + 0.5) / 256.0
    d = tgt.astype(np.float32) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = make_rays(o, d, device="cpu")
    t3, n3, v3 = pvx.intersect_voxels(pf, rays)
    t2, n2, v2 = pvx.intersect_voxels(pf2, rays)
    np.testing.assert_allclose(_np(t3), _np(t2), rtol=1e-5)
    np.testing.assert_array_equal(_np(v3), _np(v2))
    assert (_np(t3) < 1e29).mean() > 0.5
    _same_voxel_hits((t3, n3, v3), jvx.intersect_voxels(jf,
                                                        tb.make_rays(o, d)))
    occ = pvx.is_occluded_voxels(pf, rays, 1.0)
    np.testing.assert_array_equal(_np(occ), _np(t3) < 1.0)


def test_voxel_set_allocation_matches_jax():
    """Bricks are allocated in the order voxels first reach them, over
    several set() calls with repeats and a cleared voxel, as JAX's."""
    rng = np.random.default_rng(17)
    jv, pv = jvx.VoxelSet(), pvx.VoxelSet()
    for _ in range(3):
        p = rng.integers(0, 256, (300, 3))
        p = np.concatenate([p, p[:20]])
        jv.set(p[:, 0], p[:, 1], p[:, 2])
        pv.set(p[:, 0], p[:, 1], p[:, 2])
    jv.set([p[0, 0]], [p[0, 1]], [p[0, 2]], value=False)
    pv.set([p[0, 0]], [p[0, 1]], [p[0, 2]], value=False)
    jf, pf = jv.freeze(), pv.freeze(device="cpu")
    for k in jf:
        np.testing.assert_array_equal(_np(pf[k]), _np(jf[k]), err_msg=k)
    carried = from_numpy_voxels({k: _np(a) for k, a in jf.items()},
                                device="cpu")
    for k in pf:
        assert torch.equal(carried[k], pf[k]), k


# ---- voxel instances in a TLAS ------------------------------------------------

def _mat(translate=(0, 0, 0), scale=1.0):
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] *= scale
    m[:3, 3] = translate
    return m


def test_voxel_blas_in_tlas():
    """A VoxelSet as a TLAS leaf (tests/test_tlas.py's scene): triangle
    and voxel hits min-fold into one Hits record, against the triangle
    TLAS plus the DDA in the instance frame, and against the JAX
    functions."""
    rng = np.random.default_rng(7)
    tris = sphere_tris(8, 12, radius=0.8)
    tlas = TLAS([BVH(tris, device="cpu")], np.eye(4, dtype=np.float32)[None])
    jtlas = tb.TLAS([tb.BVH(tris)], np.eye(4, dtype=np.float32)[None])
    xs, ys, zs = np.meshgrid(np.arange(40, 216), np.arange(100, 130),
                             np.arange(40, 216), indexing="ij")
    jf, pf = _both_voxels(xs.ravel(), ys.ravel(), zs.ravel())
    m = _mat(translate=(3.0, -2.0, 0.0), scale=4.0)
    vi = pvb.voxel_instance(pf, m)
    jvi = jvb.voxel_instance(jf, m)

    o = rng.uniform(-4, 8, (256, 3)).astype(np.float32)
    d = rng.normal(size=(256, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = make_rays(o, d, device="cpu")
    hits, _ = pvb.intersect_tlas_voxels(tlas._impl, [vi], rays)

    h_tri = tlas.intersect(rays)
    minv = np.linalg.inv(m)
    o2 = o @ minv[:3, :3].T + minv[:3, 3]
    d2 = d @ minv[:3, :3].T
    tv, _, _ = pvx.intersect_voxels(pf, make_rays(o2, d2, device="cpu"))
    tv, tt = _np(tv), _np(h_tri.t)
    want_t = np.minimum(tv, tt)
    np.testing.assert_allclose(_np(hits.t), want_t, rtol=1e-4, atol=1e-5)
    vox_wins = tv < tt
    assert vox_wins.any() and (~vox_wins & (tt < BVH_FAR / 2)).any()
    np.testing.assert_array_equal(_np(hits.inst)[vox_wins], 1)
    assert (_np(hits.prim)[vox_wins] >= 0).all()

    jr = tb.make_rays(o, d)
    jh, _ = jvb.intersect_tlas_voxels(jtlas._impl, [jvi], jr)
    for k in ("prim", "inst"):
        np.testing.assert_array_equal(_np(getattr(hits, k)),
                                      _np(getattr(jh, k)), err_msg=k)
    for k in ("t", "u", "v"):
        np.testing.assert_allclose(_np(getattr(hits, k)),
                                   _np(getattr(jh, k)), rtol=1e-4,
                                   atol=1e-4, err_msg=k)

    occ, _ = pvb.is_occluded_tlas_voxels(tlas._impl, [vi], rays, 6.0)
    np.testing.assert_array_equal(_np(occ), want_t < 6.0)
    jocc, _ = jvb.is_occluded_tlas_voxels(jtlas._impl, [jvi], jr, 6.0)
    np.testing.assert_array_equal(_np(occ), _np(jocc))

    # a masked-out voxel instance contributes nothing
    vi_masked = pvb.voxel_instance(pf, m, mask=0x0002)
    rays1 = make_rays(o, d, mask=np.full(256, 0x0001, np.int32),
                      device="cpu")
    h2, _ = pvb.intersect_tlas_voxels(tlas._impl, [vi_masked], rays1)
    np.testing.assert_allclose(_np(h2.t), tt, rtol=1e-4, atol=1e-5)
