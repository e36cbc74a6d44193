"""The port's v1 packet engine against the JAX package, on the CPU.

The same inputs (numpy, from a seed) go through the JAX function and its
counterpart in tinybvh_tpu_torch.traverse (packet, leaf_resolve,
frustum_walk). The JAX Pallas kernels run in interpret mode, as
tests/test_packet.py:72-73 runs them; the port's wrappers pick the
kernels' plain twins for CPU tensors. The BVH8 is the JAX package's
(`collapse_bvh2(build_binned(...))`), carried over with
convert.from_numpy_bvh8, so both trace the same tables.

Tolerances (tests/test_packet.py): leaf lists, counts, overflow masks,
row positions, packed winners and prims equal; t within rtol = atol =
1e-5 against JAX and 1e-4 against brute force.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tinybvh_tpu.builders.binned import build_binned  # noqa: E402
from tinybvh_tpu.core.rays import make_rays as j_make_rays  # noqa: E402
from tinybvh_tpu.io.loaders import random_tris, sphere_tris  # noqa: E402
from tinybvh_tpu.layouts.mbvh import collapse_bvh2  # noqa: E402
from tinybvh_tpu.render.camera import auto_camera  # noqa: E402
from tinybvh_tpu.traverse import packet as jpk  # noqa: E402
from tinybvh_tpu.traverse.pallas_frustum import (  # noqa: E402
    collect_tile_leaves_pallas,
)
from tinybvh_tpu.traverse.pallas_leaf import (  # noqa: E402
    leaf_resolve as j_leaf_resolve, leaf_resolve_v2 as j_leaf_resolve_v2,
)
from tinybvh_tpu_torch.convert import from_numpy_bvh8  # noqa: E402
from tinybvh_tpu_torch.core.intersect import brute_force_closest  # noqa: E402
from tinybvh_tpu_torch.core.rays import make_rays  # noqa: E402
from tinybvh_tpu_torch.traverse import frustum_walk as fw  # noqa: E402
from tinybvh_tpu_torch.traverse import leaf_resolve as lr  # noqa: E402
from tinybvh_tpu_torch.traverse import packet as pk  # noqa: E402

I32MAX = 2**31 - 1
# leaf budgets that fit every tile of each scene's 32x32 rays (the random
# scene's tiles list 711-808 leaves)
_K = {"sphere": 512, "random": 1024, "small_sphere": 512}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """One test file per worker process: keep torch's intra-op pool small
    so the workers do not oversubscribe the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _tiled_rays(lo, hi, W=32, H=32):
    """tests/test_packet.py's primary rays in 16x16 tile order (numpy)."""
    eye, fwd, right, up = auto_camera(lo, hi)
    xs = (np.arange(W) + 0.5) / W - 0.5
    ys = (np.arange(H) + 0.5) / H - 0.5
    gx, gy = np.meshgrid(xs, ys)
    d = (fwd[None, None] + 0.9 * gx[..., None] * right[None, None]
         + 0.9 * gy[..., None] * up[None, None])
    d = d / np.linalg.norm(d, axis=2, keepdims=True)
    d = d.reshape(H // 16, 16, W // 16, 16, 3).transpose(0, 2, 1, 3, 4)
    d = d.reshape(-1, 3).astype(np.float32)
    return np.broadcast_to(eye.astype(np.float32), d.shape).copy(), d


def _wide_rays(T, seed=0):
    """T tiles of rays in every direction from the scene's middle: all-pass
    frusta, so every node is visited and the pair frontier is wide."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(T * 256, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return np.full_like(d, 5.0), d


_SCENES = {}


def _scene(name):
    """(tris, JAX BVH8, port BVH8, numpy o, d) per scene, built once."""
    if name not in _SCENES:
        if name == "sphere":
            tris = sphere_tris(24, 48, radius=2.0, center=(0, 0, 0))
        elif name == "small_sphere":
            tris = sphere_tris(16, 32, radius=1.0, center=(0, 0, 0))
        else:
            tris = random_tris(3000, seed=77)
        jb8 = collapse_bvh2(build_binned(tris, max_leaf=4), tris)
        lo, hi = tris.min(axis=(0, 1)), tris.max(axis=(0, 1))
        o, d = _wide_rays(96) if name == "wide" else _tiled_rays(lo, hi)
        _SCENES[name] = (tris, jb8, from_numpy_bvh8(jb8, device="cpu"), o, d)
    return _SCENES[name]


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def _tile_inputs(o, d):
    T = o.shape[0] // 256
    return T, o.reshape(T, 256, 3), d.reshape(T, 256, 3)


@pytest.mark.parametrize("flat", [False, True])
@pytest.mark.parametrize("name,max_leaves,pcf", [
    ("sphere", 512, 64), ("random", 1024, 64),
    ("random", 512, 64),     # lists overflow
    ("wide", 4096, 1),       # the pair frontier passes its cap: all flagged
])
def test_collect_tile_leaves_matches_jax(name, max_leaves, pcf, flat):
    """Both plain-torch phase-1 forms give JAX's lists (same slots, same
    order) and overflow masks, overflow cases included."""
    _, jb8, b8, o, d = _scene(name)
    T, o3, d3 = _tile_inputs(o, d)
    if flat:
        got = pk.collect_tile_leaves_flat(
            b8, torch.from_numpy(o3[:, 0]), torch.from_numpy(d3),
            max_leaves, pcf)
        want = jpk.collect_tile_leaves_flat(
            jb8, jnp.asarray(o3[:, 0]), jnp.asarray(d3), max_leaves, pcf)
    else:
        got = pk.collect_tile_leaves(
            b8, torch.from_numpy(o3.min(1)), torch.from_numpy(d3),
            max_leaves, pcf, tile_ohi=torch.from_numpy(o3.max(1)))
        want = jpk.collect_tile_leaves(
            jb8, jnp.asarray(o3.min(1)), jnp.asarray(d3), max_leaves, pcf,
            tile_ohi=jnp.asarray(o3.max(1)))
    np.testing.assert_array_equal(_np(got[1]), _np(want[1]))
    np.testing.assert_array_equal(_np(got[0]), _np(want[0]))
    if name == "wide" or max_leaves < _K[name]:
        assert _np(got[1]).all()
    else:
        assert not _np(got[1]).any()


def _walk_inputs(b8, o, d):
    T, o3, d3 = _tile_inputs(o, d)
    tile_o = torch.from_numpy(o3[:, 0])
    planes = pk._tile_planes(tile_o, torch.from_numpy(d3)).contiguous()
    ndoto = pk._sum3(planes * tile_o[:, None, :]).reshape(T, 1, 4)
    return planes, ndoto.contiguous()


@pytest.mark.parametrize("name", ["sphere", "random"])
@pytest.mark.parametrize("budget", ["fits", 16])
def test_frustum_walk_twin_matches_jax(name, budget):
    """Kernel F's twin against JAX collect_tile_leaves_pallas (interpret)
    on the same planes: equal lists and counts; at 16 leaves every tile
    overflows (count -1) and keeps its first 16 leaves."""
    max_leaves = _K[name] if budget == "fits" else budget
    _, jb8, b8, o, d = _scene(name)
    planes, ndoto = _walk_inputs(b8, o, d)
    before = dict(fw.LAUNCHES)
    leaves, counts = fw.collect_tile_leaves_kernel(
        b8.bounds, b8.child, planes, ndoto, max_leaves)
    assert fw.LAUNCHES == before        # the twin ran, not the kernel
    jl, jc = collect_tile_leaves_pallas(
        jb8.bounds.reshape(-1, 6, 8), jb8.child, jnp.asarray(_np(planes)),
        jnp.asarray(_np(ndoto)), max_leaves, interpret=True)
    np.testing.assert_array_equal(_np(counts), _np(jc))
    np.testing.assert_array_equal(_np(leaves), _np(jl))
    if max_leaves == 16:
        assert (_np(counts) == -1).all()
    else:
        assert (_np(counts) > 0).all()


def _resolve_inputs(name):
    """Tile rays transposed (T, 3, 256) and each tile's leaf list from the
    port's phase 1."""
    _, jb8, b8, o, d = _scene(name)
    T, o3, d3 = _tile_inputs(o, d)
    leaves, ovf = pk.collect_tile_leaves(
        b8, torch.from_numpy(o3.min(1)), torch.from_numpy(d3), _K[name],
        64, tile_ohi=torch.from_numpy(o3.max(1)))
    assert not bool(ovf.any())
    o_t = torch.from_numpy(np.ascontiguousarray(o3.transpose(0, 2, 1)))
    d_t = torch.from_numpy(np.ascontiguousarray(d3.transpose(0, 2, 1)))
    return b8, leaves, o_t, d_t


@pytest.mark.parametrize("name", ["sphere", "random"])
@pytest.mark.parametrize("wide", [False, True])
def test_leaf_resolve_v2_twin_matches_jax(name, wide):
    """Kernel D's twin (v2 and v3 tie rules) against JAX leaf_resolve_v2
    (interpret) on the engine's gathered, dead-zeroed (T, 4K, 12) rows:
    row positions equal, t within 1e-5."""
    b8, leaves, o_t, d_t = _resolve_inputs(name)
    T, K = leaves.shape
    rows = torch.clamp(leaves, 0, b8.leaf_tris.shape[0] - 1)
    idx = (rows[:, :, None] * 4 + torch.arange(4)).long()
    geom = torch.where((leaves != I32MAX)[:, :, None, None],
                       lr.pack_tri_geom(b8)[idx], 0.0).reshape(T, 4 * K, 12)
    t, i = lr.leaf_resolve_v2(o_t, d_t, geom, wide=wide)
    jt, ji = j_leaf_resolve_v2(*(jnp.asarray(_np(x)) for x in
                                 (o_t, d_t, geom)),
                               interpret=True, wide=wide)
    np.testing.assert_array_equal(_np(i), _np(ji))
    np.testing.assert_allclose(_np(t), _np(jt), rtol=1e-5, atol=1e-5)
    assert (_np(t) < 1e30).any() and (_np(t) >= 1e30).any()


@pytest.mark.parametrize("name", ["sphere", "random"])
def test_leaf_resolve_twin_matches_jax(name):
    """Kernel E's twin against JAX leaf_resolve (interpret) on
    pack_leaf_geom rows gathered by the tile lists, with the live mask
    and the rows: packed winners equal, t within 1e-5."""
    b8, leaves, o_t, d_t = _resolve_inputs(name)
    live = (leaves != I32MAX).to(torch.int32)
    rows = torch.clamp(leaves, 0, b8.leaf_tris.shape[0] - 1)
    geom = lr.pack_leaf_geom(b8)[rows.long()].contiguous()
    t, p = lr.leaf_resolve(o_t, d_t, geom, live, rows)
    jt, jp = j_leaf_resolve(*(jnp.asarray(_np(x)) for x in
                              (o_t, d_t, geom, live, rows)), interpret=True)
    np.testing.assert_array_equal(_np(p), _np(jp))
    np.testing.assert_allclose(_np(t), _np(jt), rtol=1e-5, atol=1e-5)


def test_pack_geom_matches_jax():
    from tinybvh_tpu.traverse.pallas_leaf import (
        pack_leaf_geom, pack_tri_geom,
    )

    _, jb8, b8, _, _ = _scene("random")
    np.testing.assert_array_equal(_np(lr.pack_tri_geom(b8)),
                                  _np(pack_tri_geom(jb8)))
    np.testing.assert_array_equal(_np(lr.pack_leaf_geom(b8)),
                                  _np(pack_leaf_geom(jb8)))


_MODES = {
    "default": ({}, {}),
    "flat": (dict(phase1_flat=True), dict(phase1_flat=True)),
    "leaf_kernel": (dict(leaf_kernel=True),
                    dict(use_pallas=True, interpret=True)),
    "walk+leaf_kernel": (dict(leaf_kernel=True, walk_kernel=True),
                         dict(use_pallas=True, phase1_pallas=True,
                              interpret=True)),
}


def _assert_hits(h, ref, ov_ray, tol):
    """prim equal and t within tol on the rays outside ov_ray."""
    keep = ~ov_ray
    np.testing.assert_array_equal(_np(h.prim)[keep], _np(ref.prim)[keep])
    hit = keep & (_np(ref.prim) >= 0)
    np.testing.assert_allclose(_np(h.t)[hit], _np(ref.t)[hit], rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("name,max_leaves,mode", [
    *(("sphere", 512, m) for m in _MODES),
    # every tile overflows: the BFS's flag (flat) and F's (walk)
    ("random", 512, "flat"), ("random", 512, "walk+leaf_kernel"),
    ("random", 1024, "default"), ("random", 1024, "walk+leaf_kernel"),
])
def test_intersect_packets_matches_jax(name, max_leaves, mode):
    """Each mode of intersect_packets equals the same JAX mode (prims,
    t within 1e-5, overflow mask) and brute force on the rays of tiles
    that did not overflow."""
    tris, jb8, b8, o, d = _scene(name)
    kw, jkw = _MODES[mode]
    rays = make_rays(o, d, device="cpu")
    hits, ov = pk.intersect_packets(b8, rays, max_leaves=max_leaves,
                                    chunk=32, **kw)
    jhits, jov = jpk.intersect_packets(jb8, j_make_rays(o, d),
                                       max_leaves=max_leaves, chunk=32,
                                       **jkw)
    np.testing.assert_array_equal(_np(ov), _np(jov))
    none = np.zeros(o.shape[0], bool)
    _assert_hits(hits, jhits, none, 1e-5)
    ov_ray = np.repeat(_np(ov), 256)
    assert ov_ray.all() == (max_leaves < _K[name])
    _assert_hits(hits, brute_force_closest(rays, torch.from_numpy(tris)),
                 ov_ray, 1e-4)
    assert 0.0 < (_np(hits.prim) >= 0).mean() < 1.0


@pytest.mark.parametrize("leaf_kernel", [False, True])
def test_is_occluded_packets_point_light(leaf_kernel):
    """tests/test_packet.py:110-134: shadow bundles from a point light
    equal per-segment brute force and the JAX engine."""
    tris, jb8, b8, o, _ = _scene("small_sphere")
    R = o.shape[0]
    g = np.linspace(-2.5, 2.5, 16)
    px, py = np.meshgrid(g, g)
    pts = np.stack([px, py, np.full_like(px, 3.0)], -1).reshape(-1, 3)
    pts = np.tile(pts, (R // 256, 1)).astype(np.float32)
    light = np.array([0.0, 0.0, -4.0], np.float32)
    occ, ov = pk.is_occluded_packets(b8, torch.from_numpy(light),
                                     torch.from_numpy(pts), max_leaves=512,
                                     leaf_kernel=leaf_kernel)
    assert not bool(ov.any())
    jocc, _ = jpk.is_occluded_packets(jb8, light, pts, max_leaves=512,
                                      use_pallas=leaf_kernel,
                                      interpret=leaf_kernel)
    seg = make_rays(np.broadcast_to(light, pts.shape), pts - light,
                    device="cpu")
    bf = brute_force_closest(seg, torch.from_numpy(tris))
    ref = (_np(bf.prim) >= 0) & (_np(bf.t) < 1.0 - 1e-3)
    np.testing.assert_array_equal(_np(occ), ref)
    np.testing.assert_array_equal(_np(occ), _np(jocc))
    assert 0 < ref.sum() < R


@pytest.mark.parametrize("leaf_kernel", [False, True])
def test_sorted_packets_incoherent_rays(leaf_kernel):
    """tests/test_packet.py:137-162: incoherent rays through the sorted
    packet path equal brute force on every ray whose tile did not
    overflow, and the JAX engine where neither overflowed."""
    tris, jb8, b8, _, _ = _scene("small_sphere")
    rng = np.random.default_rng(7)
    R = 1024
    o = rng.normal(size=(R, 3)).astype(np.float32)
    o = o / np.linalg.norm(o, axis=1, keepdims=True) * 3.0
    d = rng.normal(size=(R, 3)).astype(np.float32) - o * 0.25
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    lo, hi = tris.min(axis=(0, 1)), tris.max(axis=(0, 1))
    rays = make_rays(o, d, device="cpu")
    hits, ov = pk.intersect_packets_sorted(b8, rays, lo, hi, max_leaves=512,
                                           leaf_kernel=leaf_kernel)
    jhits, jov = jpk.intersect_packets_sorted(
        jb8, j_make_rays(o, d), lo, hi, max_leaves=512,
        use_pallas=leaf_kernel, interpret=leaf_kernel)
    ov, jov = _np(ov), _np(jov)
    assert (~ov).mean() > 0.9
    _assert_hits(hits, brute_force_closest(rays, torch.from_numpy(tris)),
                 ov, 1e-4)
    _assert_hits(hits, jhits, ov | jov, 1e-5)
    assert 0.0 < (_np(hits.prim)[~ov] >= 0).mean() < 1.0


def test_bad_arguments_raise():
    _, _, b8, o, d = _scene("sphere")
    rays = make_rays(o, d, device="cpu")
    with pytest.raises(ValueError):
        pk.intersect_packets(b8, make_rays(o[:300], d[:300], device="cpu"))
    with pytest.raises(ValueError):
        pk.intersect_packets(b8, rays, max_leaves=100, chunk=32)
    with pytest.raises(ValueError):
        pk.intersect_packets(b8, rays, max_leaves=12, leaf_kernel=True)
    o_t = torch.zeros((1, 3, 256))
    with pytest.raises(ValueError):
        lr.leaf_resolve_v2(o_t, o_t, torch.zeros((1, 40, 12)))
    with pytest.raises(ValueError):
        lr.leaf_resolve_v2(o_t.to("meta"), o_t, torch.zeros((1, 32, 12)))
