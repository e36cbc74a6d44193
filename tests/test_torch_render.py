"""The port's render layer against the JAX package, on the CPU.

core/rng.py (the hashes bit for bit, cosine_hemisphere within 1e-6),
render/camera.py (primary_rays with jitter within 1e-6),
render/textures.py (atlas, bilinear and mip sampling, sky, the mip
chain, bump -> normal and sRGB within 1e-6), and render/pathtracer.py:
trace_paths and render on the same BVH8 (the JAX tables carried over by
convert.from_numpy_bvh8), with JAX's own random draws replayed through a
Sampler on JAX's key schedule (split(key, 6) per bounce, split(key, 3)
per sample). Radiance agrees at rtol 1e-3 / atol 1e-4, the standard of
tests/test_pathtracer.py:330-331, and the overflow flags are equal.
The JAX packet route runs its Pallas kernels in interpret mode, as the
JAX tests do.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import tinybvh_tpu as tb  # noqa: E402
from tinybvh_tpu.core import rng as jrng  # noqa: E402
from tinybvh_tpu.render import camera as jcam  # noqa: E402
from tinybvh_tpu.render import pathtracer as jpt  # noqa: E402
from tinybvh_tpu.render import textures as jtex  # noqa: E402
from tinybvh_tpu.scene.graph import Light as JLight  # noqa: E402
from tinybvh_tpu.traverse.packet2 import build_packet_aux as jaux  # noqa: E402
from tinybvh_tpu_torch.convert import from_numpy_bvh8  # noqa: E402
from tinybvh_tpu_torch.core import rng as prng  # noqa: E402
from tinybvh_tpu_torch.core.rays import make_rays  # noqa: E402
from tinybvh_tpu_torch.io.loaders import random_tris  # noqa: E402
from tinybvh_tpu_torch.render import camera as pcam  # noqa: E402
from tinybvh_tpu_torch.render import pathtracer as ppt  # noqa: E402
from tinybvh_tpu_torch.render import textures as ptex  # noqa: E402
from tinybvh_tpu_torch.scene.graph import Light  # noqa: E402
from tinybvh_tpu_torch.traverse.packet2 import build_packet_aux  # noqa: E402
from tests.torch_parity import JaxDraws, _np, _quad  # noqa: E402
from tests.test_torch_jax_native import jax_native  # noqa: E402,F401

RTOL, ATOL = 1e-3, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """One test file per worker process: keep torch's pool small."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _cornell():
    """tests/test_pathtracer.py:18-38."""
    tris = np.concatenate([
        _quad([0, 0, 0], [2, 0, 0], [2, 0, 2], [0, 0, 2]),
        _quad([0, 2, 2], [2, 2, 2], [2, 2, 0], [0, 2, 0]),
        _quad([0, 0, 2], [2, 0, 2], [2, 2, 2], [0, 2, 2]),
        _quad([0, 0, 0], [0, 0, 2], [0, 2, 2], [0, 2, 0]),
        _quad([2, 0, 2], [2, 0, 0], [2, 2, 0], [2, 2, 2]),
        _quad([0.7, 1.98, 1.3], [1.3, 1.98, 1.3], [1.3, 1.98, 0.7],
              [0.7, 1.98, 0.7])])
    n = tris.shape[0]
    albedo = np.full((n, 3), 0.7, np.float32)
    albedo[6:8] = [0.8, 0.2, 0.2]
    albedo[8:10] = [0.2, 0.8, 0.2]
    emissive = np.zeros((n, 3), np.float32)
    emissive[10:12] = 8.0
    albedo[10:12] = 0.0
    return tris, albedo, emissive


def _box_rays(seed, n=256):
    """tests/test_pathtracer.py:56-64: rays from one point into the box."""
    rng = np.random.default_rng(seed)
    o = np.tile(np.array([[1.0, 1.0, 0.2]], np.float32), (n, 1))
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = np.abs(d[:, 2])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _down_rays(R=64, x=1.5):
    o = np.stack([np.linspace(-x, x, R), np.full(R, 2.0),
                  np.zeros(R)], -1).astype(np.float32)
    return o, np.tile([[0, -1, 0]], (R, 1)).astype(np.float32)


FLOOR = np.array([[[-2, 0, -2], [2, 0, -2], [2, 0, 2]],
                  [[-2, 0, -2], [2, 0, 2], [-2, 0, 2]]], np.float32)
UVS = np.array([[[0, 0], [1, 0], [1, 1]],
                [[0, 0], [1, 1], [0, 1]]], np.float32)


def _scene_case(name):
    """(tris, make_scene_arrays kwargs, extra kwargs for trace_paths
    (`normals`, `lights`), rays (o, d)) of one case; each mirrors a
    scene of tests/test_pathtracer.py or tests/test_textures.py."""
    if name == "cornell":
        tris, albedo, emissive = _cornell()
        return tris, dict(albedo=albedo, emissive=emissive), {}, _box_rays(3)
    if name == "mirror":                            # :187-212
        light = FLOOR[:, ::-1] + np.array([0, 4, 0], np.float32)
        tris = np.concatenate([FLOOR, light])
        albedo = np.array([[0.9, 0.8, 0.7]] * 2 + [[0, 0, 0]] * 2,
                          np.float32)
        emissive = np.zeros((4, 3), np.float32)
        emissive[2:] = 5.0
        rng = np.random.default_rng(9)
        o = np.concatenate([[[0.3, 2.0, 0.3]],
                            rng.uniform(-1.5, 1.5, (63, 3))]).astype(
                                np.float32)
        o[:, 1] = 2.0
        return tris, dict(albedo=albedo, emissive=emissive,
                          specular=np.array([1, 1, 0, 0], np.float32)), {}, (
            o, np.tile([[0, -1, 0]], (64, 1)).astype(np.float32))
    if name == "smooth":                            # :109-150
        light = (FLOOR[:, ::-1] * np.array([0.1, 1, 0.1], np.float32)
                 + np.array([0, 4, 0], np.float32))
        tris = np.concatenate([FLOOR, light])
        emissive = np.zeros((4, 3), np.float32)
        emissive[2:] = 10.0
        tilt = np.tile(np.array([0, 1, 1], np.float32) / np.sqrt(2),
                       (4, 3, 1))
        return tris, dict(albedo=np.ones((4, 3), np.float32),
                          emissive=emissive), dict(normals=tilt), _down_rays()
    if name == "textured_sky":                      # test_textures.py:50-71
        tris = FLOOR * np.float32(0.5)
        o, d = _down_rays(x=1.6)
        o[::2, 2] += 5.0                            # half of them see the sky
        sky = np.random.default_rng(4).random((4, 8, 3)).astype(np.float32)
        tex = [np.random.default_rng(5).random((4, 4, 3)).astype(np.float32)]
        return tris, dict(albedo=np.ones((2, 3), np.float32), uvs=UVS,
                          tex_id=np.array([0, -1], np.int32), textures=tex,
                          sky=sky), {}, (o, d)
    if name == "analytic":                          # :215-292
        floor = np.array([[[-10, 0, -10], [10, 0, -10], [-10, 0, 10]],
                          [[10, 0, 10], [-10, 0, 10], [10, 0, -10]]],
                         np.float32)
        b = 0.3
        blocker = np.array([[[-b, 1.0, -b], [b, 1.0, -b], [-b, 1.0, b]],
                            [[b, 1.0, b], [-b, 1.0, b], [b, 1.0, -b]]],
                           np.float32)
        tris = np.concatenate([floor, blocker])
        lights = [
            dict(kind="point", position=np.array([0, 2, 0], np.float32),
                 intensity=4.0),
            dict(kind="directional",
                 direction=np.array([0.3, -1.0, 0.2], np.float32),
                 intensity=2.0),
            dict(kind="spot", position=np.array([1, 2, 0], np.float32),
                 direction=np.array([0, -1.0, 0], np.float32), intensity=4.0,
                 cos_inner=0.95, cos_outer=0.9)]
        rng = np.random.default_rng(6)
        tgt = np.concatenate([rng.uniform(-3, 3, (64, 1)), np.zeros((64, 1)),
                              rng.uniform(-3, 3, (64, 1))], 1)
        o = np.tile(np.array([[2.0, 3.0, 0.5]]), (64, 1))
        d = tgt - o
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        return tris, dict(albedo=np.ones((4, 3), np.float32)), dict(
            lights=lights), (o.astype(np.float32), d.astype(np.float32))
    if name == "cluster":                           # :295-331
        tris = np.concatenate([
            random_tris(120, seed=11),
            np.array([[[0, 14, 0], [10, 14, 0], [0, 14, 10]],
                      [[10, 14, 10], [0, 14, 10], [10, 14, 0]]], np.float32),
            np.array([[[-5, -2, -5], [15, -2, -5], [-5, -2, 15]],
                      [[15, -2, 15], [-5, -2, 15], [15, -2, -5]]],
                     np.float32)])
        emissive = np.zeros((124, 3), np.float32)
        emissive[120:122] = 6.0
        eye, fwd, right, up = jcam.look_at(np.array([5.0, 6.0, 22.0]),
                                           np.array([5.0, 4.0, 5.0]))
        r = jcam.primary_rays(eye, fwd, right, up, 32, 16)  # 2 tiles
        return tris, dict(emissive=emissive), {}, (np.asarray(r.o),
                                                   np.asarray(r.d))
    raise KeyError(name)


class _Case:
    """One scene in both packages: the JAX BVH8 and scene arrays, and the
    port's copy of the same tables on the CPU."""

    def __init__(self, name):
        tris, arrays, extra, (o, d) = _scene_case(name)
        self.jbvh = tb.BVH(tris, layout="bvh8").bvh8
        self.pbvh = from_numpy_bvh8(self.jbvh, device="cpu")
        self.jscene = jpt.make_scene_arrays(tris, **arrays)
        self.pscene = ppt.make_scene_arrays(tris, device="cpu", **arrays)
        if "normals" in extra:
            jpt.add_vertex_normals(self.jscene, extra["normals"])
            ppt.add_vertex_normals(self.pscene, extra["normals"])
        self.janalytic = self.panalytic = None
        if "lights" in extra:
            self.janalytic = jpt.pack_analytic_lights(
                [JLight(**kw) for kw in extra["lights"]])
            self.panalytic = ppt.pack_analytic_lights(
                [Light(**kw) for kw in extra["lights"]], device="cpu")
        self.jrays = tb.make_rays(o, d)
        self.prays = make_rays(o, d, device="cpu")
        self._jaux = self._paux = None

    def jax_aux(self):
        if self._jaux is None:
            self._jaux = jaux(self.jbvh)
        return self._jaux

    def port_aux(self):
        if self._paux is None:
            self._paux = build_packet_aux(self.pbvh)
        return self._paux


@pytest.fixture(scope="module")
def cases():
    built = {}

    def get(name):
        if name not in built:
            built[name] = _Case(name)
        return built[name]
    return get


@pytest.fixture(scope="module")
def jax_runs(cases):
    """JAX trace_paths results by (case, bounces, seed, options), shared
    by the tests that compare against the same run."""
    done = {}

    def run(name, bounces, seed, aux=False, brute_force=False):
        k = (name, bounces, seed, aux, brute_force)
        if k not in done:
            c = cases(name)
            rad, ovf = jpt.trace_paths(
                c.jbvh, c.jscene, c.jrays, jax.random.PRNGKey(seed),
                bounces=bounces, brute_force=brute_force,
                analytic=c.janalytic, aux=c.jax_aux() if aux else None)
            done[k] = (np.asarray(rad), bool(np.any(np.asarray(ovf))))
        return done[k]
    return run


def _port_run(c, bounces, seed, aux=False, brute_force=False):
    rad, ovf = ppt.trace_paths(
        c.pbvh, c.pscene, c.prays, JaxDraws(jax.random.PRNGKey(seed)),
        bounces=bounces, brute_force=brute_force, analytic=c.panalytic,
        aux=c.port_aux() if aux else None)
    assert ovf.dim() == 0 and ovf.dtype == torch.bool
    return _np(rad), bool(ovf)


# ---- rng --------------------------------------------------------------------

def test_hashes_bit_equal_to_jax():
    x = np.random.default_rng(0).integers(0, 2**32, 4096, dtype=np.uint64)
    x = np.concatenate([x, [0, 1, 61, 2**31, 2**32 - 1]]).astype(np.uint32)
    np.testing.assert_array_equal(_np(prng.wang_hash(x.astype(np.int64))),
                                  np.asarray(jrng.wang_hash(x)))
    s_p, v_p = prng.xor32(x.astype(np.int64))
    s_j, v_j = jrng.xor32(x)
    np.testing.assert_array_equal(_np(s_p), np.asarray(s_j))
    np.testing.assert_array_equal(_np(v_p), np.asarray(v_j))
    np.testing.assert_array_equal(
        _np(prng.u32_to_unit_float(x.astype(np.int64))),
        np.asarray(jrng.u32_to_unit_float(jnp.asarray(x))))


def test_cosine_hemisphere_matches_jax():
    rng = np.random.default_rng(1)
    n = rng.normal(size=(2048, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    n[:8] = [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, 0, -1], [0.95, 0.3, 0],
             [0.9, 0.4359, 0], [0, 0, 1], [-0.91, 0, 0.41]]
    r1, r2 = rng.random((2, 2048)).astype(np.float32)
    got = prng.cosine_hemisphere(torch.from_numpy(n), torch.from_numpy(r1),
                                 torch.from_numpy(r2))
    ref = jrng.cosine_hemisphere(jnp.asarray(n), jnp.asarray(r1),
                                 jnp.asarray(r2))
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=1e-6)


# ---- camera -----------------------------------------------------------------

def test_primary_rays_with_jitter_match_jax():
    eye, fwd, right, up = pcam.auto_camera([0, 0, 0], [4, 2, 3])
    ref_cam = jcam.auto_camera([0, 0, 0], [4, 2, 3])
    for a, b in zip((eye, fwd, right, up), ref_cam):
        np.testing.assert_array_equal(a, b)
    jit = np.random.default_rng(2).random((12, 20, 2)).astype(np.float32)
    for j in (None, jit):
        got = pcam.primary_rays(eye, fwd, right, up, 20, 12, jitter=(
            None if j is None else torch.from_numpy(j)), device="cpu")
        ref = jcam.primary_rays(eye, fwd, right, up, 20, 12, jitter=(
            None if j is None else jnp.asarray(j)))
        assert got.o.device.type == "cpu"
        np.testing.assert_allclose(_np(got.o), np.asarray(ref.o), atol=1e-6)
        np.testing.assert_allclose(_np(got.d), np.asarray(ref.d), atol=1e-6)


# ---- textures ---------------------------------------------------------------

def _images():
    rng = np.random.default_rng(3)
    return [rng.random((4, 8, 3)).astype(np.float32),
            rng.random((6, 5)).astype(np.float32),               # grey
            rng.random((3, 3, 4)).astype(np.float32)]            # RGBA


def test_atlas_and_bilinear_sampling_match_jax():
    imgs = _images()
    for images in (imgs, []):
        got = ptex.build_atlas(images, device="cpu")
        ref = jtex.build_atlas(images)
        np.testing.assert_array_equal(_np(got["atlas"]),
                                      np.asarray(ref["atlas"]))
        np.testing.assert_array_equal(_np(got["rects"]),
                                      np.asarray(ref["rects"]))
    rng = np.random.default_rng(4)
    uv = rng.uniform(-2.5, 2.5, (4096, 2)).astype(np.float32)
    tid = rng.integers(-1, 3, 4096).astype(np.int32)
    got = ptex.sample_atlas(ptex.build_atlas(imgs, device="cpu"),
                            torch.from_numpy(tid), torch.from_numpy(uv))
    ref = jtex.sample_atlas(jtex.build_atlas(imgs), jnp.asarray(tid),
                            jnp.asarray(uv))
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=1e-6)


def test_mip_atlas_and_sky_match_jax():
    imgs = _images()
    got = ptex.build_atlas_mipped(imgs, max_levels=4, device="cpu")
    ref = jtex.build_atlas_mipped(imgs, max_levels=4)
    np.testing.assert_array_equal(_np(got["atlas"]), np.asarray(ref["atlas"]))
    np.testing.assert_array_equal(_np(got["rects"]), np.asarray(ref["rects"]))
    rng = np.random.default_rng(5)
    uv = rng.uniform(0, 1, (1024, 2)).astype(np.float32)
    tid = rng.integers(-1, 3, 1024).astype(np.int32)
    lvl = rng.integers(-1, 6, 1024).astype(np.int32)
    got_s = ptex.sample_atlas_mip(got, torch.from_numpy(tid),
                                  torch.from_numpy(uv), torch.from_numpy(lvl))
    ref_s = jtex.sample_atlas_mip(ref, jnp.asarray(tid), jnp.asarray(uv),
                                  jnp.asarray(lvl))
    np.testing.assert_allclose(_np(got_s), np.asarray(ref_s), atol=1e-6)
    sky = rng.random((6, 10, 3)).astype(np.float32)
    d = rng.normal(size=(1024, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:4] = [[0, 1, 0], [0, -1, 0], [1, 0, 0], [-1, 0, 0]]
    np.testing.assert_allclose(
        _np(ptex.sample_sky(torch.from_numpy(sky), torch.from_numpy(d))),
        np.asarray(jtex.sample_sky(jnp.asarray(sky), jnp.asarray(d))),
        atol=1e-6)


def test_image_helpers_match_jax():
    rng = np.random.default_rng(6)
    img = rng.random((16, 12, 3)).astype(np.float32)
    np.testing.assert_allclose(ptex.srgb_to_linear(img),
                               jtex.srgb_to_linear(img), atol=1e-6)
    for a, b in zip(ptex.build_mip_chain(img[:, :11]),
                    jtex.build_mip_chain(img[:, :11]), strict=True):
        np.testing.assert_allclose(a, b, atol=1e-6)
    for h in (img, img[..., 0]):
        np.testing.assert_allclose(ptex.bump_to_normal(h, 2.0),
                                   jtex.bump_to_normal(h, 2.0), atol=1e-6)


# ---- trace_paths ------------------------------------------------------------

@pytest.mark.parametrize("name,bounces,seed,brute_force", [
    ("cornell", 1, 0, False),
    ("cornell", 3, 1, False),
    ("cornell", 3, 2, True),
    ("mirror", 2, 3, False),
    ("smooth", 1, 4, False),
    ("textured_sky", 2, 5, False),
    ("analytic", 2, 6, False),
    ("cluster", 2, 3, False),
])
def test_trace_paths_wavefront_matches_jax(cases, jax_runs, name, bounces,
                                           seed, brute_force):
    ref, ref_ovf = jax_runs(name, bounces, seed, brute_force=brute_force)
    got, ovf = _port_run(cases(name), bounces, seed,
                         brute_force=brute_force)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    assert ovf == ref_ovf
    assert float(got.max()) > 0      # lit


def test_trace_paths_packets_match_jax_packets(cases, jax_runs):
    """aux= routing (packet2 with its wavefront retrace) against JAX's
    packet routing on the scene of tests/test_pathtracer.py:295-331."""
    ref, ref_ovf = jax_runs("cluster", 2, 3, aux=True)
    got, ovf = _port_run(cases("cluster"), 2, 3, aux=True)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    assert ovf == ref_ovf is False


def test_trace_paths_packets_match_wavefront(cases):
    """Both routes are exact, the draws identical: the port's packet
    route equals its wavefront route (≙ tests/test_pathtracer.py:295)."""
    c = cases("cornell")
    wf, _ = _port_run(c, 3, 7)
    pk, ovf = _port_run(c, 3, 7, aux=True)
    np.testing.assert_allclose(pk, wf, rtol=RTOL, atol=ATOL)
    assert not ovf


def test_render_matches_jax():
    """render with the jitter replayed: 2 samples of a 16x16 image of the
    Cornell box, wavefront route, and the packet route of the same frame
    against it."""
    tris, albedo, emissive = _cornell()
    jbvh = tb.BVH(tris, layout="bvh8").bvh8
    pbvh = from_numpy_bvh8(jbvh, device="cpu")
    cam = jcam.look_at([1.0, 1.0, -2.5], [1.0, 1.0, 1.0])
    ref, ref_ovf = jpt.render(jbvh, jpt.make_scene_arrays(tris, albedo,
                                                          emissive),
                              *cam, 16, 16, spp=2, bounces=2, seed=4)
    pscene = ppt.make_scene_arrays(tris, albedo, emissive, device="cpu")
    got, ovf = ppt.render(pbvh, pscene, *cam, 16, 16, spp=2, bounces=2,
                          sampler=JaxDraws(jax.random.PRNGKey(4)))
    assert got.shape == (16, 16, 3)
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
    assert bool(ovf) == bool(np.any(np.asarray(ref_ovf))) is False
    pk, ovf = ppt.render(pbvh, pscene, *cam, 16, 16, spp=2, bounces=2,
                         sampler=JaxDraws(jax.random.PRNGKey(4)),
                         aux=build_packet_aux(pbvh))
    np.testing.assert_allclose(_np(pk), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def test_seeded_sampler_repeats_its_draws():
    """A Sampler.seeded draw sequence depends only on the seed: two runs
    of one frame agree bit for bit; another seed gives another frame."""
    tris, albedo, emissive = _cornell()
    pbvh = from_numpy_bvh8(tb.BVH(tris, layout="bvh8").bvh8, device="cpu")
    scene = ppt.make_scene_arrays(tris, albedo, emissive, device="cpu")
    cam = pcam.look_at([1.0, 1.0, -2.5], [1.0, 1.0, 1.0])
    a, _ = ppt.render(pbvh, scene, *cam, 16, 16, spp=1, bounces=2,
                      sampler=ppt.Sampler.seeded(0, "cpu"))
    b, _ = ppt.render(pbvh, scene, *cam, 16, 16, spp=1, bounces=2,
                      sampler=ppt.Sampler.seeded(0, "cpu"))
    c, _ = ppt.render(pbvh, scene, *cam, 16, 16, spp=1, bounces=2,
                      sampler=ppt.Sampler.seeded(1, "cpu"))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert float(a.mean()) > 0.01
