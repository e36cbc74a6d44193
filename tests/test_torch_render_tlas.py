"""The port's instanced path tracer (render/pathtracer_tlas.py) against
the JAX package's, on the CPU.

Both trace the same tables (the JAX TLAS8 carried over by
convert.from_numpy_tlas8, and the port's own packet tables over the same
BLASes) with JAX's random draws replayed (tests/torch_parity.py
JaxDraws): the wavefront route, per-instance mirrors, analytic lights,
textured leaves, and tpacket= routing through the per-instance packet2
engine (the JAX one in interpret mode). Radiance is held to the standard
of tests/test_pathtracer_tlas.py:152-157 (more than 0.98 of the rays
within rtol 2e-2 / atol 2e-3, means within 2e-2), and the overflow flags
are equal. Where the port replays JAX's draws on the same tables (the
wavefront route, mirrors, analytic lights), every ray is also held at
rtol 1e-3 / atol 1e-4, the standard of tests/test_torch_render.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import tinybvh_tpu as tb  # noqa: E402
from tinybvh_tpu.render import pathtracer as jpt  # noqa: E402
from tinybvh_tpu.render.pathtracer_tlas import (  # noqa: E402
    trace_paths_tlas as jtrace,
)
from tinybvh_tpu.render.textures import build_atlas as jatlas  # noqa: E402
from tinybvh_tpu.scene.graph import Light as JLight  # noqa: E402
from tinybvh_tpu.tlas import instance as ji  # noqa: E402
from tinybvh_tpu.tlas.packet import build_tlas_packet as jtp  # noqa: E402
from tinybvh_tpu_torch.convert import (  # noqa: E402
    from_numpy_bvh8, from_numpy_tlas8,
)
from tinybvh_tpu_torch.core.rays import make_rays  # noqa: E402
from tinybvh_tpu_torch.render import pathtracer as ppt  # noqa: E402
from tinybvh_tpu_torch.render.pathtracer_tlas import (  # noqa: E402
    trace_paths_tlas as ptrace,
)
from tinybvh_tpu_torch.render.textures import build_atlas  # noqa: E402
from tinybvh_tpu_torch.scene.graph import Light  # noqa: E402
from tinybvh_tpu_torch.tlas.instance import merge_leaf_attrs  # noqa: E402
from tinybvh_tpu_torch.tlas.packet import build_tlas_packet  # noqa: E402
from tests.torch_parity import JaxDraws, _np, _quad  # noqa: E402
from tests.test_torch_jax_native import jax_native  # noqa: E402,F401


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _close(got, ref):
    """tests/test_pathtracer_tlas.py:152-157."""
    assert np.isfinite(got).all()
    close = np.isclose(got, ref, rtol=2e-2, atol=2e-3).all(axis=1)
    assert close.mean() > 0.98, f"only {close.mean():.3f} rays match"
    np.testing.assert_allclose(got.mean(), ref.mean(), rtol=2e-2)


def _every_ray(got, ref):
    """Exact replay: every ray within tests/test_torch_render.py's
    rtol 1e-3 / atol 1e-4."""
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4)


class _Scene:
    """A TLAS scene in both packages over the same BLAS tables."""

    def __init__(self, blas_tris, pairs, inst_albedo, inst_emissive,
                 light_tris, light_emission):
        self.jblases = [tb.BVH(t, layout="bvh8").bvh8 for t in blas_tris]
        self.pairs = pairs
        self.jtlas = ji.build_tlas(self.jblases, pairs)
        self.ptlas = from_numpy_tlas8(self.jtlas, device="cpu")
        self.args = (inst_albedo, inst_emissive, light_tris, light_emission)
        self._jtp = self._ptp = None

    def jax_tpacket(self):
        if self._jtp is None:
            self._jtp = jtp(self.jblases, self.pairs)
        return self._jtp

    def port_tpacket(self):
        if self._ptp is None:
            self._ptp = build_tlas_packet(
                [from_numpy_bvh8(b, device="cpu") for b in self.jblases],
                self.pairs,
                device="cpu")
        return self._ptp


def _box():
    """tests/test_pathtracer_tlas.py:12-30: the walls and the light as
    two BLAS instances."""
    walls = np.concatenate([
        _quad([0, 0, 0], [2, 0, 0], [2, 0, 2], [0, 0, 2]),
        _quad([0, 2, 2], [2, 2, 2], [2, 2, 0], [0, 2, 0]),
        _quad([0, 0, 2], [2, 0, 2], [2, 2, 2], [0, 2, 2]),
        _quad([0, 0, 0], [0, 0, 2], [0, 2, 2], [0, 2, 0]),
        _quad([2, 0, 2], [2, 0, 0], [2, 2, 0], [2, 2, 2])])
    light = _quad([0.7, 1.98, 1.3], [1.3, 1.98, 1.3], [1.3, 1.98, 0.7],
                  [0.7, 1.98, 0.7])
    eye = np.eye(4, dtype=np.float32)
    return _Scene([walls, light], [(0, eye), (1, eye)],
                  np.array([[0.7, 0.7, 0.7], [0, 0, 0]], np.float32),
                  np.array([[0, 0, 0], [8, 8, 8]], np.float32),
                  light.astype(np.float32), np.full((2, 3), 8.0, np.float32))


FLOOR = np.array([[[-2, 0, -2], [2, 0, -2], [2, 0, 2]],
                  [[-2, 0, -2], [2, 0, 2], [-2, 0, 2]]], np.float32)


def _floor():
    """tests/test_pathtracer_tlas.py:74-85: a floor instance under a light
    instance; the floor here is moved by a rotated, scaled transform."""
    light = (FLOOR * np.array([0.25, 1, 0.25], np.float32)
             + np.array([0, 3, 0], np.float32))[:, ::-1]
    m = np.eye(4, dtype=np.float32)
    c, s = np.cos(0.3), np.sin(0.3)
    m[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]]) * 1.2
    m[1, 3] = -0.1
    return _Scene([FLOOR, light], [(0, m), (1, np.eye(4, dtype=np.float32))],
                  np.array([[1, 1, 1], [0, 0, 0]], np.float32),
                  np.array([[0, 0, 0], [5, 5, 5]], np.float32),
                  np.ascontiguousarray(light),
                  np.full((2, 3), 5.0, np.float32))


def _interior_rays(seed, n=256):
    """tests/test_pathtracer_tlas.py:43-49."""
    rng = np.random.default_rng(seed)
    o = np.tile(np.array([[1.0, 1.0, 0.2]], np.float32), (n, 1))
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = np.abs(d[:, 2])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _down_rays(R=64):
    o = np.stack([np.linspace(-1.5, 1.5, R), np.full(R, 2.0),
                  np.linspace(-0.5, 0.5, R)], -1).astype(np.float32)
    return o, np.tile([[0, -1, 0]], (R, 1)).astype(np.float32)


LIGHTS = [dict(kind="point", position=np.array([1.0, 1.5, 1.0], np.float32),
               intensity=2.0),
          dict(kind="spot", position=np.array([0.5, 1.9, 0.5], np.float32),
               direction=np.array([0.2, -1.0, 0.3], np.float32),
               intensity=3.0, cos_inner=0.9, cos_outer=0.7),
          dict(kind="directional",
               direction=np.array([0.1, -1.0, 0.2], np.float32),
               intensity=0.5)]


def _run(sc, rays, seed, bounces, route="wavefront", specular=None,
         lights=None, textured=None):
    """(JAX radiance, JAX overflow, port radiance, port overflow)."""
    o, d = rays
    kw_j, kw_p = {}, {}
    if specular is not None:
        kw_j["inst_specular"] = kw_p["inst_specular"] = specular
    if lights is not None:
        kw_j["analytic"] = jpt.pack_analytic_lights(
            [JLight(**kw) for kw in lights])
        kw_p["analytic"] = ppt.pack_analytic_lights(
            [Light(**kw) for kw in lights], device="cpu")
    if route == "tpacket":
        kw_j["tpacket"] = sc.jax_tpacket()
        kw_p["tpacket"] = sc.port_tpacket()
    if textured is not None:
        uvs, tex_ids, images = textured
        kw_j.update(leaf_uvs=ji.merge_leaf_attrs(sc.jblases, uvs),
                    leaf_tex=ji.merge_leaf_attrs(sc.jblases, tex_ids),
                    tex=jatlas(images))
        pbl = [from_numpy_bvh8(b, device="cpu") for b in sc.jblases]
        kw_p.update(leaf_uvs=merge_leaf_attrs(pbl, uvs),
                    leaf_tex=merge_leaf_attrs(pbl, tex_ids),
                    tex=build_atlas(images, device="cpu"))
    ref, ref_ovf = jtrace(sc.jtlas, *sc.args, tb.make_rays(o, d),
                          jax.random.PRNGKey(seed), bounces=bounces, **kw_j)
    got, ovf = ptrace(sc.ptlas, *sc.args, make_rays(o, d, device="cpu"),
                      JaxDraws(jax.random.PRNGKey(seed)), bounces=bounces,
                      **kw_p)
    return (np.asarray(ref), bool(np.any(np.asarray(ref_ovf))), _np(got),
            bool(ovf))


@pytest.fixture(scope="module")
def box():
    return _box()


@pytest.fixture(scope="module")
def floor():
    return _floor()


@pytest.mark.parametrize("bounces,seed", [(1, 0), (3, 1)])
def test_wavefront_matches_jax(box, bounces, seed):
    ref, ref_ovf, got, ovf = _run(box, _interior_rays(seed), seed, bounces)
    _close(got, ref)
    _every_ray(got, ref)
    assert ovf == ref_ovf
    assert 0.005 < got.mean() < 8.0


def test_analytic_lights_match_jax(box):
    ref, _, got, _ = _run(box, _interior_rays(2), 2, 2, lights=LIGHTS)
    _close(got, ref)
    _every_ray(got, ref)
    plain = _run(box, _interior_rays(2), 2, 2)[2]
    assert got.mean() > plain.mean()       # the delta lights add light


def test_instance_mirror_matches_jax(floor):
    """The floor instance as a mirror under the light instance."""
    ref, _, got, _ = _run(floor, _down_rays(), 3, 2,
                          specular=np.array([1.0, 0.0], np.float32))
    _close(got, ref)
    _every_ray(got, ref)
    # the rays under the light see it in the mirror
    assert (got.sum(axis=1) > 1.0).mean() > 0.25


def test_textured_leaves_match_jax(floor):
    """tests/test_pathtracer_tlas.py:61-114: UVs and texture ids merged
    per leaf, a random texture on the floor, none on the light."""
    uvs = np.array([[[0, 0], [1, 0], [1, 1]],
                    [[0, 0], [1, 1], [0, 1]]], np.float32) * 3.0
    img = np.random.default_rng(7).random((4, 6, 3)).astype(np.float32)
    textured = ([uvs, np.zeros_like(uvs)],
                [np.zeros(2, np.int32), np.full(2, -1, np.int32)], [img])
    ref, _, got, _ = _run(floor, _down_rays(), 4, 1, textured=textured)
    _close(got, ref)
    white, _, _, _ = _run(floor, _down_rays(), 4, 1)
    lit = white.sum(axis=1) > 1e-4
    assert lit.any() and not np.allclose(got[lit], white[lit])


def test_tpacket_route_matches_jax(box):
    """tpacket= routing, with JAX's packet routing (interpret mode) as
    the reference, on tests/test_pathtracer_tlas.py:117-157's rays."""
    ref, ref_ovf, got, ovf = _run(box, _interior_rays(7), 3, 2,
                                  route="tpacket")
    _close(got, ref)
    assert ovf == ref_ovf is False


def test_tpacket_route_matches_wavefront(box):
    """The port's two routes on the same draws (≙ tests/
    test_pathtracer_tlas.py:117-157), analytic lights included."""
    rays = make_rays(*_interior_rays(8), device="cpu")
    out = []
    for kw in ({}, dict(tpacket=box.port_tpacket())):
        rad, ovf = ptrace(box.ptlas, *box.args, rays,
                          JaxDraws(jax.random.PRNGKey(9)), bounces=2,
                          analytic=ppt.pack_analytic_lights(
                              [Light(**k) for k in LIGHTS], device="cpu"),
                          **kw)
        assert not bool(ovf)
        out.append(_np(rad))
    _close(out[1], out[0])
