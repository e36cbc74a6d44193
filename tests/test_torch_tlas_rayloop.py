"""The port's two-level rayloop engine against the JAX package's, the
port's lockstep two-level engine and brute force, on the CPU (mirrors
tests/test_tlas_rayloop.py).

The scene: two BLASes (a sphere and a random soup) in 8 instances with
rotations, scales and visibility masks, the JAX TLAS8 carried into the
port with convert.from_numpy_tlas8; 1024 rays aimed near the instances,
a quarter of them masked to one group of instances. JAX's
make_tlas_rayloop_tables and the port's agree bit for bit, and both
engines trace the same tables.
Tolerances: ROADMAP's parity standard, prim and inst equal on every
ray, t within rtol = atol = 1e-4, u and v within 1e-3; occlusion equal."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import tinybvh_tpu as tb  # noqa: E402
from tinybvh_tpu.tlas import instance as jinst  # noqa: E402
from tinybvh_tpu.tlas import rayloop as jtrl  # noqa: E402
import tinybvh_tpu_torch as tt  # noqa: E402
from tinybvh_tpu_torch.convert import (  # noqa: E402
    from_numpy_tlas8, from_numpy_tlas_rayloop_tables,
)
from tinybvh_tpu_torch.io.loaders import random_tris, sphere_tris  # noqa: E402
from tinybvh_tpu_torch.tlas import rayloop as ptrl  # noqa: E402
from tinybvh_tpu_torch.tlas.instance import (  # noqa: E402
    intersect_tlas8, is_occluded_tlas8,
)
from tests.test_torch_jax_native import jax_native  # noqa: E402,F401

LADDER = dict(min_size=64, k=4, LQ=12)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """One test file per worker process: keep torch's pool small."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _mat(translate, scale, yaw):
    m = np.eye(4, dtype=np.float32)
    c, s = np.cos(yaw), np.sin(yaw)
    m[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]]) * scale
    m[:3, 3] = translate
    return m


@pytest.fixture(scope="module")
def scene():
    blases = [tb.BVH(sphere_tris(8, 12, radius=0.8)),
              tb.BVH(random_tris(300, seed=4, extent=1.5, size=0.2))]
    transforms = [(i % 2, _mat((4.0 * (i & 1), 4.0 * ((i >> 1) & 1),
                                4.0 * (i >> 2)), 0.7 + 0.1 * i, 0.3 * i))
                  for i in range(8)]
    masks = np.array([0x1, 0x2] * 4, np.int32)
    jtlas = jinst.build_tlas([b.bvh8 for b in blases], transforms,
                             masks=masks,
                             host8s=[b._bvh8_host for b in blases])
    rng = np.random.default_rng(31)
    o = rng.uniform(-3, 8, (1024, 3)).astype(np.float32)
    # aimed near a random instance's origin
    centers = np.stack([m[:3, 3] for _, m in transforms])
    d = (centers[rng.integers(0, 8, 1024)] - o
         + rng.normal(size=(1024, 3)) * 0.6).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ray_mask = np.full(1024, 0xFFFF, np.int32)
    ray_mask[::4] = 0x2
    t_max = rng.uniform(2.0, 10.0, 1024).astype(np.float32)
    jtables = jtrl.make_tlas_rayloop_tables(jtlas)
    return dict(jtlas=jtlas, ptlas=from_numpy_tlas8(jtlas, device="cpu"),
                jtables=jtables,
                ptables=from_numpy_tlas_rayloop_tables(jtables, device="cpu"),
                rays=tt.make_rays(o, d, mask=ray_mask, device="cpu"),
                jrays=tb.make_rays(o, d, mask=jnp.asarray(ray_mask)),
                t_max=t_max)


def test_tables_match_jax(scene):
    pt = ptrl.make_tlas_rayloop_tables(scene["ptlas"])
    jt = scene["jtables"]
    for k in ("bounds", "child", "leaf_row", "leaf_prim", "inv_flat",
              "inst_mask", "inst_root"):
        np.testing.assert_array_equal(getattr(pt, k).numpy(),
                                      np.asarray(getattr(jt, k)), err_msg=k)
    assert (pt.n_leaf_rows, pt.n_inst) == (jt.n_leaf_rows, jt.n_inst)


@pytest.mark.parametrize("ladder", ["ladder", "single"])
def test_intersect_tlas_rayloop_matches_jax(scene, ladder):
    kw = LADDER if ladder == "ladder" else dict(levels=1)
    h, sovf = ptrl.intersect_tlas_rayloop(scene["ptables"], scene["rays"],
                                          **kw)
    assert len(ptrl.LAST_CALL["sizes"]) == (3 if ladder == "ladder" else 1)
    jh, jsovf = jtrl.intersect_tlas_rayloop(scene["jtables"], scene["jrays"],
                                            **kw)
    assert not sovf.any() and not np.asarray(jsovf).any()
    assert ptrl.LAST_CALL["overflows"] == 0
    p = h.prim.numpy()
    np.testing.assert_array_equal(p, np.asarray(jh.prim))
    np.testing.assert_array_equal(h.inst.numpy(), np.asarray(jh.inst))
    m = p >= 0
    assert 0.1 < m.mean() < 0.9
    for name, tol in (("t", 1e-4), ("u", 1e-3), ("v", 1e-3)):
        np.testing.assert_allclose(getattr(h, name).numpy()[m],
                                   np.asarray(getattr(jh, name))[m],
                                   rtol=tol, atol=tol, err_msg=name)
    # the masked rays reach only the instances of mask 0x2 (odd ids)
    masked = np.zeros(1024, bool)
    masked[::4] = True
    assert (h.inst.numpy()[masked & m] % 2 == 1).all()
    # the port's lockstep two-level engine: the same hits
    ref = intersect_tlas8(scene["ptlas"], scene["rays"])
    np.testing.assert_array_equal(m, ref.prim.numpy() >= 0)
    np.testing.assert_allclose(h.t.numpy()[m], ref.t.numpy()[m], rtol=1e-4,
                               atol=1e-4)


def test_is_occluded_tlas_rayloop_matches_jax(scene):
    t_max = torch.from_numpy(scene["t_max"])
    occ, sovf = ptrl.is_occluded_tlas_rayloop(scene["ptables"],
                                              scene["rays"], t_max, **LADDER)
    jocc, _ = jtrl.is_occluded_tlas_rayloop(
        scene["jtables"], scene["jrays"], jnp.asarray(scene["t_max"]),
        **LADDER)
    assert not sovf.any()
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))
    want = is_occluded_tlas8(scene["ptlas"], scene["rays"], t_max)
    np.testing.assert_array_equal(occ.numpy(), want.numpy())
    assert 0.1 < occ.numpy().mean() < 0.9


def test_max_rounds_raises(scene):
    with pytest.raises(RuntimeError, match="max_rounds"):
        ptrl.intersect_tlas_rayloop(scene["ptables"], scene["rays"],
                                    max_rounds=1, **LADDER)
