"""The port's rayloop engine against the JAX package's and brute force, on
the CPU (mirrors tests/test_rayloop.py).

Both engines trace the same tables: JAX's make_rayloop_tables carried
into the port with convert.from_numpy_rayloop_tables (and the port's own
tables held equal to them). 2048 incoherent rays; min_size=128 makes the
ladder 2048 -> 512 -> 128, two compactions; levels=1 keeps one level.
Tolerances: ROADMAP's parity standard, prim equal on every ray, t within
rtol = atol = 1e-4, u and v within 1e-3; occlusion and the stack-overflow
flags equal."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import tinybvh_tpu as tb  # noqa: E402
from tinybvh_tpu.traverse import rayloop as jrl  # noqa: E402
import tinybvh_tpu_torch as tt  # noqa: E402
from tinybvh_tpu_torch.convert import from_numpy_rayloop_tables  # noqa: E402
from tinybvh_tpu_torch.core.intersect import (  # noqa: E402
    brute_force_any, brute_force_closest,
)
from tinybvh_tpu_torch.io.loaders import random_tris  # noqa: E402
from tinybvh_tpu_torch.traverse import rayloop as prl  # noqa: E402
from tests.test_torch_jax_native import jax_native  # noqa: E402,F401

LADDER = dict(min_size=128, k=4, LQ=12)
SINGLE = dict(levels=1)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """One test file per worker process: keep torch's pool small."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def scene():
    tris = random_tris(3000, seed=0)
    jb = tb.BVH(tris)
    pb = tt.BVH(tris, device="cpu")
    rng = np.random.default_rng(21)
    o = rng.uniform(-2, 12, (2048, 3)).astype(np.float32)
    d = rng.normal(size=(2048, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = rng.uniform(2.0, 14.0, 2048).astype(np.float32)
    return dict(tris=tris, jb=jb, pb=pb, o=o, d=d, t_max=t_max,
                rays=tt.make_rays(o, d, device="cpu"),
                jrays=tb.make_rays(o, d))


def _tables(scene, quantized):
    """JAX's tables, and the same carried into the port."""
    jt = jrl.make_rayloop_tables(scene["jb"].bvh8, quantized=quantized,
                                 host=scene["jb"]._bvh8_host)
    return jt, from_numpy_rayloop_tables(jt, device="cpu")


@pytest.mark.parametrize("quantized", [False, True])
def test_tables_match_jax(scene, quantized):
    """The port's tables, from the host copy and from the device BVH8,
    equal JAX's bit for bit."""
    jt, _ = _tables(scene, quantized)
    pb = scene["pb"]
    for host in (pb._bvh8_host, None):
        pt = prl.make_rayloop_tables(pb.bvh8, quantized=quantized, host=host)
        assert pt.quantized == quantized
        for k in ("bounds", "qbounds", "qmeta", "child", "leaf_row",
                  "leaf_prim"):
            want = getattr(jt, k)
            if want is None:
                assert getattr(pt, k) is None, k
            else:
                np.testing.assert_array_equal(getattr(pt, k).numpy(),
                                              np.asarray(want), err_msg=k)


def _assert_same_hits(h, jh):
    p = h.prim.numpy()
    np.testing.assert_array_equal(p, np.asarray(jh.prim))
    m = p >= 0
    for name, tol in (("t", 1e-4), ("u", 1e-3), ("v", 1e-3)):
        np.testing.assert_allclose(getattr(h, name).numpy()[m],
                                   np.asarray(getattr(jh, name))[m],
                                   rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize("ladder", ["ladder", "single"])
@pytest.mark.parametrize("quantized", [False, True])
def test_intersect_rayloop_matches_jax(scene, quantized, ladder):
    jt, pt = _tables(scene, quantized)
    kw = LADDER if ladder == "ladder" else SINGLE
    h, sovf = prl.intersect_rayloop(pt, scene["rays"], **kw)
    assert len(prl.LAST_CALL["sizes"]) == (3 if ladder == "ladder" else 1)
    assert prl.LAST_CALL["sizes"][0] == 2048
    jh, jsovf = jrl.intersect_rayloop(jt, scene["jrays"], **kw)
    _assert_same_hits(h, jh)
    assert not sovf.any() and not np.asarray(jsovf).any()
    ref = brute_force_closest(scene["rays"], scene["pb"].tris)
    np.testing.assert_array_equal(h.prim.numpy(), ref.prim.numpy())
    assert 0.1 < (h.prim.numpy() >= 0).mean() < 0.9


@pytest.mark.parametrize("ladder", ["ladder", "single"])
@pytest.mark.parametrize("quantized", [False, True])
def test_is_occluded_rayloop_matches_jax(scene, quantized, ladder):
    """Shadow segments with a per-ray t_max."""
    jt, pt = _tables(scene, quantized)
    kw = LADDER if ladder == "ladder" else SINGLE
    t_max = torch.from_numpy(scene["t_max"])
    occ, sovf = prl.is_occluded_rayloop(pt, scene["rays"], t_max, **kw)
    jocc, jsovf = jrl.is_occluded_rayloop(
        jt, scene["jrays"], jnp.asarray(scene["t_max"]), **kw)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))
    assert not sovf.any() and not np.asarray(jsovf).any()
    want = brute_force_any(scene["rays"], scene["pb"].tris, t_max)
    np.testing.assert_array_equal(occ.numpy(), want.numpy())
    assert 0.1 < occ.numpy().mean() < 0.9


def test_stack_overflow_flags_match_jax(scene):
    """With a 2-entry stack the pushes past it are dropped and flagged,
    on the same rays as in JAX (a spare column takes them); LAST_CALL
    counts the flagged rays."""
    jt, pt = _tables(scene, False)
    h, sovf = prl.intersect_rayloop(pt, scene["rays"], S=2, **LADDER)
    assert prl.LAST_CALL["overflows"] == int(sovf.sum())
    jh, jsovf = jrl.intersect_rayloop(jt, scene["jrays"], S=2, **LADDER)
    np.testing.assert_array_equal(sovf.numpy(), np.asarray(jsovf))
    assert 0.1 < sovf.numpy().mean() < 1.0
    _assert_same_hits(h, jh)


@pytest.mark.parametrize("anyhit", [False, True])
def test_max_rounds_raises(scene, anyhit):
    """A level that runs out of max_rounds raises instead of returning the
    live rays' partial hits (JAX's compaction drops them silently)."""
    _, pt = _tables(scene, False)
    with pytest.raises(RuntimeError, match="max_rounds"):
        if anyhit:
            prl.is_occluded_rayloop(pt, scene["rays"], 1e30, max_rounds=1,
                                    **LADDER)
        else:
            prl.intersect_rayloop(pt, scene["rays"], max_rounds=1, **LADDER)
