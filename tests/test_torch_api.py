"""tinybvh_tpu_torch.BVH on the CPU against tinybvh_tpu.BVH and the
brute-force oracle (the kernels' plain twins run on CPU tensors).

Tolerances as tests/test_packet2.py:141-160: prim equal, t within
rtol = atol = 1e-4, u and v within 1e-3. On the CPU "auto" takes the
wavefront engine (as the JAX API does off the TPU), so the packet path is
asked for by name.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import tinybvh_tpu as tb  # noqa: E402
import tinybvh_tpu_torch as tt  # noqa: E402
from tinybvh_tpu_torch.config import use_config  # noqa: E402
from tinybvh_tpu_torch.core.intersect import (  # noqa: E402
    brute_force_any, brute_force_closest,
)
from tinybvh_tpu_torch.io.loaders import random_tris  # noqa: E402
from tests.test_torch_jax_native import jax_native  # noqa: E402,F401


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs one test file per worker process: keep torch's
    intra-op pool small so the workers do not oversubscribe the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def scene():
    tris = random_tris(3000, seed=0)
    return tris, tt.BVH(tris, device="cpu"), tb.BVH(tris)


def _camera(T=16, seed=4):
    """T 16x16 camera tiles from one eye, in tile order."""
    rng = np.random.default_rng(seed)
    eye = np.array([5.0, 5.0, -8.0], np.float32)
    d = []
    for _ in range(T):
        cx, cy = rng.uniform(-0.3, 0.3, 2)
        gx, gy = np.meshgrid((np.arange(16) + 0.5) / 16 * 0.05,
                             (np.arange(16) + 0.5) / 16 * 0.05)
        dd = np.stack([cx + gx, cy + gy, np.ones_like(gx)], -1)
        dd /= np.linalg.norm(dd, axis=-1, keepdims=True)
        d.append(dd.reshape(-1, 3))
    d = np.concatenate(d).astype(np.float32)
    return np.broadcast_to(eye, d.shape).copy(), d


def test_intersect_matches_jax_and_oracle(scene):
    tris, pb, jb = scene
    o, d = _camera()
    h = pb.intersect(tt.make_rays(o, d, device="cpu"), engine="packets")
    jh = jb.intersect(tb.make_rays(o, d), engine="packets")
    ref = brute_force_closest(tt.make_rays(o, d, device="cpu"), pb.tris)
    hp = h.prim.numpy()
    np.testing.assert_array_equal(hp, np.asarray(jh.prim))
    np.testing.assert_array_equal(hp, ref.prim.numpy())
    m = hp >= 0
    assert 0.2 < m.mean() < 1.0
    for name, tol in (("t", 1e-4), ("u", 1e-3), ("v", 1e-3)):
        got = getattr(h, name).numpy()[m]
        np.testing.assert_allclose(got, np.asarray(getattr(jh, name))[m],
                                   rtol=tol, atol=tol)
        np.testing.assert_allclose(got, getattr(ref, name).numpy()[m],
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("shared_origin", [True, False])
def test_is_occluded_matches_jax_and_oracle(scene, shared_origin):
    """Shadow segments: from one light (direction-bundled) and from
    scattered origins (coherence-sorted)."""
    tris, pb, jb = scene
    o, d = _camera()
    ref = brute_force_closest(tt.make_rays(o, d, device="cpu"), pb.tris)
    pts = o + np.where(ref.prim.numpy() >= 0, ref.t.numpy(), 20.0)[:, None] * d
    if shared_origin:
        src = np.broadcast_to(np.array([5.0, 14.0, 5.0], np.float32),
                              pts.shape).copy()
    else:
        src = np.random.default_rng(2).uniform(
            -2, 12, pts.shape).astype(np.float32)
    seg_d = (pts - src).astype(np.float32)
    cutoff = 1.0 - 1e-3
    occ = pb.is_occluded(tt.make_rays(src, seg_d, device="cpu"), cutoff,
                         engine="packets").numpy()
    jocc = np.asarray(jb.is_occluded(tb.make_rays(src, seg_d), cutoff))
    want = brute_force_any(tt.make_rays(src, seg_d, device="cpu"), pb.tris, cutoff).numpy()
    np.testing.assert_array_equal(occ, want)
    np.testing.assert_array_equal(occ, jocc)
    assert 0 < occ.mean() < 1


def test_from_vertex_buffer_equals_direct(scene):
    tris, pb, _ = scene
    buf = np.concatenate([tris.reshape(-1, 3),
                          np.ones((tris.shape[0] * 3, 1), np.float32)], 1)
    vb = tt.BVH.from_vertex_buffer(buf.reshape(-1), stride=4, device="cpu")
    assert torch.equal(vb.bvh8.leaf_prim, pb.bvh8.leaf_prim)
    # bit-compare: prim lanes hold int bits (-1 reads as a NaN float)
    assert torch.equal(vb.packet_aux.gtab_pad.view(torch.int32),
                       pb.packet_aux.gtab_pad.view(torch.int32))
    lo, hi = pb.aabb
    np.testing.assert_allclose(lo, tris.reshape(-1, 3).min(0))
    np.testing.assert_allclose(hi, tris.reshape(-1, 3).max(0))


def _same_bvh_hits(pb, jb, o, d, what, **kw):
    """Both BVHs' intersect(**kw) on the same rays: the parity standard,
    and the same hits as brute force."""
    h = pb.intersect(tt.make_rays(o, d, device="cpu"), **kw)
    _assert_hits(h, jb.intersect(tb.make_rays(o, d), **kw))
    _assert_hits(h, brute_force_closest(tt.make_rays(o, d, device="cpu"),
                                        pb.tris))
    assert 0 < (h.prim.numpy() >= 0).mean() < 1, what
    return h


@pytest.mark.parametrize("call", [
    "wavefront_watertight", "engine_rayloop", "small_batch_baldwin",
    "engine_lockstep2", "occluded_watertight", "builder_median",
    "layout_bvh2", "bins_not_8", "builder_lbvh"])
def test_ported_paths_match_jax(scene, call):
    """The calls that raised NotImplementedError before the BVH2, rayloop
    and leaf-test engines and the LBVH builder were ported: each against
    the JAX API on the same call (prim equal, t within 1e-4, u and v
    within 1e-3, occlusion equal), and against brute force. builder=
    "lbvh" also builds JAX's BVH2 array for array."""
    from tinybvh_tpu.config import use_config as jax_config

    tris, pb, jb = scene
    o, d = _camera(T=4)
    if call in ("wavefront_watertight", "small_batch_baldwin"):
        test = "watertight" if call == "wavefront_watertight" else "baldwin"
        engine = "wavefront" if test == "watertight" else "auto"
        with use_config(tri_test=test), jax_config(tri_test=test):
            _same_bvh_hits(pb, jb, o, d, call, engine=engine)
    elif call == "engine_rayloop":
        h = _same_bvh_hits(pb, jb, o, d, call, engine="rayloop")
        pts = o + np.where(h.prim.numpy() >= 0, h.t.numpy(), 20.0)[:, None] * d
        src = np.broadcast_to(np.array([5.0, 14.0, 5.0], np.float32),
                              pts.shape).copy()
        seg = (pts - src).astype(np.float32)
        occ = pb.is_occluded(tt.make_rays(src, seg, device="cpu"), 0.999,
                             engine="rayloop").numpy()
        np.testing.assert_array_equal(occ, np.asarray(jb.is_occluded(
            tb.make_rays(src, seg), 0.999, engine="rayloop")))
        np.testing.assert_array_equal(occ, brute_force_any(
            tt.make_rays(src, seg, device="cpu"), pb.tris, 0.999).numpy())
        assert 0 < occ.mean() < 1
    elif call == "engine_lockstep2":
        # a ragged batch through the BVH2 engine
        o, d = np.concatenate([o, o[:100]]), np.concatenate([d, d[:100]])
        _same_bvh_hits(pb, jb, o, d, call, engine="lockstep2")
    elif call == "occluded_watertight":
        tm = np.random.default_rng(8).uniform(5.0, 15.0, o.shape[0]).astype(
            np.float32)
        with use_config(tri_test="watertight"), \
                jax_config(tri_test="watertight"):
            occ = pb.is_occluded(tt.make_rays(o, d, device="cpu"),
                                 torch.from_numpy(tm)).numpy()
            jocc = np.asarray(jb.is_occluded(tb.make_rays(o, d),
                                             jnp.asarray(tm)))
        np.testing.assert_array_equal(occ, jocc)
        assert 0 < occ.mean() < 1
    else:
        kw = {"builder_median": dict(builder="median"),
              "layout_bvh2": dict(layout="bvh2"),
              "bins_not_8": dict(bins=4),
              "builder_lbvh": dict(builder="lbvh")}[call]
        pb2 = tt.BVH(tris, device="cpu", **kw)
        jb2 = tb.BVH(tris, **kw)
        if call == "builder_lbvh":
            for k in ("node_min", "node_max", "left_first", "count",
                      "prim_idx"):
                np.testing.assert_array_equal(
                    getattr(pb2.bvh2, k).numpy(),
                    np.asarray(getattr(jb2.bvh2, k)), err_msg=k)
        assert pb2.leaf_max == jb2.leaf_max
        assert (pb2.bvh8 is None) == (jb2.bvh8 is None) == (
            call == "layout_bvh2")
        if pb2.bvh8 is not None:
            np.testing.assert_array_equal(pb2.bvh8.leaf_prim.numpy(),
                                          np.asarray(jb2.bvh8.leaf_prim))
        np.testing.assert_array_equal(pb2.packed_tris.numpy(),
                                      np.asarray(jb2.packed_tris))
        _same_bvh_hits(pb2, jb2, o, d, call)


def test_validate_rays_gate():
    from tinybvh_tpu_torch.config import use_config

    o = np.zeros((4, 3), np.float32)
    d = np.ones((4, 3), np.float32)
    d[1] = 0.0
    tt.make_rays(o, d, device="cpu")
    with use_config(validate_rays=True):
        with pytest.raises(ValueError):
            tt.make_rays(o, d, device="cpu")


def test_loaders_match_jax(tmp_path):
    """The port's numpy loaders are copies: same scenes, same file format."""
    from tinybvh_tpu.io import loaders as jl
    from tinybvh_tpu_torch.io import loaders as pl

    np.testing.assert_array_equal(pl.random_tris(64, seed=3),
                                  jl.random_tris(64, seed=3))
    np.testing.assert_array_equal(pl.sphere_tris(6, 8), jl.sphere_tris(6, 8))
    tris = pl.random_tris(10, seed=1)
    path = tmp_path / "soup.bin"
    rec = np.concatenate([tris, np.ones((10, 3, 1), np.float32)], axis=2)
    path.write_bytes(np.int32(10).tobytes() + rec.tobytes())
    np.testing.assert_array_equal(pl.load_bin(str(path)), tris)
    np.testing.assert_array_equal(jl.load_bin(str(path)), tris)


def _assert_hits(h, ref):
    """prim equal on every ray; t, u, v within the parity tolerances."""
    hp = h.prim.numpy()
    rp = np.asarray(ref.prim.numpy() if hasattr(ref.prim, "numpy")
                    else ref.prim)
    np.testing.assert_array_equal(hp, rp)
    m = hp >= 0
    for name, tol in (("t", 1e-4), ("u", 1e-3), ("v", 1e-3)):
        want = getattr(ref, name)
        want = want.numpy() if isinstance(want, torch.Tensor) else np.asarray(
            want)
        np.testing.assert_allclose(getattr(h, name).numpy()[m], want[m],
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("n", [100, 1000, 2148])
def test_small_and_ragged_batches(scene, n):
    """Batches under 4096 rays or not a multiple of 256 take the wavefront
    engine: the same hits as the JAX API and the oracle."""
    _, pb, jb = scene
    o, d = _camera()
    o, d = o[:n], d[:n]
    h = pb.intersect(tt.make_rays(o, d, device="cpu"))
    _assert_hits(h, jb.intersect(tb.make_rays(o, d)))
    _assert_hits(h, brute_force_closest(tt.make_rays(o, d, device="cpu"), pb.tris))
    assert 0 < (h.prim.numpy() >= 0).mean() < 1


def test_per_ray_t_max(scene):
    """A per-ray t_max (even on a packet-shaped batch, and with
    engine="packets", as in JAX) goes to the wavefront engine."""
    _, pb, jb = scene
    o, d = _camera()
    rays = tt.make_rays(o, d, device="cpu")
    full = pb.intersect(rays, engine="wavefront")
    tm = np.random.default_rng(8).uniform(5.0, 15.0, o.shape[0]).astype(
        np.float32)
    for engine in ("auto", "packets"):
        h = pb.intersect(rays, t_max=torch.from_numpy(tm), engine=engine)
        keep = full.t.numpy() < tm
        np.testing.assert_array_equal(h.prim.numpy(),
                                      np.where(keep, full.prim.numpy(), -1))
        _assert_hits(h, jb.intersect(tb.make_rays(o, d),
                                     t_max=jnp.asarray(tm), engine=engine))
    assert 0 < keep.mean() < 1
    occ = pb.is_occluded(rays, torch.from_numpy(tm))
    want = brute_force_any(rays, pb.tris, torch.from_numpy(tm))
    np.testing.assert_array_equal(occ.numpy(), want.numpy())


@pytest.mark.parametrize("engine", ["auto", "wavefront", "lockstep"])
def test_engines_match_jax_and_oracle(scene, engine):
    """The wavefront and lockstep engines (and "auto", which is the
    wavefront on the CPU) against the JAX API's same engine and the
    oracles, for hits and shadow segments."""
    _, pb, jb = scene
    o, d = _camera(T=4)
    rays = tt.make_rays(o, d, device="cpu")
    h = pb.intersect(rays, engine=engine)
    _assert_hits(h, jb.intersect(tb.make_rays(o, d), engine=engine))
    _assert_hits(h, brute_force_closest(rays, pb.tris))
    pts = o + np.where(h.prim.numpy() >= 0, h.t.numpy(), 20.0)[:, None] * d
    src = np.broadcast_to(np.array([5.0, 14.0, 5.0], np.float32),
                          pts.shape).copy()
    seg = (pts - src).astype(np.float32)
    occ = pb.is_occluded(tt.make_rays(src, seg, device="cpu"), 0.999, engine=engine)
    want = brute_force_any(tt.make_rays(src, seg, device="cpu"), pb.tris, 0.999)
    np.testing.assert_array_equal(occ.numpy(), want.numpy())
    jocc = jb.is_occluded(tb.make_rays(src, seg), 0.999, engine=engine)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))
    assert 0 < occ.numpy().mean() < 1


def _with_wide_tiles(n_wide):
    """Camera tiles, then n_wide tiles of rays in every direction from the
    scene's middle (those overflow the cpu row's 256-leaf budget)."""
    rng = np.random.default_rng(9)
    dw = rng.normal(size=(256 * n_wide, 3)).astype(np.float32)
    dw /= np.linalg.norm(dw, axis=1, keepdims=True)
    ow = np.full((256 * n_wide, 3), 5.0, np.float32)
    if n_wide == 16:
        return ow, dw
    o, d = _camera(T=16 - n_wide)
    return np.concatenate([o, ow]), np.concatenate([d, dw])


def test_packet_overflow_repaired_by_wavefront_retrace(scene, monkeypatch):
    """engine="packets" on a batch with overflowing tiles: the wavefront
    retrace runs and the hits equal the JAX API's and the oracle's."""
    from tinybvh_tpu_torch.traverse import wavefront

    _, pb, jb = scene
    o, d = _with_wide_tiles(2)
    rays = tt.make_rays(o, d, device="cpu")
    calls = []
    real = wavefront.intersect_wavefront

    def spy(*a, **kw):
        calls.append(kw)
        return real(*a, **kw)

    monkeypatch.setattr(wavefront, "intersect_wavefront", spy)
    h = pb.intersect(rays, engine="packets")
    assert calls and calls[0]["cap_factor"] == 8
    _assert_hits(h, brute_force_closest(rays, pb.tris))
    _assert_hits(h, jb.intersect(tb.make_rays(o, d), engine="packets"))


def test_residual_overflow_raises(scene, monkeypatch):
    """When the wavefront retrace's own frontier overflows, the API raises
    instead of returning inexact hits."""
    import dataclasses

    from tinybvh_tpu_torch import tuning

    _, pb, _ = scene
    monkeypatch.setitem(tuning._TABLES, "cpu", dataclasses.replace(
        tuning._TABLES["cpu"], wf_cap_factor=1))
    o, d = _with_wide_tiles(16)
    with pytest.raises(RuntimeError, match="frontier"):
        pb.intersect(tt.make_rays(o, d, device="cpu"), engine="packets")
