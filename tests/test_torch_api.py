"""tinybvh_tpu_torch.BVH on the CPU against tinybvh_tpu.BVH and the
brute-force oracle (the kernels' plain twins run on CPU tensors).

Tolerances as tests/test_packet2.py:141-160: prim equal, t within
rtol = atol = 1e-4, u and v within 1e-3.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tinybvh_tpu as tb  # noqa: E402
import tinybvh_tpu_torch as tt  # noqa: E402
from tinybvh_tpu_torch.core.intersect import (  # noqa: E402
    brute_force_any, brute_force_closest,
)
from tinybvh_tpu_torch.io.loaders import random_tris  # noqa: E402


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
    h = pb.intersect(tt.make_rays(o, d))
    jh = jb.intersect(tb.make_rays(o, d), engine="packets")
    ref = brute_force_closest(tt.make_rays(o, d), pb.tris)
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
    ref = brute_force_closest(tt.make_rays(o, d), pb.tris)
    pts = o + np.where(ref.prim.numpy() >= 0, ref.t.numpy(), 20.0)[:, None] * d
    if shared_origin:
        src = np.broadcast_to(np.array([5.0, 14.0, 5.0], np.float32),
                              pts.shape).copy()
    else:
        src = np.random.default_rng(2).uniform(
            -2, 12, pts.shape).astype(np.float32)
    seg_d = (pts - src).astype(np.float32)
    cutoff = 1.0 - 1e-3
    occ = pb.is_occluded(tt.make_rays(src, seg_d), cutoff).numpy()
    jocc = np.asarray(jb.is_occluded(tb.make_rays(src, seg_d), cutoff))
    want = brute_force_any(tt.make_rays(src, seg_d), pb.tris, cutoff).numpy()
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


@pytest.mark.parametrize("call", [
    "engine_wavefront", "engine_rayloop", "small_batch", "odd_batch",
    "per_ray_tmax", "refit", "builder_lbvh", "layout_bvh2", "tlas"])
def test_unported_paths_raise(scene, call):
    tris, pb, _ = scene
    o, d = _camera()
    rays = tt.make_rays(o, d)
    with pytest.raises(NotImplementedError):
        if call == "engine_wavefront":
            pb.intersect(rays, engine="wavefront")
        elif call == "engine_rayloop":
            pb.is_occluded(rays, 1.0, engine="rayloop")
        elif call == "small_batch":
            pb.intersect(tt.make_rays(o[:2048], d[:2048]))
        elif call == "odd_batch":
            pb.intersect(tt.make_rays(np.concatenate([o, o[:100]]),
                                      np.concatenate([d, d[:100]])))
        elif call == "per_ray_tmax":
            pb.intersect(rays, t_max=torch.full((o.shape[0],), 5.0))
        elif call == "refit":
            pb.refit()
        elif call == "builder_lbvh":
            tt.BVH(tris, builder="lbvh", device="cpu")
        elif call == "layout_bvh2":
            tt.BVH(tris, layout="bvh2", device="cpu")
        else:
            tt.TLAS([pb], np.eye(4, dtype=np.float32)[None])


def test_validate_rays_gate():
    from tinybvh_tpu_torch.config import use_config

    o = np.zeros((4, 3), np.float32)
    d = np.ones((4, 3), np.float32)
    d[1] = 0.0
    tt.make_rays(o, d)
    with use_config(validate_rays=True):
        with pytest.raises(ValueError):
            tt.make_rays(o, d)


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
