"""The port's TLAS packet engines (tlas/packet.py) against the JAX
package, on the CPU.

The first seven tests mirror tests/test_tlas_packet.py on the port alone,
against its exact lockstep two-level traversal (itself held to JAX in
tests/test_torch_tlas.py). The rest hold the port to the JAX functions
(Pallas in interpret mode, as tests/test_tlas_packet.py runs them) on
the same tables, carried over with convert.from_numpy_tlas_packet:
intersect_tlas_packets2, its sorted and bucketed forms and
is_occluded_tlas_packets2, with prim and inst equal except exact ties
(both t within a relative 1e-6), t within rtol = atol = 1e-4, u and v
within 1e-3, and overflow masks equal. The JAX results are computed once
per module, as each interpret-mode call takes seconds.
"""

from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import tinybvh_tpu as tb  # noqa: E402
from tinybvh_tpu.tlas import packet as jpk  # noqa: E402
from tinybvh_tpu_torch import BVH, make_rays  # noqa: E402
from tinybvh_tpu_torch.convert import from_numpy_tlas_packet  # noqa: E402
from tinybvh_tpu_torch.core.vecmath import BVH_FAR  # noqa: E402
from tinybvh_tpu_torch.io.loaders import sphere_tris  # noqa: E402
from tinybvh_tpu_torch.tlas.instance import intersect_tlas8  # noqa: E402
from tinybvh_tpu_torch.tlas.packet import (  # noqa: E402
    build_tlas_packet, intersect_tlas_packets2,
    intersect_tlas_packets2_bucketed, intersect_tlas_packets2_sorted,
    is_occluded_tlas_packets2, scene_bounds, tile_candidates,
)
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


_MATS = np.stack([_mat((0, 0, 0)),
                  _mat((2.5, 0, 0), scale=0.8, yaw=0.4),
                  _mat((0, 2.5, 0), scale=1.2, yaw=1.1),
                  _mat((2.5, 2.5, 0), scale=0.6, yaw=2.0)])


@pytest.fixture(scope="module")
def inst_scene():
    """The 2x2 instance grid of tests/test_tlas_packet.py, built by the
    port from its own BVH."""
    tris = sphere_tris(8, 12, radius=0.8)
    return build_tlas_packet([BVH(tris, device="cpu").bvh8], _MATS)


def _camera_arrays(T=8, seed=5):
    """T 16x16 tiles from one eye, aimed across the 2x2 instance grid."""
    rng = np.random.default_rng(seed)
    eye = np.array([1.2, 1.2, -6.0], np.float32)
    d = []
    for _ in range(T):
        cx, cy = rng.uniform(-0.45, 0.45, 2)
        gx, gy = np.meshgrid((np.arange(16) + 0.5) / 16 * 0.12,
                             (np.arange(16) + 0.5) / 16 * 0.12)
        dd = np.stack([cx + gx, cy + gy, np.full_like(gx, 1.0)], -1)
        dd /= np.linalg.norm(dd, axis=-1, keepdims=True)
        d.append(dd.reshape(-1, 3))
    d = np.concatenate(d).astype(np.float32)
    return np.broadcast_to(eye, d.shape).copy(), d


def _camera_rays(T=8, seed=5):
    return make_rays(*_camera_arrays(T, seed), device="cpu")


def _same_hits(h, ref, t_tol=(1e-4, 1e-5)):
    """prim and inst equal, t within t_tol where the reference hits."""
    np.testing.assert_array_equal(_np(h.prim), _np(ref.prim))
    np.testing.assert_array_equal(_np(h.inst), _np(ref.inst))
    ok = _np(ref.prim) >= 0
    np.testing.assert_allclose(_np(h.t)[ok], _np(ref.t)[ok], rtol=t_tol[0],
                               atol=t_tol[1])


# ---- mirrors of tests/test_tlas_packet.py --------------------------------

def test_tlas_packet_matches_lockstep(inst_scene):
    tp = inst_scene
    rays = _camera_rays()
    hits, ovf = intersect_tlas_packets2(tp, rays)
    ref = intersect_tlas8(tp.tlas, rays)
    hit_ref = _np(ref.prim) >= 0
    assert hit_ref.mean() > 0.1, "camera missed the scene (bad fixture)"
    np.testing.assert_array_equal(_np(hits.prim) >= 0, hit_ref)
    np.testing.assert_allclose(_np(hits.t)[hit_ref], _np(ref.t)[hit_ref],
                               rtol=1e-4, atol=1e-5)
    # inst and the BLAS-local prim agree
    np.testing.assert_array_equal(_np(hits.inst)[hit_ref],
                                  _np(ref.inst)[hit_ref])
    np.testing.assert_array_equal(_np(hits.prim)[hit_ref],
                                  _np(ref.prim)[hit_ref])


def test_tlas_packet_mask_hides_instance(inst_scene):
    tp = inst_scene
    masked = replace(tp, inst_mask=torch.tensor([0xFFFF, 0, 0xFFFF, 0xFFFF],
                                                dtype=torch.int32))
    rays = _camera_rays()
    hits, _ = intersect_tlas_packets2(masked, rays)
    assert not (_np(hits.inst) == 1).any()
    # rays that hit instance 1 now see through it
    ref = intersect_tlas8(tp.tlas, rays)
    was1 = _np(ref.inst) == 1
    assert was1.any()
    assert (_np(hits.t)[was1] >= _np(ref.t)[was1] - 1e-5).all()


def test_tlas_packet_overflow_retrace(inst_scene):
    """A tiny leaf budget forces overflow; the wavefront retrace in the
    same call still gives the exact result."""
    tp = inst_scene
    rays = _camera_rays(T=4)
    hits, ovf = intersect_tlas_packets2(tp, rays, max_leaves=32, retrace=True)
    assert not bool(ovf.any())
    ref = intersect_tlas8(tp.tlas, rays)
    hit_ref = _np(ref.prim) >= 0
    np.testing.assert_array_equal(_np(hits.prim) >= 0, hit_ref)
    np.testing.assert_allclose(_np(hits.t)[hit_ref], _np(ref.t)[hit_ref],
                               rtol=1e-4, atol=1e-5)


def _shadow_points():
    rng = np.random.default_rng(11)
    light = np.array([1.2, 1.2, -6.0], np.float32)
    return light, rng.uniform(-1.5, 4.0, (512, 3)).astype(np.float32)


def test_tlas_packet_occlusion(inst_scene):
    """Shared-origin shadow segments: the occlusion fold across instances
    matches segment tests against the lockstep engine."""
    tp = inst_scene
    light, pts = _shadow_points()
    occ, ovf = is_occluded_tlas_packets2(tp, light, pts)
    rays = make_rays(np.broadcast_to(light, pts.shape).copy(), pts - light,
                     device="cpu")
    ref = intersect_tlas8(tp.tlas, rays)
    np.testing.assert_array_equal(
        _np(occ), (_np(ref.prim) >= 0) & (_np(ref.t) < 1.0 - 1e-3))


def test_bucketed_matches_lockstep(inst_scene):
    tp = inst_scene
    rays = _camera_rays(T=8)
    hits, ovf = intersect_tlas_packets2_bucketed(tp, rays, rounds=4,
                                                 max_leaves=256,
                                                 retrace=False)
    assert not bool(ovf.any())
    _same_hits(hits, intersect_tlas8(tp.tlas, rays, BVH_FAR))


def test_bucketed_round_overflow_retraced(inst_scene):
    """rounds below the per-tile candidate count flag the tiles, and the
    wavefront retrace restores exact hits."""
    tp = inst_scene
    rays = _camera_rays(T=4, seed=11)
    hits, ovf = intersect_tlas_packets2_bucketed(
        tp, rays, rounds=1, max_leaves=256, retrace=True, wf_cap_factor=24)
    ref = intersect_tlas8(tp.tlas, rays, BVH_FAR)
    np.testing.assert_array_equal(_np(hits.prim), _np(ref.prim))
    np.testing.assert_array_equal(_np(hits.inst), _np(ref.inst))
    assert not bool(ovf.any())


def test_bucketed_many_instances():
    """64 instances of one BLAS (≙ the 3,375-instance layout,
    tiny_bvh_gpu2.cpp:124-136): hits equal the lockstep oracle's."""
    tris = sphere_tris(6, 10, radius=0.45)
    rng = np.random.default_rng(3)
    mats = [_mat(((i % 8) * 1.1, (i // 8) * 1.1, 0),
                 scale=float(rng.uniform(0.5, 1.0)),
                 yaw=float(rng.uniform(0, 3.0))) for i in range(64)]
    tp = build_tlas_packet([BVH(tris, device="cpu").bvh8], np.stack(mats))
    o, d = _camera_arrays(T=4, seed=9)
    rays = make_rays(o + np.float32([2.5, 2.5, 0]), d, device="cpu")
    hits, ovf = intersect_tlas_packets2_bucketed(
        tp, rays, rounds=8, max_leaves=256, retrace=True, wf_cap_factor=24)
    ref = intersect_tlas8(tp.tlas, rays, BVH_FAR)
    np.testing.assert_array_equal(_np(hits.prim), _np(ref.prim))
    np.testing.assert_array_equal(_np(hits.inst), _np(ref.inst))
    assert not bool(ovf.any())


# ---- parity with the JAX package -----------------------------------------

def _grid_arrays(n=32):
    """An n x n camera over the whole 2x2 grid from the fixture's eye, in
    16x16 tile order (most rays hit; tiles see several instances)."""
    eye = np.array([1.2, 1.2, -6.0], np.float32)
    xs = np.linspace(-0.36, 0.36, n)
    gx, gy = np.meshgrid(xs, xs)
    d = np.stack([gx, gy, np.ones_like(gx)], -1)
    d = d.reshape(n // 16, 16, n // 16, 16, 3).transpose(0, 2, 1, 3, 4)
    d = d.reshape(-1, 3)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return np.broadcast_to(eye, d.shape).copy(), d


def _same_bits(a, b, what=""):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert a.tobytes() == b.tobytes(), what


@pytest.fixture(scope="module")
def both():
    """The 2x2 grid in both packages: the JAX TLASPacket (host tables) and
    the port's copy of exactly its tables."""
    tris = sphere_tris(8, 12, radius=0.8)
    jb = tb.BVH(tris)
    jtp = jpk.build_tlas_packet([jb.bvh8], _MATS, host8s=[jb._bvh8_host])
    return tris, jb, jtp, from_numpy_tlas_packet(jtp, device="cpu")


def test_build_tlas_packet_matches_jax(both):
    """The port's own build (packet tables built from the BLAS's tensors)
    equals the JAX package's (host tables) bit for bit: TLAS, packet
    tables, prim tables, inverses and world boxes."""
    tris, jb, jtp, _ = both
    pb = BVH(tris, device="cpu")
    ptp = build_tlas_packet([pb.bvh8], _MATS)
    for k in ("bounds", "child", "leaf_tris", "leaf_prim", "inst_inv",
              "inst_mask", "inst_root"):
        _same_bits(getattr(ptp.tlas, k), getattr(jtp.tlas, k), k)
    for k in ("inst_inv", "inst_mask", "prim_tris", "prim_off", "inst_wlo",
              "inst_whi"):
        _same_bits(getattr(ptp, k), getattr(jtp, k), k)
    for k in ("leaf_lo", "leaf_hi", "blk_lo", "blk_hi", "gtab_pad",
              "center"):
        _same_bits(getattr(ptp.auxes[0], k), getattr(jtp.auxes[0], k), k)
    assert ptp.blas_of == jtp.blas_of
    for a, b in zip(scene_bounds(both[3]), jpk.scene_bounds(jtp)):
        _same_bits(a, b)


def assert_hits_match(h, j):
    """prim and inst equal except exact ties; t, u, v within the stated
    tolerances where both agree."""
    p, pr = _np(h.prim), _np(j.prim)
    t, tr = _np(h.t), _np(j.t)
    diff = (p != pr) | (_np(h.inst) != _np(j.inst))
    tie = np.abs(t - tr) <= 1e-6 * np.maximum(np.abs(tr), 1e-30)
    assert not (diff & ~tie).any(), f"{int((diff & ~tie).sum())} rays"
    m = ~diff & (pr >= 0)
    assert m.mean() > 0.1
    np.testing.assert_allclose(t[m], tr[m], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(h.u)[m], _np(j.u)[m], rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_allclose(_np(h.v)[m], _np(j.v)[m], rtol=1e-3,
                               atol=1e-3)


@pytest.mark.parametrize("case", ["no_retrace", "wavefront", "packet"])
def test_intersect_tlas_packets2_matches_jax(both, case):
    """Per-instance passes: plain (8 tiles), a 32-leaf budget with the
    wavefront retrace, and the escalated packet retrace."""
    _, _, jtp, ptp = both
    o, d = _grid_arrays()
    kw = {"no_retrace": dict(retrace=False),
          "wavefront": dict(max_leaves=32, retrace=True),
          "packet": dict(max_leaves=32, retrace="packet",
                         retrace_ml=256)}[case]
    h, ovf = intersect_tlas_packets2(ptp, make_rays(o, d, device="cpu"),
                                     **kw)
    jh, jovf = jpk.intersect_tlas_packets2(jtp, tb.make_rays(o, d),
                                           interpret=True, **kw)
    assert_hits_match(h, jh)
    np.testing.assert_array_equal(_np(ovf), _np(jovf))


@pytest.mark.parametrize("case", ["rounds4", "rounds1_wavefront",
                                  "packet_escalation"])
def test_bucketed_matches_jax(both, case):
    """The bucketed engine: 4 rounds with no retrace; 1 round (candidate
    overflow) with the wavefront retrace; a 32-leaf budget escalated in
    each round (retrace="packet"). Candidate counts as JAX's probe takes
    them."""
    _, _, jtp, ptp = both
    kw = {"rounds4": dict(rounds=4, max_leaves=256, retrace=False),
          "rounds1_wavefront": dict(rounds=1, max_leaves=256, retrace=True,
                                    wf_cap_factor=24),
          "packet_escalation": dict(rounds=4, max_leaves=32,
                                    retrace="packet", retrace_ml=512,
                                    retrace_blocks=8)}[case]
    o, d = _grid_arrays()
    rays = make_rays(o, d, device="cpu")
    h, ovf = intersect_tlas_packets2_bucketed(ptp, rays, **kw)
    jh, jovf = jpk.intersect_tlas_packets2_bucketed(
        jtp, tb.make_rays(o, d), interpret=True, **kw)
    assert_hits_match(h, jh)
    np.testing.assert_array_equal(_np(ovf), _np(jovf))
    (_, cand, n_cand), = tile_candidates(ptp, rays, kw["rounds"])
    assert int(n_cand.max()) > 1 and cand.shape == (4, kw["rounds"])


def test_sorted_matches_jax(both):
    """Shuffled rays through the coherence sort, scattered back."""
    _, _, jtp, ptp = both
    o, d = _grid_arrays()
    perm = np.random.default_rng(2).permutation(o.shape[0])
    o, d = o[perm], d[perm]
    lo, hi = (np.float32([-1.5, -1.5, -1.5]), np.float32([4.0, 4.0, 1.5]))
    h, ovf = intersect_tlas_packets2_sorted(
        ptp, make_rays(o, d, device="cpu"), lo, hi, retrace=False)
    jh, jovf = jpk.intersect_tlas_packets2_sorted(
        jtp, tb.make_rays(o, d), jnp.asarray(lo), jnp.asarray(hi),
        interpret=True, retrace=False)
    assert_hits_match(h, jh)
    np.testing.assert_array_equal(_np(ovf), _np(jovf))


@pytest.mark.parametrize("max_leaves", [256, 16])
def test_is_occluded_matches_jax(both, max_leaves):
    """Shadow segments; at 16 leaves tiles overflow and the any-hit
    two-level wavefront resolves them."""
    _, _, jtp, ptp = both
    light, pts = _shadow_points()
    occ, ovf = is_occluded_tlas_packets2(ptp, light, pts,
                                         max_leaves=max_leaves)
    jocc, jovf = jpk.is_occluded_tlas_packets2(
        jtp, jnp.asarray(light), jnp.asarray(pts), max_leaves=max_leaves,
        interpret=True)
    np.testing.assert_array_equal(_np(occ), _np(jocc))
    np.testing.assert_array_equal(_np(ovf), _np(jovf))
    assert 0 < _np(occ).mean() < 1


def test_singular_transform_quirk_matches_jax(both):
    """A zero-scale instance: build_tlas maps it to the identity with mask
    0, but build_tlas_packet inverts the transforms with no guard and
    raises numpy's LinAlgError, in both packages (ROADMAP queue 3)."""
    tris, jb, _, _ = both
    mats = _MATS.copy()
    mats[1, :3, :3] = 0.0
    with pytest.raises(np.linalg.LinAlgError):
        jpk.build_tlas_packet([jb.bvh8], mats)
    with pytest.raises(np.linalg.LinAlgError):
        build_tlas_packet([BVH(tris, device="cpu").bvh8], mats)
