"""The packet path's exact retrace (traverse/retrace.py) off the card: the
wavefront's tie rule, which kernel R reproduces (tests/test_torch_cuda.py
holds the kernel to the wavefront on the card), the kernel's stack,
the plain path the wrapper takes for CPU tensors, and the wrapper's
checks, which raise before any launch."""

import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tinybvh_tpu_torch import _build  # noqa: E402
from tinybvh_tpu_torch.core.intersect import moller_trumbore  # noqa: E402
from tinybvh_tpu_torch.core.rays import Hits, make_rays  # noqa: E402
from tinybvh_tpu_torch.io.loaders import random_tris  # noqa: E402
from tinybvh_tpu_torch.traverse import packet2  # noqa: E402
from tinybvh_tpu_torch.traverse import retrace as rt  # noqa: E402
from tinybvh_tpu_torch.traverse.wavefront import (  # noqa: E402
    MAX_LEVELS, intersect_wavefront,
)

from test_torch_cuda import (  # noqa: E402
    TILE_R, _plate, chain_scene, plate_rays, tie_scene,
)


@pytest.fixture(autouse=True)
def _no_launch(monkeypatch):
    """No test here may reach the kernel library."""
    def refuse():
        raise AssertionError("a CPU call reached the kernel library")

    monkeypatch.setattr(_build, "kernels", refuse)


@pytest.mark.parametrize("case", ["depth", "lane", "row"])
def test_wavefront_keeps_the_least_key_on_a_tie(case):
    """Two triangles that every ray hits at the same t: the wavefront keeps
    the shallower leaf ("depth": row 1 at depth 1 over row 0 at depth 2),
    then the lower lane of one leaf ("lane") and the lower leaf row
    ("row"): the least (t, leaf depth, row * 4 + lane), the rule kernel R
    keeps. The retrace's plain path gives the same hits."""
    b8, prim = tie_scene(case, "cpu")
    rays = plate_rays(1, "cpu")
    tri = torch.from_numpy(_plate(5.0))      # both triangles' geometry
    hit, t, _, _ = moller_trumbore(rays.o, rays.d, tri[0], tri[1] - tri[0],
                                   tri[2] - tri[0], torch.full((TILE_R,),
                                                               1e30))
    assert bool(hit.all())
    h, ov = intersect_wavefront(b8, rays, cap_factor=8)
    assert not ov and bool((h.prim == prim).all())
    assert torch.equal(h.t, t)
    stale = Hits(t=torch.zeros(TILE_R), u=torch.zeros(TILE_R),
                 v=torch.zeros(TILE_R),
                 prim=torch.full((TILE_R,), -5, dtype=torch.int32),
                 inst=torch.full((TILE_R,), -1, dtype=torch.int32))
    h2, ov2 = rt.retrace_hits(b8, packet2.build_packet_aux(b8), rays,
                              torch.full((TILE_R,), 1e30), torch.ones(
                                  1, dtype=torch.bool), stale)
    assert not bool(ov2.any())
    for k in ("t", "u", "v", "prim"):
        assert torch.equal(getattr(h2, k), getattr(h, k)), k


def test_stack_holds_the_deepest_walk():
    """Kernel R's stack, as the kernel's source sizes it and as the
    wrapper records it (`cap`), holds 7 x 63 + 1 entries: the most a walk
    can stack, since a node at depth MAX_LEVELS - 1 pushes nothing."""
    src = open(os.path.join(_build.CSRC, "retrace.cu")).read()
    (stack,) = re.findall(r"constexpr int kStack = (\d+);", src)
    (levels,) = re.findall(r"constexpr int kMaxLevels = (\d+);", src)
    assert int(stack) == rt.STACK and int(levels) == MAX_LEVELS
    assert 7 * (MAX_LEVELS - 1) + 1 <= rt.STACK


def test_wavefront_flags_a_tree_deeper_than_max_levels():
    """The plain path on the 70-node chain: pairs are left at
    MAX_LEVELS, so every traced tile stays flagged; the rays still get
    the nearest hit, leaf 0."""
    b8 = chain_scene("cpu")
    rays = plate_rays(3, "cpu")
    R = rays.o.shape[0]
    stale = Hits(t=torch.zeros(R), u=torch.zeros(R), v=torch.zeros(R),
                 prim=torch.full((R,), -5, dtype=torch.int32),
                 inst=torch.full((R,), -1, dtype=torch.int32))
    h, ov = rt.retrace_hits(b8, packet2.build_packet_aux(b8), rays,
                            torch.full((R,), 1e30),
                            torch.tensor([True, False, True]), stale)
    assert ov.tolist() == [True, False, True]
    assert bool((h.prim[:TILE_R] == 0).all())
    assert bool((h.prim[TILE_R:2 * TILE_R] == -5).all())


@pytest.fixture(scope="module")
def cpu_scene():
    from tinybvh_tpu_torch import BVH

    bvh = BVH(random_tris(1000, seed=1), device="cpu")
    rng = np.random.default_rng(2)
    o = rng.uniform(1.0, 9.0, (4 * TILE_R, 3)).astype(np.float32)
    d = rng.normal(size=(4 * TILE_R, 3)).astype(np.float32)
    return bvh, make_rays(o, d, device="cpu")


def _stale(R):
    return Hits(t=torch.full((R,), -7.0), u=torch.full((R,), -1.0),
                v=torch.full((R,), -2.0),
                prim=torch.full((R,), -5, dtype=torch.int32),
                inst=torch.full((R,), -1, dtype=torch.int32))


def test_cpu_tensors_take_the_plain_path(cpu_scene):
    """On CPU tensors the retrace is the wavefront merged over the packet
    pass's hits, closest and any hit, with no launch."""
    bvh, rays = cpu_scene
    R = rays.o.shape[0]
    ovf = torch.tensor([True, False, True, True])
    tm = torch.full((R,), 6.0)
    before = dict(rt.LAUNCHES)
    h, ov = rt.retrace_hits(bvh.bvh8, bvh.packet_aux, rays, tm, ovf.clone(),
                            _stale(R))
    ref, ref_ov = intersect_wavefront(
        bvh.bvh8, rays, t_max=torch.where(
            torch.repeat_interleave(ovf, TILE_R), tm, 0.0), cap_factor=8)
    sent = torch.repeat_interleave(ovf, TILE_R)
    for k in ("t", "u", "v", "prim"):
        got = getattr(h, k)
        assert torch.equal(got[sent], getattr(ref, k)[sent]), k
        assert torch.equal(got[~sent], getattr(_stale(R), k)[~sent]), k
    assert torch.equal(ov, ovf & ref_ov)
    occ0 = torch.zeros(R, dtype=torch.bool)
    occ, ov = rt.retrace_occluded(bvh.bvh8, bvh.packet_aux, rays, 6.0,
                                  ovf.clone(), occ0)
    assert torch.equal(occ, sent & (ref.prim >= 0))
    assert rt.LAUNCHES == before


BAD_INPUTS = ("t_max_dtype", "t_max_shape", "prim_dtype", "overflow_shape",
              "omap_shape", "device")


@pytest.mark.parametrize("case", BAD_INPUTS)
def test_wrapper_rejects_bad_inputs_before_any_launch(cpu_scene, case):
    """Kernel R's wrapper checks dtype, shape and contiguity of every
    tensor, and the retrace refuses tensors on several devices, before
    the kernel library is reached (the fixture makes reaching it fail)."""
    bvh, rays = cpu_scene
    R = rays.o.shape[0]
    aux = bvh.packet_aux
    tm = torch.full((R,), 6.0)
    ovf = torch.ones(4, dtype=torch.bool)
    hits = _stale(R)
    if case == "device":
        with pytest.raises(ValueError, match="several devices"):
            rt.retrace_hits(bvh.bvh8, aux, rays, tm.to("meta"), ovf, hits)
        return
    if case == "t_max_dtype":
        tm = tm.double()
    elif case == "t_max_shape":
        tm = tm[:-1]
    elif case == "prim_dtype":
        hits.prim = hits.prim.long()
    elif case == "overflow_shape":
        ovf = ovf[:3]
    elif case == "omap_shape":
        L = bvh.bvh8.leaf_tris.shape[0]
        aux = packet2.PacketAux(**{**aux.__dict__, "omap": torch.ones(
            (L, 4, 8, 4), dtype=torch.bool)})
    err = TypeError if case.endswith("dtype") else ValueError
    with pytest.raises(err):
        rt._retrace_cuda(bvh.bvh8, aux, rays, tm, ovf, hits=hits)


def test_smoke_holds_the_retrace_to_its_twin_on_captured_arguments():
    """chip_smoke.py's check of kernel R on the main path: capture_retrace
    records each retrace's arguments with the overflow mask and the hits
    (or flags) cloned before the call rewrites them; retrace_twins runs
    the twin on them (here on the CPU, where the kernel's place is the
    twin's) and raises where a path sent nothing to the retrace."""
    import chip_smoke as cs

    dev = torch.device("cpu")
    bvh, rays, center, extent, _ = cs.setup_scene(random_tris(1000, seed=3),
                                                  dev, 32)
    kw = dict(max_leaves=4, max_blocks=256, retrace=True, wf_cap_factor=64)
    rec, restore = cs.capture_retrace()
    try:
        hits, ov = packet2.intersect_packets2(bvh.bvh8, bvh.packet_aux, rays,
                                              **kw)
        light, pts, _ = cs.shadow_rays(hits, rays, center, extent)
        packet2.is_occluded_packets2_sorted(bvh.bvh8, bvh.packet_aux, light,
                                            pts, 0.999, **kw)
    finally:
        restore()
    assert rt.retrace_hits.__name__ == "retrace_hits"
    (args, kwargs), = rec["retrace_hits"]
    assert kwargs == {"cap_factor": 64}
    sent, before = args[4], args[5]
    assert bool(sent.any()) and not bool(ov.any())
    assert bool((before.prim != hits.prim).any())   # cloned before the call
    out = cs.retrace_twins(rec, dev, "cpu")
    assert {k: v["max_abs_err"] for k, v in out.items()} == {
        "retrace": 0.0, "retrace_any": 0.0}
    rec["retrace_occluded"].clear()
    with pytest.raises(AssertionError, match="no retrace_occluded call"):
        cs.retrace_twins(rec, dev, "cpu")
