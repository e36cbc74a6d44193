"""The plain reference against rays and triangles built by hand, and
against the program's own brute-force oracle."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from harness import reference
from harness.scene import minimal_soup

from portbench_tiny import BASE, ROOT

TRI = torch.tensor([[[-1.0, -1.0, 5.0], [1.0, -1.0, 5.0], [0.0, 1.0, 5.0]],
                    [[-1.0, -1.0, 7.0], [1.0, -1.0, 7.0], [0.0, 1.0, 7.0]]])


def _rays(o, d):
    return (torch.tensor(o, dtype=torch.float32),
            torch.tensor(d, dtype=torch.float32))


@pytest.mark.parametrize("precision", reference.PRECISIONS)
def test_closest_by_hand(precision):
    o, d = _rays([[0, 0, 0], [0.2, -0.5, 0], [5, 5, 0], [0, 0, 0],
                  [0, 0, 6], [0, 0, 10], [0, 0, 0]],
                 [[0, 0, 1], [0, 0, 2], [0, 0, 1], [1, 0, 0],
                  [0, 0, 1], [0, 0, 1], [0, 0, 1]])
    t_max = torch.tensor([1e30] * 6 + [4.0])
    t, prim = reference.closest(TRI, o, d, t_max, precision)
    # nearer triangle; the same at half speed; off the side; parallel;
    # from between the two; behind both; cut by t_max
    assert prim.tolist() == [0, 0, -1, -1, 1, -1, -1]
    assert t[0] == 5.0 and t[1] == 2.5 and t[4] == 1.0
    assert t[2] == 1e30 and t[6] == 1e30


@pytest.mark.parametrize("precision", reference.PRECISIONS)
def test_occluded_by_hand(precision):
    o, d = _rays([[0, 0, 0], [0, 0, 0], [5, 5, 0], [0, 0, 8]],
                 [[0, 0, 10], [0, 0, 4], [0, 0, 1], [0, 0, -2]])
    # a hit at t = 0.5; one past the segment's end; off the side; from
    # behind, at t = 0.5
    occ = reference.occluded(TRI, o, d, 0.999, precision)
    assert occ.tolist() == [True, False, False, True]
    occ = reference.occluded(TRI, o, d, 0.4, precision)   # stops short
    assert occ.tolist() == [False, False, False, False]


def _soup_rays(n_tris=2000, n_rays=3000, seed=4):
    tris = torch.from_numpy(minimal_soup(n_tris, seed, 1.5))
    g = torch.Generator().manual_seed(seed)
    o = torch.rand((n_rays, 3), generator=g) * 1.5
    d = torch.nn.functional.normalize(torch.randn((n_rays, 3), generator=g),
                                      dim=1)
    return tris, o, d


def test_closest_agrees_with_the_programs_oracle():
    from tinybvh_tpu_torch.core.intersect import brute_force_closest
    from tinybvh_tpu_torch.core.rays import make_rays

    tris, o, d = _soup_rays()
    ref = brute_force_closest(make_rays(o, d, device="cpu"), tris)
    t, prim = reference.closest(tris, o, d, 1e30, "fp32", ray_block=256,
                                tri_block=700)
    assert float((prim == ref.prim.long()).double().mean()) > 0.9995
    same = (prim == ref.prim.long()) & (prim >= 0)
    assert float(((t - ref.t).abs() / ref.t)[same].max()) < 1e-5
    occ = reference.occluded(tris, o, d, 3.0, "fp32")
    want = (ref.prim >= 0) & (ref.t < 3.0)
    assert float((occ == want).double().mean()) > 0.9995


def test_tf32_rounding():
    x = torch.randn(10000) * 1e3
    r = reference.round_tf32(x)
    assert torch.equal(reference.round_tf32(r), r)
    assert float(((r - x).abs() / x.abs()).max()) <= 2.0 ** -11
    bits = r.view(torch.int32)
    assert int((bits & 0x1FFF).abs().max()) == 0


def test_the_control_reads_apart_from_the_reference():
    tris, o, d = _soup_rays(n_rays=4000)
    t, prim = reference.closest(tris, o, d, 1e30, "fp32")
    tc, pc = reference.closest(tris, o, d, 1e30, "tf32")
    assert float((pc != prim).double().mean()) > 0.002
    same = (pc == prim) & (prim >= 0)
    assert float(((tc - t).abs() / t)[same].max()) > 1e-4


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path[:0] = [sys.argv[1]]; "
            "from harness import reference, hits, scene; "
            "import torch; tris = torch.rand(8, 3, 3); o = torch.rand(4, 3); "
            "reference.closest(tris, o, o + 1.0); "
            "reference.occluded(tris, o, o + 1.0, 0.5); "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code, str(BASE)],
                         capture_output=True, text=True, check=True,
                         cwd=ROOT).stdout
    tops = eval(out.strip().splitlines()[-1])
    assert not {"tinybvh_tpu_torch", "tinybvh_tpu", "jax", "jaxlib",
                "flax"} & set(tops)
