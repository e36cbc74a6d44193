"""The output check, driven through a whole run of a tiny cell on the CPU
with the timed call broken underneath: each fault has to come out as not
correct, and the sound run as correct."""

import time

import pytest
import torch

from harness import cell as cellmod
from harness.spec import load_cell

from portbench_tiny import tiny_tree


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return tiny_tree(tmp_path_factory.mktemp("tiny"))


def _run(tree, name, fault=None, seconds=1.0, seed=2 ** 35 + 3):
    cell = load_cell(name, *tree)
    return cellmod.run(cell, seed, seconds, False, "cpu",
                       time.perf_counter(), fault=fault)


def stale(fn):
    """Every call answers with the first call's result."""
    first = []

    def g(b):
        out = fn(b)
        if not first:
            first.append(out)
        return first[0]
    return g


def half_left_out(fn):
    """Only the first half of the batch is traced; the rest miss."""
    def g(b):
        out = fn(b)
        R = out.shape[0] if isinstance(out, torch.Tensor) else out.t.shape[0]
        if isinstance(out, torch.Tensor):
            out = out.clone()
            out[R // 2:] = False
            return out
        out = type(out)(*(x.clone() for x in (out.t, out.u, out.v, out.prim,
                                              out.inst)))
        out.t[R // 2:] = 1e30
        out.prim[R // 2:] = -1
        return out
    return g


def altered(fn):
    """One answer in 50 altered where it is produced: another prim, or
    the occlusion flag flipped."""
    def g(b):
        out = fn(b)
        if isinstance(out, torch.Tensor):
            out = out.clone()
            out[::50] = ~out[::50]
            return out
        prim = out.prim.clone()
        prim[::50] = torch.where(prim[::50] >= 0, prim[::50] + 1, 0)
        out.prim = prim
        return out
    return g


def t_scaled(fn):
    """Every hit distance a thousandth too long."""
    def g(b):
        out = fn(b)
        out.t = out.t * 1.001
        return out
    return g


def raises(fn):
    """Each call past the warm-up raises, as the API does when its
    retrace's frontier overflows."""
    n = []

    def g(b):
        n.append(1)
        if len(n) > 3:       # the tiny mixes warm up on 3 batches
            raise RuntimeError("the retrace's frontier overflowed")
        return fn(b)
    return g


@pytest.mark.parametrize("name", ["tiny-primary", "tiny-shadow",
                                  "tiny-diffuse"])
def test_sound_run_is_correct(tree, name):
    r = _run(tree, name)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "check"
    assert all(v["value"] <= v["limit"] for v in r["check"].values())


@pytest.mark.parametrize("fault", [stale, half_left_out, altered, raises])
@pytest.mark.parametrize("name", ["tiny-primary", "tiny-shadow",
                                  "tiny-diffuse"])
def test_faults_are_not_correct(tree, name, fault):
    r = _run(tree, name, fault=fault)
    assert r["correct"] is False


def test_a_longer_t_is_not_correct(tree):
    r = _run(tree, "tiny-primary", fault=t_scaled)
    assert r["correct"] is False
    assert r["check"]["t_err_max"]["value"] > r["check"]["t_err_max"]["limit"]


def test_failed_calls_are_counted(tree):
    r = _run(tree, "tiny-shadow", fault=raises)
    assert r["failed"] == r["attempted"] > 0
    assert r["check"]["failed_calls"]["value"] == r["failed"]
