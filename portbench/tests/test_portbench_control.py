"""The control of the output check: the plain reference computed in TF32,
put in the program's place inside a whole run, has to come out as not
correct. On the card at each cell's own scene, mix and sample, on three
seeds; on the CPU at a tiny size, where TF32 is rounded by hand."""

import json
import time

import pytest

from harness import cell as cellmod
from harness.spec import load_cell

from portbench_tiny import ROOT, TINY, tiny_tree

CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _control_run(cell, seed, device):
    return cellmod.run(cell, seed, 1.0, False, device, time.perf_counter(),
                       control_precision="tf32")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [11, 2 ** 33 + 12, 13])
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct_on_the_card(cuda, name, seed):
    r = _control_run(load_cell(name), seed, "cuda")
    assert r["failed"] == 0 and r["attempted"] > 0
    assert r["correct"] is False, r["check"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return tiny_tree(tmp_path_factory.mktemp("tiny"), triangles=2048)


@pytest.mark.parametrize("name", sorted(TINY))
def test_control_is_not_correct_on_the_cpu(tree, name):
    r = _control_run(load_cell(name, *tree), 5, "cpu")
    assert r["failed"] == 0 and r["attempted"] > 0
    assert r["correct"] is False, r["check"]
