"""The benchmark measures the PyTorch port alone: nothing it runs loads
JAX or the JAX package, compared by whole top-level name."""

import ast
import subprocess
import sys
import types

import pytest

from harness import cell as cellmod
from harness import guard

from portbench_tiny import BASE, ROOT


def test_guard_compares_whole_top_level_names():
    mods = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
            "tinybvh_tpu", "tinybvh_tpu.api", "tinybvh_tpu_torch",
            "tinybvh_tpu_torch.api", "jaxtyping", "torch"]
    assert guard.forbidden_loaded(mods) == sorted(
        ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
         "tinybvh_tpu", "tinybvh_tpu.api"])


def test_a_run_with_jax_loaded_exits_without_a_result(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(SystemExit) as e:
        cellmod.forbidden_exit("after the window")
    assert e.value.code != 0


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_file_of_the_benchmark_imports_jax():
    files = [p for p in BASE.rglob("*.py") if "tests" not in p.parts]
    assert files
    for p in files:
        bad = [m for m in _imports(p) if m.split(".")[0] in guard.FORBIDDEN]
        assert not bad, (p, bad)


def test_the_reference_imports_nothing_of_the_program():
    for p in [BASE / "harness" / "reference.py",
              BASE / "harness" / "hits.py"]:
        assert not [m for m in _imports(p) if m.startswith("tinybvh")]


def test_a_whole_run_loads_no_jax(tmp_path):
    """A tiny cell's whole run in a fresh interpreter, the program and
    its torch paths included: no module of JAX or the JAX package."""
    code = f"""
import sys, time
sys.path[:0] = [{str(BASE / 'tests')!r}, {str(BASE)!r}, {str(ROOT)!r}]
import torch
torch.set_num_threads(2)
from portbench_tiny import tiny_tree
from harness import cell, guard
from harness.spec import load_cell
from pathlib import Path
tree = tiny_tree(Path({str(tmp_path)!r}))
r = cell.run(load_cell("tiny-primary", *tree), 5, 0.5, True, "cpu",
             time.perf_counter())
print("tinybvh_tpu_torch" in sys.modules, guard.forbidden_loaded())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=tmp_path).stdout
    assert out.strip().splitlines()[-1] == "True []"
