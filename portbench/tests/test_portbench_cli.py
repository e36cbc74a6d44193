"""run.py from the command line."""

import json
import shutil
import subprocess
import sys

import pytest

from portbench_tiny import BASE, ROOT


def _run(cwd, *args):
    return subprocess.run([sys.executable, "portbench/run.py", *args],
                          capture_output=True, text=True, cwd=cwd,
                          timeout=600)


def test_alone_the_benchmark_exits_without_a_result(tmp_path):
    """In a directory with only BENCHMARK.json and the benchmark's files
    the program is missing: no result, a non-zero exit."""
    shutil.copytree(BASE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    p = _run(tmp_path, "--workload", "tris64k-primary", "--seed", "1",
             "--seconds", "1", "--trace", "0")
    assert p.returncode != 0
    assert not p.stdout.strip()


def test_without_a_card_no_result(cuda_absent):
    p = _run(ROOT, "--workload", "tris64k-primary", "--seed", "1",
             "--seconds", "1", "--trace", "0")
    assert p.returncode != 0 and not p.stdout.strip()
    assert "CUDA" in p.stderr


@pytest.fixture
def cuda_absent():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


@pytest.mark.cuda
def test_one_short_run_on_the_card(cuda):
    p = _run(ROOT, "--workload", "tris64k-shadow", "--seed", str(2 ** 33),
             "--seconds", "2", "--trace", "1")
    assert p.returncode == 0, p.stderr[-2000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
    assert r["device"]["busy_s"] > 0 and "port_kernel_ms" in r["metrics"]
    assert list(r)[-1] == "check"
