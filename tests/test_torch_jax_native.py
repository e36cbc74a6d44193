"""The JAX package's native builder, loaded in every worker that compares
the port's trees with JAX's.

`tinybvh_tpu/native/__init__.py` compiles `builder.c` to one fixed
temporary name (`libtinybvh.so.tmp`), renames it into place, and on any
`OSError` pins its numpy fallback for the rest of the process (`_tried`).
When several test workers build at once on a fresh tree (the `.so` is
ignored by git), their compiles write over each other's temporary file
and a loser builds every JAX tree with the numpy builder and the Python
collapse. Those trees differ from the native ones that the port builds
(the port compiles its own copy of `builder.c` under a per-process
name), so a parity test would then fail, or pass, against the wrong
tree.

`jax_native` (autouse, module scope) guards every port test module that
compares a tree or table with one the JAX package built: the modules
import it by name. Where a C compiler exists and the loader has failed,
it reloads the loader module, which clears `_lib` and `_tried`, until
the library loads (the winning worker's rename lands within a second),
for up to `RETRY_S` seconds; then it fails, naming the race. It never
lets a test fall through to a numpy-built tree. This module imports
nothing of JAX at the top, so that the processes of its own test can
import `load_native` cheaply.
"""

import importlib
import json
import os
import shutil
import subprocess
import sys
import time

import pytest

RETRY_S = 20.0


def load_native(native, retry_s=RETRY_S, pause_s=0.2):
    """The loader module `native` (tinybvh_tpu.native, or a copy of it)
    with its library loaded: reloaded until `available()` holds. Returns
    (module, reloads). Without a C compiler the module is returned as it
    is (both packages then build with numpy). Raises RuntimeError when
    the library still does not load after `retry_s` seconds."""
    if native.available() or shutil.which("cc") is None:
        return native, 0
    deadline = time.monotonic() + retry_s
    reloads = 0
    while time.monotonic() < deadline:
        time.sleep(pause_s)
        native = importlib.reload(native)
        reloads += 1
        if native.available():
            return native, reloads
    raise RuntimeError(
        f"{native.__name__}: the native builder did not load after "
        f"{reloads} reloads in {retry_s} s. Its loader compiles to one "
        "fixed temporary name, so test workers that build it at once "
        "overwrite each other's file (the first-build race); refusing to "
        "compare the port's trees with numpy-built ones")


@pytest.fixture(scope="module", autouse=True)
def jax_native():
    """tinybvh_tpu.native with its library loaded in this worker (see the
    module's docstring); fails the module's tests otherwise."""
    from tinybvh_tpu import native

    try:
        return load_native(native)[0]
    except RuntimeError as e:
        pytest.fail(str(e))


_CHILD = """
import importlib, json, os, sys, time
copy_dir, tests_dir, sync_dir, me = sys.argv[1:5]
sys.path[:0] = [copy_dir, tests_dir]
from test_torch_jax_native import load_native
mod = importlib.import_module("jaxnative")
open(os.path.join(sync_dir, "ready" + me), "w").close()
go, deadline = os.path.join(sync_dir, "go"), time.monotonic() + 120
while not os.path.exists(go):
    if time.monotonic() > deadline:
        sys.exit("no go file after 120 s")
    time.sleep(0.001)
first = mod.available()
mod, reloads = load_native(mod)
print(json.dumps({"first": first, "final": mod.available(),
                  "reloads": reloads}))
"""
N_CHILDREN = 6
READY_S = 90.0     # for all children to import, under a loaded test run
ROUNDS = 3         # fresh copies raced before a race without a loser fails


def _race(repo, round_dir):
    """One round: N_CHILDREN processes import a fresh copy of the JAX
    loader in `round_dir`, each writes a ready file, and once all are
    ready the go file starts their first builds at once. Returns each
    child's {"first", "final", "reloads"}."""
    copy, sync = round_dir / "jaxnative", round_dir / "sync"
    copy.mkdir(parents=True)
    sync.mkdir()
    for name in ("__init__.py", "builder.c"):
        shutil.copy(os.path.join(repo, "tinybvh_tpu", "native", name),
                    copy / name)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CHILD, str(round_dir),
         os.path.dirname(os.path.abspath(__file__)), str(sync), str(k)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for k in range(N_CHILDREN)]
    try:
        deadline = time.monotonic() + READY_S
        while len(list(sync.glob("ready*"))) < N_CHILDREN:
            dead = [p for p in procs if p.poll() is not None]
            if dead:
                pytest.fail(f"a racer exited before the start: "
                            f"{dead[0].communicate()[1][-2000:]}")
            if time.monotonic() > deadline:
                pytest.fail(f"only {len(list(sync.glob('ready*')))} of "
                            f"{N_CHILDREN} racers had imported the loader "
                            f"after {READY_S} s; the race never started")
            time.sleep(0.01)
        (sync / "go").touch()
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    return [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]


def test_load_native_survives_the_first_build_race(tmp_path):
    """Six processes load a fresh copy of the JAX loader (its
    __init__.py and builder.c, never the repo's own library, which other
    workers use), held at a barrier until all have imported it, then
    started at once, so their first builds race: at least one loses its
    first build (a round where none does is run again on a fresh copy, up
    to ROUNDS), and with load_native's reloads every one ends with the
    library loaded."""
    if shutil.which("cc") is None:
        pytest.skip("needs a C compiler")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    rounds = []
    for k in range(ROUNDS):
        res = _race(repo, tmp_path / f"round{k}")
        rounds.append(res)
        assert all(r["final"] for r in res), res
        assert os.path.exists(tmp_path / f"round{k}" / "jaxnative"
                              / "libtinybvh.so")
        if any(not r["first"] and r["reloads"] >= 1 for r in res):
            break
    assert any(not r["first"] and r["reloads"] >= 1 for r in rounds[-1]), \
        rounds
