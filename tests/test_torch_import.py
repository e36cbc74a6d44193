"""The port imports without JAX and without a CUDA toolchain, and its
kernel wrappers never fall back: CPU tensors take the plain twin, other
devices raise."""

import os
import shutil
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_loads_no_jax():
    code = (
        "import sys\n"
        "import tinybvh_tpu_torch\n"
        "import tinybvh_tpu_torch.convert, tinybvh_tpu_torch.tuning\n"
        "import tinybvh_tpu_torch.traverse.packet2, tinybvh_tpu_torch._build\n"
        "import tinybvh_tpu_torch.native, tinybvh_tpu_torch.io.loaders\n"
        "import tinybvh_tpu_torch.core.intersect\n"
        "import tinybvh_tpu_torch.traverse.packet\n"
        "import tinybvh_tpu_torch.traverse.leaf_resolve\n"
        "import tinybvh_tpu_torch.traverse.frustum_walk\n"
        "import tinybvh_tpu_torch.tlas.instance, tinybvh_tpu_torch.tlas.packet\n"
        "import tinybvh_tpu_torch.builders.binned\n"
        "import tinybvh_tpu_torch.builders.refit\n"
        "import tinybvh_tpu_torch.builders.lbvh\n"
        "import tinybvh_tpu_torch.builders.binned_device\n"
        "import tinybvh_tpu_torch.builders.sweep\n"
        "import tinybvh_tpu_torch.builders.sbvh\n"
        "import tinybvh_tpu_torch.builders.optimize\n"
        "import tinybvh_tpu_torch.layouts.cwbvh\n"
        "import tinybvh_tpu_torch.layouts.leafshape\n"
        "import tinybvh_tpu_torch.io.serialize\n"
        "import tinybvh_tpu_torch.layouts.bvh2\n"
        "import tinybvh_tpu_torch.traverse.stack\n"
        "import tinybvh_tpu_torch.traverse.rayloop\n"
        "import tinybvh_tpu_torch.tlas.rayloop\n"
        "import tinybvh_tpu_torch.core.vecmath, tinybvh_tpu_torch.config\n"
        "import tinybvh_tpu_torch.probes.gather\n"
        "import tinybvh_tpu_torch.probes.mt_ablation\n"
        "import tinybvh_tpu_torch.core.rng\n"
        "import tinybvh_tpu_torch.render.camera\n"
        "import tinybvh_tpu_torch.render.textures\n"
        "import tinybvh_tpu_torch.render.pathtracer\n"
        "import tinybvh_tpu_torch.render.pathtracer_tlas\n"
        "import tinybvh_tpu_torch.scene.mesh, tinybvh_tpu_torch.scene.graph\n"
        "import tinybvh_tpu_torch.parallel.mesh\n"
        "import tinybvh_tpu_torch.parallel.launch\n"
        "import tinybvh_tpu_torch.ops.f64\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'tinybvh_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_build_module_imports_without_nvcc(monkeypatch):
    """_build imports anywhere; building needs nvcc and says so."""
    from tinybvh_tpu_torch import _build

    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this host has nvcc")
    monkeypatch.setattr(_build, "_kernels", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.kernels()


def test_builder_source_is_the_jax_packages():
    """The port compiles its own copy of the native builder; it must stay
    byte-identical to the JAX package's, so both build the same trees."""
    with open(os.path.join(REPO, "tinybvh_tpu", "native", "builder.c"),
              "rb") as f:
        jax_src = f.read()
    with open(os.path.join(REPO, "tinybvh_tpu_torch", "native", "builder.c"),
              "rb") as f:
        port_src = f.read()
    assert port_src == jax_src


@pytest.mark.parametrize("entry", ["bvh", "make_rays", "tuning", "scene",
                                   "primary_rays", "scene_arrays"])
def test_no_card_raises_unless_cpu_is_asked(monkeypatch, entry):
    """Without a CUDA device, the entry points raise instead of carrying
    on on the CPU; device="cpu" runs there."""
    import numpy as np

    from tinybvh_tpu_torch import BVH, make_rays
    from tinybvh_tpu_torch.io.loaders import random_tris
    from tinybvh_tpu_torch.render import camera, pathtracer
    from tinybvh_tpu_torch.scene.graph import Scene
    from tinybvh_tpu_torch.tuning import detect_generation

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    o = np.zeros((4, 3), np.float32)
    d = np.tile(np.float32([[0.0, 0.0, 1.0]]), (4, 1))
    cam = camera.look_at([0, 0, -5], [0, 0, 0])
    calls = {"bvh": lambda **kw: BVH(random_tris(64, seed=0), **kw),
             "make_rays": lambda **kw: make_rays(o, d, **kw),
             "tuning": lambda **kw: detect_generation(**kw),
             "scene": lambda **kw: Scene(**kw),
             "primary_rays": lambda **kw: camera.primary_rays(
                 *cam, 8, 4, **kw),
             "scene_arrays": lambda **kw: pathtracer.make_scene_arrays(
                 random_tris(8, seed=0), **kw)}
    with pytest.raises(RuntimeError, match='device="cpu"'):
        calls[entry]()
    out = calls[entry](device="cpu")
    if entry in ("make_rays", "primary_rays"):
        assert out.o.device.type == "cpu"
        # tensor inputs keep their own device
        assert make_rays(out.o, out.d).o.device.type == "cpu"
    elif entry in ("bvh", "scene"):
        assert out.device.type == "cpu"
    elif entry == "scene_arrays":
        assert all(v.device.type == "cpu" for v in out.values())
        # tensor triangles keep their own device
        assert pathtracer.make_scene_arrays(
            out["tris"])["tris"].device.type == "cpu"
    else:
        assert out == "cpu"


def _cull_args(device):
    G, mb, spad = 1, 1, 128
    return (torch.ones(G, dtype=torch.int32, device=device),
            torch.zeros((G, mb), dtype=torch.int32, device=device),
            torch.zeros((8 * G, 128), dtype=torch.float32, device=device),
            torch.zeros((3, spad), dtype=torch.float32, device=device),
            torch.ones((3, spad), dtype=torch.float32, device=device),
            100, 16, 18)


def test_cpu_tensors_take_the_plain_twin():
    """No build, no launch count: the plain twin ran. All-pass planes
    (zero planes, zero thresholds) keep all 100 live segments."""
    from tinybvh_tpu_torch.traverse import packet2

    before = dict(packet2.LAUNCHES)
    keys, cnt = packet2.cull(*_cull_args("cpu"))
    assert packet2.LAUNCHES == before
    assert cnt.tolist() == [0] * 8   # reach cap 0 drops everything
    args = list(_cull_args("cpu"))
    args[2][:, 34] = 1e30            # reach cap lane
    keys, cnt = packet2.cull(*args)
    assert cnt.tolist() == [100] * 8
    assert keys.shape == (8, 16)
    assert (keys & ((1 << 18) - 1)).tolist()[0] == list(range(16))


def test_other_devices_raise():
    """A tensor neither on the CPU nor on CUDA raises instead of moving
    work anywhere."""
    from tinybvh_tpu_torch.traverse import packet2

    with pytest.raises(ValueError):
        packet2.cull(*_cull_args("meta"))
    args = list(_cull_args("cpu"))
    args[0] = args[0].to("meta")
    with pytest.raises(ValueError):
        packet2.cull(*args)


def test_c_entries_match_their_ctypes_signatures():
    """Every `extern "C"` entry of csrc/*.cu has an argtypes list in
    _build._SIGNATURES with one entry a parameter, a pointer where the C
    parameter is one and an int where it is an int, and no list names an
    entry the sources lack (ctypes would cut a pointer passed as an int,
    or shift the stream, without a word)."""
    import ctypes
    import glob
    import re

    from tinybvh_tpu_torch import _build

    src = "".join(open(p).read() for p in sorted(glob.glob(
        os.path.join(_build.CSRC, "*.cu"))))
    entries = dict(re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src))
    assert set(entries) == set(_build._SIGNATURES)
    for name, params in entries.items():
        kinds = [ctypes.c_void_p if "*" in p else ctypes.c_int
                 for p in params.split(",")]
        assert _build._SIGNATURES[name] == kinds, name
