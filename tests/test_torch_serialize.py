"""The port's io/serialize.py against the JAX package's (mirrors
tests/test_ops.py's serialization tests and test_save_load_bvh8q).

One structure of each layout (BVH2, BVH8, BVH8Q, TLAS8) is built by the
JAX package and carried into the port (convert.from_numpy_*). A file
saved by JAX loads in the port equal to the carried structure, a file
saved by the port loads in JAX equal to JAX's, and both files hold the
same arrays under the same names and dtypes with the same tag. A bad
tag or a corrupt file loads as None in both packages.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tinybvh_tpu.builders.binned import build_binned as j_build  # noqa: E402
from tinybvh_tpu.io import serialize as jser  # noqa: E402
from tinybvh_tpu.layouts.cwbvh import quantize_bvh8 as j_quantize  # noqa: E402
from tinybvh_tpu.layouts.mbvh import collapse_bvh2 as j_collapse  # noqa: E402
from tinybvh_tpu.tlas.instance import build_tlas as j_build_tlas  # noqa: E402
from tinybvh_tpu_torch import convert  # noqa: E402
from tinybvh_tpu_torch.builders.binned import build_binned  # noqa: E402
from tinybvh_tpu_torch.io import serialize as pser  # noqa: E402
from tinybvh_tpu_torch.io.loaders import random_tris  # noqa: E402
from tinybvh_tpu_torch.layouts.bvh2 import BVH2  # noqa: E402
from tinybvh_tpu_torch.layouts.cwbvh import BVH8Q  # noqa: E402
from tinybvh_tpu_torch.layouts.mbvh import BVH8  # noqa: E402
from tinybvh_tpu_torch.tlas.instance import TLAS8  # noqa: E402
from tests.test_torch_jax_native import jax_native  # noqa: E402,F401

LAYOUTS = {"BVH2": BVH2, "BVH8": BVH8, "BVH8Q": BVH8Q, "TLAS8": TLAS8}


@pytest.fixture(scope="module")
def structures():
    """{layout: (JAX's structure, the port's copy)}."""
    tris = random_tris(300, seed=5)
    j2 = j_build(tris, max_leaf=4)
    j8 = j_collapse(j2, tris)
    mats = [np.eye(4, dtype=np.float32) for _ in range(3)]
    for i, m in enumerate(mats):
        m[:3, 3] = [12.0 * i, 0.0, 0.0]
    jt = j_build_tlas([j8], np.stack(mats))
    jq = j_quantize(j8)
    return {"BVH2": (j2, convert.from_numpy_bvh2(j2, device="cpu")),
            "BVH8": (j8, convert.from_numpy_bvh8(j8, device="cpu")),
            "BVH8Q": (jq, convert.from_numpy_bvh8q(jq, device="cpu")),
            "TLAS8": (jt, convert.from_numpy_tlas8(jt, device="cpu"))}


def _arrays(obj):
    """Every field of a structure of either package, as numpy."""
    out = {}
    for k, v in vars(obj).items():
        if isinstance(v, torch.Tensor):
            out[k] = v.numpy()
        elif k in ("n_nodes", "n_leaf_rows"):
            out[k] = int(np.asarray(v))
        else:
            out[k] = np.asarray(v)
    return out


def _assert_same(got, want):
    a, b = _arrays(got), _arrays(want)
    assert a.keys() == b.keys()
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype or isinstance(
            a[k], int), k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_files_load_across_packages(structures, layout, tmp_path):
    jobj, pobj = structures[layout]
    jpath, ppath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jser.save_bvh(jpath, jobj)
    pser.save_bvh(ppath, pobj)
    # the port loads JAX's file ...
    got = pser.load_bvh(jpath, device="cpu")
    assert type(got) is LAYOUTS[layout]
    _assert_same(got, pobj)
    # ... JAX loads the port's ...
    _assert_same(jser.load_bvh(ppath), jobj)
    # ... and both files hold the same arrays, names, dtypes and tag
    jf, pf = np.load(jpath), np.load(ppath)
    assert jf.files == pf.files
    for k in jf.files:
        assert jf[k].dtype == pf[k].dtype, k
        np.testing.assert_array_equal(jf[k], pf[k], err_msg=k)
    assert int(pf["__tag__"]) == pser._tag(layout) == jser._tag(layout)


def test_load_rejects_garbage(tmp_path):
    p = str(tmp_path / "bad.npz")
    np.savez(p, __tag__=np.asarray(999999), junk=np.zeros(3))
    other = str(tmp_path / "layout.npz")
    np.savez(other, __tag__=np.asarray(pser.CACHE_VERSION | (9 << 24)),
             junk=np.zeros(3))
    noise = str(tmp_path / "noise.npz")
    with open(noise, "wb") as f:
        f.write(b"not a npz")
    for path in (p, other, noise):
        assert pser.load_bvh(path, device="cpu") is None
        assert jser.load_bvh(path) is None
    with pytest.raises(TypeError):
        pser.save_bvh(str(tmp_path / "x.npz"), object())


def test_load_needs_a_card_or_cpu(structures, tmp_path, monkeypatch):
    path = str(tmp_path / "b.npz")
    pser.save_bvh(path, structures["BVH2"][1])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        pser.load_bvh(path)


def test_cached_build(tmp_path):
    """The second call loads the first one's file; another builder (or
    other parameters) under the same geometry does not alias it; the
    geometry hash is JAX's."""
    tris = random_tris(200, seed=2)
    calls = []

    def builder(t):
        calls.append(1)
        return build_binned(t, max_leaf=4, device="cpu")

    b1 = pser.cached_build(tris, builder, cache_dir=str(tmp_path),
                           device="cpu")
    b2 = pser.cached_build(tris, builder, cache_dir=str(tmp_path),
                           device="cpu")
    assert len(calls) == 1
    _assert_same(b2, b1)
    b3 = pser.cached_build(tris, functools.partial(build_binned, max_leaf=2,
                                                   device="cpu"),
                           cache_dir=str(tmp_path), device="cpu")
    assert int(b3.count.max()) <= 2 and len(list(tmp_path.iterdir())) == 2
    assert pser.geometry_hash(tris) == jser.geometry_hash(tris) \
        == pser.geometry_hash(torch.from_numpy(tris))
