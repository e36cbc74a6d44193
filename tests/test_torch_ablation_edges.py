"""Kernel I's plain twin (`probes/mt_ablation.py::_ablation_plain`) against
the JAX probe (`benchmarks/mt_ablation_probe.py::_ablation_kernel`, called
as the probe's pallas_call with interpret=True) on constructed inputs
that pin what the CUDA kernel keeps while it skips work: tiles whose last
super-block is live only in part, tiles with no key, and tmax = +inf with
rows hit past BVH_FAR, where the first dead row wins at kFar. The same
inputs hold the kernel against the twin on the card
(tests/test_torch_cuda.py, which builds them).

The variants whose buffer the JAX kernel writes (full, seg8, bigdma) and
skeleton; tolerances as tests/test_torch_probes.py: the row equal except
on exact ties (both t within a relative 1e-6), t within rtol = atol =
1e-4.
"""

import functools
import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from test_torch_cuda import (  # noqa: E402
    ABLATION_EDGE_CASES, ABLATION_INF_COUNTS, ablation_edge_inputs,
)
from tinybvh_tpu.traverse import packet2 as jp2  # noqa: E402
from tinybvh_tpu_torch.probes import mt_ablation as ma  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAR = np.float32(1e30)


@pytest.fixture(scope="module")
def probe():
    path = os.path.join(REPO, "benchmarks", "mt_ablation_probe.py")
    spec = importlib.util.spec_from_file_location("_probe_ablation", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_ablation(mod, inputs, variant):
    """benchmarks/mt_ablation_probe.py:59-97 with interpret=True."""
    keys, counts, lbg, tmax, o_t, d_t, gtab = (jnp.asarray(a)
                                               for a in inputs)
    T, k_cap = keys.shape
    nb = lbg.shape[1]
    kern = functools.partial(mod._ablation_kernel, k_cap=k_cap,
                             variant=variant, leaf_bits=jp2._LEAF_BITS)

    def spec(space, *shape):
        return pl.BlockSpec((T,) + shape, lambda i: (i, 0, 0),
                            memory_space=space)

    t, i = pl.pallas_call(
        kern,
        grid=(1,),
        in_specs=[spec(pltpu.SMEM, 1, k_cap), spec(pltpu.SMEM, 1, 1),
                  spec(pltpu.SMEM, 1, nb), spec(pltpu.SMEM, 1, 1),
                  spec(pltpu.VMEM, 3, 256), spec(pltpu.VMEM, 3, 256),
                  pl.BlockSpec(memory_space=pl.ANY)],
        out_shape=(jax.ShapeDtypeStruct((T, 1, 256), jnp.float32),
                   jax.ShapeDtypeStruct((T, 1, 256), jnp.int32)),
        out_specs=(spec(pltpu.VMEM, 1, 256), spec(pltpu.VMEM, 1, 256)),
        scratch_shapes=[pltpu.VMEM((2 * 128, 128), jnp.float32),
                        pltpu.SemaphoreType.DMA((2, 32))],
        interpret=True,
    )(keys.reshape(T, 1, k_cap), counts.reshape(T, 1, 1),
      lbg.reshape(T, 1, nb), tmax.reshape(T, 1, 1), o_t, d_t, gtab)
    return np.asarray(t)[:, 0], np.asarray(i)[:, 0]


@pytest.mark.parametrize("variant", ["full", "seg8", "bigdma", "skeleton"])
@pytest.mark.parametrize("case", ABLATION_EDGE_CASES)
def test_ablation_twin_edge_cases_match_jax(probe, case, variant):
    """Rows equal to JAX's but for exact ties, t within 1e-4; the
    constructed winners of each case."""
    inputs = ablation_edge_inputs(case)
    tr, ir = _jax_ablation(probe, inputs, variant)
    args = tuple(torch.from_numpy(x) for x in inputs)
    before = dict(ma.LAUNCHES)
    t, i = (x.numpy() for x in ma.ablation(*args, variant))
    assert ma.LAUNCHES == before
    with np.errstate(invalid="ignore"):   # inf - inf on the empty tiles
        tie = np.abs(t - tr) <= 1e-6 * np.maximum(np.abs(tr), 1e-30)
    diff = i != ir
    assert not (diff & ~tie).any(), f"{int((diff & ~tie).sum())} rows"
    np.testing.assert_allclose(t[~diff], tr[~diff], rtol=1e-4, atol=1e-4)
    counts = inputs[1]
    if variant == "skeleton":
        assert (i == counts[:, None]).all()
        return
    hit = t < FAR
    if case == "partial_last":
        assert hit.any(axis=1).all()
        # a row past the tile's count never wins
        assert (i[hit] < np.repeat(counts * 4, 256)[hit.ravel()]).all()
    elif case == "no_keys":
        empty = counts == 0
        assert (t[empty] == FAR).all() and not i[empty].any()
        assert hit[~empty].any(axis=1).all()
    elif case == "inf_tmax" and variant == "full":
        assert list(counts) == list(ABLATION_INF_COUNTS)
        want = {0: (FAR, 52), 2: (FAR, 180), 4: (np.float32(1e31), 0),
                5: (FAR, 180),
                6: (np.float32(np.inf), 0)}
        for tile, (tw, iw) in want.items():
            assert (t[tile] == tw).all() and (i[tile] == iw).all(), tile
        assert (t[7] <= FAR).all() and ((i[7] >= 140) & (i[7] < 144)).all()
        assert hit[1].any() and hit[3].any()


def test_ablation_twin_edge_cases_no_copy_variants():
    """The no-copy variants on the same inputs (JAX's kernel leaves their
    buffer unwritten): nodma equals bigdma; mathonly's rows are 0 and
    every tile with a key walks all its super-blocks."""
    for case in ABLATION_EDGE_CASES:
        args = tuple(torch.from_numpy(x)
                     for x in ablation_edge_inputs(case))
        a = ma.ablation(*args, "nodma")
        b = ma.ablation(*args, "bigdma")
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        m = ma.ablation(*args, "mathonly")
        assert not m[1].any()
        _, _, n_sb = ma._ablation_plain(*args, "mathonly")
        want = (torch.clamp(args[1], max=128) + 31) // 32
        assert torch.equal(n_sb, want.long())
