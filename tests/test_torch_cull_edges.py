"""Kernel G's plain twin (`traverse/packet2.py::_cull_blocks_plain`)
against JAX `_cull_blocks_kernel` (interpret mode, built as
benchmarks/packet2_probe.py:116-148 builds it) on constructed
descriptors and block boxes: n_blocks at 1, 127, 128, 129 and nbpad - 1,
nbpad 128 and 768, and boxes whose face lies on a plane (inside) at ids
0 and n_blocks - 1, and at n_blocks (masked). Masks are held exactly
equal. The same inputs hold the CUDA kernel against the twin on the card
(tests/test_torch_cuda.py, which builds them)."""

from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from test_torch_cuda import (  # noqa: E402
    CULL_BLOCKS_EDGE_CASES, cull_blocks_edge_inputs,
)
from tinybvh_tpu.traverse import packet2 as jp2  # noqa: E402
from tinybvh_tpu_torch.traverse import packet2 as p2  # noqa: E402


def _jax_cull_blocks(desc, blo, bhi, n_blocks):
    G, nbpad = desc.shape[0] // p2.TB, blo.shape[1]
    return pl.pallas_call(
        partial(jp2._cull_blocks_kernel, n_blocks=n_blocks),
        grid=(G,),
        in_specs=[
            pl.BlockSpec((p2.TB, 128), lambda g: (g, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((3, nbpad), lambda g: (0, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((3, nbpad), lambda g: (0, 0),
                         memory_space=pltpu.VMEM),
        ],
        out_shape=jax.ShapeDtypeStruct((G, 1, nbpad), jnp.int32),
        out_specs=pl.BlockSpec((1, 1, nbpad), lambda g: (g, 0, 0),
                               memory_space=pltpu.VMEM),
        interpret=True,
    )(*(jnp.asarray(x) for x in (desc, blo, bhi)))


@pytest.mark.parametrize("nbpad,n_blocks", CULL_BLOCKS_EDGE_CASES)
def test_cull_blocks_twin_edge_cases_match_jax(nbpad, n_blocks):
    """The mask equal to JAX's; the boxes on a plane set in every group,
    nothing set at or past n_blocks, and some random block set."""
    desc, blo, bhi = cull_blocks_edge_inputs(nbpad, n_blocks)
    before = dict(p2.LAUNCHES)
    got = p2.cull_blocks(*(torch.from_numpy(x) for x in (desc, blo, bhi)),
                         n_blocks).numpy()
    assert p2.LAUNCHES == before        # the twin ran, not the kernel
    np.testing.assert_array_equal(got, np.asarray(
        _jax_cull_blocks(desc, blo, bhi, n_blocks)))
    assert got[:, 0, 0].all() and got[:, 0, n_blocks - 1].all()
    assert not got[:, 0, n_blocks:].any()
    if n_blocks > 2:
        assert got[:, 0, 1:n_blocks - 1].any()
