"""Kernel F's plain twin (`traverse/frustum_walk.py::_walk_plain`) against
JAX `collect_tile_leaves_pallas` (interpret mode) on BVH8 tables and
planes built in the test (the walk reads nothing else): a stack that
passes 64 entries (overflow and the clamp to 63), exactly K leaves and K
+ 1, EMPTY_SLOT children mixed with leaves and nodes in every slot, a
frustum that rejects every root child, planes with zero and negative
normal components, and boxes whose face lies on a plane. Lists and
counts are held exactly equal. The same inputs hold the CUDA kernel,
which places leaves by a breadth-first expansion instead of walking pop
by pop, against the twin on the card (tests/test_torch_cuda.py, which
builds them)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from test_torch_cuda import WALK_EDGE_CASES, walk_edge_inputs  # noqa: E402
from tinybvh_tpu.traverse.pallas_frustum import (  # noqa: E402
    collect_tile_leaves_pallas,
)
from tinybvh_tpu_torch.traverse import frustum_walk as fw  # noqa: E402


@pytest.mark.parametrize("case", WALK_EDGE_CASES)
def test_walk_twin_edge_cases_match_jax(case):
    """Every list and count equal to JAX's; the constructed outcomes: the
    stack overflow flags tile 0 only and its clamp drops part of the
    tile's 85 visible leaves, K + 1 leaves flag tile 0 and keep its first
    K, the rejecting frusta list nothing, and the boxes on a plane are
    inside while those one ulp beyond it are not."""
    (bounds, child, planes, ndoto), K = walk_edge_inputs(case)
    before = dict(fw.LAUNCHES)
    leaves, counts = fw.collect_tile_leaves_kernel(
        *(torch.from_numpy(x) for x in (bounds, child, planes, ndoto)), K)
    assert fw.LAUNCHES == before        # the twin ran, not the kernel
    jl, jc = collect_tile_leaves_pallas(
        jnp.asarray(bounds.reshape(-1, 6, 8)), jnp.asarray(child),
        jnp.asarray(planes), jnp.asarray(ndoto), K, interpret=True)
    counts, leaves = counts.numpy(), leaves.numpy()
    np.testing.assert_array_equal(counts, np.asarray(jc))
    np.testing.assert_array_equal(leaves, np.asarray(jl))
    want = {"stack_overflow": [-1, 49], "exact_k": [20, 12],
            "k_plus_1": [-1, 12], "reject_all": [0, 0, 0, 0],
            "touching": [7, 8]}
    if case in want:
        assert counts.tolist() == want[case]
    else:
        assert (counts > 0).all()
    n_live = (leaves != 2**31 - 1).sum(1)
    fit = counts >= 0
    assert (n_live[fit] == counts[fit]).all()
    if case == "k_plus_1":
        assert n_live[0] == K           # the first K of K + 1 leaves
    elif case == "stack_overflow":
        assert n_live[0] < 85           # the clamp dropped some of the 85
