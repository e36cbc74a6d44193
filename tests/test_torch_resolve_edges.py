"""The plain twins of kernels C (`traverse/packet2.py::_mt_plain`) and E
(`traverse/leaf_resolve.py::_resolve_plain`) against JAX `mt_resolve` and
`leaf_resolve` (interpret mode) on constructed inputs that pin the
semantics the CUDA kernels keep while they skip work: dead rows and
leaves interleaved with live ones, blocks and tiles with nothing live,
misses and hits past BVH_FAR with tmax = +inf, NaN t inside a block, NaN
tmax and gates, exact ties within and across blocks, leaves and lanes,
zero triangles, ragged chunk counts and a single tile. The same inputs
hold the kernels against the twins on the card (tests/test_torch_cuda.py,
which builds them)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from test_torch_cuda import (  # noqa: E402
    LEAF_RESOLVE_EDGE_CASES, LEAF_RESOLVE_TIE_LEAVES, MT_EDGE_CASES,
    MT_TIE_ROWS, leaf_resolve_edge_inputs, mt_edge_inputs,
)
from tinybvh_tpu.traverse.packet2 import (  # noqa: E402
    mt_resolve as j_mt_resolve,
)
from tinybvh_tpu.traverse.pallas_leaf import (  # noqa: E402
    leaf_resolve as j_leaf_resolve,
)
from tinybvh_tpu_torch.traverse import leaf_resolve as lr  # noqa: E402
from tinybvh_tpu_torch.traverse import packet2  # noqa: E402


@pytest.mark.parametrize("case", MT_EDGE_CASES)
def test_mt_resolve_twin_edge_cases_match_jax(case):
    """Rows equal to JAX's, t within 1e-4 (the existing parity test's
    tolerance; NaN where JAX has NaN); the constructed winners: the first
    copy in the ties case, row 2 at kFar where rows 0-1 are hit past
    BVH_FAR, tmax's NaN kept with row 0, and only block 0 run under a NaN
    gate at block 1."""
    inputs = mt_edge_inputs(case)
    t, i, n_blk = packet2._mt_plain(*(torch.from_numpy(x) for x in inputs))
    jt, ji = j_mt_resolve(*(jnp.asarray(x) for x in inputs), interpret=True)
    t, i = t.numpy(), i.numpy()
    np.testing.assert_array_equal(i, np.asarray(ji))
    np.testing.assert_allclose(t, np.asarray(jt), rtol=1e-4, atol=1e-4)
    assert (t < 1e30).any()
    if case == "ties":
        assert (i == np.array(MT_TIE_ROWS)[:, None]).all()
    elif case == "misses_at_inf":
        assert (t[1:] == np.float32(1e30)).all() and (i[1:] == 2).all()
    elif case == "nan":
        assert np.isnan(t[1]).all() and not i[1].any()
        # block 0's NaN hides its real hits: tile 0's winners lie past it
        assert n_blk.tolist() == [4, 0, 1] and (i[0][t[0] < 1e30] >= 128).all()
    elif case == "empty_blocks":
        assert (t[1:] == np.float32(1e30)).all() and not i[1:].any()
    elif case == "k4_384_gates":
        assert n_blk.tolist() == [2, 2] and (i == 60).all()
    elif case == "nonfinite_rays":
        assert (t[0, 17:19] == np.float32(1e30)).all()


@pytest.mark.parametrize("case", LEAF_RESOLVE_EDGE_CASES)
def test_leaf_resolve_twin_edge_cases_match_jax(case):
    """Packed winners equal to JAX's, t within 1e-5 (the existing parity
    test's tolerance); in the ties case every ray takes the first (leaf,
    lane) holding the copy; dead leaves never win."""
    inputs = leaf_resolve_edge_inputs(case)
    t, p = lr.leaf_resolve(*(torch.from_numpy(x) for x in inputs))
    jt, jp = j_leaf_resolve(*(jnp.asarray(x) for x in inputs),
                            interpret=True)
    t, p = t.numpy(), p.numpy()
    np.testing.assert_array_equal(p, np.asarray(jp))
    np.testing.assert_allclose(t, np.asarray(jt), rtol=1e-5, atol=1e-5)
    assert (t < 1e30).any() and not p[t >= 1e30].any()
    live, rows = inputs[3], inputs[4]
    for k in range(len(t)):
        assert np.isin((p[k] >> 2)[t[k] < 1e30], rows[k, live[k] > 0]).all()
    if case == "ties":
        want = [rows[k, leaf] * 4 + lane for k, (leaf, lane) in
                enumerate(LEAF_RESOLVE_TIE_LEAVES)]
        assert (p == np.array(want)[:, None]).all()
