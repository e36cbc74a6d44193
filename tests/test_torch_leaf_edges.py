"""Kernel D's plain twin (`traverse/leaf_resolve.py::_resolve_v2_plain`)
against JAX `leaf_resolve_v2` (interpret mode) on constructed inputs that
pin the semantics the CUDA kernel keeps while it skips dead rows: a tile
whose rows are all dead, live rows only in the last chunk, zero triangles
inside live leaves, and exact ties in t across rows and across the v3
body's sublanes. The same inputs hold the kernel against the twin on the
card (tests/test_torch_cuda.py, which builds them)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from test_torch_cuda import (  # noqa: E402
    LEAF_EDGE_CASES, LEAF_TIE_ROWS, leaf_edge_inputs,
)
from tinybvh_tpu.traverse.pallas_leaf import (  # noqa: E402
    leaf_resolve_v2 as j_leaf_resolve_v2,
)
from tinybvh_tpu_torch.traverse import leaf_resolve as lr  # noqa: E402


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("case", LEAF_EDGE_CASES)
def test_leaf_resolve_v2_twin_edge_cases_match_jax(case, wide):
    """Row positions equal to JAX's, t within 1e-5 (the existing parity
    test's tolerance); rays that hit nothing give (1e30, 0); in the ties
    case every ray takes the copy its tie rule names."""
    o_t, d_t, geom = leaf_edge_inputs(case)
    t, i = lr.leaf_resolve_v2(*(torch.from_numpy(x) for x in
                                (o_t, d_t, geom)), wide=wide)
    jt, ji = j_leaf_resolve_v2(*(jnp.asarray(x) for x in (o_t, d_t, geom)),
                               interpret=True, wide=wide)
    t, i = t.numpy(), i.numpy()
    np.testing.assert_array_equal(i, np.asarray(ji))
    np.testing.assert_allclose(t, np.asarray(jt), rtol=1e-5, atol=1e-5)
    miss = t >= 1e30
    assert not i[miss].any()
    if case == "all_dead":
        assert miss[0].all() and not miss[1].all()
    elif case == "ties":
        assert not miss.any()
        assert (i == np.array(LEAF_TIE_ROWS[wide])[:, None]).all()
    else:
        assert (~miss).any()
