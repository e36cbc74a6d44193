"""Kernel B's micromap twin (`traverse/packet2.py::_mt_fused_plain` with
omap_s > 0, through `mt_resolve_fused`) against JAX `mt_resolve_fused`
(its kernel in interpret mode) on constructed inputs that pin what the
CUDA instantiation keeps while it skips work: transparent hits on rays
that start at t = +inf (their kFar then wins), zero triangles whose
micromap words are set, and S = 5 and 12 beside the main path's sizes.
The same inputs hold the kernel against the twin on the card
(tests/test_torch_cuda.py, which builds them). Tolerances as
tests/test_torch_omap.py: prim equal but for exact ties, t within rtol =
atol = 1e-4, u and v within 1e-3.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from test_torch_cuda import OMAP_EDGE_CASES, omap_edge_inputs  # noqa: E402
from test_torch_omap import assert_hits_match  # noqa: E402
from tinybvh_tpu.traverse import packet2 as jp2  # noqa: E402
from tinybvh_tpu_torch.traverse import packet2 as p2  # noqa: E402

FAR = np.float32(1e30)


@pytest.mark.parametrize("case", OMAP_EDGE_CASES)
def test_mt_omap_twin_edge_cases_match_jax(case):
    """Hits equal to JAX's; the constructed winners of each case."""
    ins, kw = omap_edge_inputs(case)
    t0 = kw.pop("t0")
    t, i, u, v, p = (x.numpy() for x in p2.mt_resolve_fused(
        **{k: torch.from_numpy(x) for k, x in ins.items()},
        t0=torch.from_numpy(t0), **kw))
    jt, _, ju, jv, jp = jp2.mt_resolve_fused(
        **{k: jnp.asarray(x) for k, x in ins.items()},
        t0=jnp.asarray(t0), interpret=True, **kw)
    assert_hits_match(p, t, u, v, jp, jt, ju, jv, ties=True)
    hit = t < FAR
    assert hit.any()
    # a ray left at its initial t has no winner; one at kFar from an
    # initial +inf has one (a miss or a transparent hit)
    assert (p[~hit & (t0 == FAR)] == -1).all()
    assert (p[t0 == np.inf] >= 0).all()
    if case.startswith("transparent_inf"):
        # tile 1: every pair transparent or missed; row 0's triangle A
        first = ins["gtab_flat"][ins["offs"][1, 0],
                                 96 if kw["pack"] == 2 else 48 + (
                                     kw["omap_s"] ** 2 + 15) // 16]
        assert (t[1] == FAR).all() and not i[1].any()
        assert (p[1] == first.view(np.int32)).all()
        assert hit[0].any() and hit[2:].any()
    elif case.startswith("zero_words"):
        # rays from +inf that hit no real triangle win at row 0 (zero)
        assert (t[0] == FAR).all() and not i[0].any()
        assert (i[2][~hit[2]] == 0).all() and hit[2].any()
