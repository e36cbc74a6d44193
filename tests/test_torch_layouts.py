"""The port's quantized BVH8Q and leaf-shape transforms against the JAX
package's on the same inputs (mirrors tests/test_wavefront.py::
test_quantized_cwbvh_matches and tests/test_layouts.py).

- `quantize_bvh8`, `dequantize_bounds`, `to_bvh8`, `split_leafs`: equal
  to JAX's array for array (the same numpy steps; the dequantized bound
  origin + q * step is exact, q an integer under 256 and step a power of
  two).
- The wavefront engine on a BVH8Q against JAX's wavefront on the same
  BVH8Q: ROADMAP's parity standard (prim equal on every ray, t within
  rtol = atol = 1e-4, u and v within 1e-3), occlusion equal; and the
  port's hits on the BVH8Q equal its hits on the float BVH8 it came from
  (the quantized boxes are conservative).
- `combine_leafs`: on a tree whose subtrees own contiguous prim ranges
  (a `build_sweep` tree, checked) every leaf holds JAX's prim set; on
  the numpy `build_binned` tree of `random_tris(300, seed=3)` with
  `max_leaf=1`, where they do not, every prim survives, `prim_idx` is a
  permutation and traversal equals brute force.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tinybvh_tpu as tb  # noqa: E402
from tinybvh_tpu.builders import binned as j_binned  # noqa: E402
from tinybvh_tpu.builders import sweep as j_sweep  # noqa: E402
from tinybvh_tpu.layouts import cwbvh as j_cwbvh  # noqa: E402
from tinybvh_tpu.layouts import leafshape as j_leafshape  # noqa: E402
from tinybvh_tpu.layouts import mbvh as j_mbvh  # noqa: E402
from tinybvh_tpu.traverse import wavefront as jwf  # noqa: E402
from tinybvh_tpu_torch import convert  # noqa: E402
from tinybvh_tpu_torch.builders.binned import build_binned  # noqa: E402
from tinybvh_tpu_torch.builders.sweep import build_sweep  # noqa: E402
from tinybvh_tpu_torch.core.intersect import (  # noqa: E402
    brute_force_any, brute_force_closest,
)
from tinybvh_tpu_torch.core.rays import make_rays  # noqa: E402
from tinybvh_tpu_torch.io.loaders import random_tris  # noqa: E402
from tinybvh_tpu_torch.layouts.bvh2 import validate_host  # noqa: E402
from tinybvh_tpu_torch.layouts.cwbvh import (  # noqa: E402
    BVH8Q, dequantize_bounds, quantize_bvh8, to_bvh8,
)
from tinybvh_tpu_torch.layouts.leafshape import (  # noqa: E402
    combine_leafs, split_leafs,
)
from tinybvh_tpu_torch.layouts.mbvh import collapse_bvh2  # noqa: E402
from tinybvh_tpu_torch.traverse.stack import intersect_bvh2, pack_tris  # noqa: E402
from tinybvh_tpu_torch.traverse.wavefront import (  # noqa: E402
    intersect_wavefront, is_occluded_wavefront,
)
from tinybvh_tpu_torch.traverse.wide import intersect_bvh8  # noqa: E402
from tests.test_torch_builders import assert_same_bvh2  # noqa: E402
from tests.test_torch_jax_native import jax_native  # noqa: E402,F401
from tests.test_torch_wavefront import _rays, assert_same_hits  # noqa: E402

Q_FIELDS = ("origin", "scale", "qbounds", "child", "leaf_tris", "leaf_prim")


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """One test file per worker process: keep torch's pool small."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def quantized():
    """random_tris(1500, seed=44)'s BVH8 (JAX's collapse of JAX's numpy
    tree, carried across) and both packages' BVH8Q of it."""
    tris = random_tris(1500, seed=44)
    jb8 = j_mbvh.collapse_bvh2(j_binned.build_binned(tris, max_leaf=4), tris)
    b8 = convert.from_numpy_bvh8(jb8, device="cpu")
    return tris, jb8, b8, j_cwbvh.quantize_bvh8(jb8), quantize_bvh8(b8)


def test_quantize_matches_jax(quantized):
    _, _, b8, jq, q = quantized
    for k in Q_FIELDS:
        got, want = getattr(q, k).numpy(), np.asarray(getattr(jq, k))
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    assert q.n_nodes == jq.n_nodes and q.n_leaves == jq.n_leaves
    rows = torch.from_numpy(np.random.default_rng(1).integers(
        0, q.n_nodes, 300))
    np.testing.assert_array_equal(
        dequantize_bounds(q, rows).numpy(),
        np.asarray(j_cwbvh.dequantize_bounds(jq, rows.numpy())))
    # the reconstruction equals JAX's and contains the exact bounds
    rec = to_bvh8(q)
    np.testing.assert_array_equal(rec.bounds.numpy(),
                                  np.asarray(j_cwbvh.to_bvh8(jq).bounds))
    b0 = b8.bounds.numpy().reshape(-1, 6, 8)
    br = rec.bounds.numpy().reshape(-1, 6, 8)
    ok = b0[:, :3] < 1e29
    assert (br[:, :3][ok] <= b0[:, :3][ok]).all()
    ok = b0[:, 3:] > -1e29
    assert (br[:, 3:][ok] >= b0[:, 3:][ok]).all()
    assert rec.child is b8.child


def test_bvh8q_from_jax_needs_a_card_or_cpu(quantized, monkeypatch):
    """convert.from_numpy_bvh8q carries JAX's BVH8Q across: equal to the
    port's own, on the card unless device="cpu" is asked."""
    _, _, _, jq, q = quantized
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        convert.from_numpy_bvh8q(jq)
    got = convert.from_numpy_bvh8q(jq, device="cpu")
    assert isinstance(got, BVH8Q)
    for k in Q_FIELDS:
        assert torch.equal(getattr(got, k), getattr(q, k)), k


@pytest.mark.parametrize("seed", [61, 62])
def test_wavefront_on_bvh8q_matches_jax(quantized, seed):
    """Closest hit and any hit on the BVH8Q: JAX's wavefront on the same
    BVH8Q, the port's own hits on the float BVH8, brute force."""
    tris, _, b8, jq, q = quantized
    o, d = _rays(seed, 512)
    rays = make_rays(o, d, device="cpu")
    h, ovf = intersect_wavefront(q, rays, cap_factor=4)
    jh, jovf = jwf.intersect_wavefront(jq, tb.make_rays(o, d), cap_factor=4)
    assert not ovf and not bool(jovf)
    assert_same_hits(h, jh)
    h8, _ = intersect_wavefront(b8, rays, cap_factor=4)
    np.testing.assert_array_equal(h.prim.numpy(), h8.prim.numpy())
    np.testing.assert_array_equal(h.t.numpy(), h8.t.numpy())
    ref = brute_force_closest(rays, torch.from_numpy(tris))
    np.testing.assert_array_equal(h.prim.numpy(), ref.prim.numpy())
    assert 0 < (h.prim.numpy() >= 0).mean() < 1
    for t_max in (1.0, 1e30):
        occ = is_occluded_wavefront(q, rays, t_max)
        np.testing.assert_array_equal(occ.numpy(), np.asarray(
            jwf.is_occluded_wavefront(jq, tb.make_rays(o, d), t_max)))
        np.testing.assert_array_equal(occ.numpy(), brute_force_any(
            rays, torch.from_numpy(tris), t_max).numpy())


def _leaf_sets(mn, mx, lf, ct, pidx, n_nodes):
    """Per used node: (box, count, sorted prim ids of a leaf)."""
    out = []
    for i in range(int(n_nodes)):
        if i == 1:
            continue
        prims = (tuple(np.sort(pidx[lf[i]:lf[i] + ct[i]])) if ct[i] > 0
                 else None)
        out.append((tuple(mn[i]), tuple(mx[i]), int(ct[i]), prims))
    return out


def _host_sets(b):
    a = (b.node_min, b.node_max, b.left_first, b.count, b.prim_idx)
    a = [x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
         for x in a]
    return _leaf_sets(*a, b.n_nodes)


def _owns_contiguous_ranges(b):
    """Every subtree's prims fill one contiguous prim_idx range."""
    lf, ct = b.left_first.numpy(), b.count.numpy()
    span = {}
    for i in reversed(range(b.n_nodes)):   # children after their parents
        if i == 1 or (ct[i] == 0 and lf[i] == 0):
            continue
        if ct[i] > 0:
            span[i] = (lf[i], lf[i] + ct[i])
        else:
            (a0, a1), (b0, b1) = span[lf[i]], span[lf[i] + 1]
            if a1 != b0 and b1 != a0:
                return False
            span[i] = (min(a0, b0), max(a1, b1))
    return True


@pytest.mark.parametrize("max_prims", [2, 4])
def test_combine_leafs_matches_jax_on_contiguous_subtrees(max_prims):
    tris = random_tris(400, seed=12)
    bvh = build_sweep(tris, max_leaf=1, device="cpu")
    assert _owns_contiguous_ranges(bvh)
    jbvh = j_sweep.build_sweep(tris, max_leaf=1)
    assert_same_bvh2(bvh, jbvh)
    got = combine_leafs(bvh, max_prims=max_prims)
    want = j_leafshape.combine_leafs(jbvh, max_prims=max_prims)
    assert got.n_nodes == int(want.n_nodes)
    assert _host_sets(got) == _host_sets(want)
    cts = got.count.numpy()[:got.n_nodes]
    assert cts.max() <= max_prims and (cts > 1).any()


def test_combine_leafs_keeps_every_prim():
    """queue 3 item 1: on this tree JAX's combine_leafs points at 300
    prims of which 221 are distinct (its ranges assume contiguous
    subtrees), so JAX's function fails this test; the port's keeps every
    prim, and the combined tree traces like brute force through the BVH2
    engine and its 8-wide collapse."""
    tris = random_tris(300, seed=3)
    fine = build_binned(tris, max_leaf=1, device="cpu")
    assert not _owns_contiguous_ranges(fine)
    comb = combine_leafs(fine, max_prims=4)
    validate_host(comb, tris)          # strict: prim_idx a permutation
    np.testing.assert_array_equal(np.sort(comb.prim_idx.numpy()),
                                  np.arange(300))
    cts = comb.count.numpy()[:comb.n_nodes]
    assert cts.max() <= 4 and (cts > 1).any()
    rng = np.random.default_rng(7)
    o = rng.uniform(-2, 3, (256, 3)).astype(np.float32)
    d = rng.normal(size=(256, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = make_rays(o, d, device="cpu")
    t = torch.from_numpy(tris)
    ref = brute_force_closest(rays, t)
    h = intersect_bvh2(comb, pack_tris(comb, t), rays, leaf_max=4)
    np.testing.assert_array_equal(h.prim.numpy(), ref.prim.numpy())
    h8 = intersect_bvh8(collapse_bvh2(comb, tris), rays)
    np.testing.assert_array_equal(h8.prim.numpy(), ref.prim.numpy())
    assert 0 < (ref.prim.numpy() >= 0).mean() < 1


def test_split_leafs_matches_jax():
    """Big SAH leaves (a traversal cost of 16 makes SAH keep them) split
    to <= 4 prims: JAX's arrays, and traversal unchanged."""
    tris = random_tris(300, seed=3)
    coarse = build_binned(tris, max_leaf=None, c_trav=16.0, device="cpu")
    jcoarse = j_binned.build_binned(tris, max_leaf=None, c_trav=16.0)
    assert int(coarse.count.max()) > 4
    sp = split_leafs(coarse, max_prims=4)
    assert_same_bvh2(sp, j_leafshape.split_leafs(jcoarse, max_prims=4))
    assert int(sp.count.max()) <= 4
    o, d = _rays(9, 256)
    rays = make_rays(o, d, device="cpu")
    t = torch.from_numpy(tris)
    h = intersect_bvh2(sp, pack_tris(sp, t), rays, leaf_max=4)
    np.testing.assert_array_equal(h.prim.numpy(),
                                  brute_force_closest(rays, t).prim.numpy())
