"""The port's multi-device layer (tinybvh_tpu_torch/parallel) against the
JAX package's (mirrors tests/test_parallel.py).

The JAX side runs on the conftest's 8 virtual CPU devices in this
process; the port side on 4 gloo ranks spawned once for the module by
run_local, which save their results under tmp_path (one spawn serves
every traced case; each rank returns the whole batch, so all 4 are
checked). Parity across the scene axis depends only on the number of
shards, so the port's 1 x 4 and 2 x 2 meshes stand against JAX's 2 x 4
and 4 x 2. Tolerances: the sharding stacks equal array for array; the
sharded traces at ROADMAP's parity standard (prim equal, t within rtol
= atol = 1e-4, u and v within 1e-3) against JAX and, as JAX's own tests
do, misses equal and t within rtol 1e-4 against brute force;
trace_packets_dp equal to the single-rank trace (torch.equal); the
render step within 1e-5 of JAX's image."""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import tinybvh_tpu as tb  # noqa: E402
from tinybvh_tpu.builders.binned import build_binned as jbuild  # noqa: E402
from tinybvh_tpu.core.intersect import brute_force_closest  # noqa: E402
from tinybvh_tpu.layouts.mbvh import collapse_bvh2 as jcollapse  # noqa: E402
from tinybvh_tpu.parallel import mesh as jm  # noqa: E402
from tinybvh_tpu.traverse.packet2 import build_packet_aux as jaux  # noqa: E402
from tinybvh_tpu.traverse.stack import pack_tris as jpack  # noqa: E402
from tests import torch_mesh_ranks as ranks  # noqa: E402
from tests.test_torch_jax_native import jax_native  # noqa: E402,F401
from tinybvh_tpu_torch.io.loaders import random_tris  # noqa: E402
from tinybvh_tpu_torch.parallel import mesh as pm  # noqa: E402
from tinybvh_tpu_torch.parallel.launch import (  # noqa: E402
    dryrun_multichip, run_local,
)

N_RANKS = 4
LIGHT = [0.3, 0.8, 0.5]


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def _rays(seed, n):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-2, 12, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _tile_rays(T=8, seed=9):
    """tests/test_parallel.py's tile-ordered camera rays: T 16x16 bundles
    sharing an origin."""
    rng = np.random.default_rng(seed)
    eye = np.array([0.5, 0.5, -4.0], np.float32)
    d = []
    for _ in range(T):
        cx, cy = rng.uniform(0.2, 0.8, 2)
        gx, gy = np.meshgrid((np.arange(16) + 0.5) / 16 * 0.2,
                             (np.arange(16) + 0.5) / 16 * 0.2)
        dd = np.stack([cx + gx, cy + gy, np.full_like(gx, 4.0)], -1)
        dd /= np.linalg.norm(dd, axis=-1, keepdims=True)
        d.append(dd.reshape(-1, 3))
    d = np.concatenate(d).astype(np.float32)
    return np.broadcast_to(eye, d.shape).copy(), d


def _dup_scene():
    """random_tris(64) in two shards of 32, triangle 3 of shard 0 copied
    over triangle 5 of shard 1 (global id 37), and 16 rays at its
    centroid: both shards hit it at the same t."""
    tris = random_tris(64, seed=5)
    tris[37] = tris[3]
    c = tris[3].mean(axis=0)
    rng = np.random.default_rng(6)
    o = (c + rng.normal(size=(16, 3)) * 0.05 + [0.0, 0.0, -20.0]).astype(
        np.float32)
    d = (c - o) / np.linalg.norm(c - o, axis=1, keepdims=True)
    return tris, o, d.astype(np.float32)


@pytest.fixture(scope="module")
def inputs():
    o, d = _rays(1234, 256)
    to, td = _tile_rays(T=8, seed=9)
    dpo, dpd = _tile_rays(T=8, seed=9)
    ro, rd = _rays(77, 512)
    dup_tris, dup_o, dup_d = _dup_scene()
    return dict(tris777=random_tris(777, seed=21),
                tris1200=random_tris(1200, seed=24),
                tris1500=random_tris(1500, seed=23),
                tris500=random_tris(500, seed=22), o=o, d=d, to=to, td=td,
                dpo=dpo, dpd=dpd, ro=ro, rd=rd, dup_tris=dup_tris,
                dup_o=dup_o, dup_d=dup_d)


@pytest.fixture(scope="module")
def port(inputs, tmp_path_factory):
    """Each rank's results of ranks.parity_cases (one spawn of 4 gloo
    ranks for the module)."""
    out = tmp_path_factory.mktemp("ranks")
    t0 = time.monotonic()
    assert run_local(N_RANKS, ranks.parity_cases, inputs, str(out),
                     backend="gloo", timeout_s=45.0) == 0
    assert time.monotonic() - t0 < 120
    return [torch.load(out / f"rank{r}.pt") for r in range(N_RANKS)]


def _check_parity(got, ref):
    """ROADMAP's parity standard."""
    p, rp = _np(got["prim"]), np.asarray(ref.prim)
    np.testing.assert_array_equal(p, rp)
    m = rp >= 0
    np.testing.assert_allclose(_np(got["t"])[m], np.asarray(ref.t)[m],
                               rtol=1e-4, atol=1e-4)
    for k in ("u", "v"):
        np.testing.assert_allclose(_np(got[k])[m], np.asarray(
            getattr(ref, k))[m], rtol=1e-3, atol=1e-3)


def _check_brute(got, tris, o, d):
    ref = brute_force_closest(tb.make_rays(o, d), jnp.asarray(tris))
    miss = np.asarray(ref.prim) < 0
    np.testing.assert_array_equal(_np(got["prim"]) < 0, miss)
    np.testing.assert_allclose(_np(got["t"])[~miss],
                               np.asarray(ref.t)[~miss], rtol=1e-4)


def _same_on_every_rank(port, key):
    for r in range(1, N_RANKS):
        a, b = port[0][key], port[r][key]
        if isinstance(a, dict):
            for k in a:
                assert torch.equal(a[k], b[k]), (key, k, r)
        else:
            assert torch.equal(a, b), (key, r)


@pytest.mark.parametrize("n, seed, shards", [(777, 21, 4), (1200, 24, 2)])
def test_shard_scene_matches_jax(n, seed, shards):
    """Padded (777 into 4) and even (1200 into 2): every stacked BVH2
    array, the packed triangles and the global ids equal JAX's."""
    tris = random_tris(n, seed=seed)
    jb, jp, jg = jm.shard_scene(tris, shards)
    pb, pp, pg = pm.shard_scene(tris, shards, device="cpu")
    for f in ("node_min", "node_max", "left_first", "count", "prim_idx",
              "n_nodes"):
        a, b = _np(getattr(pb, f)), np.asarray(getattr(jb, f))
        assert a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    np.testing.assert_array_equal(_np(pp), np.asarray(jp))
    np.testing.assert_array_equal(_np(pg), np.asarray(jg))
    assert pg.dtype == torch.int32


@pytest.mark.parametrize("n, seed, shards", [(1200, 24, 2), (777, 21, 4)])
def test_shard_scene_packets_matches_jax(n, seed, shards):
    """The padded BVH8 stacks and the global ids equal JAX's. The packet
    tables equal those of JAX's numpy table builder (build_packet_aux_host,
    the one its API uses) on each of JAX's padded shards: the prim ids'
    lanes bit for bit (their NaN patterns compared as int32), every other
    value as a float, where -0.0 equals 0.0 (a padding triangle's row term
    n.v0 sums zero products: -0.0 in the port, which adds them in order,
    0.0 in numpy's sum). JAX's shard_scene_packets builds its tables with
    XLA on the CPU, which contracts the cross products' a*b - c*d into
    fused multiply-adds: against that stack the triangle rows agree
    within rtol 1e-5 (atol 1e-6), the boxes and the center exactly."""
    from tinybvh_tpu.traverse.packet2 import build_packet_aux_host

    tris = random_tris(n, seed=seed)
    jb, ja, jg = jm.shard_scene_packets(tris, shards)
    pb, pa, pg = pm.shard_scene_packets(tris, shards, device="cpu")
    for f in ("bounds", "child", "leaf_tris", "leaf_prim"):
        a, b = _np(getattr(pb, f)), np.asarray(getattr(jb, f))
        assert a.shape == b.shape and a.tobytes() == b.tobytes(), f
    np.testing.assert_array_equal(_np(pg), np.asarray(jg))
    assert set(_np(pa.n_leaf_rows).tolist()) == {ja.n_leaf_rows}
    ids = [96, 97]    # the prim ids' lanes of a pack-2 row
    rest = np.setdiff1d(np.arange(128), ids)

    def same_rows(a, b, close=False):
        np.testing.assert_array_equal(a[..., ids].view(np.int32),
                                      b[..., ids].view(np.int32))
        if close:
            np.testing.assert_allclose(a[..., rest], b[..., rest],
                                       rtol=1e-5, atol=1e-6)
        else:
            np.testing.assert_array_equal(a[..., rest], b[..., rest])

    for s in range(shards):
        host = build_packet_aux_host({f: np.asarray(getattr(jb, f))[s] for f
                                      in ("bounds", "child", "leaf_tris",
                                          "leaf_prim")})
        for f in ("leaf_lo", "leaf_hi", "blk_lo", "blk_hi", "center"):
            a, b = _np(getattr(pa, f))[s], np.asarray(getattr(host, f))
            assert a.shape == b.shape and a.tobytes() == b.tobytes(), (s, f)
        same_rows(_np(pa.gtab_pad)[s], np.asarray(host.gtab_pad))
    for f in ("leaf_lo", "leaf_hi", "blk_lo", "blk_hi", "center"):
        a, b = _np(getattr(pa, f)), np.asarray(getattr(ja, f))
        assert a.shape == b.shape and a.tobytes() == b.tobytes(), f
    assert pa.gtab_pad.shape == ja.gtab_pad.shape
    same_rows(_np(pa.gtab_pad), np.asarray(ja.gtab_pad), close=True)


def test_trace_sharded_matches_jax(port, inputs):
    """random_tris(777) in 4 shards: the port's 1 x 4 mesh against JAX's
    2 x 4 and brute force; one collective over the scene row and one
    over the rays column."""
    tris = inputs["tris777"]
    jrays = tb.make_rays(inputs["o"], inputs["d"])
    ref = jm.trace_sharded(jm.make_mesh(2, 4), *jm.shard_scene(tris, 4),
                           jrays)
    _same_on_every_rank(port, "sharded")
    _check_parity(port[0]["sharded"], ref)
    _check_brute(port[0]["sharded"], tris, inputs["o"], inputs["d"])
    assert port[0]["sharded_stats"]["collectives"] == 2


def test_trace_packets_sharded_matches_jax(port, inputs):
    """random_tris(1200) in 2 shards through packet2: the port's 2 x 2
    mesh against JAX's 4 x 2 (interpret mode) and brute force."""
    tris = inputs["tris1200"]
    jrays = tb.make_rays(inputs["to"], inputs["td"])
    ref = jm.trace_packets_sharded(jm.make_mesh(4, 2),
                                   *jm.shard_scene_packets(tris, 2), jrays,
                                   interpret=True)
    _same_on_every_rank(port, "packets_sharded")
    _check_parity(port[0]["packets_sharded"], ref)
    _check_brute(port[0]["packets_sharded"], tris, inputs["to"],
                 inputs["td"])


def test_trace_packets_dp_matches_single_rank_and_jax(port, inputs):
    """4 ranks of 2 tiles each equal the single-rank intersect_packets2
    on every field, and JAX's 8-device trace_packets_dp at the parity
    standard."""
    _same_on_every_rank(port, "dp")
    for k in ("t", "u", "v", "prim", "inst"):
        assert torch.equal(port[0]["dp"][k], port[0]["dp_single"][k]), k
    tris = inputs["tris1500"]
    bvh8 = jcollapse(jbuild(tris, max_leaf=4), jnp.asarray(tris))
    ref = jm.trace_packets_dp(jm.make_mesh(8, 1), bvh8, jaux(bvh8),
                              tb.make_rays(inputs["dpo"], inputs["dpd"]),
                              interpret=True)
    _check_parity(port[0]["dp"], ref)
    assert (_np(port[0]["dp"]["prim"]) >= 0).mean() > 0.2


def test_render_step_dp_matches_jax(port, inputs):
    tris = inputs["tris500"]
    bvh = jbuild(tris, max_leaf=8)
    ref = jm.render_step_dp(jm.make_mesh(8, 1), bvh,
                            jpack(bvh, jnp.asarray(tris)),
                            tb.make_rays(inputs["ro"], inputs["rd"]), LIGHT)
    _same_on_every_rank(port, "render")
    img = _np(port[0]["render"])
    assert img.shape == (512, 3) and np.isfinite(img).all()
    np.testing.assert_allclose(img, np.asarray(ref), rtol=1e-5, atol=1e-5)
    assert img.max() > 0.05


def test_duplicate_triangle_takes_shard_zero(port, inputs):
    """A triangle in both shards: every ray's hit takes shard 0's global
    id (3, not 37), as JAX's argmin gives it."""
    got = port[0]["dup"]
    jrays = tb.make_rays(inputs["dup_o"], inputs["dup_d"])
    ref = jm.trace_sharded(jm.make_mesh(4, 2),
                           *jm.shard_scene(inputs["dup_tris"], 2), jrays)
    assert (_np(got["prim"]) == 3).all()
    np.testing.assert_array_equal(_np(got["prim"]), np.asarray(ref.prim))
    _same_on_every_rank(port, "dup")


@pytest.mark.parametrize("case, error", [
    ("world_too_small", "ValueError"), ("rays_axis", "ValueError"),
    ("tile_block", "ValueError"), ("no_card", "RuntimeError")])
def test_bad_meshes_and_batches_raise(port, case, error):
    """make_mesh on a world smaller than the mesh, 255 rays over 2 ray
    blocks, 512 rays in 4 blocks of 128 (not a multiple of 256), and a
    mesh without a card and without device="cpu"."""
    for r in range(N_RANKS):
        assert port[r]["raises"][case] == error, (r, case)


def test_dryrun_multichip_runs():
    """The port's counterpart of __graft_entry__.dryrun_multichip on 4
    gloo ranks."""
    out = dryrun_multichip(4, timeout_s=45.0)
    assert out["img"].shape == (64, 3) and torch.isfinite(out["img"]).all()
    assert torch.isfinite(out["packet_t"]).any()


def test_hung_rank_fails_within_its_limit():
    """Rank 0 waits in a collective that rank 1 never joins: the process
    group's 5 s timeout fails rank 0, and run_local raises and ends rank
    1, well inside a minute."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 0"):
        run_local(2, ranks.hang_rank, 600.0, timeout_s=5.0)
    assert time.monotonic() - t0 < 60


def test_failed_rank_fails_the_run():
    with pytest.raises(RuntimeError, match="failed on purpose"):
        run_local(2, ranks.fail_rank, timeout_s=20.0)
