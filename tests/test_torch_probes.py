"""The port's probe kernels' plain twins against the JAX probes, on the CPU.

Kernel H (tinybvh_tpu_torch/probes/gather.py): each twin against the JAX
probe body under pl.pallas_call(..., interpret=True) on the probe
module's own arrays, exactly (assert_array_equal); `kernel2`, nested in
the probe's main(), against the probe's own numpy expression.

Kernel I (tinybvh_tpu_torch/probes/mt_ablation.py): the twin against
benchmarks/mt_ablation_probe.py::_ablation_kernel, called as the probe's
pallas_call with interpret=True, at T = 8 tiles, k_cap 64, on
random_tris(3000, seed=0)'s packet tables (the port's own build for the
port, JAX's for JAX), for the variants whose buffer the JAX kernel
writes. Tolerances as tests/test_packet2.py: the row equal except on
exact ties (both t within a relative 1e-6), t within rtol = atol = 1e-4.
The no-copy variants read a buffer that the JAX kernel never writes (NaN
in interpret mode); the port defines it, and they are held to
invariants instead.
"""

import functools
import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

import tinybvh_tpu as tb  # noqa: E402
from tinybvh_tpu.traverse import packet2 as jp2  # noqa: E402
from tinybvh_tpu_torch import BVH  # noqa: E402
from tinybvh_tpu_torch.io.loaders import random_tris  # noqa: E402
from tinybvh_tpu_torch.probes import gather as hg  # noqa: E402
from tinybvh_tpu_torch.probes import mt_ablation as ma  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T, K_CAP, KPT = 8, 64, 40


def _load(name):
    path = os.path.join(REPO, "benchmarks", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_probe_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def probes():
    """The JAX probe modules, imported once (pallas_gather_probe2 runs its
    probes at import; off the TPU each prints a FAILED line)."""
    return {n: _load(n) for n in ("pallas_gather_probe",
                                  "pallas_gather_probe2",
                                  "mt_ablation_probe")}


def _interpret(body, shape, dtype, *args):
    out = pl.pallas_call(body, out_shape=jax.ShapeDtypeStruct(shape, dtype),
                         interpret=True)(*args)
    return np.asarray(out)


def _t(x):
    """A JAX or numpy array as a CPU tensor (bf16 kept as bf16)."""
    if getattr(x, "dtype", None) == jnp.bfloat16:
        return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(x))


# ---- kernel H ---------------------------------------------------------------

# form -> (module, body, arrays of the module, output shape, twin wrapper)
H_CASES = {
    "row": ("pallas_gather_probe", "kernel", ("table", "idx"), (4096, 48),
            hg.row_gather),
    "A": ("pallas_gather_probe2", "kA", ("tblA", "idxA"), (8, 128),
          hg.lane_gather),
    "B": ("pallas_gather_probe2", "kB", ("tblB", "idxB"), (8, 1024),
          hg.lane_gather),
    "B2": ("pallas_gather_probe2", "kB2", ("tblB", "idxB2"), (8, 128),
           hg.lane_gather),
    "C": ("pallas_gather_probe2", "kC", ("tblC", "idxC"), (8, 128),
          hg.sublane_gather),
    "E": ("pallas_gather_probe2", "kE", ("flat", "idxE"), (8, 128),
          hg.flat_take),
    "A100": ("pallas_gather_probe2", "kA100", ("tblA", "idxA"), (8, 128),
             hg.chain_gather),
    "C100": ("pallas_gather_probe2", "kC100", ("tblC", "idxC"), (8, 128),
             hg.sum_gather),
    # kD reads the module's NN at call time: it exists only at the last N
    "D": ("pallas_gather_probe2", "kD", ("tblD", "idxD"), (256, 96),
          hg.onehot_gather),
}


@pytest.mark.parametrize("form", list(H_CASES))
def test_gather_twin_matches_jax_probe(probes, form):
    mod_name, body, names, shape, wrapper = H_CASES[form]
    mod = probes[mod_name]
    arrays = [getattr(mod, n) for n in names]
    ref = _interpret(getattr(mod, body), shape, jnp.float32,
                     *[jnp.asarray(a) for a in arrays])
    before = dict(hg.LAUNCHES)
    got = wrapper(*[_t(a) for a in arrays])
    assert hg.LAUNCHES == before          # the CPU runs the twin
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_gather_col_twin_matches_probe_expression():
    """`kernel2` is nested in the probe's main(); its reference is the
    probe's numpy expression (pallas_gather_probe.py:71)."""
    rng = np.random.default_rng(5)
    a = rng.random((4096, 32), dtype=np.float32)
    col = rng.integers(0, 32, 4096, dtype=np.int32)
    ref = np.take_along_axis(a, col[:, None], 1)[:, 0]
    got = hg.col_gather(torch.from_numpy(a), torch.from_numpy(col))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_gather_driver_on_cpu():
    """The driver's inputs at the probes' shapes go through every form;
    off the card it runs the twins, times nothing and launches nothing."""
    before = dict(hg.LAUNCHES)
    res = hg.run(device="cpu")
    assert set(res) == set(hg.FORMS)
    assert hg.LAUNCHES == before
    for name, r in res.items():
        assert r["ms"] is None and r["device_ms"] is None
        assert r["launches"] == 0 and r["max_abs_err"] == 0.0
    t, idx = res["D8192"]["args"]
    assert t.dtype == torch.bfloat16 and t.shape == (8192, 96)
    assert torch.equal(res["D8192"]["out"], 10 * t[idx.long()].float())


def test_probe_inputs_need_a_card_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        hg.make_inputs()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ma.make_inputs(100, T=8, keys_per_tile=16, k_cap=64)


# ---- kernel I ---------------------------------------------------------------

@pytest.fixture(scope="module")
def ablation_scene():
    """random_tris(3000, seed=0)'s packet tables from both packages and
    the reference's inputs at T=8, k_cap 64, 40 keys a tile, with tile 0
    empty, tile 1 full (count = k_cap), tile 2 stopped by a finite gate
    (tmax 5, gate 10 before its second super-block), and tiles 4-7 cast
    from origins near the soup (more hits)."""
    tris = random_tris(3000, seed=0)
    jaux = tb.BVH(tris).packet_aux
    gtab = BVH(tris, device="cpu").packet_aux.gtab_pad
    np.testing.assert_array_equal(gtab.numpy(), np.asarray(jaux.gtab_pad))
    keys, counts, lbg, tmax, o_t, d_t = ma.make_inputs(
        jaux.n_leaves, T, KPT, K_CAP, seed=0, device="cpu")
    counts[0] = 0
    counts[1] = K_CAP
    keys[1] = keys[1, 0] + torch.arange(K_CAP, dtype=torch.int32)
    lbg[1] = 0.0
    tmax[2] = 5.0
    lbg[2, 1] = 10.0
    o_t[4:] *= 0.2
    return jaux, gtab, (keys, counts, lbg, tmax, o_t, d_t)


def _jax_ablation(mod, jaux, args, variant):
    """benchmarks/mt_ablation_probe.py:59-97 with interpret=True."""
    keys, counts, lbg, tmax, o_t, d_t = (jnp.asarray(a.numpy())
                                         for a in args)
    nb = K_CAP // 32
    tbm = 8
    kern = functools.partial(mod._ablation_kernel, k_cap=K_CAP,
                             variant=variant, leaf_bits=jp2._LEAF_BITS)

    def smem(*shape):
        return pl.BlockSpec((tbm,) + shape, lambda i: (i, 0, 0),
                            memory_space=pltpu.SMEM)

    def vmem(*shape):
        return pl.BlockSpec((tbm,) + shape, lambda i: (i, 0, 0),
                            memory_space=pltpu.VMEM)

    t, i = pl.pallas_call(
        kern,
        grid=(T // tbm,),
        in_specs=[smem(1, K_CAP), smem(1, 1), smem(1, nb), smem(1, 1),
                  vmem(3, 256), vmem(3, 256),
                  pl.BlockSpec(memory_space=pl.ANY)],
        out_shape=(jax.ShapeDtypeStruct((T, 1, 256), jnp.float32),
                   jax.ShapeDtypeStruct((T, 1, 256), jnp.int32)),
        out_specs=(vmem(1, 256), vmem(1, 256)),
        scratch_shapes=[pltpu.VMEM((2 * 128, 128), jnp.float32),
                        pltpu.SemaphoreType.DMA((2, 32))],
        interpret=True,
    )(keys.reshape(T, 1, K_CAP), counts.reshape(T, 1, 1),
      lbg.reshape(T, 1, nb), tmax.reshape(T, 1, 1), o_t, d_t, jaux.gtab_pad)
    return np.asarray(t)[:, 0], np.asarray(i)[:, 0]


@pytest.mark.parametrize("variant", ["full", "seg8", "seg32", "bigdma",
                                     "skeleton"])
def test_ablation_twin_matches_jax_probe(probes, ablation_scene, variant):
    jaux, gtab, args = ablation_scene
    tr, ir = _jax_ablation(probes["mt_ablation_probe"], jaux, args, variant)
    before = dict(ma.LAUNCHES)
    t, i = (x.numpy() for x in ma.ablation(*args, gtab, variant))
    assert ma.LAUNCHES == before
    tie = np.abs(t - tr) <= 1e-6 * np.maximum(np.abs(tr), 1e-30)
    diff = i != ir
    assert not (diff & ~tie).any(), f"{int((diff & ~tie).sum())} rows"
    np.testing.assert_allclose(t[~diff], tr[~diff], rtol=1e-4, atol=1e-4)
    if variant != "skeleton":
        hits = (t < 1e30).sum(axis=1)
        assert hits[0] == 0 and hits[4:].sum() > 0
        # the finite gate stopped tile 2 after its first super-block
        _, _, n_sb = ma._ablation_plain(*args, gtab, variant)
        assert n_sb.tolist()[:3] == [0, 2, 1]


def test_ablation_nodma_equals_bigdma(ablation_scene):
    """The defined no-copy buffer holds rows 0:128, what bigdma copies."""
    _, gtab, args = ablation_scene
    a = ma.ablation(*args, gtab, "nodma")
    b = ma.ablation(*args, gtab, "bigdma")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert int((a[0] < 1e30).sum()) > 0


def test_ablation_bf16_equals_nodma_on_bf16_exact_inputs(ablation_scene):
    """With rows and ray features exact in bf16 (rows rounded to bf16;
    small integer origins and directions, so o x d is too), bf16's
    rounding changes nothing and its exact products summed in lane order
    are nodma's."""
    _, gtab, args = ablation_scene
    keys, counts, lbg, tmax, _, _ = args
    rng = np.random.default_rng(11)
    o_t = torch.from_numpy(rng.integers(-2, 3, (T, 3, 256)).astype(
        np.float32))
    d_t = torch.from_numpy(rng.integers(-2, 3, (T, 3, 256)).astype(
        np.float32))
    g16 = gtab.to(torch.bfloat16).float()
    a = ma.ablation(keys, counts, lbg, tmax, o_t, d_t, g16, "bf16")
    b = ma.ablation(keys, counts, lbg, tmax, o_t, d_t, g16, "nodma")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert int((a[0] < 1e30).sum()) > 0


def test_ablation_mathonly_is_the_fold_of_row_sums(ablation_scene):
    """mathonly: best t = min(tmax, min over rows 0:128 of det + u' + v' +
    t') for every tile with a super-block, row 0, by a numpy fold in lane
    order (float32, each product and sum rounded on its own)."""
    _, gtab, args = ablation_scene
    keys, counts, lbg, tmax, o_t, d_t = (a.numpy() for a in args)
    g = gtab.numpy()[:128, :48]
    o, d = o_t, d_t
    f = np.concatenate([d, np.stack([o[:, 1] * d[:, 2] - o[:, 2] * d[:, 1],
                                     o[:, 2] * d[:, 0] - o[:, 0] * d[:, 2],
                                     o[:, 0] * d[:, 1] - o[:, 1] * d[:, 0]],
                                    1),
                        o, np.ones_like(o[:, :1]), np.zeros_like(o[:, :2])],
                       1)
    total = np.zeros((T, 128, 256), np.float32)
    for q in range(4):
        acc = np.zeros((T, 128, 256), np.float32)
        for k in range(12):
            acc = acc + g[None, :, 12 * q + k, None] * f[:, None, k, :]
        total = acc if q == 0 else total + acc
    walks = np.minimum(counts, K_CAP) > 0
    ref = np.where(walks[:, None], np.minimum(tmax[:, None],
                                              total.min(axis=1)),
                   tmax[:, None])
    t, i = ma.ablation(*args, gtab, "mathonly")
    np.testing.assert_array_equal(t.numpy(), ref)
    assert not i.any()


def test_ablation_driver_on_cpu(ablation_scene):
    """The driver at a small size off the card: every variant against the
    twin (check), no time, no launch; full, seg8 and seg32 copy the same
    rows of consecutive keys away from the clamp."""
    bvh = BVH(random_tris(3000, seed=0), device="cpu")
    before = dict(ma.LAUNCHES)
    res = ma.run("cpu", keys_per_tile=(16, 40), T=8, k_cap=64, bvh=bvh)
    assert ma.LAUNCHES == before
    for kpt, r in res.items():
        assert r["inputs"][0].shape == (8, 64)
        for v in ma.VARIANTS:
            assert r[v]["ms"] is None and r[v]["launches"] == 0
            assert r[v]["max_abs_err"] == 0.0
        assert torch.equal(r["nodma"]["out"][0], r["bigdma"]["out"][0])
        assert r["full"]["n_sb"].tolist() == [(kpt + 31) // 32] * 8
        assert r["mathonly"]["n_sb"].tolist() == [(kpt + 31) // 32] * 8
        assert r["skeleton"]["out"][1].unique().tolist() == [kpt]
    # the split by subtraction, on made-up device times
    times = dict(zip(ma.VARIANTS, (9.0, 8.5, 8.25, 7.0, 6.0, 4.0, 1.0, 0.5)))
    got = ma.split({v: {"device_ms": t} for v, t in times.items()})
    assert got == [("scattered copies", 2.0), ("one bulk copy", 1.0),
                   ("epilogue", 2.0), ("dots", 3.5), ("fixed per tile", 0.5)]


def test_ablation_rejects_bad_inputs(ablation_scene):
    _, gtab, args = ablation_scene
    with pytest.raises(ValueError, match="variant"):
        ma.ablation(*args, gtab, "dma")
    keys = args[0][:, :40].contiguous()
    with pytest.raises(ValueError, match="k_cap"):
        ma.ablation(keys, *args[1:], gtab, "full")
    with pytest.raises(ValueError, match="rows"):
        ma.ablation(*args, gtab[:64].contiguous(), "full")
    with pytest.raises(ValueError):
        ma.ablation(*args, gtab.to("meta"), "full")


def test_ablation_work_counts_live_rows(ablation_scene):
    """tested_pairs counts the live rows of the walked super-blocks
    (every walked row for mathonly, none for skeleton); bytes_moved
    counts lanes 0:48 of each distinct live row once."""
    _, gtab, args = ablation_scene
    counts = args[1]
    out = ma.ablation(*args, gtab, "bigdma")
    _, _, n_sb = ma._ablation_plain(*args, gtab, "bigdma")
    cnt4 = np.minimum(counts.numpy(), K_CAP) * 4
    live = sum(int(np.clip(cnt4[t] - sb * 128, 0, 128))
               for t in range(T) for sb in range(int(n_sb[t])))
    assert live < int(n_sb.sum()) * 128       # tile 2's 40 keys: 160 rows
    assert ma.tested_pairs(counts, n_sb, K_CAP, "bigdma") == live * 256
    _, _, n_m = ma._ablation_plain(*args, gtab, "mathonly")
    assert (ma.tested_pairs(counts, n_m, K_CAP, "mathonly")
            == int(n_m.sum()) * 128 * 256)
    assert ma.tested_pairs(counts, n_sb, K_CAP, "skeleton") == 0
    nbytes = sum(a.numel() * a.element_size() for a in args + out)
    assert ma.bytes_moved(args, gtab, "bigdma", n_sb, out) == (
        nbytes + 128 * 48 * 4)
    assert ma.bytes_moved(args, gtab, "skeleton", n_sb, out) == (
        T * 4 * 2 + T * 256 * 4 + sum(o.numel() * 4 for o in out))


def test_ablation_scattered_keys_on_cpu():
    """With `scattered`, each tile's keys are sorted draws from the whole
    table, the rest I32MAX; the driver runs them against the twin."""
    keys, counts, *_ = ma.make_inputs(500, T=8, keys_per_tile=40, k_cap=64,
                                      device="cpu", scattered=True)
    k = keys.numpy()
    assert (np.diff(k[:, :40], axis=1) >= 0).all()
    assert k[:, :40].min() >= 0 and k[:, :40].max() < 500
    assert np.ptp(k[:, :40], axis=1).min() > 40    # not one consecutive run
    assert (k[:, 40:] == np.iinfo(np.int32).max).all()
    assert counts.tolist() == [40] * 8
    bvh = BVH(random_tris(3000, seed=0), device="cpu")
    res = ma.run("cpu", keys_per_tile=(40,), T=8, k_cap=64, bvh=bvh,
                 scattered=True)
    for v in ma.VARIANTS:
        assert res[40][v]["max_abs_err"] == 0.0
        assert res[40][v]["graph_runs"] == 0
