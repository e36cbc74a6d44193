"""The port's spans and counters on the TLAS path (tinybvh_tpu_torch/
_trace.py, api.py::TLAS, tlas/instance.py): under a CPU profiler the
tbvh.tlas_* ranges nest in the API call, the record's passes, syncs,
visits and instance entries equal counts taken independently on a 2 x 2
x 2 grid of instances (a scalar walk of each ray through the same
tables), and an untraced call keeps no record and gives bit-identical
hits."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

import tinybvh_tpu_torch as tt  # noqa: E402
from tinybvh_tpu_torch import _trace  # noqa: E402
from tinybvh_tpu_torch.io.loaders import random_tris  # noqa: E402
from tinybvh_tpu_torch.layouts.mbvh import EMPTY_SLOT  # noqa: E402
from tinybvh_tpu_torch.tlas import instance  # noqa: E402

FAR = np.float32(1e30)
SPANS = {"tbvh.tlas_intersect", "tbvh.tlas_wavefront", "tbvh.tlas_lockstep"}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _grid(tris, pitch):
    """A TLAS of 2 x 2 x 2 instances of one BLAS, each turned a little
    about y and moved by `pitch` a cell."""
    mats = []
    for i in range(8):
        a = 0.3 * i
        m = np.eye(4, dtype=np.float32)
        m[0, 0], m[0, 2], m[2, 0], m[2, 2] = (np.cos(a), np.sin(a),
                                              -np.sin(a), np.cos(a))
        m[:3, 3] = [(i % 2) * pitch, (i // 2 % 2) * pitch, (i // 4) * pitch]
        mats.append(m)
    return tt.TLAS([tt.BVH(tris, device="cpu")], np.stack(mats))


@pytest.fixture(scope="module")
def dense():
    """Overlapping instances: both capped wavefront passes overflow."""
    return _grid(random_tris(400, seed=1), 1.0)


@pytest.fixture(scope="module")
def sparse():
    """Instances apart, a few triangles each: the first pass answers."""
    return _grid(random_tris(40, seed=2, extent=2.0), 4.0)


def _rays(eye, target, n=256, spread=0.15, seed=3):
    rng = np.random.default_rng(seed)
    d = (np.asarray(target, np.float32) - eye
         + rng.normal(size=(n, 3)) * spread * np.linalg.norm(
             np.asarray(target) - eye))
    o = np.broadcast_to(np.asarray(eye, np.float32), (n, 3))
    return tt.make_rays(o.astype(np.float32), d.astype(np.float32),
                        device="cpu")


def _dense_rays():
    return _rays(np.array([-8.0, 5.0, -9.0]), [6.0, 6.0, 6.0], spread=0.05)


def _sparse_rays():
    return _rays(np.array([-8.0, 5.0, -9.0]), [6.0, 6.0, 6.0], spread=0.05,
                 seed=4)


def _traced(fn):
    n0 = len(_trace.RECORDS)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = [(e.name, e.time_range.start, e.time_range.end)
             for e in prof.events() if e.name.startswith("tbvh.")]
    return out, list(_trace.RECORDS)[n0:], spans


def _numbers(rec):
    """The record with its device counts (0-dim tensors) read."""
    return {k: int(v) if isinstance(v, torch.Tensor) else v
            for k, v in rec.items()}


# ---- an independent scalar walk of one ray through the TLAS8 tables ------

def _frame(tl, f, o, d):
    """The ray in frame f (None: the world), float32 as the program
    moves it: products summed left to right."""
    if f is None:
        a, b = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    else:
        inv = tl.inst_inv[f].numpy()
        a, b = inv[:3, :3], inv[:3, 3]

    def apply(v):
        p = a * v[None, :]
        return p[:, 0] + p[:, 1] + p[:, 2]
    o2, d2 = apply(o) + b, apply(d)
    with np.errstate(divide="ignore"):
        inv_d = np.float32(1.0) / np.where(d2 == 0, np.float32(1.0), d2)
    big = np.where(d2 < 0, -FAR, FAR).astype(np.float32)
    return o2, d2, np.where(np.abs(d2) > 1e-20, inv_d, big)


def _slab(o, rd, t, box):
    """Entry distance of each of a node's 8 children, FAR where missed."""
    b = box.reshape(6, 8)
    t1 = (b[:3] - o[:, None]) * rd[:, None]
    t2 = (b[3:] - o[:, None]) * rd[:, None]
    mn, mx = np.minimum(t1, t2), np.maximum(t1, t2)
    tmin = np.maximum(np.maximum(mn[0], mn[1]), mn[2])
    tmax = np.minimum(np.minimum(mx[0], mx[1]), mx[2])
    return np.where((tmax >= tmin) & (tmin < t) & (tmax >= 0), tmin, FAR)


def _leaf_t(tl, row, o, d, t):
    """The nearest hit t < t among a leaf row's 4 triangles, or FAR."""
    best = FAR
    for tri in tl.leaf_tris[row].numpy():
        v0, e1, e2 = tri[0], tri[1] - tri[0], tri[2] - tri[0]
        cross = (lambda a, b: np.array([a[1] * b[2] - a[2] * b[1],
                                        a[2] * b[0] - a[0] * b[2],
                                        a[0] * b[1] - a[1] * b[0]],
                                       np.float32))
        dot = (lambda a, b: (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2])
        h = cross(d, e2)
        det = dot(e1, h)
        if not abs(det) > 1e-9:
            continue
        inv = np.float32(1.0) / det
        s = o - v0
        u = dot(s, h) * inv
        q = cross(s, e1)
        v = dot(d, q) * inv
        th = dot(e2, q) * inv
        if u >= 0 and v >= 0 and u + v <= 1 and 0 < th < t and th < best:
            best = th
    return best


def _kid(tl, word, frame):
    """(code, frame, entered) of a child word: an instance's word enters
    its BLAS root in its frame."""
    L = tl.n_leaf_rows
    if word < 0 and -word - 1 >= L:
        i = -word - 1 - L
        return int(tl.inst_root[i]), i, True
    return word, frame, False


def _lockstep_counts(tl, o, d):
    """(nodes and leaves taken, instance entries) of the per-ray-stack
    walk: nearest child first, the others pushed in lane order and
    popped last in first out, a popped entry dropped unless nearer than
    the ray's t."""
    L, t = tl.n_leaf_rows, FAR
    cur, frame, stack, visits, entries = 0, None, [], 0, 0
    while True:
        if cur is None:
            if not stack:
                return visits, entries
            cur, dist, frame = stack.pop()
            if not dist < t:
                cur = None
                continue
        o2, d2, rd2 = _frame(tl, frame, o, d)
        if cur >= 0:
            visits += 1
            dist = _slab(o2, rd2, t, tl.bounds[cur].numpy())
            kids = tl.child[cur].numpy()
            dist = np.where((dist < FAR) & (kids != EMPTY_SLOT), dist, FAR)
            if not (dist < FAR).any():
                cur = None
                continue
            near = int(np.argmin(dist))
            stack += [(int(kids[k]), dist[k], frame) for k in range(8)
                      if dist[k] < FAR and k != near]
            cur = int(kids[near])
        elif -cur - 1 < L:
            visits += 1
            t = min(t, _leaf_t(tl, -cur - 1, o2, d2, t))
            cur = None
        else:
            entries += 1
            cur, frame, _ = _kid(tl, cur, frame)


def _wavefront_counts(tl, o, d):
    """(pairs summed over levels, instance entries) of the level-by-level
    walk: each level tests every pair of the ray's frontier against the
    ray's t at the level's start, folds its leaves' hits into t, and keeps
    the children nearer than the new t."""
    L, t = tl.n_leaf_rows, FAR
    front, visits, entries = [(0, None, np.float32(0))], 0, 0
    while front:
        visits += len(front)
        tb, kids_next = t, []
        for code, frame, entry in front:
            if not entry < tb:
                continue
            o2, d2, rd2 = _frame(tl, frame, o, d)
            if code >= 0:
                dist = _slab(o2, rd2, tb, tl.bounds[code].numpy())
                for k, word in enumerate(tl.child[code].numpy()):
                    if dist[k] < FAR and word != EMPTY_SLOT:
                        kids_next.append((*_kid(tl, int(word), frame),
                                          dist[k]))
            else:
                t = min(t, _leaf_t(tl, -code - 1, o2, d2, tb))
        kept = [k for k in kids_next if k[3] < t]
        entries += sum(1 for k in kept if k[2])
        front = [(c, f, e) for c, f, _, e in kept]
    return visits, entries


def _nonzeros(monkeypatch, fn):
    """fn()'s result and its `torch.nonzero` calls."""
    calls = []
    real = torch.nonzero
    monkeypatch.setattr(torch, "nonzero",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    out = fn()
    monkeypatch.undo()
    return out, len(calls)


def _checks(tl, rays, monkeypatch):
    """The lockstep's host syncs: a check at step 0 and every 8 steps,
    and no `nonzero`."""
    (_, steps), nonzeros = _nonzeros(monkeypatch, lambda: (
        instance.intersect_tlas8(tl, rays, with_steps=True)))
    assert nonzeros == 0 and steps % instance._CHECK_EVERY == 0
    return steps // instance._CHECK_EVERY + 1


def _levels(tl, rays, cap, monkeypatch):
    """A wavefront pass's levels (its `nonzero` calls, one a level) and
    whether it overflowed."""
    (_, overflow), levels = _nonzeros(monkeypatch, lambda: (
        instance.intersect_tlas_wavefront(tl, rays, cap_factor=cap)))
    return levels, overflow


# ---- the tests --------------------------------------------------------------

def test_spans_nest_under_the_profiler(dense):
    rays = _dense_rays()
    _, recs, spans = _traced(lambda: dense.intersect(rays))
    assert {n for n, _, _ in spans} == SPANS and len(recs) == 1
    (outer,) = [(s, e) for n, s, e in spans if n == "tbvh.tlas_intersect"]
    passes = sorted((s, e, n) for n, s, e in spans
                    if n != "tbvh.tlas_intersect")
    assert [n for _, _, n in passes] == ["tbvh.tlas_wavefront"] * 2 + [
        "tbvh.tlas_lockstep"]
    for s, e, _ in passes:
        assert outer[0] <= s <= e <= outer[1]
    for (_, e0, _), (s1, _, _) in zip(passes, passes[1:]):
        assert e0 <= s1
    rec = recs[0]
    assert rec["api"] == "tlas_intersect" and rec["span"] in SPANS
    _, occ_recs, occ_spans = _traced(lambda: dense.is_occluded(rays, 4.0))
    assert "tbvh.tlas_is_occluded" in {n for n, _, _ in occ_spans}
    assert occ_recs[0]["api"] == "tlas_is_occluded"


def test_lockstep_counts_equal_a_scalar_walk(dense, monkeypatch):
    rays = _dense_rays()
    _, (rec,), _ = _traced(lambda: dense.intersect(rays))
    # the device counts stay on the device: recording them waits for nothing
    assert all(isinstance(rec[k], torch.Tensor) for k in ("visits",
                                                           "entries"))
    rec = _numbers(rec)
    tl = dense._impl
    assert rec["rays"] == 256
    assert rec["passes"] == 3 and rec["discarded"] == 2
    levels = [_levels(tl, rays, cap, monkeypatch) for cap in (4, 12)]
    assert all(over for _, over in levels)
    assert rec["syncs"] == sum(n for n, _ in levels) + _checks(tl, rays,
                                                            monkeypatch)
    assert rec["discarded_visits"] > rays.o.shape[0]
    walks = [_lockstep_counts(tl, rays.o[r].numpy(), rays.d[r].numpy())
             for r in range(rays.o.shape[0])]
    assert rec["visits"] == sum(v for v, _ in walks)
    assert rec["entries"] == sum(e for _, e in walks) > 256


def test_wavefront_counts_equal_a_scalar_walk(sparse, monkeypatch):
    rays = _sparse_rays()
    hits, (rec,), spans = _traced(lambda: sparse.intersect(rays))
    assert isinstance(rec["entries"], torch.Tensor)
    rec = _numbers(rec)
    tl = sparse._impl
    assert 0.1 < float((hits.prim >= 0).double().mean()) < 0.9
    assert rec["passes"] == 1 and rec["discarded"] == 0
    assert rec["discarded_visits"] == 0
    assert "tbvh.tlas_lockstep" not in {n for n, _, _ in spans}
    levels, over = _levels(tl, rays, 4, monkeypatch)
    assert not over and rec["syncs"] == levels
    walks = [_wavefront_counts(tl, rays.o[r].numpy(), rays.d[r].numpy())
             for r in range(rays.o.shape[0])]
    assert rec["visits"] == sum(v for v, _ in walks)
    assert rec["entries"] == sum(e for _, e in walks) > 0


@pytest.mark.parametrize("scene", ["dense", "sparse"])
def test_untraced_calls_keep_nothing_and_give_the_same_bits(
        scene, request, monkeypatch):
    tl = request.getfixturevalue(scene)
    rays = _dense_rays() if scene == "dense" else _sparse_rays()
    traced, _, _ = _traced(lambda: tl.intersect(rays))
    traced_occ, _, _ = _traced(lambda: tl.is_occluded(rays, 4.0))
    opened = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a: opened.append(a) or real(*a))
    n0 = len(_trace.RECORDS)
    hits = tl.intersect(rays)
    occ = tl.is_occluded(rays, 4.0)
    assert len(_trace.RECORDS) == n0 and opened == []
    assert _trace.record() is None
    for k in ("t", "u", "v", "prim", "inst"):
        assert torch.equal(getattr(hits, k), getattr(traced, k)), k
    assert torch.equal(occ, traced_occ)
