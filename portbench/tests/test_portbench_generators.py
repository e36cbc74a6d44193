"""The scene and ray generators: the same seed gives the same inputs."""

import json
import math

import numpy as np
import pytest
import torch

from harness import reference
from harness.scene import make_scene, minimal_soup
from harness.spec import BASE, load_json, load_module
from harness.traffic import make_batches, scene_box

TRIS64K = load_json(BASE / "configs" / "tris64k.json")


def _scene(n=512, seed=3):
    return make_scene(dict(TRIS64K, triangle_count=n,
                           cube_side=(n / 8192) ** (1 / 3)), seed)


def test_scene_is_deterministic_per_seed():
    a, b, c = _scene(seed=2 ** 33 + 1), _scene(seed=2 ** 33 + 1), _scene(seed=5)
    assert a.dtype == np.float32 and a.shape == (512, 3, 3)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)


def test_scene_follows_tiny_bvh_minimal():
    """v0 uniform in the cube, v1 and v2 at v0 + 0.1 * U[0, 1)^3."""
    t = minimal_soup(20000, 2 ** 40 + 3, 2.0, 0.1)
    v0, offs = t[:, 0], t[:, 1:] - t[:, :1]
    assert v0.min() >= 0.0 and v0.max() < 2.0
    assert abs(float(v0.mean()) - 1.0) < 0.01
    assert offs.min() >= 0.0 and offs.max() <= 0.1 + 1e-6
    assert abs(float(offs.mean()) - 0.05) < 0.001


def test_configurations_keep_the_sources_density():
    for name in ("tris64k", "tris1m"):
        c = load_json(BASE / "configs" / f"{name}.json")
        src = c["source_values"]
        assert c["triangle_count"] / c["cube_side"] ** 3 == pytest.approx(
            src["triangle_count"] / src["cube_side"] ** 3)
        changed = {k for k, v in src.items() if c[k] != v}
        assert changed == set(c["reduced"])


def _traffic(name, **kw):
    t = load_json(BASE / "traffic" / f"{name}.json")
    t.update(kw)
    return t


def _batches(name, seed, n=512, base=BASE, **kw):
    tris_np = _scene(n)
    lo, hi = scene_box(tris_np)
    o, d, _ = make_batches(_traffic(name, **kw), base,
                           torch.from_numpy(tris_np), lo, hi, seed)
    return (o, d), tris_np


def test_batches_are_deterministic_per_seed(tmp_path):
    base = _tiny_tree(tmp_path)
    for name, kw in (("primary", dict(width=32, height=16)),
                     ("shadow", dict(rays_per_call=1024,
                                     primary="tiny_camera")),
                     ("diffuse", dict(rays_per_call=1024,
                                      primary="tiny_camera"))):
        (o1, d1), _ = _batches(name, 2 ** 40 + 7, 2048, base, pool=2, **kw)
        (o2, d2), _ = _batches(name, 2 ** 40 + 7, 2048, base, pool=2, **kw)
        (o3, d3), _ = _batches(name, 8, 2048, base, pool=2, **kw)
        assert torch.equal(o1, o2) and torch.equal(d1, d2)
        assert not torch.equal(d1, d3)
        assert o1.shape[:2] == (2, 1024) and torch.isfinite(d1).all()


def test_camera_rays_tiles_views_and_jitter():
    (o, d), tris = _batches("primary", 4, width=32, height=16, pool=3)
    assert o.shape == (3, 32 * 16 * 2, 3)
    assert torch.allclose(d.norm(dim=-1), torch.ones(()), atol=1e-5)
    # one eye a batch, at one distance from the centre in every view
    lo, hi = scene_box(tris)
    c = torch.tensor((lo + hi) / 2, dtype=torch.float32)
    dist = [float((o[b, 0] - c).norm()) for b in range(3)]
    assert max(dist) - min(dist) < 1e-3 * dist[0]
    assert (o[0] == o[0, :1]).all()
    # view b turns the eye by views_deg[b] about the vertical axis
    v0, v1 = o[0, 0] - c, o[1, 0] - c
    ang = math.degrees(math.atan2(float(v0[0] * v1[2] - v0[2] * v1[0]),
                                  float(v0[0] * v1[0] + v0[2] * v1[2])))
    assert abs(abs(ang) - 120.0) < 1e-2 and abs(float(v0[1] - v1[1])) < 1e-4
    # the first 256 rays are one 16x16 tile: their spread is a tile's
    tile = d[0, :256]
    assert float((tile - tile.mean(0)).norm(dim=1).max()) < 0.9 * 16 / 32
    # two samples of a pixel differ by jitter only
    half = 32 * 16
    assert 0 < float((d[0, :half] - d[0, half:]).norm(dim=1).max()) < 0.9 / 16


def _hits(tris_np, seed, need):
    """The reference's first `need` hits of the tiny camera mix."""
    lo, hi = scene_box(tris_np)
    tris = torch.from_numpy(tris_np)
    cam = _traffic("primary", width=32, height=16)
    kind = load_module(BASE, "rays", "camera")
    gen = torch.Generator().manual_seed(seed)
    o, d = zip(*[kind.make(tris, lo, hi, cam, gen, i) for i in range(40)])
    o, d = torch.cat(o), torch.cat(d)
    t, prim = reference.closest(tris, o, d)
    hit = prim >= 0
    return (o + t[:, None] * d)[hit][:need], prim[hit][:need], d[hit][:need]


def _from_hits(name, seed, n=2048, R=1024, P=2):
    tris_np = _scene(n)
    lo, hi = scene_box(tris_np)
    mix = _traffic(name, rays_per_call=R, pool=P)
    mix["primary"] = "tiny_camera"
    return mix, tris_np, lo, hi


def _tiny_tree(tmp_path):
    """The benchmark's folder with a camera mix "tiny_camera" of 32 x 16
    pixels."""
    import shutil

    base = tmp_path / "portbench"
    shutil.copytree(BASE, base, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    (base / "traffic" / "tiny_camera.json").write_text(json.dumps(
        _traffic("primary", width=32, height=16)))
    return base


def test_shadow_segments_end_on_the_primary_hits(tmp_path):
    base = _tiny_tree(tmp_path)
    mix, tris_np, lo, hi = _from_hits("shadow", 11)
    gen = torch.Generator().manual_seed(11)
    o, d, ref_s = load_module(base, "rays", "light").make_pool(
        torch.from_numpy(tris_np), lo, hi, mix, gen, base)
    assert o.shape == d.shape == (2, 1024, 3) and ref_s > 0
    # the camera batches come first from the same generator
    pts, _, _ = _hits(tris_np, 11, 2048)
    assert pts.shape[0] == 2048
    assert torch.allclose((o + d).reshape(-1, 3), pts, atol=1e-5)
    light = (lo + hi) / 2 + np.array([0, 2.0, 0]) * np.max(hi - lo)
    assert np.allclose(o[0].numpy(), light, atol=1e-4)


def test_diffuse_rays_leave_the_seen_side_cosine_weighted(tmp_path):
    base = _tiny_tree(tmp_path)
    mix, tris_np, lo, hi = _from_hits("diffuse", 12, R=2048)
    gen = torch.Generator().manual_seed(12)
    o, d, _ = load_module(base, "rays", "surface").make_pool(
        torch.from_numpy(tris_np), lo, hi, mix, gen, base)
    pts, prim, inc = _hits(tris_np, 12, 4096)
    assert pts.shape[0] == 4096
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    t = torch.from_numpy(tris_np)[prim]
    n = torch.linalg.cross(t[:, 1] - t[:, 0], t[:, 2] - t[:, 0])
    n = n / n.norm(dim=1, keepdim=True)
    n = torch.where((n * inc).sum(1, keepdim=True) > 0, -n, n)
    off = 1e-4 * float(np.max(hi - lo))
    # each origin is its hit lifted `off` towards the camera's side
    assert torch.allclose(o, pts + off * n, atol=1e-5)
    cos = (d * n).sum(1)
    assert (cos > 0).all()
    # cosine-weighted: E[cos] = 2/3
    assert abs(float(cos.mean()) - 2.0 / 3.0) < 0.02
