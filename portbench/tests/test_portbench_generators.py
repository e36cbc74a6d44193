"""The scene and ray generators: the same seed gives the same inputs."""

import hashlib
import json
import math

import numpy as np
import pytest
import torch

from harness import reference
from harness.spec import BASE, load_cell, load_json, load_module, load_scene
from harness.traffic import derive, make_batches

from portbench_tiny import tiny_tree

TRIS64K = load_json(BASE / "configs" / "tris64k.json")
SOUP = load_module(BASE, "scenes", "minimal_soup")
minimal_soup = SOUP.minimal_soup


def _scene(n=512, seed=3):
    """The minimal soup of n triangles at the source's density, on the
    CPU."""
    return load_scene(dict(TRIS64K, triangle_count=n,
                           cube_side=(n / 8192) ** (1 / 3)), seed, "cpu",
                      BASE)


def test_scene_is_deterministic_per_seed():
    a, b, c = (_scene(seed=s).host for s in (2 ** 33 + 1, 2 ** 33 + 1, 5))
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
    scene = _scene(n)
    o, d, _ = make_batches(_traffic(name, **kw), base, scene, seed)
    return (o, d), scene


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
    (o, d), scene = _batches("primary", 4, width=32, height=16, pool=3)
    assert o.shape == (3, 32 * 16 * 2, 3)
    assert torch.allclose(d.norm(dim=-1), torch.ones(()), atol=1e-5)
    # one eye a batch, at one distance from the centre in every view
    lo, hi = scene.lo, scene.hi
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


def _hits(scene, seed, need):
    """harness/reference.py's own first `need` hits of the tiny camera
    mix, called directly on the soup's triangles."""
    cam = _traffic("primary", width=32, height=16)
    kind = load_module(BASE, "rays", "camera")
    gen = torch.Generator().manual_seed(seed)
    o, d = zip(*[kind.make(scene, cam, gen, i) for i in range(40)])
    o, d = torch.cat(o), torch.cat(d)
    t, prim = reference.closest(scene.tris, o, d)
    hit = prim >= 0
    return (o + t[:, None] * d)[hit][:need], prim[hit][:need], d[hit][:need]


def _from_hits(name, seed, n=2048, R=1024, P=2):
    mix = _traffic(name, rays_per_call=R, pool=P)
    mix["primary"] = "tiny_camera"
    return mix, _scene(n)


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
    mix, scene = _from_hits("shadow", 11)
    lo, hi = scene.lo, scene.hi
    gen = torch.Generator().manual_seed(11)
    o, d, ref_s = load_module(base, "rays", "light").make_pool(
        scene, mix, gen, base)
    assert o.shape == d.shape == (2, 1024, 3) and ref_s > 0
    # the camera batches come first from the same generator
    pts, _, _ = _hits(scene, 11, 2048)
    assert pts.shape[0] == 2048
    assert torch.allclose((o + d).reshape(-1, 3), pts, atol=1e-5)
    light = (lo + hi) / 2 + np.array([0, 2.0, 0]) * np.max(hi - lo)
    assert np.allclose(o[0].numpy(), light, atol=1e-4)


def test_diffuse_rays_leave_the_seen_side_cosine_weighted(tmp_path):
    base = _tiny_tree(tmp_path)
    mix, scene = _from_hits("diffuse", 12, R=2048)
    lo, hi = scene.lo, scene.hi
    gen = torch.Generator().manual_seed(12)
    o, d, _ = load_module(base, "rays", "surface").make_pool(
        scene, mix, gen, base)
    pts, prim, inc = _hits(scene, 12, 4096)
    assert pts.shape[0] == 4096
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    t = torch.from_numpy(scene.host)[prim]
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


# SHA-256 of the inputs as the harness made them at commit b35e758, before
# scenes were found by name: moving the scene into scenes/ must not change
# a byte. The soup comes from numpy's generator and the camera batches from
# torch's CPU generator and float32 arithmetic, on any CPU.
PINNED_TINY = {
    2 ** 40 + 7: (
        "c1a709b3d7087475f6a339a5537a3c08ce645d2da5c8af6e8b6bb572b4ec27e1",
        "2218c2054eda908d3fb7ee896909919895f05dc2f9eaacad7620d12013fcdccc",
        "e5f5de7b40e70a7f983acab2f5efefd5b7f616e7befbf3b49047d9d63920b4a6"),
    5: (
        "06b6e65126f4d72bec328c3fe178564dd7f95efcd212c395b6af6baea954834e",
        "ddc3728ccf7d7227c7485e36c04e75fc31485a9b46659599597b8eb53824dbe7",
        "7d0328257e879975d95b48f4e3c0da509e5939cbc3a622afb41f118249a97d88"),
}
PINNED_SOUP = {
    "tris64k":
        "9154e0bcbf19e55b8ec3cdac2f1a002bb0d2ce45334ade850a57438ed78a0628",
    "tris1m":
        "68a1d23a4e65529578aa5d8c1e4c98d0fa4cda576ee85449af7219aaf633e846",
}


def _sha(x):
    x = x.contiguous().numpy() if isinstance(x, torch.Tensor) else x
    return hashlib.sha256(x.tobytes()).hexdigest()


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_tree(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("seed", sorted(PINNED_TINY))
def test_tiny_soup_and_camera_batches_keep_their_digests(tiny, seed):
    cell = load_cell("tiny-primary", *tiny)
    scene = load_scene(cell.config, seed, "cpu", cell.base)
    o, d, _ = make_batches(cell.traffic, cell.base, scene, seed)
    assert o.shape == (3, 4096, 3)
    assert (_sha(scene.host), _sha(o), _sha(d)) == PINNED_TINY[seed]
    assert _sha(scene.tris) == PINNED_TINY[seed][0]


@pytest.mark.parametrize("name", sorted(PINNED_SOUP))
def test_configured_soups_keep_their_digests(name):
    cfg = load_json(BASE / "configs" / f"{name}.json")
    assert _sha(SOUP.make(cfg, 2 ** 40 + 7, "cpu").host) == PINNED_SOUP[name]


def _parent_hits(scene, base, mix, gen, need):
    """The primary hits as harness/hits.py found them before scenes were
    found by name: harness/reference.py called on the triangles, each
    normal from tris[prim]."""
    p = load_json(base / "traffic" / f"{mix}.json")
    kind = load_module(base, "rays", p["rays"])
    tris, got, n, i = scene.tris, [], 0, 0
    while n < need:
        o, d = kind.make(scene, p, gen, i)
        i += 1
        t, prim = reference.closest(tris, o, d)
        keep = torch.nonzero(prim >= 0).squeeze(1)
        t, prim, o, d = t[keep], prim[keep], o[keep], d[keep]
        tri = tris[prim]
        nrm = torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
        nrm = nrm / torch.linalg.vector_norm(nrm, dim=1,
                                             keepdim=True).clamp_min(1e-30)
        nrm = torch.where((nrm * d).sum(1, keepdim=True) > 0.0, -nrm, nrm)
        got.append((o + t[:, None] * d, nrm))
        n += keep.numel()
    return [torch.cat(x)[:need].contiguous() for x in zip(*got)]


def _parent_pool(scene, mix, base, seed):
    """The shadow or bounce pool as the light and surface kinds made it
    from _parent_hits."""
    gen = torch.Generator().manual_seed(derive(seed, 1))
    R, P = int(mix["rays_per_call"]), int(mix["pool"])
    extent = float(np.max(scene.hi - scene.lo))
    if mix["rays"] == "light":
        light = torch.tensor((scene.lo + scene.hi) * 0.5 + np.asarray(
            mix["light_offset"], np.float64) * extent, dtype=torch.float32)
        pts, _ = _parent_hits(scene, base, mix["primary"], gen, R * P)
        pts = pts.view(P, R, 3)
        return light.expand_as(pts).contiguous(), pts - light
    pts, nrm = _parent_hits(scene, base, mix["primary"], gen, R * P)
    o = pts + nrm * (float(mix["offset"]) * extent)
    d = load_module(base, "rays", "surface").cosine_about(nrm, gen)
    return o.view(P, R, 3), d.view(P, R, 3)


@pytest.mark.parametrize("name", ["tiny-primary", "tiny-shadow",
                                  "tiny-diffuse"])
def test_batches_and_answers_are_the_references_called_directly(tiny, name):
    """Shadow and bounce batches, and every call's reference answers in
    both precisions, equal harness/reference.py's called directly on the
    soup's triangles in this process."""
    cell = load_cell(name, *tiny)
    seed = 2 ** 37 + 21
    scene = load_scene(cell.config, seed, "cpu", cell.base)
    o, d, _ = make_batches(cell.traffic, cell.base, scene, seed)
    if "primary" in cell.traffic:
        po, pd = _parent_pool(scene, cell.traffic, cell.base, seed)
        assert torch.equal(o, po) and torch.equal(d, pd)
    calls = load_module(cell.base, "calls", cell.traffic["call"])
    t_max = cell.traffic["t_max"]
    o, d = o[0, ::7], d[0, ::7]
    for precision in reference.PRECISIONS:
        ans = calls.reference_answers(scene, o, d, t_max, precision)
        if cell.traffic["call"] == "intersect":
            t, prim = reference.closest(scene.tris, o, d, 1e30, precision)
            assert torch.equal(ans[:, 0], t)
            assert torch.equal(ans[:, 1], prim.to(torch.float32))
        else:
            occ = reference.occluded(scene.tris, o, d, t_max, precision)
            assert torch.equal(ans[:, 0] > 0.5, occ)
