"""The port's scene layer (scene/mesh.py, scene/graph.py) against the
JAX package's, on the CPU.

The loaders array for array on files the tests write (an OBJ with
normals, UVs, quads and negative indices; a glTF with an embedded and a
file buffer, an interleaved view, a node tree, a morph target, a
two-joint skin and LINEAR / STEP / CUBICSPLINE channels). Then the
scenes of tests/test_scene.py:57-176, :196, :247 (composition and
collapse, over a glTF written to tmp_path instead of the absent testdata
file) and :298, each built in both packages from the same inputs: the
posed triangles equal, the TLAS hits of equal prim and instance with t
within 1e-4, and each test's own assertions on the port.
"""

import base64
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import tinybvh_tpu as tb  # noqa: E402
from tinybvh_tpu.render.pathtracer_tlas import (  # noqa: E402
    trace_paths_tlas as jtrace,
)
from tinybvh_tpu.scene import graph as jg  # noqa: E402
from tinybvh_tpu.scene import mesh as jm  # noqa: E402
from tinybvh_tpu_torch import native  # noqa: E402
from tinybvh_tpu_torch.core.rays import make_rays  # noqa: E402
from tinybvh_tpu_torch.render.pathtracer_tlas import (  # noqa: E402
    trace_paths_tlas as ptrace,
)
from tinybvh_tpu_torch.scene import graph as pg  # noqa: E402
from tinybvh_tpu_torch.scene import mesh as pm  # noqa: E402
from tinybvh_tpu_torch.tlas.packet import intersect_tlas_packets2  # noqa: E402
from tests.torch_parity import JaxDraws, _np  # noqa: E402
from tests.test_torch_jax_native import jax_native  # noqa: E402,F401


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _scenes():
    """(JAX scene, port scene on the CPU)."""
    return jg.Scene(), pg.Scene(device="cpu")


def _rays(o, d):
    o = np.asarray(o, np.float32)
    d = np.asarray(d, np.float32)
    return tb.make_rays(o, d), make_rays(o, d, device="cpu")


def _toward(lo, hi, n=256, seed=0):
    """n rays from outside the box lo..hi toward random points in it."""
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(lo, np.float32), np.asarray(hi, np.float32)
    ext = float(np.max(hi - lo)) + 1.0
    eye = (lo + hi) / 2 + np.array([0.3, 0.4, -2.0], np.float32) * ext
    tgt = rng.uniform(lo, hi, (n, 3))
    d = tgt - eye
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return np.tile(eye, (n, 1)), d


def _same_frame(js, ps, o, d):
    """Posed triangles equal, then the two scenes' hits: prim and inst
    equal, t within 1e-4. Returns the port's hits."""
    assert len(js.meshes) == len(ps.meshes)
    for a, b in zip(js.meshes, ps.meshes):
        np.testing.assert_array_equal(b.tris, a.tris)
    for a, b in zip(js.nodes, ps.nodes):
        np.testing.assert_array_equal(b.world, a.world)
    jr, pr = _rays(o, d)
    jh = js.intersect(jr)
    ph = ps.intersect(pr)
    np.testing.assert_array_equal(_np(ph.prim), np.asarray(jh.prim))
    np.testing.assert_array_equal(_np(ph.inst), np.asarray(jh.inst))
    hit = np.asarray(jh.prim) >= 0
    np.testing.assert_allclose(_np(ph.t)[hit], np.asarray(jh.t)[hit],
                               rtol=1e-4, atol=1e-4)
    return ph


# ---- files ------------------------------------------------------------------

OBJ = """# quad with normals and uvs, a fan, negative indices
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0.5 1.5 0.2
vt 0 0
vt 1 0
vt 1 1
vt 0 1
vn 0 0 1
vn 0 0.6 0.8
f 1/1/1 2/2/1 3/3/2 4/4/2
f -1/-2/-1 -2/-3/-2 -3/-4/-1
"""


def test_load_obj_matches_jax(tmp_path):
    path = tmp_path / "quad.obj"
    path.write_text(OBJ)
    a, b = jm.load_obj(str(path)), pm.load_obj(str(path))
    assert b.tris.shape == (3, 3, 3) and b.name == "quad.obj"
    for k in ("tris", "normals", "uvs", "mat_id"):
        np.testing.assert_array_equal(getattr(b, k), getattr(a, k))
    bare = tmp_path / "bare.obj"
    bare.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    a, b = jm.load_obj(str(bare)), pm.load_obj(str(bare))
    assert b.uvs is None
    for k in ("tris", "normals", "mat_id"):
        np.testing.assert_array_equal(getattr(b, k), getattr(a, k))


class _Gltf:
    """A small glTF 2.0 writer: buffer views and accessors over two
    buffers (0 embedded as base64, 1 a .bin file beside the .gltf)."""

    CT = {np.float32: 5126, np.uint16: 5123, np.uint8: 5121}
    TYPE = {1: "SCALAR", 2: "VEC2", 3: "VEC3", 4: "VEC4", 16: "MAT4"}

    def __init__(self):
        self.bufs = [bytearray(), bytearray()]
        self.g = {"asset": {"version": "2.0"}, "bufferViews": [],
                  "accessors": []}

    def _view(self, data: bytes, buf=0, stride=None):
        b = self.bufs[buf]
        while len(b) % 4:
            b.append(0)
        view = {"buffer": buf, "byteOffset": len(b), "byteLength": len(data)}
        if stride:
            view["byteStride"] = stride
        b.extend(data)
        self.g["bufferViews"].append(view)
        return len(self.g["bufferViews"]) - 1

    def acc(self, a, buf=0, normalized=False):
        a = np.ascontiguousarray(a)
        n = a.shape[0]
        ncomp = int(np.prod(a.shape[1:])) if a.ndim > 1 else 1
        acc = {"bufferView": self._view(a.tobytes(), buf),
               "componentType": self.CT[a.dtype.type], "count": n,
               "type": self.TYPE[ncomp]}
        if normalized:
            acc["normalized"] = True
        self.g["accessors"].append(acc)
        return len(self.g["accessors"]) - 1

    def interleaved(self, a, b):
        """Two float VEC3 accessors over one strided view."""
        data = np.concatenate([a, b], axis=1).astype(np.float32)
        v = self._view(data.tobytes(), 0, stride=24)
        for off in (0, 12):
            self.g["accessors"].append({
                "bufferView": v, "byteOffset": off, "componentType": 5126,
                "count": len(a), "type": "VEC3"})
        return len(self.g["accessors"]) - 2, len(self.g["accessors"]) - 1

    def write(self, path):
        self.g["buffers"] = [
            {"byteLength": len(self.bufs[0]),
             "uri": "data:application/octet-stream;base64,"
                    + base64.b64encode(bytes(self.bufs[0])).decode()},
            {"byteLength": len(self.bufs[1]), "uri": "extra.bin"}]
        (path.parent / "extra.bin").write_bytes(bytes(self.bufs[1]))
        path.write_text(json.dumps(self.g))
        return str(path)


def _write_gltf(path, skinned=True):
    """A skinned quad strip (two joints) with a morph target, and a
    triangle in the file buffer; a node tree with a root translation;
    LINEAR translation, STEP rotation, CUBICSPLINE scale and LINEAR
    weights channels."""
    w = _Gltf()
    pos = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                    [2, 0, 0], [2, 1, 0]], np.float32)
    nrm = np.tile(np.array([[0, 0, 1]], np.float32), (6, 1))
    p_acc, n_acc = w.interleaved(pos, nrm)
    uv = w.acc(pos[:, :2] * 0.5)
    idx = w.acc(np.array([0, 1, 2, 0, 2, 3, 1, 4, 5, 1, 5, 2], np.uint16))
    joints = w.acc(np.array([[0, 1, 0, 0]] * 4 + [[1, 0, 0, 0]] * 2,
                            np.uint8))
    weights = w.acc(np.array([[255, 0, 0, 0], [128, 127, 0, 0],
                              [128, 127, 0, 0], [255, 0, 0, 0],
                              [255, 0, 0, 0], [255, 0, 0, 0]], np.uint8),
                    normalized=True)
    target = w.acc(np.tile(np.array([[0, 0, 0.5]], np.float32), (6, 1)))
    tri = w.acc(np.array([[3, 0, 1], [4, 0, 1], [3, 1, 1]], np.float32),
                buf=1)
    ibm = np.stack([np.eye(4), np.eye(4)]).astype(np.float32)
    ibm[1, 0, 3] = -1.0                       # row-major: translate -1 x
    ibm_acc = w.acc(np.transpose(ibm, (0, 2, 1)).reshape(2, 16), buf=1)
    t2 = w.acc(np.array([0.0, 1.0], np.float32))
    t3 = w.acc(np.array([0.0, 0.5, 1.0], np.float32))
    w.g.update({
        "materials": [
            {"name": "grey", "pbrMetallicRoughness": {
                "baseColorFactor": [0.5, 0.5, 0.5, 1],
                "metallicFactor": 0.2}, "doubleSided": False,
             "extensions": {"KHR_materials_ior": {"ior": 1.4}}},
            {"name": "lamp", "emissiveFactor": [4, 4, 3],
             "alphaMode": "MASK", "alphaCutoff": 0.3}],
        "meshes": [
            {"name": "strip", "primitives": [{
                "attributes": {"POSITION": p_acc, "NORMAL": n_acc,
                               "TEXCOORD_0": uv, "JOINTS_0": joints,
                               "WEIGHTS_0": weights},
                "indices": idx, "material": 0,
                "targets": [{"POSITION": target}]}], "weights": [0.0]},
            {"name": "lamp", "primitives": [{
                "attributes": {"POSITION": tri}, "material": 1}]}],
        "nodes": [
            {"name": "root", "children": [1, 2], "translation": [0, 0, 1]},
            {"name": "skinned", "mesh": 0, "skin": 0},
            {"name": "j0", "children": [3]},
            {"name": "j1", "translation": [1, 0, 0]},
            {"name": "lamp", "mesh": 1,
             "matrix": [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0, 0, 0.5, 0, 1]}],
        "scenes": [{"nodes": [0, 4]}], "scene": 0,
        "skins": [{"joints": [2, 3], "inverseBindMatrices": ibm_acc}],
        "animations": [{"name": "move", "samplers": [
            {"input": t2, "output": w.acc(np.array(
                [[1, 0, 0], [1, 0, -1]], np.float32)),
             "interpolation": "LINEAR"},
            {"input": t2, "output": w.acc(np.array(
                [[0, 0, 0, 1], [0, 0, 0.3826834, 0.9238795]], np.float32)),
             "interpolation": "STEP"},
            {"input": t3, "output": w.acc(np.array(
                [[0, 0, 0], [1, 1, 1], [0.5, 0, 0],
                 [0, 0, 0], [1.5, 1, 1], [0, 0, 0],
                 [0, 0, 0], [1, 1, 2], [0, 0, 0]], np.float32)),
             "interpolation": "CUBICSPLINE"},
            {"input": t2, "output": w.acc(np.array([0.0, 1.0], np.float32)),
             "interpolation": "LINEAR"}],
            "channels": [
                {"sampler": 0, "target": {"node": 3, "path": "translation"}},
                {"sampler": 1, "target": {"node": 2, "path": "rotation"}},
                {"sampler": 2, "target": {"node": 4, "path": "scale"}},
                {"sampler": 3, "target": {"node": 1, "path": "weights"}}]}],
    })
    if not skinned:
        del w.g["nodes"][1]["skin"]
    return w.write(path)


@pytest.fixture
def gltf(tmp_path):
    return _write_gltf(tmp_path / "scene.gltf")


def test_load_gltf_matches_jax(gltf):
    a, b = jm.load_gltf(gltf), pm.load_gltf(gltf)
    assert len(b["meshes"]) == 2 and b["meshes"][0].tris.shape == (4, 3, 3)
    for ma, mb in zip(a["meshes"], b["meshes"], strict=True):
        for k in ("tris", "normals", "uvs", "mat_id", "joints", "weights",
                  "base_tris"):
            x, y = getattr(ma, k), getattr(mb, k)
            assert (x is None) == (y is None), k
            if x is not None:
                np.testing.assert_array_equal(y, x)
    assert [vars(m).keys() for m in b["materials"]] == [
        vars(m).keys() for m in a["materials"]]
    for ma, mb in zip(a["materials"], b["materials"], strict=True):
        for k, v in vars(ma).items():
            np.testing.assert_array_equal(getattr(mb, k), v)
    for k in ("nodes", "animations", "skins", "scenes"):
        assert b[k] == a[k]
    np.testing.assert_array_equal(
        pm._accessor(b["gltf"], b["buffers"], 9),
        jm._accessor(a["gltf"], a["buffers"], 9))


def test_gltf_scene_animates_like_jax(gltf):
    """Scene.from_gltf: skinning, the node tree and every channel kind,
    posed and traced at four times in both packages."""
    js = jg.Scene.from_gltf(gltf)
    ps = pg.Scene.from_gltf(gltf, device="cpu")
    assert ps.device.type == "cpu" and len(ps.skins) == 1
    o, d = _toward([-0.5, -0.5, 0.5], [3.5, 2.0, 1.5])
    hit_before = None
    for t in (0.0, 0.25, 0.6, 1.3):
        js.update(t)
        ps.update(t)
        h = _same_frame(js, ps, o, d)
        assert (h.prim >= 0).any()
        hits = _np(h.prim >= 0)
        if hit_before is not None:
            assert (hits != hit_before).any()      # it moves
        hit_before = hits


def test_node_animation_moves_geometry():
    """tests/test_scene.py:57-79 in both packages."""
    tri = np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]], np.float32)
    scenes = _scenes()
    for s, G, M in zip(scenes, (jg, pg), (jm, pm)):
        nid = s.add_instance(s.add_mesh(M.Mesh(tris=tri)))
        s.nodes[nid].matrix = None
        s.animations.append(G.Animation([dict(
            node=nid, path="translation", times=np.array([0.0, 1.0]),
            values=np.array([[0, 0, 0], [10, 0, 0]], np.float32),
            interp="LINEAR")]))
    o = [[0.2, 0.2, -5.0], [5.2, 0.2, -5.0]]
    d = [[0, 0, 1.0]] * 2
    for t, want in ((0.0, [0, -1]), (0.5, [-1, 0])):
        for s in scenes:
            s.update(t)
        h = _same_frame(*scenes, o, d)
        assert _np(h.prim).tolist() == want


def test_cubic_spline_animation():
    """tests/test_scene.py:82-118: the Hermite channel in both packages."""
    tri = np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]], np.float32)
    vals = np.zeros((2, 3, 3), np.float32)
    vals[1, 1] = [10, 0, 0]
    vals2 = vals.copy()
    vals2[0, 2] = [20, 0, 0]
    for v, checks in ((vals, [(0.0, 0.0), (1.0 - 1e-6, 10.0), (0.5, 5.0),
                              (0.25, 1.5625)]),
                      (vals2, [(0.25, 1.5625 + 2.8125)])):
        scenes = _scenes()
        for s, G, M in zip(scenes, (jg, pg), (jm, pm)):
            nid = s.add_instance(s.add_mesh(M.Mesh(tris=tri)))
            s.nodes[nid].matrix = None
            s.animations.append(G.Animation([dict(
                node=nid, path="translation", times=np.array([0.0, 1.0]),
                values=v, interp="CUBICSPLINE")]))
        for t, x in checks:
            for s in scenes:
                s.update(t)
            np.testing.assert_array_equal(scenes[1].nodes[0].translation,
                                          scenes[0].nodes[0].translation)
            np.testing.assert_allclose(scenes[1].nodes[0].translation,
                                       [x, 0, 0], atol=1e-3)
            _same_frame(*scenes, [[x + 0.2, 0.2, -5.0]], [[0, 0, 1.0]])


@pytest.mark.parametrize("policy", ["dynamic", "rigid", "static"])
def test_morph_targets_deform(policy):
    """tests/test_scene.py:121-137 under each BVH policy: dynamic
    rebuilds, rigid refits on the device, static keeps the first BVH."""
    tri = np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0]],
                    [[2, 0, 0], [3, 0, 0], [2, 1, 0]]], np.float32)
    scenes = _scenes()
    for s, M in zip(scenes, (jm, pm)):
        m = M.Mesh(tris=tri)
        m.base_tris = tri.copy()
        m.morph_targets = np.array([[[[0, 0, 2]] * 3, [[0, 0, -1]] * 3]],
                                   np.float32)
        nid = s.add_instance(s.add_mesh(m, policy=policy))
        s.nodes[nid].morph_weights = np.array([0.0], np.float32)
    o = [[0.2, 0.2, -5.0], [2.2, 0.2, -5.0]]
    d = [[0, 0, 1.0]] * 2
    ts = []
    for w in (0.0, 1.0, 0.5):
        for s in scenes:
            s.nodes[0].morph_weights = np.array([w], np.float32)
            s.update(0.0)
        ts.append(_np(_same_frame(*scenes, o, d).t))
    moved = {"dynamic": [2.0, -1.0], "rigid": [2.0, -1.0],
             "static": [0.0, 0.0]}[policy]
    np.testing.assert_allclose(ts[1] - ts[0], moved, atol=1e-4)
    if policy == "rigid":
        # the refit box follows the geometry
        b = _np(scenes[1]._blas[0].bounds[0]).reshape(6, 8)
        np.testing.assert_allclose(b[:3].min(1), [0, 0, -0.5], atol=1e-6)
        np.testing.assert_allclose(b[3:].max(1), [3, 1, 1], atol=1e-6)


def test_skinning_two_joints():
    """tests/test_scene.py:140-173 in both packages."""
    tris = np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0]],
                     [[2, 0, 0], [3, 0, 0], [2, 1, 0]]], np.float32)
    scenes = _scenes()
    for s, G, M in zip(scenes, (jg, pg), (jm, pm)):
        m = M.Mesh(tris=tris)
        m.base_tris = tris.copy()
        m.joints = np.zeros((2, 3, 4), np.int32)
        m.joints[1] = 1
        m.weights = np.zeros((2, 3, 4), np.float32)
        m.weights[:, :, 0] = 1.0
        mid = s.add_mesh(m, policy="dynamic")
        s.add_node(G.Node(name="j0"))
        s.add_node(G.Node(name="j1"))
        s.add_node(G.Node(mesh=mid, skin=0))
        s.skins.append(G.Skin(joints=[0, 1], inverse_bind=np.stack(
            [np.eye(4), np.eye(4)]).astype(np.float32)))
    o = [[0.2, 0.2, -5.0], [2.2, 0.2, -5.0]]
    d = [[0, 0, 1.0]] * 2
    for s in scenes:
        s.update(0.0)
    assert (_np(_same_frame(*scenes, o, d).prim) >= 0).all()
    for s in scenes:
        s.nodes[1].translation = np.array([0, 0, 5], np.float32)
        s.update(0.0)
    np.testing.assert_allclose(_np(_same_frame(*scenes, o, d).t),
                               [5.0, 10.0], atol=1e-4)


def test_add_quad_and_skydome():
    """tests/test_scene.py:176-193."""
    scenes = _scenes()
    for s in scenes:
        s.add_instance(s.add_quad([1.0, 0.0, 1.0], 2.0, normal_axis=1))
        s.update(0.0)
    h = _same_frame(*scenes, [[1.0, 5.0, 1.0]], [[0.0, -1.0, 0.0]])
    np.testing.assert_allclose(_np(h.t), [5.0], rtol=1e-5)
    img = np.random.default_rng(0).random((4, 8, 3)).astype(np.float32)
    img[0] = [1, 0, 0]
    img[-1] = [0, 0, 1]
    d = np.random.default_rng(1).normal(size=(64, 3))
    d[:2] = [[0, 1, 0], [0, -1, 0]]
    got = pg.SkyDome(img).sample(d)
    np.testing.assert_array_equal(got, jg.SkyDome(img).sample(d))
    assert got[0, 0] == 1.0 and got[1, 2] == 1.0


def test_shading_tables_feed_textured_tracer():
    """tests/test_scene.py:196-244: Scene.shading_tables into the
    textured TLAS tracer, in both packages with the same draws; a
    0.5-grey textured floor halves the NEE radiance."""
    floor = np.array([[[-2, 0, -2], [2, 0, -2], [2, 0, 2]],
                      [[-2, 0, -2], [2, 0, 2], [-2, 0, 2]]], np.float32)
    uvs = np.array([[[0, 0], [1, 0], [1, 1]], [[0, 0], [1, 1], [0, 1]]],
                   np.float32)
    light = (floor[:, ::-1] * np.array([0.25, 1, 0.25], np.float32)
             + np.array([0, 3, 0], np.float32))
    scenes = _scenes()
    for s, M in zip(scenes, (jm, pm)):
        s.textures.append(M.Texture(data=np.full((2, 2, 3), 0.5,
                                                 np.float32)))
        grey = s.add_material(M.Material(texture=0))
        s.add_instance(s.add_mesh(M.Mesh(tris=floor, uvs=uvs,
                                         mat_id=np.full(2, grey, np.int32))))
        s.add_instance(s.add_mesh(M.Mesh(tris=light)))
        s.update(0.0)
    jt, pt = (s.shading_tables() for s in scenes)
    for a, b in zip(jt[:2], pt[:2]):
        np.testing.assert_array_equal(_np(b), np.asarray(a))
    np.testing.assert_array_equal(_np(pt[2]["atlas"]),
                                  np.asarray(jt[2]["atlas"]))
    R = 32
    o = np.stack([np.linspace(-1.5, 1.5, R), np.full(R, 2.0),
                  np.zeros(R)], -1).astype(np.float32)
    jr, pr = _rays(o, np.tile([[0, -1, 0]], (R, 1)))
    args = (np.array([[1, 1, 1], [0, 0, 0]], np.float32),
            np.array([[0, 0, 0], [5, 5, 5]], np.float32),
            np.ascontiguousarray(light), np.full((2, 3), 5.0, np.float32))
    key = jax.random.PRNGKey(5)
    ref = np.asarray(jtrace(scenes[0].tlas, *args, jr, key, bounces=1,
                            leaf_uvs=jt[0], leaf_tex=jt[1], tex=jt[2])[0])
    grey, _ = ptrace(scenes[1].tlas, *args, pr, JaxDraws(key), bounces=1,
                     leaf_uvs=pt[0], leaf_tex=pt[1], tex=pt[2])
    white, _ = ptrace(scenes[1].tlas, *args, pr, JaxDraws(key), bounces=1)
    grey, white = _np(grey), _np(white)
    np.testing.assert_allclose(grey, ref, rtol=1e-3, atol=1e-4)
    lit = white.sum(axis=1) > 1e-4
    assert lit.any()
    np.testing.assert_allclose(grey[lit], 0.5 * white[lit], rtol=1e-5,
                               atol=1e-6)


def test_multi_file_composition_and_collapse(tmp_path):
    """tests/test_scene.py:247-295 on a glTF written by the test: two
    copies of the file, the second shifted +100 x, both hittable; the
    second collapsed into one static mesh, still hittable; the same
    hits as the JAX scene throughout. The strip is not skinned here:
    both packages collapse a skinned mesh's world-space vertices through
    its node chain once more, and pose it, on a frame, with the joints'
    world matrices of the frame before when its node comes first."""
    gltf = _write_gltf(tmp_path / "scene.gltf", skinned=False)
    shift = np.eye(4, dtype=np.float32)
    shift[0, 3] = 100.0
    scenes = _scenes()
    roots = []
    for s in scenes:
        r1 = s.add_gltf(gltf)
        n_nodes1, n_meshes1 = len(s.nodes), len(s.meshes)
        r2 = s.add_gltf(gltf, transform=shift)
        assert len(s.meshes) == 2 * n_meshes1
        assert r2 > r1 and len(s.roots) == 2
        assert all(s.nodes[i].mesh >= n_meshes1
                   for i in range(n_nodes1, len(s.nodes))
                   if s.nodes[i].mesh >= 0)
        s.update(0.0)
        roots.append(r2)
    # aim at points on the triangles of a single-file scene
    one = pg.Scene.from_gltf(gltf, device="cpu")
    one.update(0.0)
    world = np.concatenate([
        one.meshes[m].tris @ w[:3, :3].T + w[:3, 3]
        for m, w in one._instances])
    rng = np.random.default_rng(2)
    bary = rng.dirichlet([1, 1, 1], 64)
    pts = np.einsum("nk,nkc->nc", bary,
                    world[rng.integers(0, len(world), 64)])

    def check(target_shift):
        eye = pts.mean(0) + target_shift + np.array([0.5, 0.7, -6.0])
        d = pts + target_shift - eye
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        h = _same_frame(*scenes, np.tile(eye, (64, 1)), d)
        assert float((h.prim >= 0).float().mean()) > 0.3

    check(0.0)
    check(np.array([100, 0, 0], np.float32))
    for s, r2 in zip(scenes, roots):
        mid = s.collapse_meshes(r2)
        assert s.meshes[mid].tris.shape[0] > 0
        s.update(0.0)
    check(np.array([100, 0, 0], np.float32))


def test_texture_dedup_by_origin():
    """tests/test_scene.py:298-304 in both packages."""
    img = np.random.default_rng(0).random((4, 4, 3)).astype(np.float32)
    ids = []
    for s in _scenes():
        ids.append((s.add_texture(img, origin="foo.png"),
                    s.add_texture(img * 0.5, origin="foo.png"),
                    s.add_texture(img, origin="bar.png"), s.add_texture(img)))
        assert len(s.textures) == 3
    t1, t2, t3, t4 = ids[1]
    assert t1 == t2 and t3 != t1 and t4 not in (t1, t3)
    assert ids[1] == ids[0]
    np.testing.assert_array_equal(_scenes()[1].textures, [])


def test_tlas_packet_agrees_with_intersect(gltf):
    """Scene.tlas_packet feeds the per-instance packet engine: its hits
    equal Scene.intersect's (lockstep) on 256 rays."""
    s = pg.Scene.from_gltf(gltf, device="cpu")
    s.update(0.4)
    o, d = _toward([-0.5, -0.5, 0.5], [3.5, 2.0, 1.5])
    rays = make_rays(o.astype(np.float32), d.astype(np.float32),
                     device="cpu")
    h, ovf = intersect_tlas_packets2(s.tlas_packet(), rays)
    ref = s.intersect(rays)
    assert not bool(ovf.any())
    assert torch.equal(h.prim, ref.prim) and torch.equal(h.inst, ref.inst)
    torch.testing.assert_close(h.t, ref.t, rtol=1e-4, atol=1e-4)


def test_blas_build_has_no_numpy_fallback(monkeypatch):
    """Without a C compiler for builder.c the update raises; it never
    falls back to the numpy builder."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_cc", lambda: None)
    s = pg.Scene(device="cpu")
    s.add_instance(s.add_quad([0, 0, 0], 1.0))
    with pytest.raises(RuntimeError, match="C compiler"):
        s.update(0.0)


def test_scene_needs_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        pg.Scene()
    assert pg.Scene(device="cpu").device.type == "cpu"
