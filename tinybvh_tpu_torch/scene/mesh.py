"""Mesh, material and texture containers and loaders (OBJ, glTF)
(≙ tinybvh_tpu/scene/mesh.py; tiny_scene.h's Mesh / FatTri / Material /
Texture layer, tiny_scene.h:319-450, 497-601, 660-695).

numpy only, and the port's own copy: the JAX package's module cannot be
imported without JAX. Differences from the reference by design:

  * geometry is de-indexed into (N, 3, 3) triangle arrays (the reference
    does the same: BuildFromIndexedData, tiny_scene.h:1493-1660) plus SoA
    shading arrays (per-vertex normals / uvs / per-tri material id) instead
    of 192-byte FatTri structs;
  * loaders are dependency-free: a pure-python OBJ parser and a pure-python
    glTF 2.0 (.gltf/.glb) reader (the reference vendors tiny_obj_loader /
    tiny_gltf, external/).
"""

from __future__ import annotations

import base64
import json
import os
import struct
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Material:
    """Disney-principled material (≙ tiny_scene.h:497-569). The renderers
    sample base_color/emissive/metallic/roughness/specular (+ texture);
    the remaining lobes are carried for asset round-trips, exactly like
    the reference's CPU renderers, which shade a subset of the Material
    they parse."""

    name: str = ""
    base_color: np.ndarray = field(
        default_factory=lambda: np.array([0.7, 0.7, 0.7, 1.0], np.float32))
    emissive: np.ndarray = field(
        default_factory=lambda: np.zeros(3, np.float32))
    metallic: float = 0.0
    roughness: float = 1.0
    texture: int = -1  # index into Scene.textures
    # Disney lobe parameters (glTF core + KHR material extensions)
    specular: float = 0.0        # mirror weight (MATERIAL_SPECULAR analog)
    ior: float = 1.5             # KHR_materials_ior
    transmission: float = 0.0    # KHR_materials_transmission
    clearcoat: float = 0.0       # KHR_materials_clearcoat
    clearcoat_roughness: float = 0.0
    sheen: float = 0.0           # KHR_materials_sheen (scalar weight)
    anisotropic: float = 0.0     # KHR_materials_anisotropy
    subsurface: float = 0.0
    alpha_mode: str = "OPAQUE"   # OPAQUE | MASK | BLEND
    alpha_cutoff: float = 0.5
    double_sided: bool = True
    normal_texture: int = -1     # index into Scene.textures (bump/normal)


@dataclass
class Texture:
    """LDR/HDR image + sampling (tiny_scene.h:660-695)."""

    data: np.ndarray  # (H, W, 3/4) float32, linear
    name: str = ""

    def sample(self, u, v):
        h, w = self.data.shape[:2]
        x = np.clip((np.asarray(u) % 1.0 * w).astype(int), 0, w - 1)
        y = np.clip((np.asarray(v) % 1.0 * h).astype(int), 0, h - 1)
        return self.data[y, x]


@dataclass
class Mesh:
    """De-indexed triangle mesh with shading attributes."""

    tris: np.ndarray                 # (N, 3, 3) positions
    normals: np.ndarray | None = None  # (N, 3, 3) per-vertex normals
    uvs: np.ndarray | None = None       # (N, 3, 2)
    mat_id: np.ndarray | None = None    # (N,) int32
    name: str = ""
    # skinning / morphing source data
    joints: np.ndarray | None = None    # (N, 3, 4) int
    weights: np.ndarray | None = None   # (N, 3, 4) float
    base_tris: np.ndarray | None = None  # rest pose copy
    morph_targets: np.ndarray | None = None  # (T, N, 3, 3) position deltas

    def __post_init__(self):
        self.tris = np.asarray(self.tris, np.float32)
        if self.normals is None:
            e1 = self.tris[:, 1] - self.tris[:, 0]
            e2 = self.tris[:, 2] - self.tris[:, 0]
            n = np.cross(e1, e2)
            n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-20)
            self.normals = np.repeat(n[:, None], 3, axis=1)
        if self.mat_id is None:
            self.mat_id = np.zeros(len(self.tris), np.int32)

    # -- deformation ------------------------------------------------------
    def set_pose_morph(self, weights):
        """Blend morph targets (≙ Mesh::SetPose(weights),
        tiny_scene.h:1751-1783)."""
        if self.morph_targets is None:
            raise ValueError("set_pose_morph: the mesh has no morph targets")
        base = self.base_tris if self.base_tris is not None else self.tris
        w = np.asarray(weights, np.float32)
        self.tris = (base + np.einsum("t,tnvk->nvk", w, self.morph_targets)
                     ).astype(np.float32)
        return self

    def set_pose_skin(self, joint_matrices):
        """4-joint linear-blend skinning (≙ Mesh::SetPose(skin),
        tiny_scene.h:1785-1886)."""
        if self.joints is None or self.weights is None:
            raise ValueError("set_pose_skin: the mesh has no joints/weights")
        base = self.base_tris if self.base_tris is not None else self.tris
        jm = np.asarray(joint_matrices, np.float32)  # (J, 4, 4)
        v = base.reshape(-1, 3)
        j = self.joints.reshape(-1, 4)
        w = self.weights.reshape(-1, 4)
        vh = np.concatenate([v, np.ones((len(v), 1), np.float32)], axis=1)
        # blended matrix per vertex: sum_k w_k * M[j_k]
        m = np.einsum("vk,vkab->vab", w, jm[j])
        out = np.einsum("vab,vb->va", m, vh)[:, :3]
        self.tris = out.reshape(self.tris.shape).astype(np.float32)
        return self


# ---------------- OBJ loader ---------------------------------------------
def load_obj(path: str) -> Mesh:
    """Minimal wavefront OBJ reader (v/vn/vt/f, negative indices, fans).

    ≙ the reference's tinyobj path (tiny_scene.h:1146-1310).
    """
    vs, vns, vts = [], [], []
    tris, tn, tt = [], [], []
    with open(path) as f:
        for line in f:
            p = line.split()
            if not p:
                continue
            if p[0] == "v":
                vs.append([float(x) for x in p[1:4]])
            elif p[0] == "vn":
                vns.append([float(x) for x in p[1:4]])
            elif p[0] == "vt":
                vts.append([float(x) for x in p[1:3]])
            elif p[0] == "f":
                corners = []
                for tok in p[1:]:
                    idx = tok.split("/")
                    vi = int(idx[0])
                    vi = vi - 1 if vi > 0 else len(vs) + vi
                    ti = ni = -1
                    if len(idx) > 1 and idx[1]:
                        ti = int(idx[1])
                        ti = ti - 1 if ti > 0 else len(vts) + ti
                    if len(idx) > 2 and idx[2]:
                        ni = int(idx[2])
                        ni = ni - 1 if ni > 0 else len(vns) + ni
                    corners.append((vi, ti, ni))
                for k in range(1, len(corners) - 1):  # fan triangulation
                    tri = [corners[0], corners[k], corners[k + 1]]
                    tris.append([vs[c[0]] for c in tri])
                    tt.append([vts[c[1]] if c[1] >= 0 else [0, 0] for c in tri])
                    tn.append([vns[c[2]] if c[2] >= 0 else None for c in tri])
    tris = np.asarray(tris, np.float32)
    normals = None
    if tn and tn[0][0] is not None:
        try:
            normals = np.asarray(tn, np.float32)
        except (ValueError, TypeError):
            normals = None
    uvs = np.asarray(tt, np.float32) if vts else None
    return Mesh(tris=tris, normals=normals, uvs=uvs,
                name=os.path.basename(path))


# ---------------- glTF 2.0 loader ----------------------------------------
_GLTF_CTYPE = {5120: "b", 5121: "B", 5122: "h", 5123: "H", 5125: "I",
               5126: "f"}
_GLTF_NCOMP = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


def _gltf_buffers(g, path):
    bufs = []
    for b in g.get("buffers", []):
        uri = b.get("uri")
        if uri is None:
            bufs.append(None)  # GLB binary chunk, filled by caller
        elif uri.startswith("data:"):
            bufs.append(base64.b64decode(uri.split(",", 1)[1]))
        else:
            with open(os.path.join(os.path.dirname(path), uri), "rb") as f:
                bufs.append(f.read())
    return bufs


def _accessor(g, bufs, idx):
    a = g["accessors"][idx]
    view = g["bufferViews"][a["bufferView"]]
    buf = bufs[view["buffer"]]
    off = view.get("byteOffset", 0) + a.get("byteOffset", 0)
    n = a["count"]
    ncomp = _GLTF_NCOMP[a["type"]]
    fmt = _GLTF_CTYPE[a["componentType"]]
    itemsize = struct.calcsize(fmt)
    stride = view.get("byteStride", itemsize * ncomp)
    out = np.zeros((n, ncomp), np.float64)
    for i in range(n):
        vals = struct.unpack_from(f"<{ncomp}{fmt}", buf, off + i * stride)
        out[i] = vals
    if a.get("normalized"):
        out /= {"b": 127, "B": 255, "h": 32767, "H": 65535}.get(fmt, 1)
    return out.squeeze() if ncomp == 1 else out


def load_gltf(path: str):
    """Load a .gltf or .glb file → (meshes, materials, nodes, animations,
    skins). Pure python; covers the subset the reference's converter uses
    (tiny_scene.h:1312-1491): TRS node graphs, indexed meshes with
    POSITION/NORMAL/TEXCOORD_0/JOINTS_0/WEIGHTS_0, materials with
    baseColorFactor/emissiveFactor, animations (T/R/S/weights channels),
    skins with inverseBindMatrices."""
    if path.endswith(".glb"):
        with open(path, "rb") as f:
            magic, _ver, _len = struct.unpack("<III", f.read(12))
            if magic != 0x46546C67:
                raise ValueError(f"{path}: not a glb file")
            chunks = {}
            while True:
                head = f.read(8)
                if len(head) < 8:
                    break
                clen, ctype = struct.unpack("<II", head)
                chunks[ctype] = f.read(clen)
            g = json.loads(chunks[0x4E4F534A])
            bufs = _gltf_buffers(g, path)
            if bufs and bufs[0] is None:
                bufs[0] = chunks.get(0x004E4942, b"")
    else:
        with open(path) as f:
            g = json.load(f)
        bufs = _gltf_buffers(g, path)

    materials = []
    for m in g.get("materials", []):
        pbr = m.get("pbrMetallicRoughness", {})
        ext = m.get("extensions", {})
        materials.append(Material(
            name=m.get("name", ""),
            base_color=np.asarray(
                pbr.get("baseColorFactor", [0.7, 0.7, 0.7, 1]), np.float32),
            emissive=np.asarray(
                m.get("emissiveFactor", [0, 0, 0]), np.float32),
            metallic=pbr.get("metallicFactor", 0.0),
            roughness=pbr.get("roughnessFactor", 1.0),
            ior=ext.get("KHR_materials_ior", {}).get("ior", 1.5),
            transmission=ext.get("KHR_materials_transmission", {}).get(
                "transmissionFactor", 0.0),
            clearcoat=ext.get("KHR_materials_clearcoat", {}).get(
                "clearcoatFactor", 0.0),
            clearcoat_roughness=ext.get("KHR_materials_clearcoat", {}).get(
                "clearcoatRoughnessFactor", 0.0),
            sheen=float(np.max(np.asarray(
                ext.get("KHR_materials_sheen", {}).get(
                    "sheenColorFactor", [0, 0, 0]), np.float32))),
            anisotropic=ext.get("KHR_materials_anisotropy", {}).get(
                "anisotropyStrength", 0.0),
            alpha_mode=m.get("alphaMode", "OPAQUE"),
            alpha_cutoff=m.get("alphaCutoff", 0.5),
            double_sided=m.get("doubleSided", True),
        ))
    if not materials:
        materials = [Material()]

    meshes = []
    for gm in g.get("meshes", []):
        parts_t, parts_n, parts_uv, parts_m = [], [], [], []
        parts_j, parts_w = [], []
        for prim in gm.get("primitives", []):
            attr = prim["attributes"]
            pos = _accessor(g, bufs, attr["POSITION"])
            if "indices" in prim:
                ind = _accessor(g, bufs, prim["indices"]).astype(np.int64)
            else:
                ind = np.arange(len(pos))
            ind = ind.reshape(-1, 3)
            parts_t.append(pos[ind])
            if "NORMAL" in attr:
                parts_n.append(_accessor(g, bufs, attr["NORMAL"])[ind])
            if "TEXCOORD_0" in attr:
                parts_uv.append(_accessor(g, bufs, attr["TEXCOORD_0"])[ind])
            if "JOINTS_0" in attr:
                parts_j.append(_accessor(g, bufs, attr["JOINTS_0"])[ind])
                parts_w.append(_accessor(g, bufs, attr["WEIGHTS_0"])[ind])
            parts_m.append(np.full(len(ind), prim.get("material", 0),
                                   np.int32))
        tris = np.concatenate(parts_t).astype(np.float32)
        mesh = Mesh(
            tris=tris,
            normals=(np.concatenate(parts_n).astype(np.float32)
                     if parts_n and len(parts_n) == len(parts_t) else None),
            uvs=(np.concatenate(parts_uv).astype(np.float32)
                 if parts_uv and len(parts_uv) == len(parts_t) else None),
            mat_id=np.concatenate(parts_m),
            joints=(np.concatenate(parts_j).astype(np.int32)
                    if parts_j and len(parts_j) == len(parts_t) else None),
            weights=(np.concatenate(parts_w).astype(np.float32)
                     if parts_w and len(parts_w) == len(parts_t) else None),
            name=gm.get("name", ""),
        )
        mesh.base_tris = mesh.tris.copy()
        meshes.append(mesh)

    return dict(
        gltf=g, buffers=bufs, meshes=meshes, materials=materials,
        nodes=g.get("nodes", []), animations=g.get("animations", []),
        skins=g.get("skins", []), scenes=g.get("scenes", []),
    )
