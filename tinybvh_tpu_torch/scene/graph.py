"""Scene graph: nodes, animation, skinning, lights, per-frame BVH update
(≙ tinybvh_tpu/scene/graph.py; tiny_scene.h's Node / Animation / Skin /
Scene layer, tiny_scene.h:456-489, 607-647, 773-842, 1888-2139,
2389-2686, 3664-3697).

A TRS node hierarchy over mesh instances, animation channels writing
node TRS and morph weights, skins giving joint matrices, and
`Scene.update(t)`: animations -> node recursion (posing deformed meshes
on the host) -> BLAS rebuild or refit -> TLAS rebuild, the reference's
per-frame orchestrator (UpdateSceneGraph, tiny_scene.h:3664-3697). The
graph and the posing run in numpy; the BVHs live on the scene's device
(default: the card; device="cpu" runs the kernels' plain versions).

BVH build policy mirrors the reference's enum (tiny_scene.h:106-110):
  'dynamic' -> native binned-SAH rebuild on every deforming frame
  'rigid'   -> build once, then an 8-wide refit on the device
               (builders/refit.py) on every deforming frame
  'static'  -> build once, never updated (even if the mesh deforms)
The build is the port's native builder (native/builder.c), which raises
where it cannot be compiled: there is no numpy fallback.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from tinybvh_tpu_torch.core.rays import default_device
from tinybvh_tpu_torch.scene.mesh import (
    Material, Mesh, Texture, _accessor, load_gltf,
)


def _trs_matrix(t, r, s):
    """TRS → 4x4 (r is an xyzw quaternion, glTF convention)."""
    x, y, z, w = r
    rot = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], np.float32)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = rot * np.asarray(s, np.float32)[None, :]
    m[:3, 3] = t
    return m


@dataclass
class Node:
    """TRS node (≙ tiny_scene.h:456-489)."""

    name: str = ""
    translation: np.ndarray = field(
        default_factory=lambda: np.zeros(3, np.float32))
    rotation: np.ndarray = field(
        default_factory=lambda: np.array([0, 0, 0, 1], np.float32))
    scale: np.ndarray = field(default_factory=lambda: np.ones(3, np.float32))
    matrix: np.ndarray | None = None  # overrides TRS when set
    children: list = field(default_factory=list)
    mesh: int = -1      # index into Scene.meshes
    skin: int = -1
    morph_weights: np.ndarray | None = None
    world: np.ndarray = field(default_factory=lambda: np.eye(4, dtype=np.float32))

    def local_matrix(self):
        if self.matrix is not None:
            return np.asarray(self.matrix, np.float32)
        return _trs_matrix(self.translation, self.rotation, self.scale)


@dataclass
class Skin:
    joints: list                      # node indices
    inverse_bind: np.ndarray          # (J, 4, 4)


class Animation:
    """Sampler+channel animation (≙ tiny_scene.h:607-647, 2389-2686).

    channels: list of dicts {node, path ('translation'|'rotation'|'scale'|
    'weights'), times (K,), values (K, …), interp ('LINEAR'|'STEP'|
    'CUBICSPLINE')}. CUBICSPLINE values are (K, 3, D) glTF
    (in_tangent, value, out_tangent) triples, evaluated with the standard
    Hermite basis (≙ the SPLINE sampler of tiny_scene.h:2389-2686).
    """

    def __init__(self, channels, name=""):
        self.channels = channels
        self.name = name
        self.duration = max(
            (float(c["times"][-1]) for c in channels if len(c["times"])),
            default=0.0,
        )

    def apply(self, nodes, t):
        if self.duration > 0:
            t = t % self.duration
        for ch in self.channels:
            times = ch["times"]
            vals = ch["values"]
            k = int(np.searchsorted(times, t, side="right") - 1)
            k = max(0, min(k, len(times) - 1))
            k2 = min(k + 1, len(times) - 1)
            interp = ch.get("interp", "LINEAR")
            if interp == "CUBICSPLINE":
                if k2 == k:
                    v = vals[k][1]
                else:
                    dt = max(float(times[k2] - times[k]), 1e-9)
                    s = min(max((t - float(times[k])) / dt, 0.0), 1.0)
                    s2, s3 = s * s, s * s * s
                    vk, bk = vals[k][1], vals[k][2]     # value, out-tangent
                    ak2, vk2 = vals[k2][0], vals[k2][1]  # in-tangent, value
                    v = ((2 * s3 - 3 * s2 + 1) * vk
                         + dt * (s3 - 2 * s2 + s) * bk
                         + (-2 * s3 + 3 * s2) * vk2
                         + dt * (s3 - s2) * ak2)
                if ch["path"] == "rotation":
                    v = v / max(np.linalg.norm(v), 1e-9)
            elif interp == "STEP" or k2 == k:
                v = vals[k]
            else:
                span = max(float(times[k2] - times[k]), 1e-9)
                a = (t - float(times[k])) / span
                v = (1 - a) * vals[k] + a * vals[k2]
                if ch["path"] == "rotation":
                    v = v / max(np.linalg.norm(v), 1e-9)
            node = nodes[ch["node"]]
            if ch["path"] == "translation":
                node.translation = np.asarray(v, np.float32)
            elif ch["path"] == "rotation":
                node.rotation = np.asarray(v, np.float32)
            elif ch["path"] == "scale":
                node.scale = np.asarray(v, np.float32)
            elif ch["path"] == "weights":
                node.morph_weights = np.asarray(v, np.float32)
            node.matrix = None  # TRS now authoritative


@dataclass
class Light:
    """Point/spot/directional light (≙ tiny_scene.h:701-766); emissive
    triangles are detected from materials instead of a TriLight pool."""

    kind: str = "point"  # 'point' | 'spot' | 'directional'
    position: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    direction: np.ndarray = field(
        default_factory=lambda: np.array([0, -1, 0], np.float32))
    color: np.ndarray = field(default_factory=lambda: np.ones(3, np.float32))
    intensity: float = 1.0
    cos_inner: float = 0.9
    cos_outer: float = 0.7


class SkyDome:
    """HDR equirectangular sky (≙ tiny_scene.h:354-365, 1024-1079)."""

    def __init__(self, data):
        self.data = np.asarray(data, np.float32)  # (H, W, 3) linear

    def sample(self, d):
        """Sample by direction(s) (..., 3) → (..., 3) radiance."""
        d = np.asarray(d, np.float32)
        d = d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-20)
        u = (np.arctan2(d[..., 2], d[..., 0]) / (2 * np.pi)) % 1.0
        v = np.arccos(np.clip(d[..., 1], -1, 1)) / np.pi
        h, w = self.data.shape[:2]
        x = np.clip((u * w).astype(int), 0, w - 1)
        y = np.clip((v * h).astype(int), 0, h - 1)
        return self.data[y, x]




class Scene:
    """Registry and per-frame orchestrator (≙ the static Scene,
    tiny_scene.h:773-842, but instantiable, no global state). Its BVHs
    go to `device` (default: the card; with no CUDA device it raises
    RuntimeError unless device="cpu")."""

    def __init__(self, device=None):
        self.device = default_device(device)
        self.meshes: list[Mesh] = []
        self.materials: list[Material] = [Material()]
        self.textures: list[Texture] = []
        self.nodes: list[Node] = []
        self.roots: list[int] = []
        self.animations: list[Animation] = []
        self.skins: list[Skin] = []
        self.lights: list[Light] = []
        self.bvh_policy: dict[int, str] = {}  # mesh id -> policy
        self.default_policy = "rigid"
        self._blas = {}            # mesh id -> BVH8 on the device
        self._blas_host = {}       # mesh id -> host dict of a fresh build
        self._blas_dirty = set()
        self._refit_plans = {}     # mesh id -> bvh8_refit_plan
        self._tex_by_origin = {}
        self._merged = None
        self._merged_key = None
        self._tlas = None
        self._tlas_meshes = []
        self._instances = None

    # -- registry ---------------------------------------------------------
    def add_mesh(self, mesh: Mesh, policy: str | None = None) -> int:
        self.meshes.append(mesh)
        mid = len(self.meshes) - 1
        self.bvh_policy[mid] = policy or self.default_policy
        self._blas_dirty.add(mid)
        return mid

    def add_node(self, node: Node, parent: int | None = None) -> int:
        self.nodes.append(node)
        nid = len(self.nodes) - 1
        if parent is None:
            self.roots.append(nid)
        else:
            self.nodes[parent].children.append(nid)
        return nid

    def add_instance(self, mesh_id: int, transform=None) -> int:
        n = Node(mesh=mesh_id)
        if transform is not None:
            n.matrix = np.asarray(transform, np.float32)
        return self.add_node(n)

    def add_material(self, mat: Material) -> int:
        self.materials.append(mat)
        return len(self.materials) - 1

    def add_light(self, light: Light) -> int:
        self.lights.append(light)
        return len(self.lights) - 1

    def analytic_lights(self):
        """The scene's lights packed for the path tracers' `analytic=`
        (render.pathtracer.pack_analytic_lights) on the scene's device;
        None without point / spot / directional lights."""
        from tinybvh_tpu_torch.render.pathtracer import pack_analytic_lights

        return pack_analytic_lights(self.lights, device=self.device)

    def add_quad(self, center, size, normal_axis=1, material=0,
                 policy=None) -> int:
        """Axis-aligned quad mesh (≙ Scene::AddQuad): two triangles;
        returns the mesh id."""
        c = np.asarray(center, np.float32)
        h = size / 2.0
        axes = [a for a in range(3) if a != normal_axis]
        e0 = np.zeros(3, np.float32)
        e1 = np.zeros(3, np.float32)
        e0[axes[0]] = h
        e1[axes[1]] = h
        corners = [c - e0 - e1, c + e0 - e1, c + e0 + e1, c - e0 + e1]
        tris = np.stack([[corners[0], corners[1], corners[2]],
                         [corners[0], corners[2], corners[3]]])
        m = Mesh(tris=tris.astype(np.float32),
                 mat_id=np.full(2, material, np.int32))
        return self.add_mesh(m, policy=policy)

    def add_texture(self, data, name: str = "", origin=None) -> int:
        """Register a texture; an `origin` key seen before returns the
        existing id (≙ the reference's dedup by origin key,
        tiny_scene.h:3016-3166)."""
        if origin is not None and origin in self._tex_by_origin:
            return self._tex_by_origin[origin]
        self.textures.append(Texture(data=np.asarray(data, np.float32),
                                     name=name))
        tid = len(self.textures) - 1
        if origin is not None:
            self._tex_by_origin[origin] = tid
        return tid

    def add_gltf(self, path: str, transform=None) -> int:
        """Compose a glTF file into this scene: meshes, materials, nodes,
        skins and animations are appended with base offsets, and an extra
        root node (with `transform`) wraps the file's scene (≙ Scene::
        AddScene's multi-file composition, tiny_scene.h:3016-3166).
        Returns the new root node id."""
        data = load_gltf(path)
        # a pristine scene drops its default material, so a single-file
        # load keeps the file's material ids
        if not self.meshes and len(self.materials) == 1 and not any(
                n.mesh >= 0 for n in self.nodes):
            self.materials = []
        mesh_base = len(self.meshes)
        mat_base = len(self.materials)
        node_base = len(self.nodes)
        skin_base = len(self.skins)

        for mesh in data["meshes"]:
            if mesh.mat_id is not None:
                mesh.mat_id = mesh.mat_id + mat_base
            self.add_mesh(mesh)
        self.materials.extend(data["materials"])

        g = data["gltf"]
        for gn in data["nodes"]:
            n = Node(
                name=gn.get("name", ""),
                mesh=gn.get("mesh", -1) + (mesh_base if "mesh" in gn else 0),
                skin=gn.get("skin", -1) + (skin_base if "skin" in gn else 0),
            )
            if "matrix" in gn:
                n.matrix = np.asarray(gn["matrix"],
                                      np.float32).reshape(4, 4).T
            n.translation = np.asarray(gn.get("translation", [0, 0, 0]),
                                       np.float32)
            n.rotation = np.asarray(gn.get("rotation", [0, 0, 0, 1]),
                                    np.float32)
            n.scale = np.asarray(gn.get("scale", [1, 1, 1]), np.float32)
            n.children = [c + node_base for c in gn.get("children", [])]
            self.nodes.append(n)
        scene_def = (g.get("scenes") or [{}])[g.get("scene", 0)]
        file_roots = [r + node_base for r in
                      scene_def.get("nodes", range(len(data["nodes"])))]
        root = Node(name=f"{path}#root")
        if transform is not None:
            root.matrix = np.asarray(transform, np.float32)
        root.children = file_roots
        self.nodes.append(root)
        root_id = len(self.nodes) - 1
        self.roots.append(root_id)

        for sk in data["skins"]:
            ibm = _accessor(g, data["buffers"], sk["inverseBindMatrices"])
            ibm = np.asarray(ibm, np.float32).reshape(-1, 4, 4)
            ibm = np.transpose(ibm, (0, 2, 1))  # column -> row major
            self.skins.append(Skin(
                joints=[j + node_base for j in sk["joints"]],
                inverse_bind=ibm))
        for ga in data["animations"]:
            chans = []
            for ch in ga.get("channels", []):
                sampler = ga["samplers"][ch["sampler"]]
                times = np.atleast_1d(
                    _accessor(g, data["buffers"], sampler["input"]))
                vals = np.atleast_1d(
                    _accessor(g, data["buffers"], sampler["output"]))
                tgt = ch["target"]
                interp = sampler.get("interpolation", "LINEAR")
                if tgt["path"] == "weights" and len(times):
                    vals = vals.reshape(len(times), -1)
                if interp == "CUBICSPLINE" and len(times):
                    # glTF stores (in_tangent, value, out_tangent) triples
                    vals = vals.reshape(len(times), 3, -1)
                chans.append(dict(node=tgt["node"] + node_base,
                                  path=tgt["path"], times=times,
                                  values=vals, interp=interp))
            self.animations.append(Animation(chans, ga.get("name", "")))
        return root_id

    @classmethod
    def from_gltf(cls, path: str, device=None) -> "Scene":
        """≙ Scene::AddScene's glTF branch (tiny_scene.h:3016-3166)."""
        s = cls(device=device)
        s.add_gltf(path)
        return s

    def collapse_meshes(self, root_id: int) -> int:
        """Merge every mesh under root_id's subtree into ONE static mesh
        in that subtree's local frame (≙ Scene::CollapseMeshes,
        tiny_scene.h:3456-3524). The subtree's nodes lose their mesh
        references; the merged mesh hangs on root_id. Returns its id."""
        parts_t, parts_n, parts_uv, parts_m = [], [], [], []

        def visit(nid, xform):
            node = self.nodes[nid]
            m = (xform @ node.local_matrix() if nid != root_id
                 else np.eye(4, dtype=np.float32))
            if node.mesh >= 0:
                mesh = self.meshes[node.mesh]
                v = mesh.tris.reshape(-1, 3) @ m[:3, :3].T + m[:3, 3]
                parts_t.append(v.reshape(-1, 3, 3).astype(np.float32))
                if mesh.normals is not None:
                    nrm_m = np.linalg.inv(m[:3, :3]).T
                    nn = mesh.normals.reshape(-1, 3) @ nrm_m.T
                    nn /= np.maximum(
                        np.linalg.norm(nn, axis=1, keepdims=True), 1e-20)
                    parts_n.append(nn.reshape(-1, 3, 3).astype(np.float32))
                if mesh.uvs is not None:
                    parts_uv.append(mesh.uvs)
                parts_m.append(mesh.mat_id if mesh.mat_id is not None
                               else np.zeros(len(mesh.tris), np.int32))
                node.mesh = -1
            for c in node.children:
                visit(c, m)

        visit(root_id, np.eye(4, dtype=np.float32))
        if not parts_t:
            raise ValueError("no meshes under subtree")
        n_tris = sum(len(p) for p in parts_t)
        merged = Mesh(
            tris=np.concatenate(parts_t),
            normals=(np.concatenate(parts_n)
                     if parts_n and sum(len(p) for p in parts_n) == n_tris
                     else None),
            uvs=(np.concatenate(parts_uv)
                 if parts_uv and sum(len(p) for p in parts_uv) == n_tris
                 else None),
            mat_id=np.concatenate(parts_m),
            name=f"collapsed:{root_id}",
        )
        mid = self.add_mesh(merged, policy="static")
        self.nodes[root_id].mesh = mid
        return mid

    # -- per-frame update (≙ UpdateSceneGraph, tiny_scene.h:3664-3697) ---
    def update(self, t: float):
        """Apply the animations at time t, pose the meshes, update the
        BLASes by policy and rebuild the TLAS on the scene's device."""
        from tinybvh_tpu_torch.tlas.instance import (
            build_tlas_from_merged, merge_blas_tables,
        )

        for anim in self.animations:
            anim.apply(self.nodes, t)

        instances = []  # (mesh_id, world_matrix)
        deformed = set()

        def visit(nid, parent_world):
            node = self.nodes[nid]
            node.world = parent_world @ node.local_matrix()
            if node.mesh >= 0:
                mesh = self.meshes[node.mesh]
                if 0 <= node.skin < len(self.skins):
                    sk = self.skins[node.skin]
                    jm = np.stack([self.nodes[j].world
                                   for j in sk.joints]) @ sk.inverse_bind
                    mesh.set_pose_skin(jm)
                    deformed.add(node.mesh)
                    # skinned vertices are in world space already
                    instances.append((node.mesh,
                                      np.eye(4, dtype=np.float32)))
                else:
                    if (node.morph_weights is not None
                            and mesh.morph_targets is not None):
                        mesh.set_pose_morph(node.morph_weights)
                        deformed.add(node.mesh)
                    instances.append((node.mesh, node.world.copy()))
            for c in node.children:
                visit(c, node.world)

        eye = np.eye(4, dtype=np.float32)
        for r in self.roots:
            visit(r, eye)

        # BLAS updates per policy (≙ the bvhType switch, tiny_scene.h:1996)
        for mid in set(list(deformed) + list(self._blas_dirty)):
            self._update_blas(mid, mid in deformed)
        self._blas_dirty.clear()

        # the TLAS over the current instances. The merged BLAS tables stay
        # on the device across frames while no BLAS changes (≙ the
        # reference rebuilding only the TLAS over instance boxes,
        # tiny_scene.h:3687-3696): such a frame moves only the TLAS rows
        self._instances = instances
        if instances:
            used = sorted({m for m, _ in instances})
            remap = {m: i for i, m in enumerate(used)}
            pairs = [(remap[m], w) for m, w in instances]
            host8s = [self._blas_host.get(m) for m in used]
            key = (tuple(used), tuple(id(self._blas[m]) for m in used))
            if self._merged_key != key:
                self._merged = merge_blas_tables(
                    [self._blas[m] for m in used],
                    host8s if all(h is not None for h in host8s) else None,
                ).to_device(self.device)
                self._merged_key = key
            self._tlas = build_tlas_from_merged(self._merged, pairs,
                                                device=self.device)
            self._tlas_meshes = used
        return self

    def shading_tables(self):
        """Merged leaf-aligned shading tables for the textured TLAS path
        tracer: (leaf_uvs (L, 4, 3, 2), leaf_tex (L, 4), atlas dict), on
        the scene's device (≙ the reference renderer uploading FatTri UVs
        and material / texture tables next to the BVH, raytracer.cl).
        Call after update(); pass to trace_paths_tlas(leaf_uvs=,
        leaf_tex=, tex=)."""
        if self._tlas is None:
            raise RuntimeError("call update() first")
        from tinybvh_tpu_torch.render.textures import build_atlas
        from tinybvh_tpu_torch.tlas.instance import merge_leaf_attrs

        blases = [self._blas[m] for m in self._tlas_meshes]
        uv_list, tex_list = [], []
        for m in self._tlas_meshes:
            mesh = self.meshes[m]
            n = len(mesh.tris)
            uvs = (mesh.uvs if mesh.uvs is not None
                   else np.zeros((n, 3, 2), np.float32))
            tex_ids = np.array([
                self.materials[int(mid)].texture
                if 0 <= int(mid) < len(self.materials) else -1
                for mid in mesh.mat_id], np.int32)
            uv_list.append(np.asarray(uvs, np.float32))
            tex_list.append(tex_ids)
        atlas = build_atlas([t.data for t in self.textures],
                            device=self.device)
        return (merge_leaf_attrs(blases, uv_list),
                merge_leaf_attrs(blases, tex_list), atlas)

    def _update_blas(self, mid, deformed):
        from tinybvh_tpu_torch import native
        from tinybvh_tpu_torch.builders.refit import (
            bvh8_refit_plan, refit_bvh8,
        )
        from tinybvh_tpu_torch.layouts.mbvh import BVH8

        mesh = self.meshes[mid]
        policy = self.bvh_policy.get(mid, self.default_policy)
        # dynamic: rebuild whenever deformed; rigid: refit; static: built
        # once and never updated, even if the mesh deforms (the documented
        # BVH_STATIC semantics, tiny_scene.h:106-110)
        if mid not in self._blas or (deformed and policy == "dynamic"):
            # the native C build and 8-wide collapse with leaf combining,
            # as api.BVH; it raises where builder.c cannot be compiled
            tris_h = np.asarray(mesh.tris, np.float32)
            _, host = native.build_binned_native(tris_h, max_leaf=4,
                                                 return_host=True)
            h8 = native.collapse_bvh8_native(host, tris_h, combine=4)
            self._blas[mid] = BVH8.from_host(h8, self.device)
            self._blas_host[mid] = h8
            # a rebuild changes the collapse topology: a cached refit plan
            # would write bounds to the wrong rows
            self._refit_plans.pop(mid, None)
        elif deformed and policy == "rigid":
            # the 8-wide refit on the device (≙ MBVH<8>::Refit,
            # tiny_bvh.h:4925-4961): the collapse topology is kept, one
            # level-synchronous pass per frame
            if mid not in self._refit_plans:
                host8 = self._blas_host.get(mid)
                child = (host8["child"] if host8 is not None
                         else self._blas[mid].child)
                self._refit_plans[mid] = tuple(
                    ids.to(self.device) for ids in bvh8_refit_plan(child))
            self._blas[mid] = refit_bvh8(
                self._blas[mid],
                torch.from_numpy(np.asarray(mesh.tris, np.float32)).to(
                    self.device),
                self._refit_plans[mid])
            # the device refit has no host twin
            self._blas_host.pop(mid, None)

    # -- tracing ----------------------------------------------------------
    def intersect(self, rays, t_max=1e30):
        """Closest hit through the lockstep two-level traversal
        (tlas.instance.intersect_tlas8): .inst the instance (in update's
        visit order), .prim the BLAS-local prim."""
        from tinybvh_tpu_torch.tlas.instance import intersect_tlas8

        if self._tlas is None:
            raise RuntimeError("call update() first")
        return intersect_tlas8(self._tlas, rays, t_max)

    def is_occluded(self, rays, t_max):
        from tinybvh_tpu_torch.tlas.instance import is_occluded_tlas8

        if self._tlas is None:
            raise RuntimeError("call update() first")
        return is_occluded_tlas8(self._tlas, rays, t_max)

    @property
    def tlas(self):
        return self._tlas

    def tlas_packet(self):
        """TLASPacket over the current instances, for the per-instance and
        bucketed packet engines (tlas/packet.py) and trace_paths_tlas(
        tpacket=) (≙ the GPU renderer tracing the scene TLAS,
        tiny_bvh_gpu2.cpp). Call after update(); rebuild after any
        instance or BLAS change."""
        from tinybvh_tpu_torch.tlas.packet import build_tlas_packet

        if not self._instances:
            raise RuntimeError("call update() first")
        used = sorted({m for m, _ in self._instances})
        remap = {m: i for i, m in enumerate(used)}
        pairs = [(remap[m], w) for m, w in self._instances]
        return build_tlas_packet([self._blas[m] for m in used], pairs,
                                 device=self.device)
