"""Wavefront path tracer (≙ tinybvh_tpu/render/pathtracer.py; the
reference's wavefront.cl:1-287).

The reference runs persistent-thread kernels (Generate -> Extend -> Shade
-> Connect -> Finalize) coordinated by global atomic counters. Here, as
in the JAX package, the same stages are one bounce loop over dense ray
batches: "queues" are alive-masks and the loop is unrolled in Python.

Shading (parity with wavefront.cl's Shade kernel): Lambertian albedo per
triangle, optional textures, smooth normals, perfect mirrors and a sky
on miss; emissive triangles as lights; next-event estimation toward one
sampled light triangle per bounce with multiple importance sampling
(lightPDF/(lightPDF+brdfPDF) on NEE, brdfPDF/(brdfPDF+lightPDF) on BRDF
hits of lights); optional point, spot and directional lights; cosine
bounce sampling.

Traversal: the wavefront engine (traverse/wavefront.py), or with `aux=`
the packet2 engine (traverse/packet2.py: kernels A and B on the card)
for every extension and shadow pass, with its exact retrace
(traverse/retrace.py: kernel R on the card, no frontier cap; the
wavefront elsewhere). The budgets and the wavefront's frontier cap come
from the device's tuning row. Every overflow flag is ORed on the device
and returned once, as a 0-dim bool tensor: True means some paths were
truncated.

Random numbers: a `Sampler` draws them, in one place per bounce (light
index, r1-r4) and one per sample (the pixel jitter of `render`), from an
explicit torch.Generator on the rays' device. The JAX package draws from
jax.random (threefry), which a torch.Generator cannot reproduce; a
Sampler subclass can replay such draws."""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from tinybvh_tpu_torch.core.intersect import tri_edges
from tinybvh_tpu_torch.core.rays import Rays, default_device, make_rays
from tinybvh_tpu_torch.core.rng import cosine_hemisphere
from tinybvh_tpu_torch.core.vecmath import cross, norm, normalize, safe_rcp
from tinybvh_tpu_torch.render.textures import (
    build_atlas, sample_atlas, sample_sky,
)
from tinybvh_tpu_torch.traverse import packet2
from tinybvh_tpu_torch.traverse.packet import TILE
from tinybvh_tpu_torch.traverse.wavefront import intersect_wavefront

# shadow segments end short of the light: t in (0, SHADOW_CUTOFF)
SHADOW_CUTOFF = 1.0 - 1e-3


class Sampler:
    """The path tracers' random numbers. `bounce` gives one bounce's draws
    and `jitter` one sample's pixel offsets, each drawn from `generator`
    (a torch.Generator on the device the draws go to)."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    @classmethod
    def seeded(cls, seed: int, device) -> "Sampler":
        g = torch.Generator(device=torch.device(device))
        g.manual_seed(seed)
        return cls(g)

    def bounce(self, n_rays: int, n_lights: int, device):
        """(light index (R,) int64 in [0, n_lights), r1, r2, r3, r4 (R,)
        float32 in [0, 1)): the light pick, its point (r1, r2) and the
        bounce direction (r3, r4)."""
        li = torch.randint(0, n_lights, (n_rays,), generator=self.generator,
                           device=device)
        r = torch.rand((4, n_rays), generator=self.generator, device=device)
        return li, r[0], r[1], r[2], r[3]

    def jitter(self, height: int, width: int, device):
        """(H, W, 2) subpixel offsets in [0, 1)."""
        return torch.rand((height, width, 2), generator=self.generator,
                          device=device)


def _tensor(x, dtype, device):
    """x (a tensor, or anything numpy reads) as `dtype` on `device`."""
    return torch.as_tensor(x if isinstance(x, torch.Tensor)
                           else np.asarray(x), dtype=dtype, device=device)


def make_scene_arrays(tris, albedo=None, emissive=None, uvs=None,
                      tex_id=None, textures=None, sky=None, specular=None,
                      device=None):
    """Shading arrays: per-triangle albedo (N, 3) and emission (N, 3) on
    tris' device if it is a tensor, else on `device` (default: the card).

    Light triangles = any with emission > 0 (≙ tiny_scene's TriLight
    extraction, tiny_scene.h:2145-2203), found once per scene (one host
    sync). Optional texture mapping (≙ raytracer.cl's material shading):
    `uvs` (N, 3, 2) per-vertex UVs, `tex_id` (N,) texture index per
    triangle (-1 = untextured), `textures` a list of (H, W, 3) images
    packed into one atlas. Optional `sky` (H, W, 3) equirect environment
    sampled on a miss (≙ SkyDome). Optional `specular` (N,): triangles
    with specular > 0.5 shade as perfect mirrors (≙ MATERIAL_SPECULAR,
    wavefront.cl:166-240)."""
    dev = (tris.device if isinstance(tris, torch.Tensor)
           else default_device(device))
    n = tris.shape[0]
    f32 = torch.float32
    albedo = (torch.full((n, 3), 0.7, dtype=f32, device=dev)
              if albedo is None else _tensor(albedo, f32, dev))
    emissive = (torch.zeros((n, 3), dtype=f32, device=dev)
                if emissive is None else _tensor(emissive, f32, dev))
    light_ids = torch.nonzero(emissive.sum(dim=1) > 0).reshape(-1)
    if light_ids.numel() == 0:
        # a dummy light: emission 0 adds nothing
        light_ids = torch.zeros(1, dtype=torch.int64, device=dev)
    scene = dict(tris=_tensor(tris, f32, dev), albedo=albedo,
                 emissive=emissive, light_ids=light_ids)
    if specular is not None:
        scene["specular"] = _tensor(specular, f32, dev)
    if textures is not None:
        if uvs is None or tex_id is None:
            raise ValueError("textured scenes need per-triangle uvs and "
                             "tex_id")
        scene["tex"] = build_atlas(textures, device=dev)
        scene["uvs"] = _tensor(uvs, f32, dev)
        scene["tex_id"] = _tensor(tex_id, torch.int32, dev)
    if sky is not None:
        scene["sky"] = _tensor(sky, f32, dev)
    return scene


def add_vertex_normals(scene, normals):
    """Attach (N, 3, 3) per-vertex shading normals (≙ FatTri's vN0-2,
    tiny_scene.h:319-348): hits then shade with their barycentric
    interpolation instead of the flat geometric normal."""
    scene["normals"] = _tensor(normals, torch.float32,
                               scene["tris"].device)
    return scene


@dataclass(frozen=True)
class AnalyticLights:
    """Point / spot / directional delta lights for NEE
    (≙ tiny_scene.h:701-766). kinds is one name per light; the tensors
    are (A, ...)."""

    pos: torch.Tensor        # (A, 3)
    dir: torch.Tensor        # (A, 3) unit
    color: torch.Tensor      # (A, 3) color * intensity
    cos_inner: torch.Tensor  # (A,)
    cos_outer: torch.Tensor  # (A,)
    kinds: tuple = ()


def pack_analytic_lights(lights, device=None):
    """scene.graph.Light list -> AnalyticLights on `device` (default: the
    card) for the tracers' `analytic=`; None without lights. Delta lights
    enter NEE with weight 1 (BRDF sampling never hits them)."""
    if not lights:
        return None
    dev = default_device(device)
    d = np.stack([np.asarray(lt.direction, np.float32) for lt in lights])
    d /= np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-20)

    def up(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    return AnalyticLights(
        pos=up(np.stack([lt.position for lt in lights])),
        dir=up(d),
        color=up(np.stack([np.asarray(lt.color, np.float32)
                           * float(lt.intensity) for lt in lights])),
        cos_inner=up([lt.cos_inner for lt in lights]),
        cos_outer=up([lt.cos_outer for lt in lights]),
        kinds=tuple(lt.kind for lt in lights))


def _analytic_nee(occl_fn, analytic, p, n, mat_albedo, throughput, valid0):
    """Direct light from delta lights: one shadow segment per light (the
    list is small). occl_fn(origin, seg) returns ((R,) occluded,
    overflow) for segments origin -> origin + seg. Returns (radiance to
    add, overflow)."""
    R = p.shape[0]
    add = torch.zeros((R, 3), dtype=torch.float32, device=p.device)
    ovf = torch.zeros((), dtype=torch.bool, device=p.device)
    for i, kind in enumerate(analytic.kinds):
        if kind == "directional":
            wi = torch.broadcast_to(-analytic.dir[i], (R, 3))
            li = torch.broadcast_to(analytic.color[i], (R, 3))
            seg = wi * 1e4
        else:
            delta = analytic.pos[i][None, :] - p
            dist2 = torch.clamp((delta * delta).sum(-1), min=1e-12)
            wi = delta / torch.sqrt(dist2)[:, None]
            li = analytic.color[i][None, :] / dist2[:, None]
            if kind == "spot":
                cos_t = (-wi * analytic.dir[i][None, :]).sum(-1)
                fall = torch.clamp(
                    (cos_t - analytic.cos_outer[i])
                    / torch.clamp(analytic.cos_inner[i]
                                  - analytic.cos_outer[i], min=1e-6),
                    0.0, 1.0)
                li = li * fall[:, None]
            seg = delta
        cos_s = (n * wi).sum(-1)
        valid = valid0 & (cos_s > 0)
        occluded, o1 = occl_fn(p + n * 1e-4, seg)
        ovf = ovf | o1
        c = throughput * mat_albedo / math.pi * li * cos_s[:, None]
        add = add + torch.where((valid & ~occluded)[:, None], c, 0.0)
    return add, ovf


def _tri_geom(tris, prim):
    """(v0, e1, e2, unit normal, area) of tris[prim]."""
    v0, e1, e2 = tri_edges(tris[prim])
    n = cross(e1, e2)
    area = 0.5 * norm(n)
    return v0, e1, e2, normalize(n), area


def _packet_routes(bvh8, aux, device):
    """extend(rays, bounce) -> (Hits, overflow) and occluded(origin, seg)
    -> ((R,) occluded, overflow) through the packet2 engine, at the
    device's tuning row (its retrace's cap too); bounce 0 traces the
    camera rays as they come, later bounces and shadow segments through
    the coherence sort."""
    from tinybvh_tpu_torch.tuning import get_tuning

    tun = get_tuning(device=device)
    kw = dict(max_leaves=tun.max_leaves, max_blocks=tun.max_blocks,
              wf_cap_factor=tun.wf_cap_factor)
    scene_lo = aux.leaf_lo.amin(dim=1)
    scene_hi = aux.leaf_hi.amax(dim=1)

    def extend(cur, bounce):
        if bounce == 0:
            h, ov = packet2.intersect_packets2(bvh8, aux, cur, **kw)
        else:
            h, ov = packet2.intersect_packets2_sorted(
                bvh8, aux, cur, scene_lo, scene_hi, **kw)
        return h, ov.any()

    def occluded(oo, seg):
        # any_hit: a tile stops once every ray found an occluder
        h, ov = packet2.intersect_packets2_sorted(
            bvh8, aux, make_rays(oo, seg), scene_lo, scene_hi,
            any_hit=True, t_max_static=SHADOW_CUTOFF, **kw)
        return (h.prim >= 0) & (h.t < SHADOW_CUTOFF), ov.any()

    return extend, occluded


def _wavefront_routes(bvh8, cap_factor):
    def extend(cur, bounce):
        return intersect_wavefront(bvh8, cur, cap_factor=cap_factor)

    def occluded(oo, seg):
        _, occ, ov = intersect_wavefront(bvh8, make_rays(oo, seg),
                                         SHADOW_CUTOFF,
                                         cap_factor=cap_factor, any_hit=True)
        return occ, ov

    return extend, occluded


def trace_paths(bvh8, scene, rays: Rays, sampler: Sampler,
                bounces: int = 3, cap_factor: int = 4,
                brute_force: bool = False, analytic=None, aux=None):
    """One sample per ray through `bounces` bounces on the rays' device;
    returns ((R, 3) radiance, overflow), overflow a 0-dim bool tensor
    ORing every traversal's frontier overflow (True: some paths were
    truncated; retry with a larger cap_factor).

    brute_force=True disables NEE and MIS and counts emission with weight
    1 on every hit: the plain path-integral estimator, same expectation,
    higher variance.

    aux: optional traverse.packet2.PacketAux; with R a multiple of 256 it
    routes every traversal through the packet2 engine (kernels A and B on
    the card), each with the exact retrace of overflowed tiles (kernel R
    on the card)."""
    R = rays.o.shape[0]
    dev = rays.o.device
    if aux is not None and R % TILE == 0:
        extend, occluded = _packet_routes(bvh8, aux, dev)
    else:
        extend, occluded = _wavefront_routes(bvh8, cap_factor)
    tris = scene["tris"]
    albedo = scene["albedo"]
    emissive = scene["emissive"]
    light_ids = scene["light_ids"]
    n_lights = light_ids.shape[0]

    radiance = torch.zeros((R, 3), dtype=torch.float32, device=dev)
    throughput = torch.ones((R, 3), dtype=torch.float32, device=dev)
    alive = torch.ones(R, dtype=torch.bool, device=dev)
    o, d, rd = rays.o, rays.d, rays.rd
    # MIS state: the solid-angle pdf of the BRDF sample that spawned the
    # ray; last_spec marks delta (camera / mirror) vertices, where light
    # sampling has zero probability: emission weight 1
    last_spec = torch.ones(R, dtype=torch.bool, device=dev)
    prev_pdf = torch.ones(R, dtype=torch.float32, device=dev)
    any_overflow = torch.zeros((), dtype=torch.bool, device=dev)

    for bounce in range(bounces):
        li_idx, r1, r2, r3, r4 = sampler.bounce(R, n_lights, dev)
        hits, ovf = extend(Rays(o=o, d=d, rd=rd, mask=rays.mask), bounce)
        any_overflow = any_overflow | ovf
        hit = hits.prim >= 0
        hit_ok = alive & hit

        # environment on miss (≙ raytracer.cl's skydome lookup)
        if "sky" in scene:
            env = sample_sky(scene["sky"], d)
            radiance = radiance + torch.where((alive & ~hit)[:, None],
                                              throughput * env, 0.0)

        prim = torch.clamp(hits.prim, min=0).long()
        _, _, _, ng, harea = _tri_geom(tris, prim)
        n = ng
        u, v = hits.u[:, None], hits.v[:, None]
        if "normals" in scene:
            # smooth shading: barycentric-interpolated vertex normals
            vn = scene["normals"][prim]
            n = normalize((1.0 - hits.u - hits.v)[:, None] * vn[:, 0]
                          + u * vn[:, 1] + v * vn[:, 2])
        # face-forward normal
        n = torch.where(((n * d).sum(-1) > 0)[:, None], -n, n)
        p = o + hits.t[:, None] * d

        # ---- direct emission with its MIS weight -------------------------
        # brdfPDF/(brdfPDF + lightPDF) for diffuse-sampled rays, 1 for
        # camera and mirror rays (≙ wavefront.cl's Shade + Connect)
        emit = emissive[prim]
        is_emitter = emit.sum(-1) > 0
        cos_lh = (ng * d).sum(-1).abs()
        pl_hit = hits.t * hits.t / torch.clamp(cos_lh * harea * n_lights,
                                               min=1e-9)
        w_emit = torch.where(last_spec, 1.0, prev_pdf / torch.clamp(
            prev_pdf + pl_hit, min=1e-9))
        if brute_force:
            w_emit = torch.ones_like(w_emit)
        radiance = radiance + torch.where(
            (hit_ok & is_emitter)[:, None],
            throughput * emit * w_emit[:, None], 0.0)

        mat_albedo = albedo[prim]
        if "tex" in scene:
            tuv = scene["uvs"][prim]                      # (R, 3, 2)
            uv = ((1.0 - hits.u - hits.v)[:, None] * tuv[:, 0]
                  + u * tuv[:, 1] + v * tuv[:, 2])
            mat_albedo = mat_albedo * sample_atlas(
                scene["tex"], scene["tex_id"][prim], uv)

        # mirror vertices skip NEE and bounce by reflection
        # (≙ MATERIAL_SPECULAR, wavefront.cl:166-240)
        if "specular" in scene:
            is_spec = hit_ok & (scene["specular"][prim] > 0.5)
        else:
            is_spec = torch.zeros(R, dtype=torch.bool, device=dev)

        # ---- next-event estimation (Connect, wavefront.cl:200-240) -----
        li = light_ids[li_idx]
        lv0, le1, le2, ln, larea = _tri_geom(tris, li)
        su = torch.sqrt(r1)
        # uniform triangle sample: barycentrics (1 - sqrt r1, r2 sqrt r1)
        lp = lv0 + (1 - su)[:, None] * le1 + (r2 * su)[:, None] * le2
        wi = lp - p
        dist2 = (wi * wi).sum(-1)
        dist = torch.sqrt(torch.clamp(dist2, min=1e-12))
        wi = wi / dist[:, None]
        cos_s = (n * wi).sum(-1)
        cos_l = (ln * -wi).sum(-1).abs()
        l_emit = emissive[li]
        nee_valid = hit_ok & ~is_spec & (cos_s > 0) & (l_emit.sum(-1) > 0)
        if brute_force:
            nee_valid = torch.zeros_like(nee_valid)
        occ, ovf_s = occluded(p + n * 1e-4, wi * dist[:, None])
        any_overflow = any_overflow | ovf_s
        # pdf of that point on that light (area -> solid angle)
        pdf_l = dist2 / torch.clamp(cos_l * larea * n_lights, min=1e-9)
        pdf_b = torch.clamp(cos_s, min=0.0) / math.pi   # cosine pdf
        w_nee = pdf_l / torch.clamp(pdf_l + pdf_b, min=1e-9)
        contrib = (throughput * mat_albedo / math.pi * l_emit
                   * (cos_s * w_nee / torch.clamp(pdf_l, min=1e-9))[:, None])
        radiance = radiance + torch.where((nee_valid & ~occ)[:, None],
                                          contrib, 0.0)

        # ---- point / spot / directional delta lights ---------------------
        if analytic is not None:
            a_add, a_ovf = _analytic_nee(occluded, analytic, p, n,
                                         mat_albedo, throughput,
                                         hit_ok & ~is_spec)
            radiance = radiance + a_add
            any_overflow = any_overflow | a_ovf

        # ---- bounce: cosine-weighted diffuse or mirror reflection -------
        nd = normalize(cosine_hemisphere(n, r3, r4))
        refl = normalize(d - 2.0 * (d * n).sum(-1, keepdim=True) * n)
        # the cosine pdf cancels cos / pi for diffuse; a mirror is a delta
        throughput = throughput * mat_albedo
        alive = hit_ok & (throughput.amax(dim=-1) > 1e-3)
        o = p + n * 1e-4
        d = torch.where(is_spec[:, None], refl, nd)
        rd = safe_rcp(d)
        prev_pdf = torch.clamp((nd * n).sum(-1), min=1e-6) / math.pi
        last_spec = is_spec

    return radiance, any_overflow


def render(bvh8, scene, eye, fwd, right, up, width, height, spp=4,
           bounces=3, sampler: Sampler | None = None, cap_factor: int = 4,
           analytic=None, aux=None):
    """Accumulate spp samples on the BVH's device; returns ((H, W, 3)
    image, overflow). Each sample draws its pixel jitter, then traces
    row-major primary rays with trace_paths. sampler: default
    Sampler.seeded(0) on the BVH's device (JAX's render takes seed=0).
    aux: the packet tables (traverse.packet2.build_packet_aux(bvh8)) to
    route every traversal through the packet2 engine, built once by the
    caller (JAX's use_packets=True builds them in each call)."""
    from tinybvh_tpu_torch.render.camera import primary_rays

    dev = bvh8.bounds.device
    if sampler is None:
        sampler = Sampler.seeded(0, dev)
    acc = torch.zeros((width * height, 3), dtype=torch.float32, device=dev)
    ovf = torch.zeros((), dtype=torch.bool, device=dev)
    for _ in range(spp):
        jit = sampler.jitter(height, width, dev)
        rays = primary_rays(eye, fwd, right, up, width, height, jitter=jit)
        rad, o1 = trace_paths(bvh8, scene, rays, sampler, bounces=bounces,
                              cap_factor=cap_factor, analytic=analytic,
                              aux=aux)
        acc = acc + rad
        ovf = ovf | o1
    return (acc / spp).reshape(height, width, 3), ovf
