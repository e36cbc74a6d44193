"""Wavefront path tracer over an instanced TLAS scene
(≙ tinybvh_tpu/render/pathtracer_tlas.py; the reference's TLAS wavefront
tracer, tiny_bvh_gpu2.cpp + wavefront2.cl).

The bounce loop of render/pathtracer.py, with rays traversing a TLAS8
and shading data per instance:

  * inst_albedo / inst_emissive: (I, 3) per-instance colours
    (≙ wavefront2.cl's per-instance materials);
  * light_tris / light_emission: explicit world-space emissive triangles
    for NEE (a light is directly visible only if it is also TLAS
    geometry);
  * normals: the winning BLAS-space triangle's geometric normal, mapped
    to world space by the inverse transpose of the instance transform,
    in explicit f32 multiply-sums.

Traversal: the two-level wavefront (tlas/instance.py), or with
`tpacket=` the per-instance packet2 engine (tlas/packet.py: kernels A
and B on the card, once per instance and pass) at the device's tuning
row, each pass with the exact two-level wavefront retrace."""

from __future__ import annotations

import math

import torch

from tinybvh_tpu_torch.core.intersect import tri_edges
from tinybvh_tpu_torch.core.rays import Rays, make_rays
from tinybvh_tpu_torch.core.rng import cosine_hemisphere
from tinybvh_tpu_torch.core.vecmath import cross, norm, normalize, safe_rcp
from tinybvh_tpu_torch.render.pathtracer import (
    SHADOW_CUTOFF, Sampler, _analytic_nee, _tensor,
)
from tinybvh_tpu_torch.render.textures import sample_atlas
from tinybvh_tpu_torch.tlas import packet as tpk
from tinybvh_tpu_torch.tlas.instance import TLAS8, intersect_tlas_wavefront
from tinybvh_tpu_torch.traverse.packet import TILE


def _packet_routes(tpacket, device):
    """extend / occluded through the per-instance packet2 engine at the
    device's tuning row: bounce 0 traces the camera rays as they come,
    later bounces and shadow segments through the coherence sort."""
    from tinybvh_tpu_torch.tuning import get_tuning

    tun = get_tuning(device=device)
    kw = dict(max_leaves=tun.max_leaves, max_blocks=tun.max_blocks,
              wf_cap_factor=tun.wf_cap_factor)
    slo, shi = tpk.scene_bounds(tpacket)

    def extend(cur, bounce):
        if bounce == 0:
            h, ov = tpk.intersect_tlas_packets2(tpacket, cur, **kw)
        else:
            h, ov = tpk.intersect_tlas_packets2_sorted(tpacket, cur, slo,
                                                       shi, **kw)
        return h, ov.any()

    def occluded(oo, seg):
        h, ov = tpk.intersect_tlas_packets2_sorted(
            tpacket, make_rays(oo, seg), slo, shi, any_hit=True,
            t_max_static=SHADOW_CUTOFF, **kw)
        return (h.prim >= 0) & (h.t < SHADOW_CUTOFF), ov.any()

    return extend, occluded


def trace_paths_tlas(tlas: TLAS8, inst_albedo, inst_emissive, light_tris,
                     light_emission, rays: Rays, sampler: Sampler,
                     bounces: int = 3, cap_factor: int = 4, leaf_uvs=None,
                     leaf_tex=None, tex=None, inst_specular=None,
                     analytic=None, tpacket=None):
    """One sample per ray over an instanced scene, on the rays' device ->
    ((R, 3) radiance, overflow), overflow a 0-dim bool tensor ORing every
    traversal's frontier overflow (True: truncated paths; retry with a
    larger cap_factor).

    NEE + MIS and mirrors as render/pathtracer.py (≙ wavefront2.cl's
    Shade / Connect). inst_specular: optional (I,); instances with
    specular > 0.5 shade as perfect mirrors.

    tpacket: optional tlas.packet.TLASPacket; with R a multiple of 256 and
    no textures it routes every traversal through the per-instance packet2
    engine. Textures need the merged-leaf winner, which only the
    wavefront returns.

    Textures (≙ raytracer.cl's textured materials): leaf_uvs (L, 4, 3, 2)
    and leaf_tex (L, 4), merged leaf-aligned tables (tlas.instance.
    merge_leaf_attrs), and tex, a render.textures.build_atlas dict; the
    sample multiplies the instance albedo at the hit's interpolated UV."""
    R = rays.o.shape[0]
    dev = rays.o.device
    f32 = torch.float32
    inst_albedo = _tensor(inst_albedo, f32, dev)
    inst_emissive = _tensor(inst_emissive, f32, dev)
    light_tris = _tensor(light_tris, f32, dev)
    light_emission = _tensor(light_emission, f32, dev)
    if inst_specular is not None:
        inst_specular = _tensor(inst_specular, f32, dev)
    use_packets = (tpacket is not None and R % TILE == 0
                   and leaf_uvs is None)
    if use_packets:
        extend, occluded = _packet_routes(tpacket, dev)
    else:
        def occluded(oo, seg):
            _, occ, ov = intersect_tlas_wavefront(
                tlas, make_rays(oo, seg), SHADOW_CUTOFF,
                cap_factor=cap_factor, any_hit=True)
            return occ, ov
    n_lights = light_tris.shape[0]
    lv0, le1, le2 = tri_edges(light_tris)
    lnv = cross(le1, le2)
    larea = 0.5 * norm(lnv)
    lnv = normalize(lnv)
    n_inst = tlas.inst_inv.shape[0]

    radiance = torch.zeros((R, 3), dtype=f32, device=dev)
    throughput = torch.ones((R, 3), dtype=f32, device=dev)
    alive = torch.ones(R, dtype=torch.bool, device=dev)
    o, d, rd = rays.o, rays.d, rays.rd
    last_spec = torch.ones(R, dtype=torch.bool, device=dev)
    prev_pdf = torch.ones(R, dtype=f32, device=dev)
    any_overflow = torch.zeros((), dtype=torch.bool, device=dev)

    for bounce in range(bounces):
        li, r1, r2, r3, r4 = sampler.bounce(R, n_lights, dev)
        cur = Rays(o=o, d=d, rd=rd, mask=rays.mask)
        if use_packets:
            hits, ovf = extend(cur, bounce)
            inst = torch.clamp(hits.inst, min=0).long()
            tri = tpacket.prim_tris[(tpacket.prim_off[inst]
                                     + torch.clamp(hits.prim, min=0)).long()]
            wl = wk = None
        else:
            hits, win, ovf = intersect_tlas_wavefront(
                tlas, cur, cap_factor=cap_factor, return_winner=True)
            inst = torch.clamp(hits.inst, min=0).long()
            wl = torch.where(win >= 0, win >> 2, 0).long()
            wk = torch.where(win >= 0, win & 3, 0).long()
            tri = tlas.leaf_tris[wl, wk]                  # BLAS space
        any_overflow = any_overflow | ovf
        hit_ok = alive & (hits.prim >= 0)
        _, te1, te2 = tri_edges(tri)
        n_l = cross(te1, te2)
        inv = tlas.inst_inv[torch.clamp(inst, 0, n_inst - 1)]
        # inv^T n in exact f32 (the sum over j of inv[j, i] * n[j])
        n_w = (inv[:, :3, :3] * n_l[:, :, None]).sum(1)
        n = normalize(n_w)
        n = torch.where(((n * d).sum(-1) > 0)[:, None], -n, n)
        p = o + hits.t[:, None] * d

        # ---- direct emission with its MIS weight -------------------------
        # the hit triangle's world-space area from the inverse transform:
        # |cross(M e1, M e2)| = |inv3^T (e1 x e2)| / |det(inv3)|
        emit = inst_emissive[inst]
        is_emitter = emit.sum(-1) > 0
        i3 = inv[:, :3, :3]
        det_inv = (
            i3[:, 0, 0] * (i3[:, 1, 1] * i3[:, 2, 2]
                           - i3[:, 1, 2] * i3[:, 2, 1])
            - i3[:, 0, 1] * (i3[:, 1, 0] * i3[:, 2, 2]
                             - i3[:, 1, 2] * i3[:, 2, 0])
            + i3[:, 0, 2] * (i3[:, 1, 0] * i3[:, 2, 1]
                             - i3[:, 1, 1] * i3[:, 2, 0]))
        harea = 0.5 * norm(n_w) / torch.clamp(det_inv.abs(), min=1e-12)
        cos_lh = (n * d).sum(-1).abs()
        pl_hit = hits.t * hits.t / torch.clamp(cos_lh * harea * n_lights,
                                               min=1e-9)
        w_emit = torch.where(last_spec, 1.0, prev_pdf / torch.clamp(
            prev_pdf + pl_hit, min=1e-9))
        radiance = radiance + torch.where(
            (hit_ok & is_emitter)[:, None],
            throughput * emit * w_emit[:, None], 0.0)

        mat_albedo = inst_albedo[inst]
        if leaf_uvs is not None:
            tuv = leaf_uvs[wl, wk]                        # (R, 3, 2)
            uv = ((1.0 - hits.u - hits.v)[:, None] * tuv[:, 0]
                  + hits.u[:, None] * tuv[:, 1] + hits.v[:, None] * tuv[:, 2])
            mat_albedo = mat_albedo * sample_atlas(tex, leaf_tex[wl, wk], uv)

        if inst_specular is not None:
            is_spec = hit_ok & (inst_specular[inst] > 0.5)
        else:
            is_spec = torch.zeros(R, dtype=torch.bool, device=dev)

        # ---- NEE toward a sampled world-space light ----------------------
        su = torch.sqrt(r1)
        lp = (lv0[li] + (1 - su)[:, None] * le1[li]
              + (r2 * su)[:, None] * le2[li])
        wi = lp - p
        dist2 = (wi * wi).sum(-1)
        dist = torch.sqrt(torch.clamp(dist2, min=1e-12))
        wi = wi / dist[:, None]
        cos_s = (n * wi).sum(-1)
        cos_l = (lnv[li] * -wi).sum(-1).abs()
        nee_valid = hit_ok & ~is_spec & (cos_s > 0)
        occ, ovf_s = occluded(p + n * 1e-4, wi * dist[:, None])
        any_overflow = any_overflow | ovf_s
        pdf_l = dist2 / torch.clamp(cos_l * larea[li] * n_lights, min=1e-9)
        pdf_b = torch.clamp(cos_s, min=0.0) / math.pi
        w_nee = pdf_l / torch.clamp(pdf_l + pdf_b, min=1e-9)
        contrib = (throughput * mat_albedo / math.pi * light_emission[li]
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
        throughput = throughput * mat_albedo
        alive = hit_ok & (throughput.amax(dim=-1) > 1e-3)
        o = p + n * 1e-4
        d = torch.where(is_spec[:, None], refl, nd)
        rd = safe_rcp(d)
        prev_pdf = torch.clamp((nd * n).sum(-1), min=1e-6) / math.pi
        last_spec = is_spec

    return radiance, any_overflow
