"""High-level API: `BVH(tris, device=...).intersect(rays)` and `TLAS`
(≙ tinybvh_tpu/api.py; bvh.Build + bvh.Intersect, tiny_bvh.h:884-960, and
the TLAS build + IntersectTLAS, tiny_bvh.h:2221-2259, 3306-3380).

Builders: the native SAH build ("sah" at 8 bins), the numpy one ("sah"
at other bin counts, "median"), the LBVH on the device ("lbvh").
Layouts: the 8-wide BVH8 (leaves of at most 4 triangles) or, for layout
!= "bvh8" or larger leaves, the BVH2 alone. Engines over the BVH8: the packet2 trace with the wavefront
retrace (on a CUDA device it runs the hand-written kernels; on the CPU
their plain twins), the wavefront, the per-ray-stack lockstep and the
rayloop engine; over the BVH2: the lockstep BVH2 engine. `BVH.refit`
(the BVH2 refit and a re-collapse, on the BVH's device); `TLAS` over
instanced BLASes (the two-level wavefront, then the two-level lockstep
engine). An overflow the wavefront retrace cannot repair raises
RuntimeError: approximate hits are never returned silently."""

from __future__ import annotations

import numpy as np
import torch

from tinybvh_tpu_torch.core.rays import Hits, Rays, default_device, make_rays
from tinybvh_tpu_torch.core.vecmath import BVH_FAR

ENGINES = ("auto", "packets", "wavefront", "lockstep", "lockstep2",
           "rayloop")


def _check_nans(what, *xs):
    """Config.debug_nans: raise FloatingPointError where a float tensor
    of xs holds a NaN."""
    for x in xs:
        if (isinstance(x, torch.Tensor) and x.is_floating_point()
                and bool(torch.isnan(x).any())):
            raise FloatingPointError(f"{what}: NaN (Config.debug_nans)")


class BVH:
    """A BVH over a triangle soup: tris (N, 3, 3) float32 (or a (3N, 3|4)
    vertex soup), built on the host and uploaded to `device` (default:
    the card; with no CUDA device it raises RuntimeError unless
    device="cpu" asks for the kernels' plain versions).

    builder: "sah" (binned SAH; the native C build at 8 bins, the numpy
    one otherwise), "median" (≙ BuildQuick) or "lbvh" (the Morton radix
    tree built on `device`, one prim a leaf, collapsed without leaf
    combining, as in JAX); layout: "bvh8" keeps the 8-wide layout where
    every leaf holds at most 4 triangles, any other value (e.g. "bvh2")
    keeps the BVH2 alone (bvh8 is None)."""

    def __init__(self, tris, builder: str = "sah", max_leaf: int | None = None,
                 bins: int | None = None, layout: str = "bvh8", device=None):
        from tinybvh_tpu_torch import native
        from tinybvh_tpu_torch.builders.binned import build_binned
        from tinybvh_tpu_torch.config import get_config
        from tinybvh_tpu_torch.layouts.mbvh import BVH8, collapse_bvh2

        cfg = get_config()
        max_leaf = cfg.max_leaf if max_leaf is None else max_leaf
        bins = cfg.bins if bins is None else bins
        if builder not in ("sah", "median", "lbvh"):
            raise ValueError(f"unknown builder {builder!r}")
        self.device = default_device(device)
        if isinstance(tris, torch.Tensor):
            tris = tris.detach().cpu().numpy()
        tris_host = np.asarray(tris, np.float32)
        if tris_host.ndim == 2:  # (3N, 3/4) vertex soup -> (N, 3, 3)
            if tris_host.shape[0] % 3 or tris_host.shape[1] not in (3, 4):
                raise ValueError(
                    f"vertex soup must be (3N, 3|4), got {tris_host.shape}")
            tris_host = tris_host[:, :3].reshape(-1, 3, 3)
        if (tris_host.ndim != 3 or tris_host.shape[1:] != (3, 3)
                or tris_host.shape[0] == 0):
            raise ValueError("triangles must be (N, 3, 3) with N >= 1, "
                             f"got {tris_host.shape}")
        self.tris = torch.from_numpy(tris_host).to(self.device)
        self.device = self.tris.device      # "cuda" -> "cuda:0"
        self._bvh2 = None
        # as JAX: the native C build where it serves (SAH at 8 bins), the
        # numpy builder otherwise (other bin counts, the median split, no
        # C compiler), whose tree takes the Python collapse
        native_built = (builder == "sah" and bins == 8
                        and native.available())
        if native_built:
            _, self._host = native.build_binned_native(
                tris_host, max_leaf=max_leaf, return_host=True)
        elif builder == "lbvh":
            # the Morton radix tree, built on the BVH's device (≙ JAX
            # api.py:80-83); then one host copy of each of its arrays for
            # the leaf size, the triangle packing and the Python collapse
            from tinybvh_tpu_torch.builders.lbvh import build_lbvh

            self._bvh2 = build_lbvh(self.tris)
            self._host = {k: getattr(self._bvh2, k).cpu().numpy()
                          for k in ("node_min", "node_max", "left_first",
                                    "count", "prim_idx")}
            self._host["n_nodes"] = self._bvh2.n_nodes
        elif builder == "median":
            _, self._host = build_binned(tris_host, strategy="median",
                                         return_host=True, device="cpu")
        else:
            _, self._host = build_binned(tris_host, bins=bins,
                                         max_leaf=max_leaf, return_host=True,
                                         device="cpu")
        self.leaf_max = int(self._host["count"].max())
        self.packed_tris = torch.from_numpy(
            tris_host[self._host["prim_idx"]]).to(self.device)
        self.layout = layout
        self.bvh8 = self._bvh8_host = None
        if layout == "bvh8" and self.leaf_max <= 4:
            if native_built:
                self._bvh8_host = native.collapse_bvh8_native(
                    self._host, tris_host, combine=cfg.leaf_combine)
            else:
                self._bvh8_host = collapse_bvh2(None, tris_host,
                                                host=self._host, as_host=True)
            self.bvh8 = BVH8.from_host(self._bvh8_host, self.device)
        self._packet_aux = None
        self._rayloop_tables = None
        self._refit_plan = None
        self._aabb = (self._host["node_min"][0], self._host["node_max"][0])

    @classmethod
    def from_vertex_buffer(cls, buf, stride: int, offset: int = 0,
                           indices=None, **kw):
        """Build from an interleaved vertex buffer (≙ bvhvec4slice,
        tiny_bvh.h:428-436): vertex i reads 3 floats at offset + i*stride
        (in floats). indices: optional (N, 3) triangle indices."""
        buf = np.asarray(buf, np.float32).reshape(-1)
        if stride < 3:
            raise ValueError(f"stride must be >= 3 floats, got {stride}")
        n_v = max(0, (buf.size - offset - 3) // stride + 1)
        verts = buf[offset + np.arange(n_v)[:, None] * stride + np.arange(3)]
        if indices is not None:
            tris = verts[np.asarray(indices, np.int64).reshape(-1, 3)]
        else:
            tris = verts[: n_v - n_v % 3].reshape(-1, 3, 3)
        return cls(tris, **kw)

    @property
    def packet_aux(self):
        """Lazy packet tables (traverse.packet2) for this BVH8, built on
        the BVH's device."""
        if self._packet_aux is None:
            if self.bvh8 is None:
                raise ValueError("packet tracing needs the bvh8 layout")
            from tinybvh_tpu_torch.traverse.packet2 import build_packet_aux

            self._packet_aux = build_packet_aux(self.bvh8)
        return self._packet_aux

    @property
    def rayloop_tables(self):
        """Lazy flat tables of the rayloop engine (traverse.rayloop), from
        the collapse's host copy where there is one."""
        if self._rayloop_tables is None:
            if self.bvh8 is None:
                raise ValueError("rayloop tracing needs the bvh8 layout")
            from tinybvh_tpu_torch.traverse.rayloop import (
                make_rayloop_tables,
            )

            self._rayloop_tables = make_rayloop_tables(
                self.bvh8, host=self._bvh8_host)
        return self._rayloop_tables

    @property
    def bvh2(self):
        """The BVH2 as tensors on the BVH's device, uploaded at first use:
        the packet and BVH8 engines never read it."""
        if self._bvh2 is None:
            from tinybvh_tpu_torch.layouts.bvh2 import BVH2

            self._bvh2 = BVH2.from_host(self._host, self.device)
        return self._bvh2

    @bvh2.setter
    def bvh2(self, value):
        self._bvh2 = value

    @property
    def aabb(self):
        """Root box (lo, hi) as numpy (3,) arrays (the refit box after a
        refit)."""
        return self._aabb

    def _engine(self, rays: Rays, t_max, engine: str,
                any_hit: bool = False) -> str:
        """The engine of one call (≙ JAX api.py:210-323), one of
        "rayloop", "packets", "wavefront", "lockstep" (BVH8) and "bvh2":
          * "rayloop" for engine="rayloop" (is_occluded: only with a
            BVH8, as JAX's, which otherwise takes the BVH2 engine);
          * "packets" for engine="packets", and for "auto" on a CUDA BVH8
            with R % 256 == 0 and R >= 4096 (the counterpart of JAX's TPU
            gate); both need a scalar t_max, and is_occluded without a
            BVH8 takes the BVH2 engine as JAX's does;
          * without a BVH8, "bvh2";
          * "lockstep2" is "bvh2" in intersect and, as in JAX, "lockstep"
            in is_occluded;
          * "lockstep" for engine="lockstep", else "wavefront" (small or
            ragged batches, a per-ray t_max, the CPU)."""
        if engine not in ENGINES:
            raise ValueError(f"unknown engine {engine!r}")
        if rays.o.device != self.device:
            raise ValueError(f"rays on {rays.o.device}, BVH on {self.device}")
        has8 = self.bvh8 is not None
        if engine == "rayloop" and (has8 or not any_hit):
            return "rayloop"
        R = rays.o.shape[0]
        t_scalar = not (hasattr(t_max, "shape") and len(t_max.shape) > 0)
        if t_scalar and (has8 or not any_hit) and (
                engine == "packets" or (
                    engine == "auto" and has8
                    and self.device.type == "cuda"
                    and R % 256 == 0 and R >= 4096)):
            return "packets"
        if not has8:
            return "bvh2"
        if engine == "lockstep2":
            return "lockstep" if any_hit else "bvh2"
        return "lockstep" if engine == "lockstep" else "wavefront"

    def _packet_trace(self, rays: Rays, t_max, any_hit: bool):
        """(R,) hits, or with any_hit (R,) occlusion flags, from the packet
        path with the wavefront retrace. Rays sharing one origin (shadow
        rays traced from a light) are bundled by direction; others by the
        coherence sort."""
        from tinybvh_tpu_torch.traverse.packet2 import (
            intersect_packets2_sorted, occluded_direction_sorted,
        )
        from tinybvh_tpu_torch.tuning import get_tuning

        tun = get_tuning(device=self.device)
        kw = dict(max_leaves=tun.max_leaves, max_blocks=tun.max_blocks,
                  wf_cap_factor=tun.wf_cap_factor)
        t_max = float(t_max)
        if any_hit and bool((rays.o == rays.o[:1]).all()):
            out, ovf = occluded_direction_sorted(
                self.bvh8, self.packet_aux, rays, t_max, **kw)
        else:
            lo, hi = self.aabb
            out, ovf = intersect_packets2_sorted(
                self.bvh8, self.packet_aux, rays, lo, hi, any_hit=any_hit,
                t_max_static=t_max, **kw)
            if any_hit:
                out = (out.prim >= 0) & (out.t < t_max)
        n_ovf = int(ovf.sum())
        if n_ovf:
            raise RuntimeError(
                f"{n_ovf} rays overflowed the wavefront retrace's frontier "
                f"({tun.wf_cap_factor} pairs per ray); their hits would not "
                "be exact")
        return out

    @staticmethod
    def _overflowed(sovf):
        """The rays whose rayloop stack overflowed, or None (one host
        sync). JAX re-traces the whole call with the lockstep engine; the
        port re-traces these rays alone: each ray's result is exact
        either way."""
        deep = torch.nonzero(sovf).squeeze(1)
        return deep if deep.numel() else None

    @staticmethod
    def _take_t(t_max, idx):
        per_ray = hasattr(t_max, "shape") and len(t_max.shape) > 0
        return t_max[idx] if per_ray else t_max

    def intersect(self, rays: Rays, t_max=BVH_FAR,
                  engine: str = "auto") -> Hits:
        """Closest hit. engine:
          "auto"      packets on CUDA for large tile-shaped batches with a
                      scalar t_max, else the wavefront; the BVH2 engine
                      without a BVH8;
          "packets"   the packet2 pipeline with coherence sort and the
                      wavefront retrace (R % 256 == 0; ValueError without
                      a BVH8);
          "wavefront" level-synchronous BFS; falls back to "lockstep"
                      when its frontier overflows;
          "lockstep"  per-ray stacks over the BVH8 (traverse.wide);
          "lockstep2" per-ray stacks over the BVH2 (traverse.stack);
          "rayloop"   per-ray ordered traversal with round compaction
                      (traverse.rayloop); the rays whose stack overflows
                      are re-traced by "lockstep" (ValueError without a
                      BVH8).
        All are exact (≙ the reference's per-layout Intersect). With
        Config.debug_nans, a NaN in the rays or the hits raises
        FloatingPointError."""
        from tinybvh_tpu_torch.config import get_config
        from tinybvh_tpu_torch.traverse.wavefront import intersect_wavefront
        from tinybvh_tpu_torch.traverse.wide import intersect_bvh8

        nans = get_config().debug_nans
        if nans:
            _check_nans("BVH.intersect input", rays.o, rays.d, t_max)
        eng = self._engine(rays, t_max, engine)
        if eng == "packets":
            h = self._packet_trace(rays, t_max, any_hit=False)
        elif eng == "bvh2":
            from tinybvh_tpu_torch.traverse.stack import intersect_bvh2

            h = intersect_bvh2(self.bvh2, self.packed_tris, rays, t_max,
                               leaf_max=self.leaf_max)
        elif eng == "rayloop":
            from tinybvh_tpu_torch.traverse.rayloop import intersect_rayloop

            h, sovf = intersect_rayloop(self.rayloop_tables, rays, t_max)
            deep = self._overflowed(sovf)
            if deep is not None:   # stacks too shallow: the deep engine
                fix = intersect_bvh8(self.bvh8, rays.take(deep),
                                     self._take_t(t_max, deep))
                for k in ("t", "u", "v", "prim", "inst"):
                    getattr(h, k)[deep] = getattr(fix, k)
        elif eng == "wavefront":
            h, ovf = intersect_wavefront(self.bvh8, rays, t_max,
                                         cap_factor=8)
            if ovf:
                h = intersect_bvh8(self.bvh8, rays, t_max)
        else:
            h = intersect_bvh8(self.bvh8, rays, t_max)
        if nans:
            _check_nans("BVH.intersect", h.t, h.u, h.v)
        return h

    def is_occluded(self, rays: Rays, t_max,
                    engine: str = "auto") -> torch.Tensor:
        """(R,) bool: any hit in (0, t_max); engine semantics as in
        intersect() (≙ JAX api.py:294-323), with JAX's two routings: with
        a BVH8, "lockstep2" takes the BVH8 lockstep engine, and without
        one every engine takes the BVH2 engine. With Config.debug_nans, a
        NaN in the rays or t_max raises FloatingPointError."""
        from tinybvh_tpu_torch.config import get_config
        from tinybvh_tpu_torch.traverse.wavefront import intersect_wavefront
        from tinybvh_tpu_torch.traverse.wide import is_occluded_bvh8

        if get_config().debug_nans:
            _check_nans("BVH.is_occluded input", rays.o, rays.d, t_max)
        eng = self._engine(rays, t_max, engine, any_hit=True)
        if eng == "packets":
            return self._packet_trace(rays, t_max, any_hit=True)
        if eng == "bvh2":
            from tinybvh_tpu_torch.traverse.stack import is_occluded_bvh2

            return is_occluded_bvh2(self.bvh2, self.packed_tris, rays, t_max,
                                    leaf_max=self.leaf_max)
        if eng == "rayloop":
            from tinybvh_tpu_torch.traverse.rayloop import (
                is_occluded_rayloop,
            )

            occ, sovf = is_occluded_rayloop(self.rayloop_tables, rays, t_max)
            deep = self._overflowed(sovf)
            if deep is not None:
                occ[deep] = is_occluded_bvh8(self.bvh8, rays.take(deep),
                                             self._take_t(t_max, deep))
            return occ
        if eng == "wavefront":
            _, occ, ovf = intersect_wavefront(self.bvh8, rays, t_max,
                                              cap_factor=8, any_hit=True)
            if not ovf:
                return occ
        return is_occluded_bvh8(self.bvh8, rays, t_max)

    def intersect_one(self, origin, direction, t_max=BVH_FAR):
        """One ray (the reference's scalar Intersect): a dict of numpy
        scalars t, u, v and prim."""
        rays = make_rays(np.asarray(origin, np.float32)[None],
                         np.asarray(direction, np.float32)[None],
                         device=self.device)
        h = self.intersect(rays, t_max)
        return {k: getattr(h, k).cpu().numpy()[0]
                for k in ("t", "u", "v", "prim")}

    # -- maintenance ------------------------------------------------------
    def refit(self, new_tris=None):
        """New boxes after vertex deformation, topology kept (≙ JAX
        BVH.refit): the triangles repacked, the BVH2 refit
        (builders.refit) on the BVH's device, then, where there is a
        BVH8, bvh8 re-collapsed from it (layouts.mbvh.collapse_bvh2, no
        leaf combining). The host copies, the packet tables and the
        rayloop tables are dropped; the next trace that needs them
        builds them on the device. new_tris: (N, 3, 3) in the original
        prim order."""
        from tinybvh_tpu_torch.builders.refit import refit as _refit
        from tinybvh_tpu_torch.builders.refit import refit_plan
        from tinybvh_tpu_torch.layouts.mbvh import collapse_bvh2
        from tinybvh_tpu_torch.traverse.stack import pack_tris

        if new_tris is not None:
            new = torch.as_tensor(new_tris, dtype=torch.float32,
                                  device=self.device)
            if new.shape != self.tris.shape:
                raise ValueError(f"refit needs {tuple(self.tris.shape)} "
                                 f"triangles, got {tuple(new.shape)}")
            self.tris = new
        self.packed_tris = pack_tris(self.bvh2, self.tris)
        if self._refit_plan is None:
            self._refit_plan = refit_plan(self.bvh2)
        self.bvh2 = _refit(self.bvh2, self.packed_tris, self._refit_plan,
                           leaf_max=max(self.leaf_max, 1))
        if self.bvh8 is not None:
            self.bvh8 = collapse_bvh2(self.bvh2, None, tris_dev=self.tris)
        # refit moved the geometry: host copies and tables are stale
        self._bvh8_host = None
        self._packet_aux = None
        self._rayloop_tables = None
        self._aabb = (self.bvh2.node_min[0].cpu().numpy(),
                      self.bvh2.node_max[0].cpu().numpy())
        return self

    # -- metrics ----------------------------------------------------------
    def sah_cost(self) -> float:
        from tinybvh_tpu_torch.layouts.bvh2 import sah_cost

        return float(sah_cost(self.bvh2))

    def node_count(self) -> int:
        from tinybvh_tpu_torch.layouts.bvh2 import node_counts

        return int(node_counts(self.bvh2)[0])

    def validate(self):
        from tinybvh_tpu_torch.layouts.bvh2 import validate_host

        return validate_host(self.bvh2, self.tris)


class TLAS:
    """Top-level structure over instanced BLASes, see tlas/instance.py
    (≙ tinybvh_tpu.api.TLAS; BVH::Build(BLASInstance*, ...) +
    IntersectTLAS, tiny_bvh.h:2221-2259, 3306-3380).

    blases: list of api.BVH (their host copies feed a numpy merge) or raw
    layouts.mbvh.BVH8; transforms: (I, 4, 4) matrices (all instances of
    blases[0]) or (blas_index, matrix) pairs. The tables go to the
    BLASes' device. As in the JAX package, the bucketed packet engine is
    reached through tlas/packet.py, not through this class."""

    def __init__(self, blases, transforms, masks=None):
        from tinybvh_tpu_torch.layouts.mbvh import BVH8
        from tinybvh_tpu_torch.tlas.instance import build_tlas

        raw, host8s = [], []
        for b in blases:
            if isinstance(b, BVH):
                if b.bvh8 is None:
                    raise ValueError("TLAS BLASes need the bvh8 layout "
                                     "(max_leaf <= 4)")
                raw.append(b.bvh8)
                host8s.append(b._bvh8_host)
            elif isinstance(b, BVH8):
                raw.append(b)
                host8s.append(None)
            else:
                raise TypeError(f"not a BLAS: {type(b)}")
        self._impl = build_tlas(
            raw, transforms, masks,
            host8s=host8s if all(h is not None for h in host8s) else None,
            device=raw[0].bounds.device)
        self.blases = blases

    def intersect(self, rays: Rays, t_max=BVH_FAR) -> Hits:
        """Closest hit (.inst the instance, .prim the BLAS-local prim):
        the two-level wavefront at 4, then 12 pairs per ray; where both
        overflow, the exact lockstep traversal."""
        from tinybvh_tpu_torch.tlas.instance import (
            intersect_tlas8, intersect_tlas_wavefront,
        )

        for cap in (4, 12):
            hits, overflow = intersect_tlas_wavefront(self._impl, rays, t_max,
                                                      cap_factor=cap)
            if not overflow:
                return hits
        return intersect_tlas8(self._impl, rays, t_max)

    def is_occluded(self, rays: Rays, t_max) -> torch.Tensor:
        """(R,) bool: any hit in (0, t_max) (tlas.instance.
        is_occluded_tlas8)."""
        from tinybvh_tpu_torch.tlas.instance import is_occluded_tlas8

        return is_occluded_tlas8(self._impl, rays, t_max)
