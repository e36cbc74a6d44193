"""High-level API: `BVH(tris, device=...).intersect(rays)`
(≙ tinybvh_tpu/api.py; bvh.Build + bvh.Intersect, tiny_bvh.h:884-960).

The port's slice covers the packet path: the native SAH build, the
8-wide collapse, the packet tables, and the packet2 trace with the
escalated packet retrace. On a CUDA device that trace runs the two
hand-written kernels; on the CPU it runs their plain twins. A residual
overflow raises RuntimeError: the exact wavefront retrace is not ported
yet, and approximate hits are never returned silently."""

from __future__ import annotations

import numpy as np
import torch

from tinybvh_tpu_torch.core.rays import Hits, Rays
from tinybvh_tpu_torch.core.vecmath import BVH_FAR

_SLICE = "ROADMAP queue 1"


def _unsupported(what: str, slice_no: int):
    return NotImplementedError(f"{what} is not ported yet ({_SLICE}, "
                               f"slice {slice_no})")


class BVH:
    """A BVH over a triangle soup: tris (N, 3, 3) float32 (or a (3N, 3|4)
    vertex soup), built on the host and uploaded to `device` (default:
    CUDA when available, else the CPU)."""

    def __init__(self, tris, builder: str = "sah", max_leaf: int | None = None,
                 bins: int | None = None, layout: str = "bvh8", device=None):
        from tinybvh_tpu_torch.config import get_config
        from tinybvh_tpu_torch.layouts.mbvh import BVH8
        from tinybvh_tpu_torch.native import (
            build_binned_native, collapse_bvh8_native,
        )

        cfg = get_config()
        max_leaf = cfg.max_leaf if max_leaf is None else max_leaf
        bins = cfg.bins if bins is None else bins
        if builder != "sah":
            raise _unsupported(f"builder={builder!r}", 11)
        if layout != "bvh8":
            raise _unsupported(f"layout={layout!r}", 6)
        if bins != 8:
            raise _unsupported("the numpy SAH builder (bins != 8)", 11)
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        self.device = torch.device(device)
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
        _, self._host = build_binned_native(tris_host, max_leaf=max_leaf,
                                            return_host=True)
        self.leaf_max = int(self._host["count"].max())
        if self.leaf_max > 4:
            raise _unsupported("the BVH2 layout (leaves over 4 tris)", 6)
        self._bvh8_host = collapse_bvh8_native(self._host, tris_host,
                                               combine=cfg.leaf_combine)
        self.bvh8 = BVH8.from_host(self._bvh8_host, self.device)
        self.layout = layout
        self._packet_aux = None

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
        """Lazy packet tables (traverse.packet2) for this BVH8."""
        if self._packet_aux is None:
            from tinybvh_tpu_torch.traverse.packet2 import (
                build_packet_aux_host,
            )

            self._packet_aux = build_packet_aux_host(self._bvh8_host,
                                                     device=self.device)
        return self._packet_aux

    @property
    def aabb(self):
        """Root box (lo, hi) as numpy (3,) arrays."""
        return self._host["node_min"][0], self._host["node_max"][0]

    def _packet_trace(self, rays: Rays, t_max, engine: str, any_hit: bool):
        """(R,) hits, or with any_hit (R,) occlusion flags. Rays sharing
        one origin (shadow rays traced from a light) are bundled by
        direction; others by the coherence sort."""
        from tinybvh_tpu_torch.traverse.packet2 import (
            intersect_packets2_sorted, occluded_direction_sorted,
        )
        from tinybvh_tpu_torch.tuning import get_tuning

        R = rays.o.shape[0]
        if engine not in ("auto", "packets"):
            raise _unsupported(f"engine={engine!r}", 6)
        if hasattr(t_max, "shape"):
            raise _unsupported("a per-ray t_max on the packet path", 5)
        if R % 256 or R < 4096:
            raise _unsupported(
                f"{R} rays (the packet path takes multiples of 256, at "
                "least 4096; smaller batches go to the wavefront engine)", 6)
        if rays.o.device != self.device:
            raise ValueError(f"rays on {rays.o.device}, BVH on {self.device}")
        tun = get_tuning(device=self.device)
        kw = dict(max_leaves=tun.max_leaves, max_blocks=tun.max_blocks,
                  retrace="packet", retrace_ml=tun.retrace_ml)
        if any_hit and bool((rays.o == rays.o[:1]).all()):
            out, ovf = occluded_direction_sorted(
                self.bvh8, self.packet_aux, rays, float(t_max), **kw)
        else:
            lo, hi = self.aabb
            out, ovf = intersect_packets2_sorted(
                self.bvh8, self.packet_aux, rays, lo, hi, any_hit=any_hit,
                t_max_static=float(t_max), **kw)
            if any_hit:
                out = (out.prim >= 0) & (out.t < float(t_max))
        n_ovf = int(ovf.sum())
        if n_ovf:
            raise RuntimeError(
                f"{n_ovf} rays overflowed the escalated packet budget; "
                "their exact retrace (the wavefront engine) is not ported "
                "yet")
        return out

    def intersect(self, rays: Rays, t_max=BVH_FAR,
                  engine: str = "auto") -> Hits:
        """Closest hit. engine "auto" and "packets" run the packet2
        pipeline with the escalated packet retrace; other engines are not
        ported yet."""
        return self._packet_trace(rays, t_max, engine, any_hit=False)

    def is_occluded(self, rays: Rays, t_max,
                    engine: str = "auto") -> torch.Tensor:
        """(R,) bool: any hit in (0, t_max); engine semantics as in
        intersect()."""
        return self._packet_trace(rays, t_max, engine, any_hit=True)

    def refit(self, new_tris=None):
        raise _unsupported("refit", 7)


class TLAS:
    """Top-level structure over instanced BLASes (≙ tinybvh_tpu.api.TLAS):
    not ported yet."""

    def __init__(self, blases, transforms, masks=None):
        raise _unsupported("TLAS instancing", 8)
