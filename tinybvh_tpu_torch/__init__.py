"""tinybvh_tpu_torch — the PyTorch / CUDA port of tinybvh_tpu.

The JAX package `tinybvh_tpu` is the reference; this package imports
torch and never jax. Ported so far: `BVH(tris).intersect(rays)` /
`.is_occluded(...)` with its engines: the packet2 pipeline
(traverse/packet2.py, four hand-written Hopper kernels in csrc/ and
their plain PyTorch twins) with its exact retrace (traverse/retrace.py:
kernel R on the card, the wavefront as its twin), the
wavefront engine (traverse/wavefront.py), the per-ray-stack lockstep
engine (traverse/wide.py), the rayloop engine (traverse/rayloop.py) and
the BVH2 engines (traverse/stack.py), with the Möller–Trumbore,
watertight and Baldwin–Weber leaf tests; the v1 packet engine
(traverse/packet.py); `BVH.refit` and the per-frame refit
(builders/refit.py); and instancing, `TLAS(blases, transforms)` with
the two-level engines (tlas/instance.py), the per-instance and bucketed
packet engines (tlas/packet.py) and the two-level rayloop
(tlas/rayloop.py); the scene layer (scene/: meshes, loaders, the animated node graph and its
per-frame BVH update) and the path tracers (render/: `render`,
`trace_paths`, `trace_paths_tlas`); opacity micromaps (ops/omap.py,
`build_packet_aux(omap=)`, kernel B's micromap mode, the retraces and
`build_tlas_packet(omaps=)`); the sphere and custom-primitive queries
(ops/queries.py), the voxel DDA (ops/voxel.py) and voxel TLAS instances
(tlas/voxel_blas.py); the device builders (builders/lbvh.py, behind
`BVH(builder="lbvh")`, and builders/binned_device.py), the host builders
(builders/sweep.py, sbvh.py, optimize.py), the quantized BVH8Q
(layouts/cwbvh.py, taken by the wavefront engine), the leaf-shape
transforms (layouts/leafshape.py) and serialization (io/serialize.py).
See ROADMAP.md for what is still to port."""

from tinybvh_tpu_torch.api import BVH, TLAS
from tinybvh_tpu_torch.core.rays import Hits, Rays, make_rays

__all__ = ["BVH", "TLAS", "Hits", "Rays", "make_rays"]
