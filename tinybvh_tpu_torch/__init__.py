"""tinybvh_tpu_torch — the PyTorch / CUDA port of tinybvh_tpu.

The JAX package `tinybvh_tpu` is the reference; this package imports
torch and never jax. Ported so far: the packet2 primary-ray path
(`BVH(tris).intersect(rays)` / `.is_occluded(...)`) with two
hand-written Hopper kernels (csrc/cull.cu, csrc/mt_fused.cu) and their
plain PyTorch twins. See ROADMAP.md for what is still to port."""

from tinybvh_tpu_torch.api import BVH, TLAS
from tinybvh_tpu_torch.core.rays import Hits, Rays, make_rays

__all__ = ["BVH", "TLAS", "Hits", "Rays", "make_rays"]
