"""8-wide BVH container (≙ tinybvh_tpu/layouts/mbvh.py; MBVH<8>,
tiny_bvh.h:4975-5048).

child[i] >= 0 -> child node row; child[i] < 0 -> leaf row -(child[i]+1);
EMPTY_SLOT marks an unused slot."""

from __future__ import annotations

from dataclasses import dataclass

import torch

EMPTY_SLOT = -(2**31) + 1


@dataclass
class BVH8:
    bounds: torch.Tensor     # (M, 48) f32
    child: torch.Tensor      # (M, 8) i32
    leaf_tris: torch.Tensor  # (L, 4, 3, 3) f32
    leaf_prim: torch.Tensor  # (L, 4) i32 global prim ids (-1 padding)

    @classmethod
    def from_host(cls, h8: dict, device) -> "BVH8":
        """From the dict of numpy arrays that the native collapse returns."""
        return cls(**{k: torch.as_tensor(h8[k]).to(device)
                      for k in ("bounds", "child", "leaf_tris", "leaf_prim")})
