"""Per-device packet-pipeline parameters (≙ tinybvh_tpu/tuning.py, the
reference's vendor #define specialization, tiny_ocl.h:366-369).

The "h100" row is a starting point copied from the JAX package's
measured TPU v5e row and has not been tuned on the card (measured=False);
get_tuning warns once when it resolves such a row. Callers that pass
explicit values win."""

from __future__ import annotations

import warnings
from dataclasses import dataclass

import torch

from tinybvh_tpu_torch.core.rays import default_device


@dataclass(frozen=True)
class Tuning:
    max_leaves: int      # per-tile leaf budget of the first cull pass
    max_blocks: int      # cull worklist depth per tile group
    wf_cap_factor: int   # wavefront retrace frontier: pairs per ray
    measured: bool = True


_TABLES = {
    # wf_cap_factor: the JAX rows' 8 is too small here. Through the API,
    # the retrace of random_tris(65536) camera rays peaks at 39.45,
    # 35.33 and 28.49 frontier pairs per ray of the batch at 160x160,
    # 320x320 and 640x640 (49-75 per retraced ray), and the shadow
    # retrace of its 4x4 grid at 45.62, so at 8 (or 32) the API would
    # raise. The port's frontier holds only live pairs: device memory
    # follows the pairs a retrace holds, ~690 B each (NVIDIA H100 80GB
    # HBM3, 700.00 W), not the cap. A retrace that filled the cap would
    # take 64 x 690 B = 44 KB per ray of the batch, so the cap is reached
    # before the card's 80 GB run out only for batches up to ~1.8M rays;
    # a larger batch can end in torch.OutOfMemoryError instead of the
    # API's RuntimeError.
    "h100": Tuning(max_leaves=512, max_blocks=256, wf_cap_factor=64,
                   measured=False),
    # CPU (the kernels' plain versions): small budgets keep tests fast
    "cpu": Tuning(max_leaves=256, max_blocks=128, wf_cap_factor=8),
}

_warned: set[str] = set()


def detect_generation(device=None) -> str:
    """'h100' for a CUDA device, 'cpu' otherwise. device=None means the
    card and raises RuntimeError where there is none (core.rays.
    default_device). Every CUDA card maps to the h100 row: it is the
    only GPU row, and is named by the card (torch.cuda.get_device_name)
    in every measurement."""
    dev = default_device(device)
    if dev.type != "cuda":
        return "cpu"
    name = torch.cuda.get_device_name(dev).lower()
    if "h100" not in name:
        warnings.warn(f"no tuning row for {name!r}; using the h100 row",
                      stacklevel=2)
    return "h100"


def get_tuning(generation: str | None = None, device=None) -> Tuning:
    gen = generation or detect_generation(device)
    tun = _TABLES[gen]
    if not tun.measured and gen not in _warned:
        _warned.add(gen)
        warnings.warn(
            f"tuning row for {gen!r} is a projection (never measured on "
            "hardware); pass explicit kernel parameters to override",
            stacklevel=2)
    return tun
