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


@dataclass(frozen=True)
class Tuning:
    max_leaves: int      # per-tile leaf budget of the first cull pass
    max_blocks: int      # cull worklist depth per tile group
    # leaf budget of the escalated packet retrace: the API raises on any
    # residual overflow (the exact wavefront retrace is not ported), so it
    # is sized to cover the widest tiles of the coherence sort
    retrace_ml: int
    measured: bool = True


_TABLES = {
    "h100": Tuning(max_leaves=512, max_blocks=256, retrace_ml=16384,
                   measured=False),
    # CPU (the kernels' plain versions): small budgets keep tests fast
    "cpu": Tuning(max_leaves=256, max_blocks=128, retrace_ml=4096),
}

_warned: set[str] = set()


def detect_generation(device=None) -> str:
    """'h100' for a CUDA device, 'cpu' otherwise. Every CUDA card maps to
    the h100 row: it is the only GPU row, and is named by the card
    (torch.cuda.get_device_name) in every measurement."""
    dev = torch.device(device) if device is not None else (
        torch.device("cuda") if torch.cuda.is_available()
        else torch.device("cpu"))
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
