"""The import check: the benchmark measures the PyTorch port alone."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "tinybvh_tpu")


def forbidden_loaded(modules=None) -> list[str]:
    """The loaded modules whose top-level name (before the first dot,
    compared whole) is forbidden: 'tinybvh_tpu_torch' is not
    'tinybvh_tpu'."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)
