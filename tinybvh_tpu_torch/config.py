"""Frozen runtime configuration: the fields the packet path reads.

Counterpart of tinybvh_tpu/config.py (≙ the reference's compile-time
defines, tiny_bvh.h:56-177). `use_config` scopes an override."""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, replace


@dataclass(frozen=True)
class Config:
    bins: int = 8                  # SAH bins (≙ BVHBINS)
    max_leaf: int = 4              # BVH2 leaf size before the 8-wide collapse
    # pack subtrees of <= this many prims into one wide-layout leaf during
    # the native collapse (≙ CombineLeafs(4), tiny_bvh.h:5463-5465)
    leaf_combine: int = 4
    # ≙ VALIDATE_RAY (tiny_bvh.h:1663-1665): make_rays rejects non-finite
    # or zero-length rays
    validate_rays: bool = False


DEFAULT = Config()
_current = DEFAULT


def get_config() -> Config:
    return _current


def set_config(cfg: Config) -> None:
    global _current
    _current = cfg


@contextlib.contextmanager
def use_config(**overrides):
    """Scoped override: `with use_config(validate_rays=True): ...`."""
    prev = _current
    set_config(replace(prev, **overrides))
    try:
        yield _current
    finally:
        set_config(prev)
