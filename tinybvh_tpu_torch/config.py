"""Frozen runtime configuration (≙ tinybvh_tpu/config.py; the
reference's compile-time defines, tiny_bvh.h:56-177, and the runtime
members c_trav / c_int / hqbvhbins). `use_config` scopes an override."""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, fields, replace

# Fields kept for parity with the JAX package's Config that no engine of
# either package reads. A value other than the default raises
# NotImplementedError saying what the port reads instead, rather than
# being accepted and doing nothing.
UNREAD = {
    "hq_bins": "the builders take bins= (build_binned(bins=))",
    "c_trav": "the builders take c_trav= (default core/vecmath.py C_TRAV)",
    "c_int": "the builders take c_int= (default core/vecmath.py C_INT)",
    "sbvh_slack": "the spatial-split builder takes slack= "
                  "(builders/sbvh.py build_sbvh(slack=))",
    "stack_depth": "the engines fix their own depths (traverse/stack.py "
                   "STACK_DEPTH = 130, the rayloop engines' S, 24 and "
                   "two-level 32)",
    "wavefront_cap": "the wavefront engine takes cap_factor= (tuning.py "
                     "wf_cap_factor through the API)",
    "packet_k": "the packet engines' budgets come from tuning.py",
}


@dataclass(frozen=True)
class Config:
    bins: int = 8                  # SAH bins (≙ BVHBINS)
    hq_bins: int = 8               # ≙ HQBVHBINS; unread (UNREAD)
    c_trav: float = 1.0            # ≙ C_TRAV / C_INT; unread (UNREAD)
    c_int: float = 1.0
    max_leaf: int = 4              # BVH2 leaf size before the 8-wide collapse
    # pack subtrees of <= this many prims into one wide-layout leaf during
    # the native collapse (≙ CombineLeafs(4), tiny_bvh.h:5463-5465)
    leaf_combine: int = 4
    sbvh_slack: float = 0.5        # spatial-split headroom; unread (UNREAD)
    # leaf triangle test of the wavefront and BVH2 engines: "mt",
    # "watertight" (Woop: shared edges never leak) or "baldwin"
    # (Baldwin–Weber rows) (≙ WATERTIGHT_TRITEST, tiny_bvh.h:131,
    # 8486-8507). The packet engines keep Möller–Trumbore.
    tri_test: str = "mt"
    stack_depth: int = 128         # unread (UNREAD)
    wavefront_cap: int = 3         # unread (UNREAD)
    packet_k: int = 256            # unread (UNREAD)
    # ≙ VALIDATE_RAY (tiny_bvh.h:1663-1665): make_rays rejects non-finite
    # or zero-length rays
    validate_rays: bool = False
    # NaN tripwire. JAX flips its global jax_debug_nans, which checks
    # every op; torch has no such global switch, so here BVH.intersect
    # and BVH.is_occluded check their float outputs and raise
    # FloatingPointError on a NaN (one host sync per call while it is on)
    debug_nans: bool = False

    def __post_init__(self):
        for f in fields(self):
            if f.name in UNREAD and getattr(self, f.name) != f.default:
                raise NotImplementedError(
                    f"Config.{f.name} is read by neither package: "
                    f"{UNREAD[f.name]}")


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
