"""The scenes of the configurations, made from the seed on the host.

The scene is upstream tinybvh's `tiny_bvh_minimal.cpp`: TRIANGLE_COUNT
(8,192) triangles, each with its first vertex uniform in the unit cube
and its other two at that vertex plus 0.1 times a uniform vector of
[0, 1)^3. A configuration gives the count, the side of the cube and
that 0.1 as `triangle_count`, `cube_side` and `vertex_offset`; one that
holds more triangles than the source widens the cube so that the
triangles per unit of volume stay the source's."""

from __future__ import annotations

import numpy as np


def minimal_soup(n: int, seed: int, cube_side: float = 1.0,
                 vertex_offset: float = 0.1) -> np.ndarray:
    """(N, 3, 3) float32: tiny_bvh_minimal.cpp's random small triangles,
    v0 uniform in [0, cube_side)^3 and v1, v2 at v0 + vertex_offset *
    U[0, 1)^3."""
    rng = np.random.default_rng(seed)
    v0 = rng.random((n, 1, 3), dtype=np.float32) * np.float32(cube_side)
    offs = rng.random((n, 2, 3), dtype=np.float32) * np.float32(
        vertex_offset)
    return np.concatenate([v0, v0 + offs], axis=1)


def make_scene(config: dict, seed: int) -> np.ndarray:
    """The (N, 3, 3) float32 triangles of a configuration, from the
    seed."""
    if config["scene"] != "minimal_soup":
        raise ValueError(f"unknown scene {config['scene']!r}")
    return minimal_soup(int(config["triangle_count"]), seed,
                        float(config["cube_side"]),
                        float(config["vertex_offset"]))
