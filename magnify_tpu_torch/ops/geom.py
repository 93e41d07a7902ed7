"""Disk rasterization table shared by the host mask code.

A filled Bresenham disk is exactly ``{(dy, dx): |dy| <= r, |dx| <= ext_r[|dy|]}``,
so the ownership masks of :mod:`magnify_tpu_torch.components.find` rasterize
with one table lookup and a compare. Numpy code copied from
``magnify_tpu.ops.geom.extent_lut``; the table is array-equal to the JAX
package's.
"""

from __future__ import annotations

import functools

import numpy as np

from magnify_tpu_torch import utils

__all__ = ["extent_lut"]


@functools.lru_cache(maxsize=None)
def extent_lut(max_radius: int) -> np.ndarray:
    """EXT[r, a] = half-width of the radius-r Bresenham disk in row ±a.

    Entries with a > r are -1 (empty row), so a plain compare produces the
    mask without branching. Shape (max_radius + 1, max_radius + 1), int32.
    """
    lut = -np.ones((max_radius + 1, max_radius + 1), dtype=np.int32)
    for r in range(max_radius + 1):
        lut[r, : r + 1] = utils.disk_extents(r)
    return lut
