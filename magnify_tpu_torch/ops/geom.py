"""Geometry: the disk rasterization table of the host mask code, the
perimeter tables of the RANSAC scorer, batched ROI windows and plane
rotation on a device.

A filled Bresenham disk is exactly ``{(dy, dx): |dy| <= r, |dx| <= ext_r[|dy|]}``,
so the ownership masks of :mod:`magnify_tpu_torch.components.find` rasterize
with one table lookup and a compare. Numpy code copied from
``magnify_tpu.ops.geom.extent_lut``; the table is array-equal to the JAX
package's, and so are :func:`perimeter_tables`'. :func:`extract_rois` and
:func:`rotate_plane` are the torch counterparts of the JAX package's
functions of the same names.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from magnify_tpu_torch import utils

__all__ = ["extent_lut", "extract_rois", "perimeter_tables", "rotate_plane"]


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


@functools.lru_cache(maxsize=None)
def perimeter_tables(max_radius: int):
    """Padded Bresenham perimeter offsets for every radius up to max_radius.

    Returns (offsets (max_radius + 1, L, 2) int32, padded rows repeat
    offset 0; lengths (max_radius + 1,) int32, the true perimeter lengths;
    expected (max_radius + 1, L) float32, numpy's ``arctan2(row, col)`` of
    each offset rounded to f32: the radial direction the roundness score
    compares the gradient angle with).
    """
    tables = [utils.circle_points(r) for r in range(max_radius + 1)]
    lengths = np.array([len(t) for t in tables], dtype=np.int32)
    offsets = np.zeros((max_radius + 1, int(lengths.max()), 2), np.int32)
    for r, t in enumerate(tables):
        offsets[r, : len(t)] = t
    expected = np.arctan2(offsets[..., 0], offsets[..., 1]).astype(np.float32)
    return offsets, lengths, expected


def extract_rois(image: torch.Tensor, tops: torch.Tensor, lefts: torch.Tensor,
                 roi_length: int) -> torch.Tensor:
    """Fixed-size ROI windows as one gather: image (..., H, W) -> (N, ..., L,
    L), window k at (tops[k], lefts[k]). The windows must lie inside the
    image (the caller clamps the corners)."""
    span = torch.arange(roi_length, device=image.device)
    rows = (tops.to(torch.int64)[:, None] + span)[:, :, None]   # (N, L, 1)
    cols = (lefts.to(torch.int64)[:, None] + span)[:, None, :]  # (N, 1, L)
    return image[..., rows, cols].movedim(-3, 0)


def rotate_plane(image: torch.Tensor, degrees: float) -> torch.Tensor:
    """Rotate a 2-D plane about its center (bilinear, zero fill); the output
    keeps the input's shape and is float32. f32 arithmetic in the order of
    ``magnify_tpu.ops.geom.rotate_plane``; sin and cos come from another
    library, so the two agree to a few f32 ulps of the pixel range, not bit
    for bit."""
    h, w = image.shape
    dev = image.device
    theta = np.float32(degrees) * np.float32(np.pi / 180.0)
    cos_t, sin_t = float(np.cos(theta)), float(np.sin(theta))
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    rows = torch.arange(h, dtype=torch.float32, device=dev)[:, None] - cy
    cols = torch.arange(w, dtype=torch.float32, device=dev)[None, :] - cx
    # Inverse mapping: output pixel <- input coordinates.
    src_r = cos_t * rows + sin_t * cols + cy
    src_c = -sin_t * rows + cos_t * cols + cx
    r0, c0 = torch.floor(src_r), torch.floor(src_c)
    fr, fc = src_r - r0, src_c - c0
    img = image.to(torch.float32)

    def sample(rr, cc):
        inside = (rr >= 0) & (rr < h) & (cc >= 0) & (cc < w)
        ri = rr.clamp(0, h - 1).to(torch.int64)
        ci = cc.clamp(0, w - 1).to(torch.int64)
        return torch.where(inside, img[ri, ci], 0.0)

    return (sample(r0, c0) * (1 - fr) * (1 - fc)
            + sample(r0, c0 + 1) * (1 - fr) * fc
            + sample(r0 + 1, c0) * fr * (1 - fc)
            + sample(r0 + 1, c0 + 1) * fr * fc)
