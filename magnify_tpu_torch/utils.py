"""Host-side utilities: rasterization tables, bounding boxes, misc helpers.

The circle rasterization here is the framework's geometry contract. The
reference generates circle perimeters with a Bresenham walk and fills disks by
per-row scanline fill (magnify/utils.py:398-465); its test
suite draws synthetic fixtures with ``filled_circle_points``, making the exact
pixel sets part of the public contract. This module reproduces those pixel
sets from a closed-form octant walk and derives per-row extent tables
(``disk_extents``) that the ops layer uses to rasterize foreground/
background masks on device with a single gather + compare instead of point
scatters.
"""

from __future__ import annotations

import functools
import inspect
import os
import re
from collections.abc import Callable, Iterable
from typing import Any

import numpy as np

PathLike = str | bytes | os.PathLike

__all__ = [
    "PathLike",
    "annulus",
    "bounding_box",
    "ceildiv",
    "circle",
    "circle_points",
    "disk_extents",
    "filled_circle_points",
    "natural_sort_key",
    "to_list",
    "to_uint8",
    "valid_kwargs",
]


def ceildiv(a: int, b: int) -> int:
    return -(a // -b)


def to_uint8(arr: np.ndarray) -> np.ndarray:
    """Min-max normalize an array into the uint8 range.

    Matches the normalization applied before detection in the reference
    (magnify/utils.py:20-27), including truncation on the
    final cast.
    """
    arr = np.asarray(arr)
    if arr.size == 0:
        return arr.astype(np.uint8)
    arr = arr.astype(float)
    arr = arr - arr.min()
    peak = arr.max()
    if peak > 0:
        arr = 255 * arr / peak
    return arr.astype(np.uint8)


def to_list(x: Any) -> list:
    if x is None:
        return []
    if isinstance(x, str) or not isinstance(x, Iterable):
        return [x]
    return list(x)


def valid_kwargs(kwargs: dict[str, Any], func: Callable) -> dict[str, Any]:
    names = set(inspect.signature(func).parameters)
    return {k: v for k, v in kwargs.items() if k in names}


def natural_sort_key(s: str) -> list:
    return [int(part) if part.isdigit() else part.lower()
            for part in re.split(r"([0-9]+)", s)]


def bounding_box(
    x: int, y: int, box_length: int, image_width: int, image_height: int
) -> tuple[int, int, int, int]:
    """A ``box_length`` window around (x, y), shifted (never shrunk) at borders.

    Same clamping semantics as magnify/utils.py:60-80: the
    window keeps its full size by sliding inward when it would cross an image
    edge, so every ROI has identical static shape — which is exactly what the
    batched ROI gather requires.
    """
    half = box_length // 2
    other_half = ceildiv(box_length, 2)
    top, bottom = y - half, y + other_half
    if top < 0:
        bottom -= top
        top = 0
    if bottom > image_height:
        top -= bottom - image_height
        bottom = image_height
    left, right = x - half, x + other_half
    if left < 0:
        right -= left
        left = 0
    if right > image_width:
        left -= right - image_width
        right = image_width
    return top, bottom, left, right


# ---------------------------------------------------------------------------
# Circle rasterization
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _octant_arc(r: int, four_connected: bool) -> tuple:
    """Walk the first octant of a Bresenham circle of radius ``r``.

    Returns the strictly-interior arc points (a, b) with 0 < a < -b < r
    ... i.e. points between the axis and the diagonal, as (col, row) pairs
    (col > 0, row < 0, col < -row), plus a flag for whether the walk ended
    exactly on the diagonal.
    """
    pts = []
    a, b = 1, -r
    while a < -b:
        pts.append((a, b))
        if a * a + b * b > r * r:
            b += 1
            if four_connected:
                continue  # move up only; revisit same column
        a += 1
    on_diagonal = (b == -a)
    return tuple(pts), on_diagonal


@functools.lru_cache(maxsize=None)
def _circle_points_cached(r: int, four_connected: bool) -> np.ndarray:
    if r == 0:
        return np.zeros((1, 2), dtype=np.int32)
    arc, on_diagonal = _octant_arc(r, four_connected)
    out = [np.array([[0, -r], [-r, 0], [0, r], [r, 0]], dtype=np.int32)]
    if arc:
        ab = np.asarray(arc, dtype=np.int32)
        a, b = ab[:, 0], ab[:, 1]
        # 8-way symmetry: (±a, b), (±a, -b), (b, ±a), (-b, ±a) as (row, col).
        out.append(np.stack([a, b], axis=1))
        out.append(np.stack([b, a], axis=1))
        out.append(np.stack([-a, b], axis=1))
        out.append(np.stack([-b, a], axis=1))
        out.append(np.stack([a, -b], axis=1))
        out.append(np.stack([b, -a], axis=1))
        out.append(np.stack([-a, -b], axis=1))
        out.append(np.stack([-b, -a], axis=1))
    if on_diagonal:
        # The walk ended exactly on the diagonal (d, -d): add its 4 mirrors.
        a, b = 1, -r
        while a < -b:
            if a * a + b * b > r * r:
                b += 1
                if four_connected:
                    continue
            a += 1
        d = a
        out.append(np.array([[d, -d], [-d, d], [-d, -d], [d, d]], dtype=np.int32))
    pts = np.concatenate(out, axis=0)
    return pts


def circle_points(r: int, four_connected: bool = False) -> np.ndarray:
    """Integer (row, col) offsets of a Bresenham circle perimeter of radius r.

    Pixel-set compatible with magnify/utils.py:433-465.
    ``four_connected=True`` yields a 4-connected perimeter (no diagonal
    steps), used for NMS exclusion zones.
    """
    return _circle_points_cached(int(r), bool(four_connected)).copy()


@functools.lru_cache(maxsize=None)
def disk_extents(r: int) -> np.ndarray:
    """Per-row half-width of the filled Bresenham disk of radius ``r``.

    ``ext[a]`` is the maximum |col| of the perimeter in row ±a; the filled
    disk is exactly {(row, col): |row| <= r, |col| <= ext[|row|]}. This is the
    closed form the device kernels use to rasterize fg/bg masks.
    """
    pts = _circle_points_cached(int(r), False)
    ext = np.zeros(int(r) + 1, dtype=np.int32)
    rows = np.abs(pts[:, 0])
    cols = np.abs(pts[:, 1])
    np.maximum.at(ext, rows, cols)
    return ext


def filled_circle_points(r: int) -> np.ndarray:
    """Integer (row, col) offsets of the filled Bresenham disk of radius r.

    Pixel-set compatible with the reference's scanline fill
    (magnify/utils.py:398-430); ordering is perimeter
    points first, then interior points row by row.
    """
    r = int(r)
    perimeter = _circle_points_cached(r, False)
    ext = disk_extents(r)
    interior = []
    per_row_max = np.full(2 * r + 1, -1, dtype=np.int64)
    # Perimeter cols per row, to exclude them from the interior listing.
    row_sets: dict[int, set] = {}
    for row, col in perimeter:
        row_sets.setdefault(int(row), set()).add(int(col))
    for row in range(-r, r + 1):
        width = int(ext[abs(row)])
        cols = row_sets.get(row, set())
        for col in range(-width, width + 1):
            if col not in cols:
                interior.append((row, col))
    if interior:
        return np.concatenate(
            [perimeter, np.asarray(interior, dtype=np.int32)], axis=0
        )
    return perimeter.copy()


def circle(
    image_shape: tuple[int, int],
    center: tuple[int, int],
    radius: int,
    value: Any = 1,
    thickness: int = -1,
) -> np.ndarray:
    """Rasterize a circle mask into an image.

    ``center`` is (row, col). ``thickness=-1`` fills the disk; ``1`` draws
    the Bresenham perimeter; ``t > 1`` draws a stroke band of exactly ``t``
    filled radii, ``radius - (t-1)//2 .. radius + t//2`` (an annulus whose
    width matches cv.circle's ``t``-px stroke). Replaces the reference's
    ``cv.circle`` call (magnify/utils.py:30-40) with
    the framework's own Bresenham-extent rasterization so fg/bg masks match
    the fixture geometry exactly. cv.circle's thick strokes rasterize
    octant polylines, so the band deviates from OpenCV by ~1 px at the
    stroke edges (same coverage and pixel count to within a few percent;
    no reference caller passes thickness > 1).
    """
    image = np.zeros(image_shape, dtype=np.uint8)
    radius = int(radius)
    if radius >= 0:
        if thickness == -1 or thickness > 1:

            def filled(r):
                if r < 0:
                    return np.zeros(image_shape, dtype=bool)
                ext = disk_extents(r)
                rows = np.arange(image_shape[0]) - center[0]
                cols = np.arange(image_shape[1]) - center[1]
                in_rows = np.abs(rows) <= r
                width = np.where(in_rows, ext[np.minimum(np.abs(rows), r)],
                                 -1)
                return np.abs(cols)[None, :] <= width[:, None]

            if thickness == -1:
                image = filled(radius).astype(np.uint8)
            else:
                t = int(thickness)
                # Exactly t radii: r - (t-1)//2 .. r + t//2 (a centered
                # band, outward-biased for even t like cv.circle's stroke;
                # the previous ceil(t/2)-both-ways band drew t+1 or t+2
                # radii — ~50% more pixels than cv.circle at t=2).
                image = (filled(radius + t // 2)
                         & ~filled(radius - (t - 1) // 2 - 1)).astype(
                             np.uint8)
        else:
            pts = circle_points(radius) + np.asarray(center, dtype=np.int32)
            ok = (
                (pts[:, 0] >= 0) & (pts[:, 0] < image_shape[0])
                & (pts[:, 1] >= 0) & (pts[:, 1] < image_shape[1])
            )
            image[pts[ok, 0], pts[ok, 1]] = 1
    return image.astype(type(value)) * value


def disk_masks(
    image_shape: tuple[int, int],
    centers: np.ndarray,
    radii: np.ndarray,
) -> np.ndarray:
    """(N, H, W) filled-disk bool masks, vectorized over markers.

    Bit-identical per row to ``circle(image_shape, center, r, thickness=-1)``
    (the same Bresenham extent-LUT formula), but grouped by unique radius
    and evaluated as whole-array ops — the chip path rasterizes hundreds of
    chamber masks per timestep, and the per-mask Python loop was the
    largest host cost after the relay pull.
    """
    centers = np.asarray(centers, np.int64).reshape(-1, 2)
    radii = np.asarray(radii, np.int64).reshape(-1)
    h, w = image_shape
    n = centers.shape[0]
    out = np.zeros((n, h, w), bool)
    row_off = np.arange(h, dtype=np.int64)
    col_off = np.arange(w, dtype=np.int64)
    for r in np.unique(radii):
        if r < 0:
            continue
        idx = np.nonzero(radii == r)[0]
        ext = disk_extents(int(r))
        rows = np.abs(row_off[None, :] - centers[idx, 0][:, None])  # (K, H)
        width = np.where(rows <= r, ext[np.minimum(rows, r)], -1)
        cols = np.abs(col_off[None, None, :]
                      - centers[idx, 1][:, None, None])             # (K,1,W)
        out[idx] = cols <= width[:, :, None]
    return out


def annulus_masks(
    image_shape: tuple[int, int],
    centers: np.ndarray,
    outer_radius: int,
    inner_radius: int,
) -> np.ndarray:
    """(N, H, W) annulus bool masks (outer disk & ~inner disk), vectorized
    over markers; per row identical to :func:`annulus`."""
    centers = np.asarray(centers, np.int64).reshape(-1, 2)
    n = centers.shape[0]
    outer = disk_masks(image_shape, centers,
                       np.full(n, outer_radius, np.int64))
    inner = disk_masks(image_shape, centers,
                       np.full(n, inner_radius, np.int64))
    return outer & ~inner


def annulus(
    image_shape: tuple[int, int],
    center: tuple[int, int],
    outer_radius: int,
    inner_radius: int,
    value: Any = 1.0,
) -> np.ndarray:
    # Build the ring as a boolean mask first: float values have no "&"
    # operator (the reference's outer & ~inner raises for its own default
    # value=1.0), so scale by value only at the end.
    outer = circle(image_shape, center, outer_radius, True)
    inner = circle(image_shape, center, inner_radius, True)
    return (outer & ~inner).astype(type(value)) * value
