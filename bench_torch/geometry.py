"""Bresenham disks, written out plainly for the generators and the
reference (magnify's scanline fill: the disk of radius ``r`` is every
(row, col) with |row| <= r and |col| <= the widest perimeter column of
that row)."""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=None)
def perimeter(r: int) -> np.ndarray:
    """(n, 2) int64 (row, col) offsets of the 8-connected Bresenham circle
    of radius ``r``."""
    r = int(r)
    if r == 0:
        return np.zeros((1, 2), np.int64)
    pts = {(0, -r), (-r, 0), (0, r), (r, 0)}
    a, b = 1, -r
    while a < -b:
        for p, q in ((a, b), (b, a), (-a, b), (-b, a), (a, -b), (b, -a),
                     (-a, -b), (-b, -a)):
            pts.add((p, q))
        if a * a + b * b > r * r:
            b += 1
        a += 1
    if b == -a:
        pts |= {(a, -a), (-a, a), (-a, -a), (a, a)}
    return np.array(sorted(pts), np.int64)


@functools.lru_cache(maxsize=None)
def extents(r: int) -> np.ndarray:
    """``ext[a]``: half-width of the filled disk of radius ``r`` in rows
    ±a."""
    pts = perimeter(r)
    ext = np.zeros(int(r) + 1, np.int64)
    np.maximum.at(ext, np.abs(pts[:, 0]), np.abs(pts[:, 1]))
    return ext


@functools.lru_cache(maxsize=None)
def disk(r: int) -> np.ndarray:
    """(n, 2) int64 (row, col) offsets of the filled disk of radius
    ``r``."""
    ext = extents(r)
    rows = [(dy, dx) for dy in range(-r, r + 1)
            for dx in range(-ext[abs(dy)], ext[abs(dy)] + 1)]
    return np.array(rows, np.int64)


def disk_mask(side: int, cy: np.ndarray, cx: np.ndarray,
              r: np.ndarray) -> np.ndarray:
    """(n, side, side) bool: the disk of radius ``r[i]`` centred at
    (``cy[i]``, ``cx[i]``) in window coordinates (a centre may lie
    outside the window)."""
    cy, cx, r = (np.asarray(v, np.int64).reshape(-1) for v in (cy, cx, r))
    out = np.zeros((len(r), side, side), bool)
    ar = np.arange(side)
    for rad in np.unique(r):
        idx = np.nonzero(r == rad)[0]
        ext = extents(int(rad))
        dy = np.abs(ar[None, :] - cy[idx, None])
        width = np.where(dy <= rad, ext[np.minimum(dy, rad)], -1)
        dx = np.abs(ar[None, None, :] - cx[idx, None, None])
        out[idx] = dx <= width[:, :, None]
    return out


def window_corner(center: np.ndarray, side: int, size: int) -> np.ndarray:
    """Top (or left) of a ``side`` window around integer ``center``,
    slid, never shrunk, to stay inside ``size``."""
    return np.clip(np.asarray(center, np.int64) - side // 2, 0, size - side)


def paint(img: np.ndarray, cy, cx, r, value) -> None:
    """Set the disks of radius ``r`` at (``cy``, ``cx``) in the 2-D
    ``img`` to ``value`` (per disk), clipped to the image."""
    cy, cx, r = (np.asarray(v, np.int64).reshape(-1) for v in (cy, cx, r))
    value = np.broadcast_to(np.asarray(value), cy.shape)
    h, w = img.shape
    for rad in np.unique(r):
        idx = np.nonzero(r == rad)[0]
        off = disk(int(rad))
        ys = cy[idx, None] + off[None, :, 0]
        xs = cx[idx, None] + off[None, :, 1]
        vals = np.broadcast_to(value[idx, None], ys.shape)
        ok = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
        img[ys[ok], xs[ok]] = vals[ok]


def placed_mismatch(a: np.ndarray, b: np.ndarray, dy, dx) -> int:
    """Pixels in one mask and not the other, over all ``n`` pairs of
    (n, L, L) window masks ``a`` and ``b``, where window ``b[i]`` lies
    ``dy[i]`` rows and ``dx[i]`` columns from window ``a[i]`` in the image:
    the masks compared where they lie, so that a window placed a pixel
    off counts as unlike even where its mask is the same."""
    n, side = a.shape[0], a.shape[-1]
    dy = np.broadcast_to(np.asarray(dy, np.int64), (n,))
    dx = np.broadcast_to(np.asarray(dx, np.int64), (n,))
    total = int(a.sum()) + int(b.sum())
    same = (dy == 0) & (dx == 0)
    overlap = int((a[same] & b[same]).sum())
    for i in np.nonzero(~same)[0]:
        y, x = int(dy[i]), int(dx[i])
        if abs(y) >= side or abs(x) >= side:
            continue
        overlap += int((a[i, max(y, 0):side + min(y, 0),
                          max(x, 0):side + min(x, 0)]
                        & b[i, max(-y, 0):side + min(-y, 0),
                            max(-x, 0):side + min(-x, 0)]).sum())
    return total - 2 * overlap
