"""Geometry: the disk rasterization table of the bead ownership masks, the
masks themselves on a device, the perimeter tables of the RANSAC scorer,
batched ROI windows and plane rotation on a device.

A filled Bresenham disk is exactly ``{(dy, dx): |dy| <= r, |dx| <= ext_r[|dy|]}``,
so the ownership masks of :mod:`magnify_tpu_torch.components.find` rasterize
with one table lookup and a compare. Numpy code copied from
``magnify_tpu.ops.geom.extent_lut``; the table is array-equal to the JAX
package's, and so are :func:`perimeter_tables`'. :func:`bead_ownership`
makes the masks with the CUDA kernel ``csrc/bead_ownership.cu`` on a card
and with the JAX package's numpy pass on the CPU.
:func:`extract_rois` and :func:`rotate_plane` are the torch counterparts of
the JAX package's functions of the same names.
"""

from __future__ import annotations

import functools

import numpy as np
import scipy.spatial
import torch

from magnify_tpu_torch import _build, diagnostics, utils

__all__ = ["bead_ownership", "bead_ownership_launches", "extent_lut",
           "extract_rois", "perimeter_tables", "rotate_plane"]

#: Kernel launches of :func:`bead_ownership` since the count was last reset
#: (one a call on at least one mark).
bead_ownership_launches = 0

# Budget for the CPU branch's (pairs, L, L) ownership temporaries.
_PAIR_CHUNK_BYTES = 32 << 20


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


@functools.lru_cache(maxsize=None)
def _extent_tensor(max_radius: int, device: torch.device) -> torch.Tensor:
    """:func:`extent_lut` on ``device``, copied there once."""
    return torch.as_tensor(extent_lut(max_radius), device=device)


def _bead_ownership_host(beads, tops, lefts, roi_length, max_radius):
    """The CPU branch of :func:`bead_ownership`, numpy code copied from
    ``magnify_tpu.components.find._bead_ownership_host``: a KD-tree finds
    the marks whose disks can reach each window, and each (window, mark)
    pair is rasterized into (pairs, L, L) covers summed per window. Returns
    the (2, n, L, L) uint8 masks."""
    n = len(beads)
    L = roi_length
    lut = extent_lut(max_radius)
    out = np.zeros((2, n, L, L), np.uint8)
    fg = out[0].view(bool)
    count = np.zeros((n, L, L), np.int16)
    if n == 0:
        return out

    # Neighbor lists: beads whose disks can reach a window (Chebyshev
    # distance from bead center to window center <= L/2 + max_radius).
    tree = scipy.spatial.KDTree(beads[:, :2])
    win_centers = np.stack([tops + L // 2, lefts + L // 2], axis=1)
    neighbor_lists = tree.query_ball_point(
        win_centers, L / 2 + max_radius + 1, p=np.inf)

    arange_l = np.arange(L)
    pairs_i = np.concatenate(
        [np.full(len(nb), i, np.int64) for i, nb in enumerate(neighbor_lists)]
    )
    pairs_j = np.concatenate(
        [np.asarray(nb, np.int64) for nb in neighbor_lists]
    )
    chunk = max(1, _PAIR_CHUNK_BYTES // max(L * L, 1))
    for s in range(0, len(pairs_i), chunk):
        pi = pairs_i[s:s + chunk]
        pj = pairs_j[s:s + chunk]
        r = np.clip(beads[pj, 2].astype(np.int64), 0, max_radius)
        dr = np.abs(tops[pi, None] + arange_l[None, :] - beads[pj, 0][:, None])
        width = np.where(dr <= r[:, None],
                         lut[r[:, None], np.minimum(dr, max_radius)], -1)
        dc = np.abs(lefts[pi, None] + arange_l[None, :]
                    - beads[pj, 1][:, None])
        cover = dc[:, None, :] <= width[:, :, None]  # (P, L, L)
        # pairs_i ascends, so each window's pairs form a contiguous run.
        ui, starts = np.unique(pi, return_index=True)
        count[ui] += np.add.reduceat(cover.astype(np.int16), starts, axis=0)
        self_rows = pi == pj
        fg[pi[self_rows]] = cover[self_rows]

    fg &= count == 1
    np.equal(count, 0, out=out[1].view(bool))
    return out


def bead_ownership(marks: torch.Tensor, tops: torch.Tensor,
                   lefts: torch.Tensor, roi_length: int,
                   max_radius: int) -> torch.Tensor:
    """Ownership masks of the beads' ROI windows: (2, n, L, L) uint8, fg
    then bg, for ``marks`` (n, 3) int32 (row, col, radius) and the windows'
    corners ``tops``, ``lefts`` (n,) int32, on the marks' device. A mark
    covers the pixels of its Bresenham disk (:func:`extent_lut`) at its
    radius clamped to [0, ``max_radius``]; fg is where the window's own
    mark alone covers a pixel, bg where no mark of the n does. Bit for bit
    the masks of ``magnify_tpu.components.find._bead_ownership_host``.

    The one place that picks the route, by the tensors' device. CUDA
    tensors take the kernel (``csrc/bead_ownership.cu``): one launch on the
    current stream, none for n = 0, no host sync (the extent table is
    copied to the card once per radius and card); the windows are counted
    in ``ownership_device_windows``. CPU tensors take the host's numpy
    pass, counted in ``ownership_host_windows``."""
    global bead_ownership_launches
    for name, t, shape in (("marks", marks, (marks.shape[0], 3)),
                           ("tops", tops, (marks.shape[0],)),
                           ("lefts", lefts, (marks.shape[0],))):
        if t.dtype != torch.int32:
            raise TypeError(f"bead_ownership: int32 {name} required, got "
                            f"{t.dtype}")
        if tuple(t.shape) != shape or t.device != marks.device:
            raise ValueError(f"bead_ownership: {name} of shape "
                             f"{tuple(t.shape)} on {t.device}; {shape} on "
                             f"{marks.device} required")
    if not 1 <= roi_length < 32768 or max_radius < 0:
        raise ValueError(f"bead_ownership: roi_length {roi_length}, "
                         f"max_radius {max_radius}; 1 <= roi_length < "
                         "32,768 and max_radius >= 0 required")
    n = marks.shape[0]
    if marks.device.type == "cpu":
        diagnostics.count("ownership_host_windows", n)
        return torch.from_numpy(_bead_ownership_host(
            marks.numpy(), tops.numpy(), lefts.numpy(), roi_length,
            max_radius))
    if marks.device.type != "cuda":
        raise ValueError(f"bead_ownership: tensors on {marks.device}; a "
                         "CUDA device (or the CPU) required")
    if not (marks.is_contiguous() and tops.is_contiguous()
            and lefts.is_contiguous()):
        raise ValueError("bead_ownership: contiguous tensors required")
    if n >= 2**30:
        raise ValueError(f"bead_ownership: {n} marks; under 2^30 required")
    out = torch.empty((2, n, roi_length, roi_length), dtype=torch.uint8,
                      device=marks.device)
    diagnostics.count("ownership_device_windows", n)
    if n == 0:
        return out
    lut = _extent_tensor(max_radius, marks.device)
    with torch.cuda.device(marks.device):  # the launch goes to its card
        err = _build.load().mg_bead_ownership(
            marks.data_ptr(), tops.data_ptr(), lefts.data_ptr(),
            lut.data_ptr(), n, roi_length, max_radius, out.data_ptr(),
            torch.cuda.current_stream(marks.device).cuda_stream)
    bead_ownership_launches += 1
    _build.check(err, "mg_bead_ownership")
    return out


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
