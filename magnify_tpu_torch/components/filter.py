"""Marker QC filters: ``filter_expression``, ``filter_nonround``,
``filter_leaky``.

Port of ``magnify_tpu.components.filter``. Registered but not part of any
default pipeline; users attach them with ``pipe.add_pipe(...)``. The masked
fg/bg medians reduce on ``device`` (default ``"cuda"``; ``"cpu"`` takes the
numpy twins of :mod:`magnify_tpu_torch.ops.reduce`); the contour tracing of
``filter_nonround`` is host code copied from the JAX package.
"""

from __future__ import annotations


import numpy as np

from magnify_tpu_torch import utils
from magnify_tpu_torch.core.registry import component
from magnify_tpu_torch.ops.reduce import masked_median

__all__ = ["filter_expression", "filter_nonround", "filter_leaky_buttons"]


def _search_channels(assay, search_channel):
    if search_channel is None:
        return list(assay["channel"].values.tolist()) if "channel" in assay.coords \
            else list(range(assay.sizes["channel"]))
    return utils.to_list(search_channel)


def _fg_bg_medians(assay, channel, device):
    sub = assay.roi.isel(time=0).sel(channel=channel)
    vals = sub.to_numpy()
    fg = assay["fg"].isel(time=0).to_numpy()
    bg = assay["bg"].isel(time=0).to_numpy()
    return (masked_median(vals, fg, device=device),
            masked_median(vals, bg, device=device))


def _bg_sigma_bound(bg: np.ndarray, mult: float) -> float:
    """Std of all pairwise off-diagonal background differences, scaled.

    The auto contrast threshold is ``mult`` times the standard deviation
    of bg_i - bg_j over all i != j.
    """
    diffs = bg[:, None] - bg[None, :]
    offdiag = ~np.eye(len(bg), dtype=bool)
    return mult * diffs[offdiag].std()


@component("filter_expression")
def filter_expression(assay, search_channel=None, min_contrast=None,
                      device="cuda"):
    """Mark valid only where fg median exceeds bg median by a contrast bound
    (auto: 4 sigma of pairwise bg differences)."""
    channels = _search_channels(assay, search_channel)
    valid_dims = assay["valid"].dims
    acc = np.zeros(assay["valid"].shape, bool)
    for channel in channels:
        fg_med, bg_med = _fg_bg_medians(assay, channel, device)
        if min_contrast is None:
            upper = _bg_sigma_bound(bg_med.flatten(), 4.0)
        else:
            upper = min_contrast
        ok = fg_med - bg_med > upper  # (mark,)
        acc |= ok.reshape(ok.shape + (1,) * (len(valid_dims) - ok.ndim))
    assay["valid"] = (valid_dims, assay["valid"].to_numpy() & acc)
    return assay


# Clockwise 8-neighborhood for Moore boundary tracing, (drow, dcol).
_MOORE = ((-1, 0), (-1, 1), (0, 1), (1, 1),
          (1, 0), (1, -1), (0, -1), (-1, -1))


def _trace_outer_border(mask: np.ndarray, start: tuple) -> float:
    """Closed length of the 8-connected outer border cycle from ``start``
    (the component's topmost-leftmost pixel): Moore-neighbor tracing with
    state-repeat termination; steps weigh 1 (axial) / sqrt(2) (diagonal),
    exactly ``cv.arcLength(contour, True)`` on the traced border."""
    r0, c0 = start
    h, w = mask.shape

    def nb(pix, k):
        return (pix[0] + _MOORE[k][0], pix[1] + _MOORE[k][1])

    def fg(pix):
        return 0 <= pix[0] < h and 0 <= pix[1] < w and mask[pix]

    cur = (r0, c0)
    back = 6  # came from the W neighbor (background: start is row-major first)
    pts = []
    seen = {}
    while (cur, back) not in seen:
        seen[(cur, back)] = len(pts)
        pts.append(cur)
        for j in range(1, 9):
            k = (back + j) % 8
            if fg(nb(cur, k)):
                cur, back = nb(cur, k), (k + 4 + 1) % 8
                break
        else:
            return 0.0  # isolated pixel: cv contour of length 0
    # The walk is eventually periodic in (pixel, backtrack) state space;
    # exactly one period (from the repeated state's first occurrence to the
    # end) is the closed border cycle.
    cycle = pts[seen[(cur, back)]:]
    total = 0.0
    for a, b in zip(cycle, cycle[1:] + cycle[:1]):
        total += 1.0 if (a[0] == b[0] or a[1] == b[1]) else np.sqrt(2.0)
    return total


def _contour_perimeters(fg: np.ndarray) -> np.ndarray:
    """Per-mark external contour length of the fg masks.

    Uses OpenCV contour tracing when OpenCV is installed (as the JAX
    package does); otherwise a Moore-neighbor outer border trace per
    connected component: the same 8-connected border cycle OpenCV's border
    following walks, with the same axial/diagonal step weights.
    """
    n = fg.shape[0]
    out = np.zeros(n)
    try:
        import cv2 as cv

        for i in range(n):
            mask = (fg[i] > 0).astype(np.uint8) * 255
            contours, _ = cv.findContours(mask, cv.RETR_EXTERNAL,
                                          cv.CHAIN_APPROX_SIMPLE)
            out[i] = sum(cv.arcLength(c, True) for c in contours)
        return out
    except ImportError:
        pass
    import scipy.ndimage

    eight = np.ones((3, 3), int)
    for i in range(n):
        mask = fg[i] > 0
        labels, n_comp = scipy.ndimage.label(mask, structure=eight)
        # RETR_EXTERNAL keeps only outermost contours: a component nested
        # inside another component's hole is omitted entirely. A component
        # is outermost iff it is 8-adjacent to background 4-connected to
        # the image border (background is the 4-connected dual of the
        # 8-connected foreground); pad so the border region always exists.
        outer_bg = np.zeros_like(mask)
        if mask.any():
            bg_lab, _ = scipy.ndimage.label(np.pad(~mask, 1,
                                                   constant_values=True))
            outer_bg = (bg_lab == bg_lab[0, 0])[1:-1, 1:-1]
        near_outer = scipy.ndimage.binary_dilation(outer_bg, structure=eight)
        external = set(np.unique(labels[near_outer & mask])) - {0}
        total = 0.0
        for comp in external:
            rows, cols = np.nonzero(labels == comp)
            j = np.lexsort((cols, rows))[0]  # topmost, then leftmost
            total += _trace_outer_border(labels == comp, (rows[j], cols[j]))
        out[i] = total
    return out


@component("filter_nonround")
def filter_nonround(assay, min_roundness=0.75, search_channel=None):
    """Invalidate marks whose fg mask roundness = 4*pi*A/P^2 falls at or
    below ``min_roundness``."""
    valid = assay["valid"].to_numpy().copy()
    fg = assay["fg"].isel(time=0).to_numpy()
    areas = fg.reshape(fg.shape[0], -1).sum(-1)
    perimeters = _contour_perimeters(fg)
    ok = np.zeros(fg.shape[0], bool)
    nonzero = perimeters > 0
    ok[nonzero] = (4 * np.pi * areas[nonzero] / perimeters[nonzero] ** 2
                   > min_roundness)
    valid &= ok.reshape(ok.shape + (1,) * (valid.ndim - ok.ndim))
    assay["valid"] = (assay["valid"].dims, valid)
    return assay


@component("filter_leaky")
def filter_leaky_buttons(assay, search_channel=None, device="cuda"):
    """Invalidate buttons whose neighboring blank chambers express above
    5 sigma of pairwise bg differences."""
    channels = _search_channels(assay, search_channel)
    tag = assay["tag"].to_numpy()
    valid = assay["valid"].to_numpy().copy()
    rows = assay["mark_row"].to_numpy()
    n_marks = assay.sizes["mark"]
    for channel in channels:
        fg_med, bg_med = _fg_bg_medians(assay, channel, device)
        upper = _bg_sigma_bound(bg_med.flatten(), 5.0)
        empty = (fg_med - bg_med) < upper
        for i in range(n_marks):
            if tag[i] == "":
                continue
            if rows[i] > 0 and tag[i - 1] == "":
                valid[i] &= empty[i - 1]
            if rows[i] < rows.max() and i + 1 < n_marks and tag[i + 1] == "":
                valid[i] &= empty[i + 1]
    assay["valid"] = (assay["valid"].dims, valid)
    return assay
