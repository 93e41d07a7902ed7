"""Dense circle detection on one device: the dense detector's whole path.

    edge stack -> int8 ring-correlation score maps -> bound filters ->
    roundness threshold -> survivors in (-score, index) order -> greedy NMS

Torch port of ``magnify_tpu.ops.detect``'s dense path
(``_dense_candidates`` and ``_stage_dense_full``) plus the host uint8
normalization ``normalize_planes_u8``. The JAX package sizes its survivor
buffers with a memoized static cap and a grow-retry (a jit needs static
shapes); eager torch takes the survivors with ``torch.nonzero``, so there
is no cap to grow and the result equals the JAX result at an adequate cap.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from magnify_tpu_torch.ops.edge import edge_pipeline
from magnify_tpu_torch.ops.nms import parallel_greedy_nms
from magnify_tpu_torch.ops.score import score_maps

__all__ = ["dense_candidates", "detect_dense", "normalize_planes_u8"]


def normalize_planes_u8(images: np.ndarray) -> np.ndarray:
    """Per-plane min-max normalization to uint8 with trunc cast (f32 math,
    bit-identical to the JAX package's host and device normalizations)."""
    x = images.astype(np.float32)
    x -= x.min(axis=(-2, -1), keepdims=True)
    peak = x.max(axis=(-2, -1), keepdims=True)
    with np.errstate(invalid="ignore", divide="ignore"):
        x = np.where(peak > 0, 255.0 * x / peak, x)
    return np.trunc(x).astype(np.uint8)


def dense_candidates(image_u8: torch.Tensor, low_q: float, high_q: float,
                     min_roundness: float, *, min_radius: int,
                     max_radius: int):
    """Score every (center, radius) of a uint8-valued plane, keep those at
    or above ``min_roundness`` whose circle touches the image, and sort them.

    Returns (circles (n, 3) int32 (row, col, radius), scores (n,) f32) in
    (-score, unfolded row-major index) order — the order of the reference's
    ``lax.sort((-score, index), num_keys=2)``.
    """
    h, w = image_u8.shape
    edges, dx, dy = edge_pipeline(image_u8, low_q, high_q)
    pad = 2 * max_radius
    eg = F.pad(edges, (pad, pad, pad, pad))
    dxp = F.pad(dx, (pad, pad, pad, pad))
    dyp = F.pad(dy, (pad, pad, pad, pad))
    hp, wp = eg.shape
    maps = score_maps(eg, dxp, dyp, min_radius=min_radius,
                      max_radius=max_radius)

    dev = maps.device
    rads = torch.arange(min_radius, max_radius + 1, device=dev)[:, None]
    rows = torch.arange(hp, device=dev)[None, :] - pad
    cols = torch.arange(wp, device=dev)[None, :] - pad
    ok_r = (rows + rads >= 0) & (rows - rads < h)  # (n_radii, hp)
    ok_c = (cols + rads >= 0) & (cols - rads < w)  # (n_radii, wp)
    thresh = torch.tensor(np.float32(min_roundness), device=dev)
    keep = (maps >= thresh) & ok_r[:, :, None] & ok_c[:, None, :]

    lin = torch.nonzero(keep.reshape(-1)).reshape(-1)  # ascending
    scores = maps.reshape(-1)[lin]
    order = torch.sort(-scores, stable=True).indices  # ties keep lin order
    lin = lin[order]
    scores = scores[order]
    r_idx = lin // (hp * wp)
    rem = lin % (hp * wp)
    circles = torch.stack([rem // wp - pad, rem % wp - pad,
                           r_idx + min_radius], dim=1).to(torch.int32)
    return circles, scores


def detect_dense(image_u8: torch.Tensor, low_q: float, high_q: float,
                 min_roundness: float, *, min_radius: int, max_radius: int,
                 min_dist: int):
    """Dense detection + greedy NMS of one plane: the NMS-accepted circles
    (n, 3) int32 and their scores, best first."""
    h, w = image_u8.shape
    circles, scores = dense_candidates(
        image_u8, low_q, high_q, min_roundness, min_radius=min_radius,
        max_radius=max_radius)
    accepted = parallel_greedy_nms(
        circles, torch.isfinite(scores), min_dist=min_dist, height=h,
        width=w, max_radius=max_radius)
    return circles[accepted], scores[accepted]
