"""Dense circle detection on one device: the dense detector's whole path.

    edge stack -> int8 ring-correlation score maps -> bound filters ->
    roundness threshold -> survivors in (-score, index) order -> greedy NMS

Torch port of ``magnify_tpu.ops.detect``'s dense path
(``_dense_candidates`` and ``_stage_dense_full``), the batched per-ROI
detector of the chip path (``_detect_rois_dense``), and the host
quantizations of the search planes (``normalize_planes_u8``/``_u16``,
``choose_upload_precision``). The JAX package sizes its survivor
buffers with a memoized static cap and a grow-retry (a jit needs static
shapes); eager torch takes the survivors with ``torch.nonzero``, so there
is no cap to grow and the result equals the JAX result at an adequate cap.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from magnify_tpu_torch.ops.edge import edge_pipeline
from magnify_tpu_torch.ops.nms import parallel_greedy_nms
from magnify_tpu_torch.ops.score import score_maps

__all__ = ["choose_upload_precision", "dense_candidates",
           "detect_best_in_rois", "detect_dense", "detect_rois_dense",
           "normalize_planes_u16", "normalize_planes_u8"]


def normalize_planes_u8(images: np.ndarray) -> np.ndarray:
    """Per-plane min-max normalization to uint8 with trunc cast (f32 math,
    bit-identical to the JAX package's host and device normalizations)."""
    x = images.astype(np.float32)
    x -= x.min(axis=(-2, -1), keepdims=True)
    peak = x.max(axis=(-2, -1), keepdims=True)
    with np.errstate(invalid="ignore", divide="ignore"):
        x = np.where(peak > 0, 255.0 * x / peak, x)
    return np.trunc(x).astype(np.uint8)


def normalize_planes_u16(images: np.ndarray) -> np.ndarray:
    """Per-plane min-max quantization to uint16 with trunc cast (f32 math,
    the JAX package's arithmetic): the upload for frames whose useful range
    rare outliers compress (:func:`choose_upload_precision`). The device
    then normalizes every plane and every crop itself
    (``normalized=False``)."""
    x = images.astype(np.float32)
    x -= x.min(axis=(-2, -1), keepdims=True)
    peak = x.max(axis=(-2, -1), keepdims=True)
    with np.errstate(invalid="ignore", divide="ignore"):
        x = np.where(peak > 0, 65535.0 * x / peak, x)
    return np.trunc(x).astype(np.uint16)


#: 'auto' (default) picks u8 unless outliers crush the useful range;
#: 'u8'/'u16' force a precision. Read per call.
_UPLOAD_PRECISION_KNOB = "MAGNIFY_TPU_UPLOAD_PRECISION"


def choose_upload_precision(planes: np.ndarray) -> str:
    """Pick the quantization ('u8' or 'u16') of the chip path's search
    planes.

    u8 is exactly the reference's own global quantization and always right
    for detection, but the per-chamber re-detection re-normalizes CROPS of
    the quantized planes: one saturated speck can compress every chamber's
    contrast into a handful of u8 levels. So: u16 when a plane's full
    min-max range exceeds 4x the 0.1%..99.9% range of a <= 64k-pixel
    subsample (or that range is 0: the subsample saw background only).
    ``MAGNIFY_TPU_UPLOAD_PRECISION=u8|u16`` overrides.
    """
    mode = os.environ.get(_UPLOAD_PRECISION_KNOB, "auto")
    if mode in ("u8", "u16"):
        return mode
    if mode != "auto":
        raise ValueError(
            f"{_UPLOAD_PRECISION_KNOB} must be 'auto', 'u8', or 'u16', "
            f"got {mode!r}")
    planes = np.asarray(planes)
    flat = planes.reshape(-1, planes.shape[-2], planes.shape[-1])
    for plane in flat:
        lo = float(plane.min())
        hi = float(plane.max())
        if hi <= lo:
            continue
        stride = max(1, int(np.ceil(np.sqrt(plane.size / 65536.0))))
        sub = plane[::stride, ::stride]
        q_lo, q_hi = np.quantile(sub.astype(np.float32), [0.001, 0.999])
        useful = float(q_hi - q_lo)
        if useful <= 0 or (hi - lo) > 4.0 * useful:
            return "u16"
    return "u8"


def dense_candidates(image_u8: torch.Tensor, low_q: float, high_q: float,
                     min_roundness: float, *, min_radius: int,
                     max_radius: int, normalized: bool = True):
    """Score every (center, radius) of a uint8-valued plane, keep those at
    or above ``min_roundness`` whose circle touches the image, and sort them.
    With ``normalized=False`` the plane holds raw or uint16-quantized values
    and is min-max normalized on the device first.

    Returns (circles (n, 3) int32 (row, col, radius), scores (n,) f32) in
    (-score, unfolded row-major index) order — the order of the reference's
    ``lax.sort((-score, index), num_keys=2)``.
    """
    h, w = image_u8.shape
    edges, dx, dy = edge_pipeline(image_u8, low_q, high_q, normalized)
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
                 min_dist: int, normalized: bool = True):
    """Dense detection + greedy NMS of one plane: the NMS-accepted circles
    (n, 3) int32 and their scores, best first."""
    h, w = image_u8.shape
    circles, scores = dense_candidates(
        image_u8, low_q, high_q, min_roundness, min_radius=min_radius,
        max_radius=max_radius, normalized=normalized)
    accepted = parallel_greedy_nms(
        circles, torch.isfinite(scores), min_dist=min_dist, height=h,
        width=w, max_radius=max_radius)
    return circles[accepted], scores[accepted]


def detect_rois_dense(rois: torch.Tensor, low_q: float, high_q: float,
                      min_roundness: float, *, min_radius: int,
                      max_radius: int):
    """The best (center, radius) of every ROI by exhaustive score-map
    argmax: ``magnify_tpu.ops.detect._detect_rois_dense``.

    ``rois``: (N, L, L) crops of any numeric dtype, all on one device. Each
    crop is min-max normalized on its own, the edge stack runs on the whole
    batch (one hysteresis call), and one ring correlation scores all N
    padded crops. Returns (circles (N, 3) int32 (row, col, radius) relative
    to the crop, scores (N,) f32); where no (center, radius) reaches
    ``min_roundness`` the score is ``-inf`` and the circle is the flat
    layout's first entry. Ties go to the first maximum of the flat
    (n_radii, hp, wp) layout, as ``jnp.argmax`` breaks them.
    """
    n, l, _ = rois.shape
    pad = 2 * max_radius
    edges, dx, dy = edge_pipeline(rois.to(torch.float32), low_q, high_q,
                                  normalized=False)
    p = (pad, pad, pad, pad)
    maps = score_maps(F.pad(edges, p), F.pad(dx, p), F.pad(dy, p),
                      min_radius=min_radius, max_radius=max_radius)
    _n, _n_r, hp, wp = maps.shape
    dev = maps.device
    rads = torch.arange(min_radius, max_radius + 1, device=dev)[:, None]
    rows = torch.arange(hp, device=dev)[None, :] - pad
    cols = torch.arange(wp, device=dev)[None, :] - pad
    ok_r = (rows + rads >= 0) & (rows - rads < l)  # (n_radii, hp)
    ok_c = (cols + rads >= 0) & (cols - rads < l)  # (n_radii, wp)
    thresh = torch.tensor(np.float32(min_roundness), device=dev)
    ok = (maps >= thresh) & ok_r[:, :, None] & ok_c[:, None, :]
    flat = torch.where(ok, maps, -torch.inf).reshape(n, -1)
    best = torch.argmax(flat, dim=1)
    scores = torch.gather(flat, 1, best[:, None])[:, 0]
    r_idx = best // (hp * wp)
    rem = best % (hp * wp)
    circles = torch.stack([rem // wp - pad, rem % wp - pad,
                           r_idx + min_radius], dim=1).to(torch.int32)
    return circles, scores


def detect_best_in_rois(rois, low_edge_quantile: float,
                        high_edge_quantile: float, min_radius: int,
                        max_radius: int, min_roundness: float,
                        device="cuda"):
    """Best circle per ROI for a batch of same-size ROIs (numpy or tensor):
    the dense branch of ``magnify_tpu.ops.detect.detect_best_in_rois``.
    Returns numpy (circles (N, 3) int32, scores (N,), found (N,) bool)."""
    if isinstance(rois, np.ndarray):  # uint16 crops are exact in f32
        rois = torch.from_numpy(np.ascontiguousarray(rois, dtype=np.float32))
    rois = rois.to(device)
    circles, scores = detect_rois_dense(
        rois, float(low_edge_quantile), float(high_edge_quantile),
        float(min_roundness), min_radius=int(min_radius),
        max_radius=int(max_radius))
    circles = circles.cpu().numpy()
    scores = scores.cpu().numpy()
    return circles, scores, np.isfinite(scores)
