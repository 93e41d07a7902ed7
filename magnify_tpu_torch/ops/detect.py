"""Circle detection on one device: the dense detector's and the RANSAC
detector's whole paths.

    dense:  edge stack -> int8 ring-correlation score maps -> bound filters
            -> roundness threshold -> survivors in (-score, index) order ->
            greedy NMS
    RANSAC: edge stack (with gradient angles) -> Monte-Carlo circumcircle
            proposals -> unique triples -> exact perimeter scores ->
            roundness threshold -> survivors in (-score, index) order ->
            greedy NMS

Torch port of ``magnify_tpu.ops.detect``'s dense path
(``_dense_candidates`` and ``_stage_dense_full``), the batched per-ROI
detector of the chip path (``_detect_rois_dense``), and the host
quantizations of the search planes (``normalize_planes_u8``/``_u16``,
``choose_upload_precision``) and ``upload_planes_u8``, which decides
whether the uint8 planes are made on the host or on the device. The JAX
package sizes its survivor buffers with a memoized static cap and a
grow-retry (a jit needs static shapes); eager torch takes the survivors
with ``torch.nonzero``, so there is no cap to grow and the result equals
the JAX result at an adequate cap.

The RANSAC detector is the port of ``find_circles``' RANSAC branch
(``_stage_ransac_packed`` and ``ransac_score_pack``) and of the per-ROI
``_detect_rois`` with its 3 x 3 x 3 hill-climb. Its proposals come from the
JAX package's threefry streams, so one seed gives the same circles in both
packages. It scores them with the exact perimeter ("gather") scorer, the
one the JAX package runs on every backend but the TPU, or, with
``MAGNIFY_TPU_SCORER=conv`` (:func:`use_conv_scorer`), by reading each
circle's score out of the dense detector's int8 score maps (the JAX
package's TPU scorer).

The public entry points :func:`find_circles` (the upstream magnify
contract: a host image in, host circles and scores out, best first) and
:func:`find_circles_stack` (dense, a stack of planes) pick the detector
with :func:`resolve_detector`, which reads ``MAGNIFY_TPU_DETECTOR`` per
call as the JAX package does.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from magnify_tpu_torch import diagnostics
from magnify_tpu_torch.ops import prng
from magnify_tpu_torch.ops.edge import edge_pipeline, normalize_u8
from magnify_tpu_torch.ops.nms import parallel_greedy_nms
from magnify_tpu_torch.ops.ransac import candidate_circles
from magnify_tpu_torch.ops.score import (dedupe_circles, gather_map_scores,
                                         score_circles, score_maps)

__all__ = ["choose_upload_precision", "dense_candidates",
           "detect_best_in_rois", "detect_dense", "detect_ransac",
           "detect_rois_dense", "detect_rois_ransac",
           "find_circles", "find_circles_stack", "normalize_planes_u16",
           "normalize_planes_u8", "ransac_plane", "resolve_detector",
           "select_ransac", "upload_planes_u8", "use_conv_scorer"]

#: The JAX package's per-ROI unique cap (``detect_best_in_rois``).
ROI_UNIQUE_CAP = 4096

#: The 27 (dy, dx, dr) steps of the per-ROI hill-climb, in the JAX order.
_NEIGHBORHOOD = np.array([(dy, dx, dr) for dy in (-1, 0, 1)
                          for dx in (-1, 0, 1) for dr in (-1, 0, 1)],
                         dtype=np.int32)


def use_conv_scorer() -> bool:
    """Whether the RANSAC detector scores its proposals by reading the
    int8 score maps ("conv") instead of walking each perimeter ("gather").

    ``MAGNIFY_TPU_SCORER=conv|gather|auto``, read per call as the JAX
    package reads it. "auto" (the default) is the perimeter scorer on every
    device: the JAX package picks the maps only on a TPU.
    """
    mode = os.environ.get("MAGNIFY_TPU_SCORER", "auto")
    if mode not in ("auto", "conv", "gather"):
        raise ValueError(f"MAGNIFY_TPU_SCORER must be 'auto', 'conv' or "
                         f"'gather', got {mode!r}")
    return mode == "conv"


def resolve_detector(detector: str = "auto") -> str:
    """The detector a call runs: "dense" or "ransac".

    ``MAGNIFY_TPU_DETECTOR``, read per call, overrides the argument, as in
    the JAX package; an unknown value raises. "auto" is the dense detector
    on every device (the JAX package takes RANSAC off the TPU).
    """
    mode = os.environ.get("MAGNIFY_TPU_DETECTOR", detector or "auto")
    if mode not in ("auto", "dense", "ransac"):
        raise ValueError(f"unknown detector {mode!r}")
    return "dense" if mode == "auto" else mode


@diagnostics.span("detect.normalize_u8")
def normalize_planes_u8(images: np.ndarray) -> np.ndarray:
    """Per-plane min-max normalization to uint8 with trunc cast (f32 math,
    bit-identical to the JAX package's host and device normalizations).
    Counts its planes in ``normalize_u8_host_planes``."""
    diagnostics.count("normalize_u8_host_planes",
                      int(np.prod(images.shape[:-2])))
    x = images.astype(np.float32)
    x -= x.min(axis=(-2, -1), keepdims=True)
    peak = x.max(axis=(-2, -1), keepdims=True)
    with np.errstate(invalid="ignore", divide="ignore"):
        x = np.where(peak > 0, 255.0 * x / peak, x)
    return np.trunc(x).astype(np.uint8)


def upload_planes_u8(raw: np.ndarray, device, mesh=None):
    """The uint8 search planes of ``raw`` (S, H, W) for detection on
    ``device``, bit for bit those of :func:`normalize_planes_u8`, and the
    bytes copied to the device, also counted in ``upload_bytes``:
    ``(planes, nbytes)``.

    The one place that decides where the normalization runs. uint16 planes
    without a ``mesh`` go to ``device`` as they are (2 bytes a pixel) and
    are normalized there by :func:`magnify_tpu_torch.ops.edge.normalize_u8`
    (the CUDA kernel, or its plain twin on the CPU) under the span
    ``detect.normalize_u8``, their planes counted in
    ``normalize_u8_device_planes``; the raw device planes are freed on
    return, before the caller's detection starts, so they never live at the
    detector's peak. Planes of other dtypes, and every plane under a mesh,
    are normalized on the host and copied to ``device``; with ``device``
    None they stay on the host (a mesh cuts them into its bands) and the
    count is of the host planes."""
    if device is not None and mesh is None and raw.dtype == np.uint16:
        raw_dev = torch.from_numpy(np.ascontiguousarray(raw)).to(device)
        nbytes = raw_dev.nbytes
        with diagnostics.span("detect.normalize_u8", device=raw_dev.device):
            planes = normalize_u8(raw_dev)
        del raw_dev
        diagnostics.count("normalize_u8_device_planes", planes.shape[0])
    else:
        planes = normalize_planes_u8(raw)
        if device is not None:
            planes = torch.as_tensor(planes).to(device)
        nbytes = planes.nbytes
    diagnostics.count("upload_bytes", nbytes)
    return planes, nbytes


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
    maps = _padded_maps(edges, dx, dy, min_radius, max_radius)
    _n_r, hp, wp = maps.shape
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
    maps = _padded_maps(edges, dx, dy, min_radius, max_radius)
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


def _padded_maps(edges, dx, dy, min_radius: int, max_radius: int):
    """The int8 score maps of (H, W) or (N, H, W) edge planes padded by
    ``2 * max_radius``, as the conv scorer reads them."""
    p = (2 * max_radius,) * 4
    return score_maps(F.pad(edges, p), F.pad(dx, p), F.pad(dy, p),
                      min_radius=min_radius, max_radius=max_radius)


def detect_ransac(image: torch.Tensor, low_q: float, high_q: float,
                  min_roundness: float, *, grid_length: int, num_iter: int,
                  min_radius: int, max_radius: int, min_dist: int,
                  key: torch.Tensor, normalized: bool):
    """RANSAC detection + greedy NMS of one plane (``_stage_ransac_packed``).

    ``normalized`` says whether ``image`` already holds uint8 values (the
    bead path's host-normalized planes; normalizing them again changes
    nothing) or raw values (the chip's ``find_centers``). The unique
    proposals are scored by the perimeter scorer, or with
    :func:`use_conv_scorer` read out of the plane's int8 score maps (no
    gradient angles are computed then). Returns the NMS-accepted circles
    (n, 3) int32, best first, their scores, and the number of unique
    proposals.
    """
    h, w = image.shape
    conv = use_conv_scorer()
    edges, dx, dy, *angles = edge_pipeline(image, low_q, high_q, normalized,
                                           angles=not conv)
    cands, any_edges = candidate_circles(edges, grid_length, num_iter, key)
    uniq, n_unique = dedupe_circles(
        cands, any_edges, height=h, width=w, min_radius=min_radius,
        max_radius=max_radius)
    circles, scores = select_ransac(
        edges, dx, dy, angles[0] if angles else None, uniq, min_roundness,
        min_radius=min_radius, max_radius=max_radius, min_dist=min_dist)
    return circles, scores, n_unique


def ransac_plane(image: torch.Tensor, low_q: float, high_q: float,
                 min_roundness: float, *, grid_length: int, num_iter: int,
                 min_radius: int, max_radius: int, min_dist: int, seed: int,
                 normalized: bool):
    """RANSAC on one plane (H, W) with the proposals of ``seed``, wherever
    the caller is: under an active mesh of more than one device
    (:func:`magnify_tpu_torch.parallel.use_mesh`) the proposals split over
    its devices where the plane's dedupe raster allows it (the JAX
    package's rule, :func:`magnify_tpu_torch.parallel.mesh.
    ransac_fits_mesh`), else :func:`detect_ransac` on the plane's device.
    The result is the same: (circles, scores, n_unique)."""
    from magnify_tpu_torch.parallel import mesh as mesh_mod

    mesh = mesh_mod.sharded_mesh()
    kw = dict(grid_length=grid_length, num_iter=num_iter,
              min_radius=min_radius, max_radius=max_radius,
              min_dist=min_dist, normalized=normalized)
    if mesh is not None and mesh_mod.ransac_fits_mesh(
            *image.shape, min_radius, max_radius):
        return mesh_mod.ransac_on_mesh(image, mesh, low_q, high_q,
                                       min_roundness, seed=seed, **kw)
    return detect_ransac(image, low_q, high_q, min_roundness,
                         key=prng.prng_key(seed, image.device), **kw)


def select_ransac(edges, dx, dy, grad_angles, uniq, min_roundness: float, *,
                  min_radius: int, max_radius: int, min_dist: int):
    """The tail of :func:`detect_ransac`: score the unique proposals
    ``uniq`` (n, 3) of one plane (with the perimeter scorer on
    ``grad_angles``, or where those are None out of the int8 score maps),
    keep those at or above ``min_roundness`` in (-score, unique-index)
    order, and run greedy NMS. Returns the accepted (circles, scores)."""
    h, w = edges.shape
    pad = 2 * max_radius
    shift = torch.tensor([pad, pad, 0], dtype=torch.int32,
                         device=uniq.device)
    if grad_angles is None:
        maps = _padded_maps(edges, dx, dy, min_radius, max_radius)
        live = torch.ones(uniq.shape[0], dtype=torch.bool, device=uniq.device)
        scores = gather_map_scores(maps, uniq + shift, live,
                                   min_radius=min_radius)
    else:
        scores = score_circles(grad_angles, edges, uniq + shift,
                               max_radius=max_radius, pad=pad)
    thresh = torch.tensor(np.float32(min_roundness), device=scores.device)
    lin = torch.nonzero(scores >= thresh).reshape(-1)  # unique-index order
    order = torch.sort(-scores[lin], stable=True).indices
    lin = lin[order]
    circles, scores = uniq[lin], scores[lin]
    accepted = parallel_greedy_nms(
        circles, torch.isfinite(scores), min_dist=min_dist, height=h,
        width=w, max_radius=max_radius)
    return circles[accepted], scores[accepted]


def detect_rois_ransac(rois: torch.Tensor, low_q: float, high_q: float,
                       min_roundness: float, keys: torch.Tensor, *,
                       grid_length: int, num_iter: int, min_radius: int,
                       max_radius: int, unique_cap: int):
    """The best circle of every ROI by RANSAC and a hill-climb:
    ``magnify_tpu.ops.detect._detect_rois``, with the perimeter scorer or,
    with :func:`use_conv_scorer`, the score maps of the whole batch (one
    ring correlation) read at each circle.

    ``rois`` (N, L, L), each crop min-max normalized on its own and its
    edge stack run on the whole batch; ``keys`` (N, 2), one threefry key
    per crop. Per crop: ``num_iter`` proposals, the first ``unique_cap``
    unique triples in key order (no retry, as the JAX package), their
    scores at or above ``min_roundness`` and the first maximum; then the 27
    neighbours (dy, dx, dr in -1..1, the radius clipped to the range) of
    that maximum are scored, unfiltered, and the first best of them
    replaces it only where strictly better. Returns (circles (N, 3) int32
    relative to the crop, scores (N,) f32, ``-inf`` where no proposal
    reached ``min_roundness``; such a crop's circle is meaningless).
    """
    n, l, _ = rois.shape
    dev = rois.device
    conv = use_conv_scorer()
    edges, dx, dy, *angles = edge_pipeline(
        rois.to(torch.float32), low_q, high_q, normalized=False,
        angles=not conv)
    cands, any_edges = candidate_circles(edges, grid_length, num_iter, keys)
    uniq, uvalid, _n = dedupe_circles(
        cands, any_edges[:, None], height=l, width=l, min_radius=min_radius,
        max_radius=max_radius, cap=unique_cap)
    pad = 2 * max_radius
    shift = torch.tensor([pad, pad, 0], dtype=torch.int32, device=dev)
    maps = _padded_maps(edges, dx, dy, min_radius, max_radius) if conv \
        else None

    def scores_of(circles, valid):
        """Scores of (N, K, 3) circles, K per crop."""
        if conv:
            return gather_map_scores(maps, circles + shift, valid,
                                     min_radius=min_radius)
        return score_circles(angles[0], edges, circles + shift, valid,
                             max_radius=max_radius, pad=pad)

    thresh = torch.tensor(np.float32(min_roundness), device=dev)
    scores = scores_of(uniq, uvalid)
    scores = torch.where(scores >= thresh, scores, -torch.inf)
    best = torch.argmax(scores, dim=1)
    best_circle = uniq[torch.arange(n, device=dev), best]
    best_score = torch.gather(scores, 1, best[:, None])[:, 0]

    nb = torch.as_tensor(_NEIGHBORHOOD, device=dev)
    cand = best_circle[:, None, :] + nb[None]
    cand[..., 2] = torch.clamp(cand[..., 2], min_radius, max_radius)
    nb_ok = torch.isfinite(best_score)[:, None].expand(n, nb.shape[0])
    nb_scores = scores_of(cand, nb_ok)
    j = torch.argmax(nb_scores, dim=1)
    nb_best = torch.gather(nb_scores, 1, j[:, None])[:, 0]
    improved = nb_best > best_score
    best_circle = torch.where(improved[:, None],
                              cand[torch.arange(n, device=dev), j],
                              best_circle)
    return best_circle, torch.where(improved, nb_best, best_score)


def detect_best_in_rois(rois, low_edge_quantile: float,
                        high_edge_quantile: float, min_radius: int,
                        max_radius: int, min_roundness: float,
                        device="cuda", *, detector: str = "auto",
                        grid_length: int = 20, num_iter: int | None = None,
                        seed: int = 0, unique_cap: int = ROI_UNIQUE_CAP):
    """Best circle per ROI for a batch of same-size ROIs (numpy or tensor):
    ``magnify_tpu.ops.detect.detect_best_in_rois``. ``detector``
    (:func:`resolve_detector`) "auto"/"dense" takes the dense branch;
    "ransac" runs ``num_iter`` proposals per ROI with keys
    ``split(PRNGKey(seed), N)`` and keeps ``min(unique_cap, num_iter)``
    uniques per ROI.
    Returns numpy (circles (N, 3) int32, scores (N,), found (N,) bool)."""
    if isinstance(rois, np.ndarray):  # uint16 crops are exact in f32
        rois = torch.from_numpy(np.ascontiguousarray(rois, dtype=np.float32))
    rois = rois.to(device)
    args = (float(low_edge_quantile), float(high_edge_quantile),
            float(min_roundness))
    if resolve_detector(detector) == "dense":
        circles, scores = detect_rois_dense(
            rois, *args, min_radius=int(min_radius),
            max_radius=int(max_radius))
    else:
        if num_iter is None:
            raise ValueError("detect_best_in_rois: the RANSAC detector "
                             "needs num_iter")
        num_iter = max(int(num_iter), 1)
        keys = prng.split(prng.prng_key(seed, rois.device), rois.shape[0])
        circles, scores = detect_rois_ransac(
            rois, *args, keys, grid_length=int(grid_length),
            num_iter=num_iter, min_radius=int(min_radius),
            max_radius=int(max_radius),
            unique_cap=int(min(unique_cap, num_iter)))
    circles = circles.cpu().numpy()
    scores = scores.cpu().numpy()
    return circles, scores, np.isfinite(scores)


def _to_host(circles: torch.Tensor, scores: torch.Tensor):
    return circles.cpu().numpy().astype(np.int32), scores.cpu().numpy()


def find_circles(image, low_edge_quantile: float, high_edge_quantile: float,
                 grid_length: int, num_iter: int, min_radius: int,
                 max_radius: int, min_roundness: float, min_dist: int,
                 gui=None, seed: int = 0, detector: str = "auto",
                 device="cuda"):
    """Detect circles in one image: ``magnify_tpu.ops.detect.find_circles``,
    the upstream magnify contract.

    ``image`` (H, W), a host array of any numeric dtype (uint16 values are
    exact in the float32 upload) or a tensor. It is min-max normalized on
    ``device``. Returns host (circles (n, 3) int32 (row, col, radius),
    scores (n,) float32), best first, after greedy NMS at ``min_dist``
    (none when it is 0). The detector (:func:`resolve_detector`) is dense,
    or RANSAC with ``num_iter`` proposals in cells of ``grid_length`` from
    the threefry key of ``seed``, scored as :func:`use_conv_scorer` says.
    With ``gui`` (a :class:`magnify_tpu_torch.plot.vis.InteractiveUI`) the
    parameters are tuned in its two stages (edge quantiles, circle
    filters) first; headless, each stage runs once with these values and
    the result is this call's without ``gui``.

    Under an active mesh of more than one device
    (:func:`magnify_tpu_torch.parallel.use_mesh`) detection shards over it:
    dense detection over its (batch, space) bands, RANSAC's proposals over
    its devices where the plane's dedupe raster is within
    ``RASTER_KEY_LIMIT`` keys (the JAX package's rule); the result is the
    same.
    """
    if gui is not None:
        from magnify_tpu_torch.plot.vis import interactive_find_circles

        return interactive_find_circles(
            image, gui, low_edge_quantile=low_edge_quantile,
            high_edge_quantile=high_edge_quantile, grid_length=grid_length,
            num_iter=num_iter, min_radius=min_radius, max_radius=max_radius,
            min_roundness=min_roundness, min_dist=min_dist, seed=seed,
            detector=detector, device=device)
    from magnify_tpu_torch.parallel import mesh as mesh_mod

    dense = resolve_detector(detector) == "dense"
    if isinstance(image, np.ndarray):
        image = torch.from_numpy(np.ascontiguousarray(image,
                                                      dtype=np.float32))
    args = (float(low_edge_quantile), float(high_edge_quantile),
            float(min_roundness))
    kw = dict(min_radius=int(min_radius), max_radius=int(max_radius),
              min_dist=int(min_dist), normalized=False)
    mesh = mesh_mod.sharded_mesh()
    if dense and mesh is not None:
        return mesh_mod.sharded_find_circles(
            image, mesh, low_edge_quantile, high_edge_quantile, min_radius,
            max_radius, min_roundness, min_dist)
    image = image.to(device)
    if dense:
        return _to_host(*detect_dense(image, *args, **kw))
    circles, scores, _n = ransac_plane(
        image, *args, grid_length=int(grid_length), num_iter=int(num_iter),
        seed=int(seed), **kw)
    return _to_host(circles, scores)


def find_circles_stack(images, low_edge_quantile: float,
                       high_edge_quantile: float, min_radius: int,
                       max_radius: int, min_roundness: float, min_dist: int,
                       nms_cap: int = 4096, batch: int = 4,
                       pull_cap: int = 511, device="cuda") -> list:
    """Dense detection over a stack of planes:
    ``magnify_tpu.ops.detect.find_circles_stack``.

    ``images`` (B, H, W) are normalized to uint8 on the host
    (:func:`normalize_planes_u8`, bit-equal to the device's normalization)
    and uploaded ``batch`` planes at a time; each plane is detected by
    :func:`detect_dense`, as :func:`find_circles` detects it densely.
    Returns a list of (circles, scores) per plane. ``nms_cap`` and
    ``pull_cap`` size the JAX package's static buffers; here the survivors
    are taken whole, so they are validated and change nothing. Under an
    active mesh of more than one device the whole stack shards over it
    (:func:`magnify_tpu_torch.parallel.mesh.
    sharded_find_circles_batch_packed`), with the same result.
    """
    if min(int(nms_cap), int(pull_cap), int(batch)) < 1:
        raise ValueError("find_circles_stack: nms_cap, batch and pull_cap "
                         "must be >= 1")
    planes = normalize_planes_u8(np.ascontiguousarray(images))
    from magnify_tpu_torch.parallel import mesh as mesh_mod

    mesh = mesh_mod.sharded_mesh()
    if mesh is not None:
        return mesh_mod.sharded_find_circles_batch_packed(
            planes, mesh, float(low_edge_quantile),
            float(high_edge_quantile), float(min_roundness),
            min_radius=int(min_radius), max_radius=int(max_radius),
            min_dist=int(min_dist))
    results = []
    for start in range(0, planes.shape[0], int(batch)):
        chunk = torch.from_numpy(planes[start:start + int(batch)]).to(device)
        results += [_to_host(*detect_dense(
            one, float(low_edge_quantile), float(high_edge_quantile),
            float(min_roundness), min_radius=int(min_radius),
            max_radius=int(max_radius), min_dist=int(min_dist)))
            for one in chunk]
    return results
