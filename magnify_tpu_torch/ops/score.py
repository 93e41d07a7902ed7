"""Roundness scoring: the dense detector's int8 ring-correlation score maps,
and the RANSAC detector's unique-triple dedupe and exact perimeter scorer.

The reference's per-pixel alignment score ``4*|wrap(|a - e|) - pi/2|/pi - 1``
equals ``(8/pi^2) * sum_{k odd} cos(2k (a - e)) / k^2``, which separates the
image angle ``a`` from the ring angle ``e``: scoring every (center, radius)
becomes a correlation of per-harmonic features ``edge * (cos 2ka, sin 2ka)``
with a ring kernel per radius. Torch port of the int8, unfolded (s2d = 1)
form of ``magnify_tpu.ops.score.score_maps``; the int8 maps do not depend
on the space-to-depth fold, so the fold is not carried over.

The int8 features are the CUDA kernel ``csrc/features_q8.cu`` for CUDA
tensors and a torch chain for CPU tensors (:func:`alignment_features_q8`
picks the route). The ring kernels are built by numpy code copied from the
JAX package and are array-equal to its tables (harmonics k <= 7, the JAX
default). The correlation itself is the CUDA kernel ``csrc/ring_corr.cu``
for CUDA tensors and a float ``conv2d`` in a type where it is exact on int8
values for CPU tensors.

The RANSAC detector (``magnify_tpu.ops.score.dedupe_circles`` and
``score_circles``) rounds its proposals to (row, col, radius) triples,
keeps the unique ones in key order (:func:`dedupe_circles`) and scores each
by walking its Bresenham perimeter (:func:`score_circles`, on the unpadded
planes): the CUDA kernel ``csrc/perimeter_score.cu`` for CUDA tensors,
:func:`score_circles_plain` for CPU tensors. Both sum in the order of the
reference's compiled CPU program (:func:`sum_form`), so the scores are
bit-equal to the JAX package's.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from magnify_tpu_torch import _build, diagnostics, utils
from magnify_tpu_torch.ops.edge import fma_f32

__all__ = ["RASTER_KEY_LIMIT", "RingWeights", "alignment_features_q8",
           "alignment_features_q8_plain", "circle_keys", "decode_keys",
           "dedupe_circles", "features_q8", "gather_map_scores",
           "perimeter_plan", "perimeter_score", "raster_key_space", "ring_corr",
           "ring_corr_plain", "ring_weights", "score_circles",
           "score_circles_plain", "score_maps", "spread_lanes", "sum_form"]

_HARMONICS = (1, 3, 5, 7)
_COEFFS = tuple(8.0 / (np.pi**2 * k**2) for k in _HARMONICS)

#: Kernel launches of :func:`ring_corr` since the count was last reset.
launches = 0
#: Those of them that calls on a batch (N, C, H, W) made.
batched_launches = 0
#: Kernel launches of :func:`perimeter_score` since the count was last reset.
perimeter_launches = 0
#: Those of them that scored circles on a batch of planes.
perimeter_batched_launches = 0
#: Kernel launches of :func:`features_q8` since the count was last reset.
features_q8_launches = 0
#: Those of them that made the features of a batch of planes.
features_q8_batched_launches = 0


@functools.lru_cache(maxsize=None)
def _ring_conv_kernel(min_radius: int, max_radius: int) -> np.ndarray:
    """Conv kernel (n_radii, 2*len(H), K, K) for ring-correlation scoring.

    Input channels alternate (edge*cos(2ka), edge*sin(2ka)) per harmonic;
    output channel r_idx accumulates sum_k c_k * [cos term + sin term] over
    the Bresenham ring of radius min_radius + r_idx, normalized by ring
    length.
    """
    n_radii = max_radius - min_radius + 1
    size = 2 * max_radius + 1
    kernel = np.zeros((n_radii, 2 * len(_HARMONICS), size, size), np.float32)
    for ri in range(n_radii):
        r = min_radius + ri
        ring = utils.circle_points(r)
        angles = np.arctan2(ring[:, 0], ring[:, 1])
        inv_len = 1.0 / len(ring)
        for hi, (k, c) in enumerate(zip(_HARMONICS, _COEFFS)):
            kernel[ri, 2 * hi, max_radius + ring[:, 0],
                   max_radius + ring[:, 1]] += c * inv_len * np.cos(
                       2 * k * angles)
            kernel[ri, 2 * hi + 1, max_radius + ring[:, 0],
                   max_radius + ring[:, 1]] += c * inv_len * np.sin(
                       2 * k * angles)
    return kernel


@functools.lru_cache(maxsize=None)
def _ring_conv_kernel_q8(min_radius: int, max_radius: int):
    """Symmetric per-radius int8 quantization of the ring kernel: returns
    (q int8 (n_radii, C, K, K), scale f32 (n_radii,)), ``w ~= q*scale/127``.
    """
    k = _ring_conv_kernel(min_radius, max_radius)
    amax = np.abs(k).max(axis=(1, 2, 3))
    scale = np.where(amax > 0, amax, 1.0).astype(np.float32)
    q = np.round(k / scale[:, None, None, None] * 127.0).astype(np.int8)
    return q, scale


def pack_positions(q: np.ndarray):
    """The int8 ring kernel (n_radii, 8, K, K) by position, per radius.

    Returns (table int32 (n_pos, 4), offsets int32 (n_radii + 1,)): radius
    r's positions are ``table[offsets[r]:offsets[r + 1]]``, in (i, j) order,
    each ``(i | j << 16, w_lo, w_hi, r)`` with kernel row i and column j,
    and the weights of channels 0-3 (``w_lo``) and 4-7 (``w_hi``) packed as
    4 signed bytes each, channel c's in byte ``c % 4`` (the operand layout
    of CUDA's ``__dp4a``). A position is listed where any channel's weight
    is nonzero.
    """
    n_r, c_in, k, _ = q.shape
    if c_in != 8 or k > 1 << 15:
        raise ValueError(f"kernel {q.shape}: 8 channels and K < 32768 "
                         "required")
    rows, offsets = [], [0]
    for r in range(n_r):
        i, j = np.nonzero((q[r] != 0).any(axis=0))
        words = np.ascontiguousarray(q[r][:, i, j].T).view(np.int32)
        rows.append(np.column_stack([i | j << 16, words,
                                     np.full_like(i, r)]))
        offsets.append(offsets[-1] + len(i))
    table = np.concatenate(rows).astype(np.int32).reshape(-1, 4)
    return table, np.asarray(offsets, np.int32)


class RingWeights(NamedTuple):
    """One int8 ring kernel on one device, in both layouts: ``dense``
    (n_radii, C, K, K) int8 for the plain twin, ``table``/``offsets`` (see
    :func:`pack_positions`) for the CUDA kernel."""

    dense: torch.Tensor
    table: torch.Tensor
    offsets: torch.Tensor


def ring_weights(q: np.ndarray, device) -> RingWeights:
    table, offsets = pack_positions(q)
    return RingWeights(
        dense=torch.as_tensor(q, device=device),
        table=torch.as_tensor(table, device=device),
        offsets=torch.as_tensor(offsets, device=device),
    )


@functools.lru_cache(maxsize=None)
def _cached_tables(min_radius: int, max_radius: int, device: str):
    q, scale = _ring_conv_kernel_q8(min_radius, max_radius)
    # Dequant multiplier in numpy f32, as the reference computes it.
    dq = (scale / (127.0 * 127.0)).astype(np.float32)
    return ring_weights(q, device), torch.as_tensor(dq, device=device)


# Shared memory one CTA may use on sm_90 (232,448 bytes).
_MAX_SMEM = 227 * 1024

# A CPU convolution may unfold C*K*K values per output pixel (46 GB of
# doubles for a 1024^2 frame's padded plane at radii 8-12): bands of rows
# bound it.
_CPU_UNFOLD_BYTES = 1 << 28


# Planes of a batch that one float64 convolution takes on a card: bounds the
# f64 copies of features and maps (1,568 padded chamber crops would hold
# 4 GB of them at once).
_PLAIN_BATCH_BYTES = 1 << 30


def _exact_dtype(weights: RingWeights, device) -> torch.dtype:
    """The float type in which a convolution of int8 features is exact.

    Every product and partial sum is an integer of magnitude at most
    ``127 * sum|w|`` of one radius; below 2^24 that is exact in float32
    whatever the order of the sums (1.64e6 at radii 8-12, 2.12e6 at 4-15),
    and the CPU's float32 convolution is ~25x faster than its float64 one.
    A card keeps float64: its float32 convolutions may round operands to
    TF32 or transform them (FFT, Winograd)."""
    bound = 127 * int(weights.dense.to(torch.int64).abs().sum(
        dim=(1, 2, 3)).max()) if weights.dense.numel() else 0
    if torch.device(device).type == "cpu" and bound < 2**24:
        return torch.float32
    return torch.float64


def ring_corr_plain(feats: torch.Tensor, weights: RingWeights) -> torch.Tensor:
    """Float correlation of int8 values in a type where it is exact
    (:func:`_exact_dtype`): float32 on the CPU, float64 on a card, so any
    algorithm gives the exact int32 result. ``feats``: (C, H, W) or a batch
    (N, C, H, W)."""
    if feats.ndim == 3:
        return ring_corr_plain(feats[None], weights)[0]
    n_r, c_in, k, _ = weights.dense.shape
    rad = k // 2
    n, _, h, w = feats.shape
    dtype = _exact_dtype(weights, feats.device)
    size = torch.finfo(dtype).bits // 8
    wt = weights.dense.to(dtype)
    rows = h
    if feats.device.type == "cpu":
        rows = max(1, _CPU_UNFOLD_BYTES // (c_in * k * k * max(w, 1) * size))
    per_plane = size * (c_in * (h + 2 * rad) * (w + 2 * rad) + n_r * h * w)
    planes = max(1, _PLAIN_BATCH_BYTES // max(per_plane, 1))
    out = torch.empty((n, n_r, h, w), dtype=torch.int32, device=feats.device)
    for n0 in range(0, n, planes):
        fp = F.pad(feats[n0:n0 + planes].to(dtype), (rad, rad, rad, rad))
        for y0 in range(0, h, rows):
            y1 = min(h, y0 + rows)
            band = F.conv2d(fp[:, :, y0:y1 + 2 * rad], wt)
            out[n0:n0 + planes, :, y0:y1] = torch.round(band).to(torch.int32)
    return out


def ring_corr(feats: torch.Tensor, weights: RingWeights) -> torch.Tensor:
    """Exact int8 ring correlation, zero padded (SAME): (C, H, W) int8
    features -> (n_radii, H, W) int32, or a batch (N, C, H, W) -> (N,
    n_radii, H, W) in one launch. CPU tensors take the plain twin; CUDA
    tensors take the kernel, which needs C = 8."""
    global launches, batched_launches
    if feats.device.type == "cpu" and weights.dense.device.type == "cpu":
        return ring_corr_plain(feats, weights)
    batched = feats.ndim == 4
    if feats.ndim == 3:
        feats = feats[None]
    for name, t in (("table", weights.table), ("offsets", weights.offsets)):
        if t.device != feats.device or t.dtype != torch.int32:
            raise ValueError(f"ring_corr: {name} must be int32 on "
                             f"{feats.device}, got {t.dtype} on {t.device}")
    if feats.device.type != "cuda":
        raise ValueError(f"ring_corr: unsupported device {feats.device}")
    if feats.dtype != torch.int8 or feats.ndim != 4:
        raise TypeError("ring_corr: (C, H, W) or (N, C, H, W) int8 features "
                        f"required, got {feats.dtype} {tuple(feats.shape)}")
    n_r, c_in, k, k2 = weights.dense.shape
    if k != k2 or k % 2 == 0 or feats.shape[1] != c_in or c_in != 8:
        raise ValueError(f"ring_corr: kernel {tuple(weights.dense.shape)} "
                         f"does not fit features {tuple(feats.shape)} "
                         "(8 channels required)")
    rad = k // 2
    n_pos = weights.table.shape[0]
    lib = _build.load()
    smem = lib.mg_ring_corr_smem(rad, n_pos)
    if not 0 < smem <= _MAX_SMEM:
        raise ValueError(f"ring_corr: kernel half-width {rad} with {n_pos} "
                         "positions exceeds the kernel's shared memory")
    feats = feats.contiguous()
    table = weights.table.contiguous()
    offsets = weights.offsets.contiguous()
    n, _, h, w = feats.shape
    out = torch.empty((n, n_r, h, w), dtype=torch.int32, device=feats.device)
    if out.numel() == 0:
        return out if batched else out[0]
    if n * ((w + 63) // 64) >= 2**31 or (h + 31) // 32 > 65535:
        raise ValueError(f"ring_corr: {n} planes of {h}x{w} exceed the "
                         "launch grid")
    with torch.cuda.device(feats.device):  # the launch goes to its card
        err = lib.mg_ring_corr(
            feats.data_ptr(), n, h, w, table.data_ptr(), offsets.data_ptr(),
            n_r, n_pos, rad, out.data_ptr(),
            torch.cuda.current_stream(feats.device).cuda_stream)
    launches += 1
    batched_launches += int(batched)
    _build.check(err, "mg_ring_corr")
    return out if batched else out[0]


def _cs2_from_grads(dx, dy):
    """(cos(2a), sin(2a)) for a = arctan2(dy, dx) from the double-angle
    identities; zero-gradient pixels get the a = 0 values (1, 0)."""
    g2 = dx * dx + dy * dy
    pos = g2 > 0
    safe = torch.where(pos, g2, 1.0)
    c1 = torch.where(pos, (dx * dx - dy * dy) / safe, 1.0)
    s1 = torch.where(pos, (2.0 * dx * dy) / safe, 0.0)
    return c1, s1


def alignment_features_q8_plain(edges, dx, dy) -> torch.Tensor:
    """int8 per-harmonic (edge*cos(2ka), edge*sin(2ka)) channels,
    ``round(127 * feature)``, in torch on any device: the ``qdtype="int8"``
    form of ``magnify_tpu.ops.score._alignment_features`` with ``grads=(dx,
    dy)``, and the twin of :func:`features_q8`.

    The cos/sin(2ka) recurrence ``c' = c*c1 - s*s1``, ``s' = s*c1 + c*s1``
    rounds as the reference's compiled program does: the first product of
    each line fused with the sum (one FMA), the second rounded on its own.
    Plain two-rounding arithmetic moves a few int8 features in 10^5 by one
    step across a .5 boundary, which moves scores in the 5th digit.
    """
    e = edges.to(torch.float32)
    c1, s1 = _cs2_from_grads(dx, dy)
    feats = []
    ck, sk = c1, s1
    for k in range(1, max(_HARMONICS) + 1):
        if k in _HARMONICS:
            feats.append(e * ck)
            feats.append(e * sk)
        ck, sk = fma_f32(ck, c1, -(sk * s1)), fma_f32(sk, c1, ck * s1)
    # Channels before the plane: (8, H, W), or (N, 8, H, W) for a batch.
    return torch.round(torch.stack(feats, dim=-3) * 127.0).to(torch.int8)


def features_q8(edges, dx, dy) -> torch.Tensor:
    """The CUDA kernel ``csrc/features_q8.cu``: the features of
    :func:`alignment_features_q8_plain`, bit for bit, in one launch on the
    current stream (none for an empty plane), no host sync. ``edges`` bool,
    ``dx``/``dy`` float32, all of one shape (..., H, W) on one CUDA device;
    returns (..., 8, H, W) int8."""
    global features_q8_launches, features_q8_batched_launches
    dev = edges.device
    if dev.type != "cuda":
        raise ValueError(f"features_q8: unsupported device {dev}")
    for name, t in (("dx", dx), ("dy", dy)):
        if t.device != dev or t.shape != edges.shape:
            raise ValueError(f"features_q8: {name} {tuple(t.shape)} on "
                             f"{t.device}, edges {tuple(edges.shape)} on "
                             f"{dev}")
    if edges.dtype != torch.bool or dx.dtype != torch.float32 or (
            dy.dtype != torch.float32):
        raise TypeError("features_q8: bool edges and f32 gradients "
                        f"required, got {edges.dtype}, {dx.dtype}, "
                        f"{dy.dtype}")
    if edges.ndim < 2:
        raise ValueError("features_q8: planes (..., H, W) required, got "
                         f"{tuple(edges.shape)}")
    lead, (h, w) = edges.shape[:-2], edges.shape[-2:]
    planes = int(np.prod(lead, dtype=np.int64))
    out = torch.empty(lead + (8, h, w), dtype=torch.int8, device=dev)
    if out.numel() == 0:
        return out
    if planes >= 2**31 or h * w >= 2**40:
        raise ValueError(f"features_q8: {planes} planes of {h}x{w} exceed "
                         "the launch grid")
    edges_u8 = edges.contiguous().view(torch.uint8)
    dx, dy = dx.contiguous(), dy.contiguous()
    with torch.cuda.device(dev):  # the launch goes to the tensors' card
        err = _build.load().mg_features_q8(
            edges_u8.data_ptr(), dx.data_ptr(), dy.data_ptr(), planes, h * w,
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    features_q8_launches += 1
    features_q8_batched_launches += int(edges.ndim > 2)
    _build.check(err, "mg_features_q8")
    return out


def alignment_features_q8(edges, dx, dy) -> torch.Tensor:
    """int8 per-harmonic (edge*cos(2ka), edge*sin(2ka)) channels of the
    padded planes: (H, W) -> (8, H, W), or a batch (N, H, W) -> (N, 8, H,
    W) (see :func:`alignment_features_q8_plain`).

    The one place that picks the route, by the tensors' device: CUDA tensors
    take the kernel (:func:`features_q8`), their pixels counted in
    ``features_q8_device_px``; CPU tensors take the torch chain, counted in
    ``features_q8_host_px``. Either way the call is the span
    ``score.features_q8``, on the card a device span."""
    px = edges.numel()
    with diagnostics.span("score.features_q8", device=edges.device):
        if edges.device.type == "cpu":
            diagnostics.count("features_q8_host_px", px)
            return alignment_features_q8_plain(edges, dx, dy)
        diagnostics.count("features_q8_device_px", px)
        return features_q8(edges, dx, dy)


def score_maps(edges, dx, dy, *, min_radius: int, max_radius: int):
    """Roundness score for every (center, radius): (n_radii, Hp, Wp) f32.

    ``edges``/``dx``/``dy`` are the padded (Hp, Wp) planes (the caller pads
    by 2*max_radius); map [r, y, x] scores radius ``min_radius + r`` at
    padded position (y, x). int8 features, exact int32 correlation, then one
    f32 multiply by ``scale / 127^2``. A batch (N, Hp, Wp) gives (N,
    n_radii, Hp, Wp) through one correlation, as the JAX package's
    leading-batch ``score_maps`` does.
    """
    weights, dq = _cached_tables(int(min_radius), int(max_radius),
                                 str(edges.device))
    acc = ring_corr(alignment_features_q8(edges, dx, dy), weights)
    return acc.to(torch.float32) * dq[:, None, None]


def gather_map_scores(maps, circles, valid, *, min_radius: int):
    """Each circle's score read out of the score maps
    (``magnify_tpu.ops.score.gather_map_scores``): the conv scorer of the
    RANSAC detector.

    ``maps`` (n_radii, Hp, Wp) of one plane with ``circles`` (K, 3) int32
    and ``valid`` (K,), or a batch (N, n_radii, Hp, Wp) with (N, K, 3) and
    (N, K). The circles' rows and columns are in the padded coordinates of
    the maps. The radius index, the row and the column are each clipped
    into the maps, as the JAX package clips them, and an invalid circle
    scores ``-inf``. The flat index is int64: frame C's chamber batch holds
    1,568 x 12 x 132^2 entries.
    """
    n_radii, hp, wp = maps.shape[-3:]
    r = torch.clamp(circles[..., 2].to(torch.int64) - min_radius, 0,
                    n_radii - 1)
    row = torch.clamp(circles[..., 0].to(torch.int64), 0, hp - 1)
    col = torch.clamp(circles[..., 1].to(torch.int64), 0, wp - 1)
    idx = (r * hp + row) * wp + col
    if maps.ndim == 4:
        plane = torch.arange(maps.shape[0], device=maps.device)[:, None]
        idx = idx + plane * (n_radii * hp * wp)
    scores = maps.reshape(-1)[idx]
    return torch.where(valid, scores, -torch.inf)


# ---------------------------------------------------------------------------
# RANSAC: unique-triple dedupe and the exact perimeter scorer
# ---------------------------------------------------------------------------

#: The JAX package dedupes proposals on a presence raster of this many keys
#: at most; above it its mesh detector refuses a plane (the port's dedupe
#: needs no raster and keeps the limit only there).
RASTER_KEY_LIMIT = 1 << 28


def raster_key_space(height: int, width: int, min_radius: int,
                     max_radius: int) -> int:
    """Number of (row, col, radius) dedupe keys: rows and columns within
    ``max_radius`` of the image (one more), radii ``min_radius ..
    max_radius``."""
    return ((height + 2 * max_radius + 1) * (width + 2 * max_radius + 1)
            * (max_radius - min_radius + 1))


def _round_i32(x: torch.Tensor) -> torch.Tensor:
    """``jnp.round(x).astype(int32)`` under XLA: half to even, saturating at
    the int32 range, NaN to 0 (torch's own cast gives -2^31 for all of
    those). Returned as int64."""
    r = torch.nan_to_num(torch.round(x).to(torch.float64), nan=0.0)
    return torch.clamp(r, -2.0**31, 2.0**31 - 1).to(torch.int64)


def _round_filter(circles, valid, *, height: int, width: int,
                  min_radius: int, max_radius: int):
    """Round proposals to integer triples and apply the reference's radius
    and off-image filters. The JAX package tests the bounds in wrapping
    int32; in int64 every test comes out the same (a saturated coordinate
    fails one of them either way)."""
    row, col, rad = (_round_i32(v) for v in circles)
    ok = valid & (rad >= min_radius) & (rad <= max_radius)
    ok &= (row + rad >= 0) & (col + rad >= 0)
    ok &= (row - rad < height) & (col - rad < width)
    return row, col, rad, ok


def dedupe_circles(circles, valid, *, height: int, width: int,
                   min_radius: int, max_radius: int, cap: int | None = None):
    """Round, bound-filter and collapse proposals to unique triples.

    ``circles``: three f32 tensors (rows, cols, radii) of shape (M,), or
    (N, M) for a batch of planes; ``valid`` broadcasts against them. The
    uniques come out in ascending (row, col, radius) order, the order of
    both of the JAX package's compactions (the key raster and the sort).

    Returns (uniq (n_unique, 3) int32, n_unique) for one plane, or for a
    batch (uniq (N, cap, 3) int32 zero-padded, uvalid (N, cap) bool,
    n_unique (N,) int64): each plane keeps its first ``cap`` uniques, as
    the JAX package's per-chamber batch does (a static cap, no retry).
    ``cap`` is required for a batch; one plane keeps every unique (the JAX
    package grows its cap until they fit).
    """
    batched = circles[0].ndim == 2
    if not batched:
        uk = circle_keys(circles, valid, height=height, width=width,
                         min_radius=min_radius, max_radius=max_radius)
        return decode_keys(uk, width=width, min_radius=min_radius,
                           max_radius=max_radius), int(uk.numel())
    row, col, rad, ok = _round_filter(
        circles, valid, height=height, width=width, min_radius=min_radius,
        max_radius=max_radius)
    kw = width + 2 * max_radius + 1
    kr = max_radius - min_radius + 1
    space = raster_key_space(height, width, min_radius, max_radius)
    key = ((row + max_radius) * kw + (col + max_radius)) * kr + (
        rad - min_radius)
    if cap is None:
        raise ValueError("dedupe_circles: a batch of planes needs a cap")
    n = row.shape[0]
    plane = torch.arange(n, device=key.device)[:, None]
    # One sort for the batch: plane-major keys, one sentinel per plane.
    key = plane * (space + 1) + torch.where(ok, key, space)
    uk = torch.unique(key)
    p, k = uk // (space + 1), uk % (space + 1)
    live = k < space
    p, k = p[live], k[live]
    n_unique = torch.bincount(p, minlength=n)
    first = torch.cumsum(n_unique, 0) - n_unique
    rank = torch.arange(p.numel(), device=p.device) - first[p]
    keep = rank < cap
    uniq = torch.zeros((n, cap, 3), dtype=torch.int32, device=key.device)
    uniq[p[keep], rank[keep]] = _decode(k[keep], kw, kr, min_radius,
                                        max_radius)
    uvalid = torch.arange(cap, device=key.device)[None, :] < n_unique[:, None]
    return uniq, uvalid, n_unique


def circle_keys(circles, valid, *, height: int, width: int, min_radius: int,
                max_radius: int) -> torch.Tensor:
    """The ascending unique dedupe keys of one plane's proposals (three f32
    tensors (M,)) that pass the round-and-bound filter: a key is a triple's
    index in the (row, col, radius) raster of :func:`raster_key_space`, so
    the union of several sets of proposals is the unique of their keys."""
    row, col, rad, ok = _round_filter(
        circles, valid, height=height, width=width, min_radius=min_radius,
        max_radius=max_radius)
    kw = width + 2 * max_radius + 1
    kr = max_radius - min_radius + 1
    space = raster_key_space(height, width, min_radius, max_radius)
    key = ((row + max_radius) * kw + (col + max_radius)) * kr + (
        rad - min_radius)
    uk = torch.unique(torch.where(ok, key, space))
    return uk[uk < space]


def decode_keys(keys, *, width: int, min_radius: int, max_radius: int):
    """(n, 3) int32 (row, col, radius) triples of :func:`circle_keys`."""
    return _decode(keys, width + 2 * max_radius + 1,
                   max_radius - min_radius + 1, min_radius, max_radius)


def _decode(key, kw, kr, min_radius, max_radius):
    yx = key // kr
    return torch.stack([yx // kw - max_radius, yx % kw - max_radius,
                        key % kr + min_radius], dim=1).to(torch.int32)


@functools.lru_cache(maxsize=None)
def _perimeter_tensors(max_radius: int, device: str):
    from magnify_tpu_torch.ops.geom import perimeter_tables

    offsets, lengths, expected = perimeter_tables(max_radius)
    return (torch.as_tensor(offsets, device=device),
            torch.as_tensor(lengths, device=device),
            torch.as_tensor(expected, device=device))


@functools.lru_cache(maxsize=None)
def _kernel_table(max_radius: int, device: str):
    """The kernel's perimeter table, position-major: (L, max_radius + 1,
    2) int32 pairs {dy << 16 | dx & 0xffff, the f32 bits of the expected
    angle}."""
    from magnify_tpu_torch.ops.geom import perimeter_tables

    offsets, _lengths, expected = perimeter_tables(max_radius)
    dy, dx = (offsets[..., i].astype(np.int64) for i in (0, 1))
    packed = ((dy << 16) | (dx & 0xFFFF)).astype(np.uint32).view(np.int32)
    table = np.stack([packed, expected.view(np.int32)], axis=-1)
    table = table.transpose(1, 0, 2)
    return torch.as_tensor(np.ascontiguousarray(table), device=device)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _pixel_index(circles, offsets, r, p, hp, wp):
    rows = offsets[r, p, 0] + circles[:, 0]
    cols = offsets[r, p, 1] + circles[:, 1]
    return torch.clamp(rows.to(torch.int64) * wp + cols, 0, hp * wp - 1)


def sum_form(n_pos: int) -> str:
    """The reduction XLA's CPU backend compiles for a perimeter of
    ``n_pos`` padded positions (read from the optimized LLVM IR of the
    jitted ``score_circles``): "one" (1 position: the term itself, no +0
    start, so -0.0 survives), "seq" (8 and 12: one sum in position order
    from +0), "lanes8" (16-32: 8 vector lanes, lane j summing positions j,
    j + 8, ... in order, then halved 8 -> 4 -> 2 -> 1) or "windows" (above
    32: windows of 32, each summed in order from +0, then the window sums
    in order)."""
    if n_pos == 1:
        return "one"
    if n_pos < 16:
        return "seq"
    return "lanes8" if n_pos <= 32 else "windows"


def _check_scorer_shapes(grad_angles, edges, circles, valid, name):
    if grad_angles.shape != edges.shape or grad_angles.ndim not in (2, 3):
        raise ValueError(f"{name}: angles and edges of one (H, W) or "
                         "(P, H, W) shape required")
    if grad_angles.ndim == 2:
        fits = circles.ndim == 2
    else:
        fits = circles.ndim == 3 and circles.shape[0] == grad_angles.shape[0]
    if not fits or circles.shape[-1] != 3:
        raise ValueError(f"{name}: circles {tuple(circles.shape)} do not fit "
                         f"planes {tuple(grad_angles.shape)}: (N, 3) for one "
                         "plane, (P, K, 3) for P planes")
    if valid is not None and valid.shape != circles.shape[:-1]:
        raise ValueError(f"{name}: valid {tuple(valid.shape)} does not fit "
                         f"circles {tuple(circles.shape)}")


def score_circles_plain(grad_angles, edges, circles, valid=None, *,
                        max_radius: int, pad: int | None = None
                        ) -> torch.Tensor:
    """Roundness score per circle in plain torch: the twin of
    :func:`perimeter_score`, bit-identical to it and to the JAX package's
    jitted ``score_circles`` on the CPU.

    Pads the planes by ``pad`` and runs the reference's program on them:
    per perimeter position (a Python loop over the L positions on (N,)
    vectors), align = fma(|wrap(|a - e|) - pi/2|, f32(4/pi), -1) at edge
    pixels, summed in XLA's CPU order (:func:`sum_form`), then divided by
    the perimeter length. Arguments as :func:`score_circles`.
    """
    _check_scorer_shapes(grad_angles, edges, circles, valid,
                         "score_circles_plain")
    pad = 2 * int(max_radius) if pad is None else int(pad)
    ga = F.pad(grad_angles, (pad,) * 4)
    eg = F.pad(edges, (pad,) * 4)
    angles_flat = ga.reshape(-1)
    edges_flat = eg.reshape(-1)
    hp, wp = ga.shape[-2:]
    dev = circles.device
    offsets, lengths, expected = _perimeter_tensors(int(max_radius),
                                                    str(dev))
    n_pos = offsets.shape[1]
    c = circles.reshape(-1, 3).to(torch.int64)
    r = torch.clamp(c[:, 2], 0, int(max_radius))
    n_r = lengths[r]
    base = 0
    if circles.ndim == 3:
        k = circles.shape[1]
        base = torch.arange(circles.shape[0], device=dev).repeat_interleave(
            k) * (hp * wp)

    def f32(v):
        return torch.tensor(np.float32(v), device=dev)

    pi, half_pi, four_over_pi = f32(np.pi), f32(np.pi / 2), f32(4 / np.pi)
    minus_one = f32(-1.0).expand(c.shape[0])

    def align_hit(p):
        idx = base + _pixel_index(c, offsets, r, p, hp, wp)
        d = torch.abs(angles_flat[idx] - expected[r, p])
        d = torch.where(d > pi, d + (-pi), d)
        align = fma_f32(torch.abs(d + (-half_pi)),
                        four_over_pi.expand_as(d), minus_one)
        return align, edges_flat[idx].to(torch.bool) & (p < n_r)

    def add_term(acc, p):
        align, hit = align_hit(p)
        return torch.where(hit, acc + align, acc)

    zeros = torch.zeros(c.shape[0], dtype=torch.float32, device=dev)
    form = sum_form(n_pos)
    if form == "one":
        align, hit = align_hit(0)
        total = align * hit.to(torch.float32)
    elif form == "seq":
        total = zeros
        for p in range(n_pos):
            total = add_term(total, p)
    elif form == "lanes8":
        lanes = [zeros] * 8
        for p in range(n_pos):
            lanes[p % 8] = add_term(lanes[p % 8], p)
        lanes = [lanes[k] + lanes[k + 4] for k in range(4)]
        lanes = [lanes[k] + lanes[k + 2] for k in range(2)]
        total = lanes[0] + lanes[1]
    else:
        n_windows = -(-n_pos // 32)
        lead = (n_windows * 32 - n_pos) // 2
        total = zeros
        for w in range(n_windows):
            acc = zeros
            for p in range(max(w * 32 - lead, 0),
                           min(w * 32 - lead + 32, n_pos)):
                acc = add_term(acc, p)
            total = total + acc
    scores = (total / n_r.to(torch.float32)).reshape(circles.shape[:-1])
    if valid is not None:
        scores = torch.where(valid, scores, -torch.inf)
    return scores


#: Warps a SM should have in flight: a call with fewer circles than their
#: lanes spreads each circle's positions over lanes.
_WARPS_PER_SM = 32


def spread_lanes(n_pos: int) -> int:
    """Lanes that share a circle of ``n_pos`` perimeter positions when its
    positions are spread: one per pair of 32-position windows (L > 32), 8
    (the 8 vector lanes, L = 16-32), else 1."""
    form = sum_form(n_pos)
    if form == "windows":
        return (-(-n_pos // 32) + 1) // 2
    return 8 if form == "lanes8" else 1


def perimeter_plan(circles, *, max_radius: int) -> int:
    """Lanes a circle takes in :func:`perimeter_score`'s launch: one where
    the call has circles for :data:`_WARPS_PER_SM` warps on every SM at one
    lane each, else :func:`spread_lanes` (where they are at most 32)."""
    n_pos = _perimeter_tensors(int(max_radius), "cpu")[0].shape[1]
    n = int(np.prod(circles.shape[:-1]))
    lanes = spread_lanes(n_pos)
    full = _sm_count(circles.device) * _WARPS_PER_SM * 32
    return lanes if n < full and lanes <= 32 else 1


def perimeter_score(grad_angles, edges, circles, valid=None, *,
                    max_radius: int, pad: int | None = None,
                    plan: int | None = None) -> torch.Tensor:
    """The CUDA kernel ``csrc/perimeter_score.cu``: one launch on the
    current stream (its plan: :func:`perimeter_plan`), no host sync.
    Arguments as :func:`score_circles`; every tensor on one CUDA device.
    ``plan`` (lanes a circle) overrides :func:`perimeter_plan`'s, for
    timing."""
    global perimeter_launches, perimeter_batched_launches
    dev = circles.device
    if dev.type != "cuda":
        raise ValueError(f"perimeter_score: unsupported device {dev}")
    for name, t in (("grad_angles", grad_angles), ("edges", edges)) + (
            (("valid", valid),) if valid is not None else ()):
        if t.device != dev:
            raise ValueError(f"perimeter_score: {name} on {t.device}, "
                             f"circles on {dev}")
    if grad_angles.dtype != torch.float32 or edges.dtype != torch.bool:
        raise TypeError("perimeter_score: f32 angles and bool edges "
                        f"required, got {grad_angles.dtype}, {edges.dtype}")
    _check_scorer_shapes(grad_angles, edges, circles, valid,
                         "perimeter_score")
    pad = 2 * int(max_radius) if pad is None else int(pad)
    h, w = grad_angles.shape[-2:]
    hp, wp = h + 2 * pad, w + 2 * pad
    n = int(np.prod(circles.shape[:-1]))
    if pad < 0 or hp * wp >= 2**31 or n >= 2**31 or (
            grad_angles.numel() >= 2**31):
        raise ValueError(f"perimeter_score: {n} circles on {h}x{w} planes "
                         f"padded by {pad} exceed the kernel's indices")
    offsets, lengths, _expected = _perimeter_tensors(int(max_radius),
                                                     str(dev))
    out = torch.empty(circles.shape[:-1], dtype=torch.float32, device=dev)
    if n == 0:
        return out
    lanes = plan or perimeter_plan(circles, max_radius=max_radius)
    angles = grad_angles.contiguous()
    edges_u8 = edges.contiguous().view(torch.uint8)
    circ = circles.to(torch.int32).contiguous()
    valid_u8 = None if valid is None else \
        valid.to(torch.bool).contiguous().view(torch.uint8)
    per_plane = circles.shape[1] if circles.ndim == 3 else n
    table = _kernel_table(int(max_radius), str(dev))
    with torch.cuda.device(dev):  # the launch goes to the tensors' card
        err = _build.load().mg_perimeter_score(
            angles.data_ptr(), edges_u8.data_ptr(), h, w, pad,
            circ.data_ptr(),
            None if valid_u8 is None else valid_u8.data_ptr(), n, per_plane,
            table.data_ptr(), lengths.data_ptr(), int(max_radius),
            offsets.shape[1], lanes, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    perimeter_launches += 1
    perimeter_batched_launches += int(circles.ndim == 3)
    _build.check(err, "mg_perimeter_score")
    return out


def score_circles(grad_angles, edges, circles, valid=None, *,
                  max_radius: int, pad: int | None = None) -> torch.Tensor:
    """Roundness score per circle (the reference's ``mean_grad``): the mean
    perimeter alignment of the gradient angles at edge pixels.

    ``grad_angles`` f32 and ``edges`` bool are the unpadded planes, one
    (H, W) or a batch (P, H, W). ``circles`` (row, col, radius) int32 are
    in the coordinates of those planes padded by ``pad`` (default ``2 *
    max_radius``, the reference's padding): (N, 3) for one plane, (P, K,
    3) for K circles on each plane of a batch. A perimeter pixel is read where the
    reference reads it: at its flat index into the padded plane, clamped
    into that plane (a column past the edge wraps into the next row); pad
    pixels are not edges. Rows where ``valid`` (of the circles' leading
    shape) is False score ``-inf``. Returns scores of the circles' leading
    shape. CUDA tensors launch :func:`perimeter_score`, CPU tensors run
    :func:`score_circles_plain`; both give the JAX package's scores bit for
    bit.
    """
    if circles.device.type == "cpu":
        return score_circles_plain(grad_angles, edges, circles, valid,
                                   max_radius=max_radius, pad=pad)
    return perimeter_score(grad_angles, edges, circles, valid,
                           max_radius=max_radius, pad=pad)
