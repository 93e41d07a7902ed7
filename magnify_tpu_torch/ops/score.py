"""Dense roundness scoring: int8 ring-correlation score maps.

The reference's per-pixel alignment score ``4*|wrap(|a - e|) - pi/2|/pi - 1``
equals ``(8/pi^2) * sum_{k odd} cos(2k (a - e)) / k^2``, which separates the
image angle ``a`` from the ring angle ``e``: scoring every (center, radius)
becomes a correlation of per-harmonic features ``edge * (cos 2ka, sin 2ka)``
with a ring kernel per radius. Torch port of the int8, unfolded (s2d = 1)
form of ``magnify_tpu.ops.score.score_maps``; the int8 maps do not depend
on the space-to-depth fold, so the fold is not carried over.

The ring kernels are built by numpy code copied from the JAX package and
are array-equal to its tables (harmonics k <= 7, the JAX default). The
correlation itself is the CUDA kernel ``csrc/ring_corr.cu`` for CUDA
tensors and a float64 ``conv2d`` (exact on int8 values) for CPU tensors.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from magnify_tpu_torch import _build, utils
from magnify_tpu_torch.ops.edge import fma_f32

__all__ = ["RingWeights", "ring_corr", "ring_corr_plain", "ring_weights",
           "score_maps"]

_HARMONICS = (1, 3, 5, 7)
_COEFFS = tuple(8.0 / (np.pi**2 * k**2) for k in _HARMONICS)

#: Kernel launches of :func:`ring_corr` since the count was last reset.
launches = 0
#: Those of them that calls on a batch (N, C, H, W) made.
batched_launches = 0


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

# The CPU convolution unfolds C*K*K doubles per output pixel (46 GB for a
# 1024^2 frame's padded plane at radii 8-12): bands of rows bound it.
_CPU_UNFOLD_BYTES = 1 << 28


# Planes of a batch that one float64 convolution takes on a card: bounds the
# f64 copies of features and maps (1,568 padded chamber crops would hold
# 4 GB of them at once).
_PLAIN_BATCH_BYTES = 1 << 30


def ring_corr_plain(feats: torch.Tensor, weights: RingWeights) -> torch.Tensor:
    """float64 correlation of int8 values: every product and partial sum is
    an integer below 2^53, so any algorithm gives the exact int32 result.
    ``feats``: (C, H, W) or a batch (N, C, H, W)."""
    if feats.ndim == 3:
        return ring_corr_plain(feats[None], weights)[0]
    n_r, c_in, k, _ = weights.dense.shape
    rad = k // 2
    n, _, h, w = feats.shape
    wt = weights.dense.to(torch.float64)
    rows = h
    if feats.device.type == "cpu":
        rows = max(1, _CPU_UNFOLD_BYTES // (c_in * k * k * max(w, 1) * 8))
    per_plane = 8 * (c_in * (h + 2 * rad) * (w + 2 * rad) + n_r * h * w)
    planes = max(1, _PLAIN_BATCH_BYTES // max(per_plane, 1))
    out = torch.empty((n, n_r, h, w), dtype=torch.int32, device=feats.device)
    for n0 in range(0, n, planes):
        fp = F.pad(feats[n0:n0 + planes].to(torch.float64),
                   (rad, rad, rad, rad))
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
    err = lib.mg_ring_corr(
        feats.data_ptr(), n, h, w, table.data_ptr(), offsets.data_ptr(), n_r,
        n_pos, rad, out.data_ptr(),
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


def alignment_features_q8(edges, dx, dy) -> torch.Tensor:
    """int8 per-harmonic (edge*cos(2ka), edge*sin(2ka)) channels,
    ``round(127 * feature)``: the ``qdtype="int8"`` form of
    ``magnify_tpu.ops.score._alignment_features`` with ``grads=(dx, dy)``.

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
