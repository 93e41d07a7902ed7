"""The least time each hand kernel could take for the work of a call.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, 700 W): the run prints the card's power limit beside them. A
call's bound is the larger of its bytes over the memory bandwidth and its
operations over the peak rate of their type. Each input byte is counted
once and each output byte once, whatever the kernel reads again, and the
work is what these inputs need, not the most they could need. (The
arithmetic is the kernel records' of ``chip_smoke.py``.)
"""

from __future__ import annotations

import numpy as np

from bench_torch import geometry

HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15
F32_OPS_PER_S = 67e12  # float32 outside the tensor cores


def bound_s(n_bytes: float, n_ops: float, ops_per_s: float) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s)


def hysteresis_work(n_pixels: int) -> tuple:
    """(bytes, ops, peak): strong and weak masks read once, the result
    written once, 1 byte each a pixel; no arithmetic to speak of."""
    return 3 * n_pixels, 0, INT8_OPS_PER_S


def ring_corr_work(n_pixels: int, n_radii: int, n_taps: int) -> tuple:
    """(bytes, ops, peak) of the int8 ring correlation over ``n_pixels``
    pixels (all planes): 8 int8 features read and ``n_radii`` int32 maps
    written a pixel, one multiply and one add per nonzero weight (all
    ``n_taps`` of them, over radii and channels) and pixel."""
    return ((8 + 4 * n_radii) * n_pixels, 2 * n_taps * n_pixels,
            INT8_OPS_PER_S)


def perimeter_work(n_circles: int, has_valid: bool, n_valid: int,
                   batched: bool, edge_hits: int, touched: int,
                   touched_edges: int) -> tuple:
    """(bytes, ops, peak) of the RANSAC perimeter scorer: every circle's
    score (4 B) and valid flag (1 B) once, each valid circle (12 B) and its
    plane index (4 B, batched calls) once, the edge flag (1 B) of each
    distinct perimeter pixel and the angle (4 B) of each distinct edge
    pixel among them once; float32 work of 6 operations at each edge pixel
    of a perimeter and a division a valid circle."""
    n_bytes = (n_circles * (4 + has_valid) + n_valid * (12 + 4 * batched)
               + touched + 4 * touched_edges)
    return n_bytes, 6 * edge_hits + n_valid, F32_OPS_PER_S


def perimeter_counts(edges, circles, valid, max_radius: int,
                     pad: int) -> tuple:
    """What the scorer must touch for these inputs (torch tensors, on any
    device): (valid circles, edge pixels on their perimeters, distinct
    perimeter pixels, distinct edge pixels among them). Counted on the
    planes padded by ``pad``, where the reference reads them, at the
    clamped flat index of the padded plane (batch), as the scorer reads
    them."""
    import torch
    import torch.nn.functional as F

    dev = circles.device
    table = [geometry.perimeter(r) for r in range(max_radius + 1)]
    longest = max(len(t) for t in table)
    offsets = np.zeros((max_radius + 1, longest, 2), np.int64)
    lengths = np.array([len(t) for t in table], np.int64)
    for r, t in enumerate(table):
        offsets[r, :len(t)] = t
    offsets = torch.as_tensor(offsets, device=dev)
    lengths = torch.as_tensor(lengths, device=dev)
    c = circles.reshape(-1, 3).to(torch.int64)
    r = torch.clamp(c[:, 2], 0, max_radius)
    padded = F.pad(edges, (pad,) * 4)
    hp, wp = padded.shape[-2:]
    base = 0
    if circles.ndim == 3:
        base = torch.arange(circles.shape[0], device=dev).repeat_interleave(
            circles.shape[1]) * (hp * wp)
    flat = padded.reshape(-1).to(torch.bool)
    live = (torch.ones_like(r, dtype=torch.bool) if valid is None
            else valid.reshape(-1).to(torch.bool))
    seen = torch.zeros_like(flat)
    hits = torch.zeros((), dtype=torch.int64, device=dev)
    for p in range(longest):
        rows = offsets[r, p, 0] + c[:, 0]
        cols = offsets[r, p, 1] + c[:, 1]
        idx = base + torch.clamp(rows * wp + cols, 0, hp * wp - 1)
        on = live & (p < lengths[r])
        seen[idx[on]] = True
        hits += (flat[idx] & on).sum()
    return (int(live.sum()), int(hits), int(seen.sum()),
            int((seen & flat).sum()))


def share_pct(trace, bound_total_s: float, kernel_prefix: str):
    """Bound over the device time of the kernels whose name starts with
    ``kernel_prefix`` (after the ``void`` of a template's name and an
    ``(anonymous namespace)::``), in %; None where the window ran none of
    them."""
    def match(name):
        name = name.removeprefix("void ").removeprefix(
            "(anonymous namespace)::")
        return name.startswith(kernel_prefix)

    spent = trace.kernel_s(match)
    if spent <= 0 or bound_total_s <= 0:
        return None
    return 100.0 * bound_total_s / spent
