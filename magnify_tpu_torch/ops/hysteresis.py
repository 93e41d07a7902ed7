"""Canny hysteresis: the CUDA kernel (``csrc/hysteresis.cu``) and its plain twin.

The counterpart of ``magnify_tpu.ops.pallas_kernels``: both of its Pallas
kernels (the whole-plane ``_hysteresis_call`` and the tiled
``_hysteresis_tiled_call``) compute the least fixpoint of
``cur = cur | (weak & dilate8(cur))`` from ``cur = strong``. The CUDA
kernel computes the same set as ``F & (the 8-connected component of F
holds a strong pixel)`` with ``F = weak | strong`` (the argument is in the
source header), by union-find labelling in four launches per call: one
plane, or a batch of planes of one size (the chip path's per-chamber crops,
which the JAX package grows with a vmapped ``while_loop``).

:func:`hysteresis` launches the kernel for CUDA tensors and runs
:func:`hysteresis_plain` (the XLA ``dilate8`` loop of
``magnify_tpu.ops.edge.canny``, written in torch) for CPU tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from magnify_tpu_torch import _build

__all__ = ["hysteresis", "hysteresis_plain", "launches", "batched_launches",
           "LAUNCHES_PER_CALL"]

#: Kernel launches since the count was last reset.
launches = 0
#: Those of them that calls on a batch (N, H, W) made.
batched_launches = 0
#: Kernel launches of one call on a non-empty plane or batch of planes:
#: local labelling, border merge, seed marking, output.
LAUNCHES_PER_CALL = 4

# 16 x 128 tiles: of 8/16/32/64/128 rows, the fastest on a 1024^2 frame's
# masks and within 2% of 8 rows on an 1844^2 frame's (PERF.md, Findings;
# scripts/torch_profile_frame.py sweeps them).
DEFAULT_TILE_ROWS = 16
MAX_TILE_ROWS = 128  # 64 KB of int32 labels per tile in shared memory


def dilate8(m: torch.Tensor) -> torch.Tensor:
    """One step of 8-connected boolean dilation (zero border) of every
    (H, W) plane of ``m``."""
    h, w = m.shape[-2:]
    p = F.pad(m.to(torch.uint8), (1, 1, 1, 1)).bool()
    acc = m
    for dr in (-1, 0, 1):
        for dc in (-1, 0, 1):
            if dr or dc:
                acc = acc | p[..., 1 + dr:1 + dr + h, 1 + dc:1 + dc + w]
    return acc


def hysteresis_plain(strong: torch.Tensor, weak: torch.Tensor) -> torch.Tensor:
    """Grow ``strong`` through ``weak`` to the fixpoint, one dilation a step.

    A batch (N, H, W) grows all its planes together until none changes: a
    plane at its fixpoint no longer moves, so each plane ends where it
    would alone."""
    cur = strong
    while True:
        grown = dilate8(cur) & weak | cur
        if torch.equal(grown, cur):
            return grown
        cur = grown


def hysteresis(strong: torch.Tensor, weak: torch.Tensor,
               tile_rows: int | None = None) -> torch.Tensor:
    """Grow strong seeds through weak pixels (8-connectivity) to fixpoint.

    ``strong``/``weak``: (H, W) or (N, H, W) bool on one device; the planes
    of a batch are grown independently. CPU tensors take the plain twin;
    CUDA tensors take the kernel: a fixed sequence of
    :data:`LAUNCHES_PER_CALL` launches on the current stream for the whole
    batch, with no host sync. ``tile_rows`` sets the kernel's tile height
    (the ``tile_rows`` of the Pallas tiled kernel): small tiles force edge
    chains across many tile borders.
    """
    global launches, batched_launches
    if strong.device.type == "cpu" and weak.device.type == "cpu":
        return hysteresis_plain(strong, weak)
    if strong.device.type != "cuda" or weak.device != strong.device:
        raise ValueError(
            f"hysteresis: tensors on {strong.device} and {weak.device}; "
            "both must be on one CUDA device (or both on the CPU)")
    if strong.dtype != torch.bool or weak.dtype != torch.bool:
        raise TypeError(f"hysteresis: bool masks required, got "
                        f"{strong.dtype} and {weak.dtype}")
    if strong.ndim not in (2, 3) or strong.shape != weak.shape:
        raise ValueError(f"hysteresis: shapes {tuple(strong.shape)} and "
                         f"{tuple(weak.shape)}; one (H, W) or (N, H, W) "
                         "shape required")
    tile_rows = DEFAULT_TILE_ROWS if tile_rows is None else int(tile_rows)
    if not 1 <= tile_rows <= MAX_TILE_ROWS:
        raise ValueError(f"tile_rows must be in [1, {MAX_TILE_ROWS}]")
    h, w = strong.shape[-2:]
    n_planes = strong.shape[0] if strong.ndim == 3 else 1
    # A label is a pixel's offset in the whole batch.
    if n_planes * h * w >= 2**31 - 1:
        raise ValueError(f"hysteresis: {n_planes} plane(s) of {h}x{w} "
                         "exceed int32 labels")
    out = torch.empty(strong.shape, dtype=torch.uint8, device=strong.device)
    if out.numel() == 0:
        return out.view(torch.bool)
    strong_u8 = strong.contiguous().view(torch.uint8)
    weak_u8 = weak.contiguous().view(torch.uint8)
    labels = torch.empty(strong.shape, dtype=torch.int32,
                         device=strong.device)
    with torch.cuda.device(strong.device):  # the launch goes to its card
        err = _build.load().mg_hysteresis(
            strong_u8.data_ptr(), weak_u8.data_ptr(), n_planes, h, w,
            tile_rows, labels.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(strong.device).cuda_stream)
    launches += LAUNCHES_PER_CALL
    if strong.ndim == 3:
        batched_launches += LAUNCHES_PER_CALL
    _build.check(err, "mg_hysteresis")
    return out.view(torch.bool)
