"""Canny hysteresis: the CUDA kernel (``csrc/hysteresis.cu``) and its plain twin.

The counterpart of ``magnify_tpu.ops.pallas_kernels``: both of its Pallas
kernels (the whole-plane ``_hysteresis_call`` and the tiled
``_hysteresis_tiled_call``) compute the least fixpoint of
``cur = cur | (weak & dilate8(cur))`` from ``cur = strong``, and one tiled
CUDA kernel computes it here for every plane size.

:func:`hysteresis` launches the kernel for CUDA tensors and runs
:func:`hysteresis_plain` (the XLA ``dilate8`` loop of
``magnify_tpu.ops.edge.canny``, written in torch) for CPU tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from magnify_tpu_torch import _build

__all__ = ["hysteresis", "hysteresis_plain", "launches", "last_sweeps"]

#: Kernel launches (one per sweep) since the count was last reset.
launches = 0
#: Sweeps the last CUDA call took to reach the fixpoint.
last_sweeps = 0

DEFAULT_TILE_ROWS = 32
MAX_TILE_ROWS = 128  # keeps the two shared-memory tiles under 48 KB


def dilate8(m: torch.Tensor) -> torch.Tensor:
    """One step of 8-connected boolean dilation (zero border)."""
    h, w = m.shape
    p = F.pad(m.to(torch.uint8), (1, 1, 1, 1)).bool()
    acc = m
    for dr in (-1, 0, 1):
        for dc in (-1, 0, 1):
            if dr or dc:
                acc = acc | p[1 + dr:1 + dr + h, 1 + dc:1 + dc + w]
    return acc


def hysteresis_plain(strong: torch.Tensor, weak: torch.Tensor) -> torch.Tensor:
    """Grow ``strong`` through ``weak`` to the fixpoint, one dilation a step."""
    cur = strong
    while True:
        grown = dilate8(cur) & weak | cur
        if torch.equal(grown, cur):
            return grown
        cur = grown


def hysteresis(strong: torch.Tensor, weak: torch.Tensor,
               tile_rows: int | None = None) -> torch.Tensor:
    """Grow strong seeds through weak pixels (8-connectivity) to fixpoint.

    ``strong``/``weak``: (H, W) bool on one device. CPU tensors take the
    plain twin; CUDA tensors take the kernel, sweeping until a sweep
    changes nothing. ``tile_rows`` sets the kernel's tile height (the
    ``tile_rows`` of the Pallas tiled kernel): small tiles force edge chains
    across many tile borders.
    """
    global launches, last_sweeps
    if strong.device.type == "cpu" and weak.device.type == "cpu":
        return hysteresis_plain(strong, weak)
    if strong.device.type != "cuda" or weak.device != strong.device:
        raise ValueError(
            f"hysteresis: tensors on {strong.device} and {weak.device}; "
            "both must be on one CUDA device (or both on the CPU)")
    if strong.dtype != torch.bool or weak.dtype != torch.bool:
        raise TypeError(f"hysteresis: bool masks required, got "
                        f"{strong.dtype} and {weak.dtype}")
    if strong.ndim != 2 or strong.shape != weak.shape:
        raise ValueError(f"hysteresis: shapes {tuple(strong.shape)} and "
                         f"{tuple(weak.shape)}; one (H, W) shape required")
    tile_rows = DEFAULT_TILE_ROWS if tile_rows is None else int(tile_rows)
    if not 1 <= tile_rows <= MAX_TILE_ROWS:
        raise ValueError(f"tile_rows must be in [1, {MAX_TILE_ROWS}]")
    h, w = strong.shape
    weak_u8 = weak.contiguous().view(torch.uint8)
    out = torch.empty((h, w), dtype=torch.uint8, device=strong.device)
    out.copy_(strong)
    if h == 0 or w == 0:
        return out.view(torch.bool)
    changed = torch.empty(1, dtype=torch.int32, device=strong.device)
    lib = _build.load()
    stream = torch.cuda.current_stream(strong.device).cuda_stream
    sweeps = 0
    while True:
        changed.zero_()
        err = lib.mg_hysteresis_sweep(out.data_ptr(), weak_u8.data_ptr(), h,
                                      w, tile_rows, changed.data_ptr(),
                                      stream)
        launches += 1
        sweeps += 1
        _build.check(err, "mg_hysteresis_sweep")
        if int(changed.item()) == 0:
            break
    last_sweeps = sweeps
    return out.view(torch.bool)
