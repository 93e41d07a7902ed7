"""Exact greedy neighbor suppression with claimed-raster semantics.

Each accepted circle claims its exclusion ring (a 4-connected Bresenham
ring of radius ``min_dist``); a lower-scoring circle whose ring touches a
claimed pixel is rejected. Torch port of the raster rounds of
``magnify_tpu.ops.nms._parallel_greedy_nms``: the greedy result in
O(conflict-chain depth) parallel rounds instead of one step per circle.
"""

from __future__ import annotations

import numpy as np
import torch

from magnify_tpu_torch import utils

__all__ = ["parallel_greedy_nms"]

_BIG = np.iinfo(np.int32).max


def parallel_greedy_nms(circles: torch.Tensor, valid: torch.Tensor, *,
                        min_dist: int, height: int, width: int,
                        max_radius: int) -> torch.Tensor:
    """Accepted mask of ``circles`` ((n, 3) int (row, col, radius), sorted
    best first, ``valid`` masking live rows). Each round:

    * scatter-min every live circle's priority onto its ring pixels,
    * accept live circles whose ring sees no better live priority (their
      greedy fate cannot depend on undecided circles),
    * reject live circles whose ring touches an accepted ring.
    """
    if min_dist <= 0:
        return valid
    n = circles.shape[0]
    dev = circles.device
    ring = torch.as_tensor(utils.circle_points(min_dist, four_connected=True),
                           dtype=torch.int64, device=dev)
    shift = max_radius + min_dist + 1
    rh = height + 2 * shift
    rw = width + 2 * shift
    sink = rh * rw  # one slot past the raster takes the masked scatters

    c = circles.to(torch.int64)
    idx = ((ring[None, :, 0] + c[:, None, 0] + shift) * rw
           + ring[None, :, 1] + c[:, None, 1] + shift)
    idx = torch.clamp(idx, 0, rh * rw - 1)  # (n, L)
    priority = torch.arange(n, dtype=torch.int32, device=dev)
    pri_src = priority[:, None].expand(idx.shape).reshape(-1)

    live = valid.clone()
    accepted = torch.zeros_like(valid)
    progressed = True
    while progressed and bool(live.any()):
        pri_raster = torch.full((sink + 1,), _BIG, dtype=torch.int32,
                                device=dev)
        scatter_idx = torch.where(live[:, None], idx, sink).reshape(-1)
        pri_raster.scatter_reduce_(0, scatter_idx, pri_src, "amin")
        ring_best = pri_raster[idx].amin(dim=1)
        newly = live & (ring_best == priority)
        acc_raster = torch.zeros((sink + 1,), dtype=torch.bool, device=dev)
        acc_raster[torch.where((accepted | newly)[:, None], idx, sink)] = True
        conflicted = acc_raster[idx].any(dim=1)
        accepted = accepted | newly
        live = live & ~newly & ~conflicted
        progressed = bool(newly.any())
    return accepted
