"""Monte-Carlo circumcircle proposals (the RANSAC detector's sampler).

Torch port of ``magnify_tpu.ops.ransac.candidate_circles``, bit for bit:
each of ``num_iter`` iterations draws one edge pixel uniformly, then two
edge pixels of its grid cell, and proposes their circumcircle. The random
streams are the JAX package's threefry streams (:mod:`.prng`): with
``k0, k1, k2 = split(key, 3)``, the edge pixel is ``randint(k0, 0, total)``
into the edge pixels listed cell by cell, and the two neighbours are
``min(trunc(uniform(k1 or k2) * count), count - 1)`` into the cell's list.

The circumcircle algebra is the JAX package's f32 arithmetic, rounded as
its compiled CPU program rounds it: every operation once, except that LLVM
contracts ``m1 * col + b1`` (the centre's row) and ``col * col + row * row``
(the squared radius) into fused multiply-adds (``fma_f32``). The other
candidates for contraction, ``0.5 * p_r - m * (0.5 * p_c)``, fuse their
exact ``0.5 * p_r`` and round the same either way.

The JAX package's TPU layouts (the 128-lane row gathers, the interleaved
start/count table) are left out: they gather the same values.
"""

from __future__ import annotations

import numpy as np
import torch

from magnify_tpu_torch import diagnostics
from magnify_tpu_torch.ops import prng
from magnify_tpu_torch.ops.edge import fma_f32, sqrt_f32

__all__ = ["candidate_circles"]


@diagnostics.span("ransac.sampler", device=True)
def candidate_circles(edges: torch.Tensor, grid_length: int, num_iter: int,
                      key: torch.Tensor, start=None, count: int | None = None):
    """Propose ``num_iter`` circles from an edge mask.

    ``edges``: (H, W) bool with ``key`` (2,), or a batch (N, H, W) with one
    key per plane, ``keys`` (N, 2) (the chip path's per-chamber crops under
    ``split(PRNGKey(seed), N)``). Returns ((rows, cols, radii), any_edges):
    three f32 tensors (num_iter,) (or (N, num_iter)) and a bool that is
    False for a plane without edge pixels, whose proposals are then
    meaningless (every sample is pixel 0) and must be dropped.

    ``start`` and ``count`` take slices of the ``num_iter`` proposals
    instead: proposals ``start .. start + count - 1``, each exactly the
    proposal of that index in the whole run (the streams are counter
    based). ``start`` may be a 1-D int64 tensor of slice starts; the
    slices then come one after another, ``len(start) * count`` proposals
    (the mesh detector's slices of one device in one call).
    """
    draws = num_iter
    if start is not None:
        starts = torch.as_tensor(start, dtype=torch.int64).reshape(-1)
        if count is None or count < 0:
            raise ValueError("a slice of the proposals needs its count")
        if starts.numel() and (int(starts.min()) < 0
                               or int(starts.max()) + count > num_iter):
            raise ValueError(f"proposal slices of {count} at "
                             f"{starts.tolist()} leave 0..{num_iter}")
        draws = (starts[:, None] + torch.arange(count)).reshape(-1)
    batched = edges.ndim == 3
    if not batched:
        edges, key = edges[None], key[None]
    n, h, w = edges.shape
    dev = edges.device
    g = int(grid_length)
    n_grid_cols = -(-w // g)

    # Edge pixels listed cell by cell (cells row-major, the pixels of a cell
    # row-major), all planes in one table: plane b's run starts at base[b].
    # A pixel's place in its plane's list has a closed form: the pixels of
    # the cell rows above it, of the cells left of it in its cell row, and
    # those before it in its own cell. One zero past the end serves planes
    # without edges (the JAX package's zero-padded table gives them pixel 0).
    hw = h * w
    ids = torch.nonzero(edges.reshape(-1)).reshape(-1)  # plane-major
    pix = ids % hw
    r, c = pix // w, pix % w
    top, left = r - r % g, c - c % g
    rank = (top * w + torch.clamp(h - top, max=g) * left
            + (r % g) * torch.clamp(w - left, max=g) + c % g)
    order = torch.cat([pix[torch.sort(ids - pix + rank).indices],
                       torch.zeros(1, dtype=pix.dtype, device=dev)])
    totals = edges.reshape(n, hw).sum(dim=1)
    any_edges = totals > 0
    base = (torch.cumsum(totals, 0) - totals)[:, None]

    gh, gw = -(-h // g) * g, -(-w // g) * g
    padded = torch.zeros((n, gh, gw), dtype=torch.int64, device=dev)
    padded[:, :h, :w] = edges
    counts = padded.reshape(n, gh // g, g, gw // g, g).sum((2, 4))
    counts = counts.reshape(n, -1)
    starts = torch.cumsum(counts, 1) - counts
    counts = torch.clamp(counts, min=1)

    keys = prng.split(key, 3)  # (N, 3, 2)
    u0 = prng.randint(keys[:, 0], draws, 0,
                      torch.clamp(totals, min=1)[:, None])

    def pixel(slot):
        """Pixel id at ``slot`` of each plane's list (0 without edges)."""
        ids = order[base + slot]
        return torch.where(any_edges[:, None], ids, torch.zeros_like(ids))

    p0 = pixel(u0.to(torch.int64))
    p0r, p0c = p0 // w, p0 % w
    cell = (p0r // g) * n_grid_cols + p0c // g
    c_starts = torch.gather(starts, 1, cell)
    c_counts = torch.gather(counts, 1, cell)
    cf = c_counts.to(torch.float32)

    def neighbour(k):
        u = prng.uniform(keys[:, k], draws)
        off = torch.minimum((u * cf).to(torch.int64), c_counts - 1)
        p = pixel(c_starts + off)
        return ((p // w - p0r).to(torch.float32),
                (p % w - p0c).to(torch.float32))

    p1r, p1c = neighbour(1)
    p2r, p2c = neighbour(2)

    eps = torch.tensor(np.float32(1e-20), device=dev)
    half = torch.tensor(np.float32(0.5), device=dev)
    m1 = -p1c / (p1r + eps)
    m2 = -p2c / (p2r + eps)
    b1 = half * p1r - m1 * (half * p1c)
    b2 = half * p2r - m2 * (half * p2c)
    col = (b1 - b2) / (m2 - m1 + eps)
    row = fma_f32(m1, col, b1)
    radius = sqrt_f32(fma_f32(col, col, row * row))
    out = (row + p0r.to(torch.float32), col + p0c.to(torch.float32), radius)
    if not batched:
        return tuple(v[0] for v in out), any_edges[0]
    return out, any_edges
