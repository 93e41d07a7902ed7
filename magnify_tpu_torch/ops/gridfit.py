"""Chip-grid geometry on a device: 1-D clustering, per-cluster regression.

Torch port of ``magnify_tpu.ops.gridfit``: the exhaustive 1-D grid-offset
sweep (``cluster_1d_dev``), fixed-geometry interval labelling
(``label_clusters_dev``) and the robust per-cluster line fits
(``regress_clusters_dev``), so that a whole chip timestep (detection, grid
fit, per-chamber refinement) stays on one device.

Everything is float32, as in the JAX package. The offset sweep evaluates
per-cluster squared deviations directly against each candidate grid's
cluster centers (deviations are bounded by the cluster length, so the f32
sums are well conditioned), and regression slopes use mean-centered second
moments. The sums reduce in another order than XLA's, so slopes and
intercepts agree with the JAX package to about 1e-4 of a pixel, not bit for
bit; labels are exact unless an integer point sits within f32 rounding of a
cluster edge.

The JAX package passes fixed-capacity point buffers with a ``valid`` mask
(a jit needs static shapes); the functions here keep the mask so a caller
may pass one, and the chip path passes all-true masks over exactly the
detected points.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "cluster_1d_dev",
    "label_clusters_dev",
    "num_offsets",
    "regress_clusters_dev",
]

# Budget for the (offsets, clusters, points) temporaries of the sweep: above
# it the offsets run in chunks (the result does not depend on the chunking).
_SWEEP_BYTES = 1 << 30


def num_offsets(total_length: int, num_clusters: int,
                cluster_length: float) -> int:
    """The sweep width of the 1-D offset search; callers check that it is
    positive."""
    return int(total_length - round(num_clusters * cluster_length))


def _masked_linregress(x, y, mask):
    """Least squares over masked points; (nan, mean(y)) when degenerate,
    (nan, nan) without any point."""
    w = mask.to(torch.float32)
    m = w.sum()
    safe = torch.clamp(m, min=1.0)
    xm = (w * x).sum() / safe
    ym = (w * y).sum() / safe
    dx = torch.where(mask, x - xm, 0.0)
    dy = torch.where(mask, y - ym, 0.0)
    denom = (dx * dx).sum()
    nan = torch.full_like(denom, torch.nan)
    slope = torch.where(denom != 0.0,
                        (dx * dy).sum() / torch.where(denom == 0.0, 1.0, denom),
                        nan)
    intercept = torch.where(denom != 0.0, ym - slope * xm, ym)
    intercept = torch.where(m > 0, intercept, nan)
    return slope, intercept


def _nanmedian_small(v):
    """nanmedian of a small 1-D vector: the mean of the two middle values
    of the non-NaN entries (``torch.median`` would return the lower one)."""
    nan = torch.isnan(v)
    s = torch.sort(torch.where(nan, torch.inf, v)).values
    m = (~nan).sum()
    lo = s[torch.clamp((m - 1) // 2, min=0)]
    hi = s[torch.clamp(m // 2, min=0)]
    return torch.where(m > 0, 0.5 * (lo + hi), torch.nan)


def cluster_1d_dev(points, valid, *, total_length: int, num_clusters: int,
                   cluster_length: float, ideal_num_points, penalty):
    """Exhaustive 1-D grid-offset sweep (host ``cluster_1d``).

    Per-cluster point variance scaled by sqrt(ideal count) plus a quadratic
    count-mismatch penalty; empty clusters cost the per-offset maximum; the
    first offset of least cost wins; points outside the winning grid label
    -1. ``points`` (N,) with ``valid`` marking live entries. Returns (N,)
    int32 labels.
    """
    dev = points.device
    n_off = num_offsets(total_length, num_clusters, cluster_length)
    c = num_clusters
    cl = np.float32(cluster_length)
    pts = torch.where(valid, points.to(torch.float32), torch.inf)
    ideal = torch.as_tensor(ideal_num_points, dtype=torch.float32, device=dev)
    sqrt_ideal = torch.sqrt(ideal)
    penalty = float(np.float32(penalty))

    edge_idx = torch.arange(c + 1, dtype=torch.float32, device=dev) * cl
    offs = torch.arange(n_off, dtype=torch.float32, device=dev)
    p = pts[None, None, :]

    def chunk_cost(off_k):  # (K,) -> (K,)
        edges = off_k[:, None] + edge_idx[None, :]         # (K, C+1)
        lo = edges[:, :-1, None]                           # (K, C, 1)
        hi = edges[:, 1:, None]
        inside = (p >= lo) & (p < hi)                      # (K, C, N)
        counts = inside.sum(-1).to(torch.float32)          # (K, C)
        centers = 0.5 * (edges[:, 1:] + edges[:, :-1])     # (K, C)
        dev_ = torch.where(inside, p - centers[..., None], 0.0)
        sq_dev = (dev_ * dev_).sum(-1)
        var = torch.where(counts > 0, sq_dev / torch.clamp(counts, min=1.0),
                          0.0)
        row_max = var.max(dim=1, keepdim=True).values
        var = torch.where(counts == 0, row_max, var)
        cost = var * sqrt_ideal[None, :] + penalty * (ideal[None, :]
                                                      - counts) ** 2
        return cost.sum(dim=1)

    chunk = max(1, _SWEEP_BYTES // max(1, 12 * c * pts.shape[0]))
    costs = torch.cat([chunk_cost(offs[k:k + chunk])
                       for k in range(0, n_off, chunk)])
    best = torch.argmin(costs)

    best_edges = best.to(torch.float32) + edge_idx         # (C+1,)
    k = (pts[:, None] >= best_edges[None, :]).sum(1) - 1   # (N,)
    labels = torch.where(valid & (k >= 0) & (k < c), k, -1)
    return labels.to(torch.int32)


def label_clusters_dev(points, valid, *, offset, num_clusters: int,
                       cluster_length, cluster_gap):
    """Fixed-geometry interval labelling (host ``label_clusters``): cluster
    ``i`` spans [offset + i*(length+gap), ... + length)."""
    pts = points.to(torch.float32)
    pitch = np.float32(cluster_length) + np.float32(cluster_gap)
    starts = (np.float32(offset)
              + torch.arange(num_clusters, dtype=torch.float32,
                             device=pts.device) * pitch)
    slot = (pts[:, None] >= starts[None, :]).sum(1) - 1
    clipped = torch.clamp(slot, 0, num_clusters - 1)
    inside = ((slot >= 0)
              & (pts < starts[clipped] + np.float32(cluster_length)) & valid)
    return torch.where(inside, clipped, -1).to(torch.int32)


def regress_clusters_dev(x, y, labels, *, num_clusters: int,
                         ideal_num_points):
    """Robust per-cluster line fits (host ``regress_clusters``): the median
    of per-cluster least-squares slopes, per-cluster median intercepts under
    the shared slope, then a weighted blend with the global
    evenly-spaced-intercept lattice. ``labels`` < 0 marks outliers. Returns
    (slope, intercepts (C,), counts (C,) f32)."""
    cnum = num_clusters
    dev = x.device
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    ideal = torch.as_tensor(ideal_num_points, dtype=torch.float32, device=dev)
    live = labels >= 0

    if cnum == 1:
        m = live.sum()
        slope, b = _masked_linregress(x, y, live)
        single = torch.where(live, y, 0.0).sum()
        slope = torch.where(m == 1, 0.0, slope)
        b = torch.where(m == 1, single, b)
        return slope, b[None], m.to(torch.float32)[None]

    onehot = (labels[:, None] == torch.arange(cnum, device=dev)[None, :]) \
        & live[:, None]
    w = onehot.to(torch.float32)                           # (N, C)
    n = w.sum(0)                                           # (C,)
    safe_n = torch.clamp(n, min=1.0)
    xm = (w * x[:, None]).sum(0) / safe_n
    ym = (w * y[:, None]).sum(0) / safe_n
    dx = torch.where(onehot, x[:, None] - xm[None, :], 0.0)
    dy = torch.where(onehot, y[:, None] - ym[None, :], 0.0)
    sxx = (dx * dx).sum(0)
    sxy = (dx * dy).sum(0)
    slopes = torch.where((n >= 2) & (sxx != 0.0),
                         sxy / torch.where(sxx == 0.0, 1.0, sxx), torch.nan)
    slope = _nanmedian_small(slopes)
    # Every cluster has <= 1 point (Nx1 / 1xN grids): no slope can be
    # estimated, so the grid lines are taken as axis-aligned.
    slope = torch.where(torch.isnan(slope), 0.0, slope)

    residuals = y - slope * x
    # inf pads sort to the end of each cluster's row (residuals are finite).
    res = torch.where(onehot.T, residuals[None, :], torch.inf)  # (C, N)
    if res.shape[1] == 0:
        res = torch.full((cnum, 1), torch.inf, device=dev)
    res = torch.sort(res, dim=1).values
    m_i = n.to(torch.int64)
    lo_i = torch.clamp((m_i - 1) // 2, min=0)
    hi_i = torch.clamp(m_i // 2, min=0)
    med = 0.5 * (torch.gather(res, 1, lo_i[:, None])[:, 0]
                 + torch.gather(res, 1, hi_i[:, None])[:, 0])
    observed = n > 0

    idx = torch.arange(cnum, dtype=torch.float32, device=dev)
    med0 = torch.where(observed, med, 0.0)
    lat_m, lat_b = _masked_linregress(idx, med0, observed)
    lattice = lat_m * idx + lat_b
    weight = torch.minimum(n, ideal) / torch.where(ideal == 0.0, 1.0, ideal)
    use_local = observed & (ideal != 0.0)
    blended = torch.where(use_local,
                          weight * med0 + (1.0 - weight) * lattice,
                          lattice)
    return slope, blended, n
