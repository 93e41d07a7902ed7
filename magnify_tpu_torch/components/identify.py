"""Marker identification: pinlist tagging and MRBLEs spectral decoding.

Torch port of ``magnify_tpu.components.identify``. The mrbles decoder's
three compute stages run on the explicit ``device``:

* per-bead lanthanide intensities (masked fg mean minus bg median over the
  ROI stack) as one fused reduction (:mod:`magnify_tpu_torch.ops.reduce`),
* the 100 x 100 affine grid search per lanthanide dim as one batched cost
  evaluation,
* the 50-iteration Gaussian-mixture EM with a uniform outlier component,
  with the divergence latch kept on the device (no host sync per iteration).

The least squares, the kNN trim and the GMM initialization stay numpy/scipy
on the host, as in the JAX package. The CSV tables are parsed with the
``csv`` module (the package does not import pandas).

The lattice fit reproduces the JAX package's jitted program bit for bit:
the arithmetic below follows what XLA compiles that program to on the CPU
(blocked prefix sums, reciprocal constants, the places where a multiply-add
is contracted into one FMA), because the argmin over the 10,000 grid costs
decides the fit and the returned (scale, offset) are grid values.
"""

from __future__ import annotations

import csv
import re

import numpy as np
import scipy.spatial
import torch

from magnify_tpu_torch import diagnostics
from magnify_tpu_torch.core.lazy import is_memmap_backed
from magnify_tpu_torch.core.registry import component
from magnify_tpu_torch.ops.edge import fma_f32
from magnify_tpu_torch.ops.reduce import fg_mean_bg_median

__all__ = ["identify_buttons", "identify_mrbles", "last_decode_timings"]

_F32 = np.float32


def _read_csv(src) -> dict[str, np.ndarray]:
    """Parse a CSV with a header row into {column: array}, columns in header
    order. File-like sources are REWOUND first: pipelines re-run their
    identify component per assay (and per frame in the ``*_stream`` APIs)
    with the same spectra/codes/pinlist argument, and a handle consumed by
    the first frame must not come back empty for the second.

    A column whose every non-blank cell parses as a number becomes float64
    (blank cells NaN); any other column is an object array of ``str`` with
    blank cells as ``None``. Blank lines are skipped.
    """
    if hasattr(src, "seek"):
        src.seek(0)
        rows = [row for row in csv.reader(src) if row]
    else:
        with open(src, newline="") as handle:
            rows = [row for row in csv.reader(handle) if row]
    if not rows:
        raise ValueError(f"{src} is empty: a CSV with a header row is needed")
    header, body = rows[0], rows[1:]
    table = {}
    for j, name in enumerate(header):
        cells = [row[j].strip() if j < len(row) else "" for row in body]
        try:
            col = np.array([float(c) if c else np.nan for c in cells],
                           dtype=np.float64)
        except ValueError:
            col = np.array([c if c else None for c in cells], dtype=object)
        table[name] = col
    return table


def _name_column(table, src) -> np.ndarray:
    """The ``name`` column as an object array of ``str``."""
    if "name" not in table:
        raise ValueError(f"{src} has no 'name' column")
    names = table["name"]
    if names.dtype != object:
        # Numeric-looking names: keep their text form.
        names = np.array([format(v, "g") for v in names], dtype=object)
    return names


def _reference_first(names: np.ndarray, reference: str) -> list[int]:
    """Row order that puts the reference lanthanide first and keeps the
    others in file order."""
    matches = np.nonzero(names == reference)[0]
    if len(matches) == 0:
        raise ValueError(
            f"Reference lanthanide '{reference}' not found in spectra file"
        )
    ref_idx = int(matches[0])
    return [ref_idx] + [i for i in range(len(names)) if i != ref_idx]


def _tags_from_pinlist(pinlist, blank) -> np.ndarray:
    """Parse a pinlist CSV into a (rows, cols) tag grid.

    An ``Indices`` column of "(col, row)" strings (1-indexed) and a
    ``MutantID`` name column; names in ``blank`` (and missing names) become
    the empty tag.
    """
    table = _read_csv(pinlist)
    positions = np.array([
        [int(part) for part in re.findall(r"-?\d+", cell)]
        for cell in table["Indices"]
    ])
    cols, rows = positions.T - 1  # "(col, row)", 1-indexed

    ids = table["MutantID"]
    if ids.dtype != object:
        ids = np.array([None if np.isnan(v) else format(v, "g") for v in ids],
                       dtype=object)
    names = np.array(["" if n is None or n in blank else str(n) for n in ids])

    grid = np.zeros((rows.max() + 1, cols.max() + 1), dtype=names.dtype)
    grid[rows, cols] = names
    return grid


@component("identify_buttons")
def identify_buttons(assay, shape=None, pinlist=None, blank=None):
    """Attach chamber tags from a pinlist CSV or a default-filled shape."""
    if blank is None:
        blank = ["", "blank", "BLANK"]

    if pinlist is not None:
        tags = _tags_from_pinlist(pinlist, blank)
    elif shape is not None:
        tags = np.full(tuple(shape), "default", dtype="<U200")
    else:
        raise ValueError(
            "identify_buttons needs a chip layout: pass pinlist or shape."
        )

    return assay.assign_coords(
        tag=(("mark_row", "mark_col"), tags),
        valid=(
            ("mark_row", "mark_col", "time"),
            np.ones(tags.shape + (assay.sizes["time"],), bool),
        ),
    )


# ----------------------------------------------------------------------
# Lattice fit
# ----------------------------------------------------------------------

def _prefix_sums(x: np.ndarray) -> np.ndarray:
    """Inclusive f32 prefix sums in the order XLA's CPU compiler takes
    them: sequential inside blocks of 16, the block totals scanned the same
    way (recursively) and added to every element of the later blocks."""
    n = len(x)
    if n <= 16:
        return np.cumsum(x, dtype=np.float32)
    blocks = -(-n // 16)
    padded = np.zeros(blocks * 16, np.float32)
    padded[:n] = x
    inner = np.cumsum(padded.reshape(blocks, 16), axis=1, dtype=np.float32)
    before = np.concatenate(
        [np.zeros(1, np.float32), _prefix_sums(inner[:, -1])[:-1]])
    return (inner + before[:, None]).reshape(-1)[:n]


def _grid(start: np.float32, stop: np.float32, stop_step: np.float32,
          n_grid: int) -> np.ndarray:
    """``jnp.linspace(start, stop, n_grid)`` as the compiled lattice fit
    evaluates it: ``fma(i, stop_step, start * (1 - i * r))`` with
    ``r = 1 / (n_grid - 1)`` for the first ``n_grid - 1`` entries, ``stop``
    itself for the last; ``stop_step`` is the caller's ``stop * r`` (XLA
    folds constant factors of ``stop`` into it)."""
    div = n_grid - 1
    i = torch.arange(div, dtype=torch.float32)
    r = torch.full((div,), float(_F32(1) / _F32(div)), dtype=torch.float32)
    rest = torch.full((div,), float(start), dtype=torch.float32) * (1 - i * r)
    step = torch.full((div,), float(stop_step), dtype=torch.float32)
    out = fma_f32(i, step, rest).numpy()
    return np.concatenate([out, [stop]]).astype(np.float32)


def _search_grids(lo: np.float32, hi: np.float32, code_span: np.float32,
                  n_grid: int):
    """The (scale, offset) grids of one search window: scales 0.75-1.25 x
    the window's span over the code span, offsets from ``lo`` a quarter of
    the way to ``hi``."""
    r = _F32(1) / _F32(n_grid - 1)
    scale = _F32(hi - lo) / code_span
    a_grid = _grid(scale * _F32(0.75), scale * _F32(1.25),
                   scale * _F32(_F32(1.25) * r), n_grid)
    # 0.25 * hi is exact, so one FMA gives the compiled program's value.
    p_stop = fma_f32(torch.tensor(_F32(0.75)), torch.tensor(lo),
                     torch.tensor(_F32(0.25) * hi)).numpy()[()]
    p_grid = _grid(lo, p_stop, p_stop * r, n_grid)
    return a_grid, p_grid


def _grid_costs(points: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor,
                codes: torch.Tensor, count_frac: torch.Tensor,
                a_grid: torch.Tensor, p_grid: torch.Tensor) -> torch.Tensor:
    """Cost of every (scale, offset) pair: points are assigned to the
    nearest lattice cluster by midpoint boundaries, cost = 100 * mean
    per-cluster MSE + mean squared cluster-size mismatch. (G, G) f32."""
    n_pts = points.shape[0]
    n_codes = codes.shape[0]
    g = a_grid.shape[0]
    clusters = ((a_grid[:, None] * codes[None, :])[:, None, :]
                + p_grid[None, :, None])                    # (G, G, K)
    mids = (clusters[..., :-1] + clusters[..., 1:]) * 0.5
    # searchsorted(side="left") == the count of points below each boundary.
    spans = torch.searchsorted(points, mids.contiguous(), right=False)
    starts = torch.cat([torch.zeros_like(spans[..., :1]), spans], dim=-1)
    ends = torch.cat([spans, torch.full_like(spans[..., :1], n_pts)], dim=-1)
    n = (ends - starts).to(torch.float32)
    s1 = p1[ends] - p1[starts]
    s2 = p2[ends] - p2[starts]
    # s2 - 2 c s1 + n c^2, each multiply-add one FMA.
    part = fma_f32(-(clusters * 2.0), s1, s2)
    mse = fma_f32(n, clusters * clusters, part) / torch.clamp(n, min=1.0)
    inf = torch.tensor(float("inf"), device=points.device)
    mse = torch.where(n > 0, mse, inf)
    inv_pts = torch.full_like(n, float(_F32(1) / _F32(n_pts)))
    mismatch = fma_f32(n, inv_pts, -count_frac.expand_as(n))
    # Sums over clusters left to right from 0; the squares join by FMA.
    mse_sum = torch.zeros((g, g), dtype=torch.float32, device=points.device)
    size_sum = torch.zeros_like(mse_sum)
    for j in range(n_codes):
        mse_sum = mse_sum + mse[..., j]
        m_j = mismatch[..., j].contiguous()
        size_sum = fma_f32(m_j, m_j, size_sum)
    inv_codes = _F32(1) / _F32(n_codes)
    w_mse = torch.full_like(mse_sum, float(_F32(100) * inv_codes))
    return fma_f32(mse_sum, w_mse, size_sum * float(inv_codes))


def _fit_affine_1d(points_sorted, codes, counts, n_grid: int = 100,
                   device="cuda"):
    """Best (scale, offset) aligning a 1-D code lattice to sorted points.

    TWO search windows are evaluated and the lower-cost fit wins:

    * min/max anchors, which cover unbalanced panels whose extreme code
      level holds very few points, but which a handful of extreme ratio
      outliers can drag entirely off the true lattice;
    * 5th/95th order-statistic anchors, robust to those outliers, since the
      outer levels of a balanced panel hold >= 1/levels of points.

    The true fit minimizes the cost under either window, so taking the
    minimum over both grids is exact whenever either window covers it.

    ``points_sorted``, ``codes`` and ``counts`` are 1-D arrays (cast to
    f32); the prefix sums and the grids are built on the host, the 2 x
    ``n_grid``^2 costs and their argmin on ``device``. Returns two f32
    scalars.
    """
    device = torch.device(device)
    pts = np.ascontiguousarray(points_sorted, dtype=np.float32)
    codes = np.ascontiguousarray(codes, dtype=np.float32)
    counts = np.ascontiguousarray(counts, dtype=np.float32)
    n_pts = len(pts)

    zero = np.zeros(1, np.float32)
    p1 = np.concatenate([zero, _prefix_sums(pts)])
    p2 = np.concatenate([zero, _prefix_sums(pts * pts)])
    code_span = np.maximum(codes[-1] - codes[0], _F32(1e-30))
    count_frac = counts / counts.sum(dtype=np.float32)

    pts_d, p1_d, p2_d, codes_d, frac_d = (
        torch.as_tensor(a).to(device) for a in (pts, p1, p2, codes, count_frac))

    def search(lo, hi):
        a_grid, p_grid = _search_grids(lo, hi, code_span, n_grid)
        costs = _grid_costs(pts_d, p1_d, p2_d, codes_d, frac_d,
                            torch.as_tensor(a_grid).to(device),
                            torch.as_tensor(p_grid).to(device)).reshape(-1)
        idx = torch.argmin(costs)
        return costs[idx], a_grid, p_grid, idx

    c_mm, a_mm, p_mm, i_mm = search(pts[0], pts[-1])
    c_q, a_q, p_q, i_q = search(
        pts[(n_pts - 1) * 5 // 100],        # floor 5th pct
        pts[-(-(n_pts - 1) * 95 // 100)],   # ceil 95th pct
    )
    use_q, i_mm, i_q = (int(v) for v in
                        torch.stack([c_q < c_mm, i_mm, i_q]).cpu())
    if use_q:
        return a_q[i_q // n_grid], p_q[i_q % n_grid]
    return a_mm[i_mm // n_grid], p_mm[i_mm % n_grid]


# ----------------------------------------------------------------------
# Gaussian-mixture EM
# ----------------------------------------------------------------------

def _median_all(x: torch.Tensor) -> torch.Tensor:
    """Median over every element, the two middle values averaged when the
    count is even and NaN if any element is (``torch.median`` returns the
    lower middle instead)."""
    flat = torch.sort(x.reshape(-1)).values
    m = flat.shape[0]
    med = (flat[(m - 1) // 2] + flat[m // 2]) / 2
    nan = torch.tensor(float("nan"), dtype=x.dtype, device=x.device)
    return torch.where(torch.isnan(flat[-1]), nan, med)


def _gmm_em(X, means0, covs0, proportions0, bounds_log_vol,
            num_iters: int = 50):
    """EM for a Gaussian mixture plus one uniform outlier component, in log
    space with shared covariance regularization. f32 tensors on one device;
    returns (posteriors (n, k + 1), ok, had_probs) as tensors there.

    An iteration whose covariances are singular (``det <= 0``) or whose
    log-densities are not finite trips the ``ok`` latch: that and every
    later iteration keep the state before it, so ``probs`` holds the last
    good posteriors (all zero if the very first iteration failed).
    """
    n, d = X.shape
    k = means0.shape[0]
    dev = X.device
    uniform = torch.full((n, 1), float(_F32(-bounds_log_vol)),
                         dtype=torch.float32, device=dev)
    log_norm = float(_F32(-d) * np.log(_F32(2 * np.pi)) / _F32(2))
    eye = torch.eye(d, dtype=torch.float32, device=dev)

    means, covs, proportions = means0, covs0, proportions0
    probs = torch.zeros((n, k + 1), dtype=torch.float32, device=dev)
    ok = torch.ones((), dtype=torch.bool, device=dev)
    for _ in range(num_iters):
        diff = X[:, None, :] - means[None, :, :]
        det = torch.linalg.det(covs)
        inv = torch.linalg.inv_ex(covs).inverse
        maha = (torch.einsum("nki,kij->nkj", diff, inv) * diff).sum(-1)
        log_cond = log_norm - 0.5 * torch.log(torch.abs(det)) - 0.5 * maha
        bad = (det <= 0).any() | (~torch.isfinite(log_cond)).any()
        logp = torch.log(proportions) + torch.cat([log_cond, uniform], dim=1)
        logp = logp - torch.logsumexp(logp, dim=1, keepdim=True)
        new_probs = torch.exp(logp)

        resp = new_probs[:, :-1]
        weight = resp.sum(dim=0)
        new_means = (resp[:, :, None] * X[:, None, :]).sum(0) / weight[:, None]
        diff = X[:, None, :] - new_means[None, :, :]
        new_covs = (torch.einsum("nk,nki,nkj->kij", resp, diff, diff)
                    / weight[:, None, None])
        new_covs = new_covs + eye * _median_all(new_covs) / 10
        new_props = new_probs.sum(dim=0) / n

        frozen = bad | ~ok
        means = torch.where(frozen, means, new_means)
        covs = torch.where(frozen, covs, new_covs)
        proportions = torch.where(frozen, proportions, new_props)
        probs = torch.where(frozen, probs, new_probs)
        ok = ok & ~bad
    return probs, ok, (probs > 0).any()


# Wall-clock of the last decode's stages (intensities/lstsq, kNN trim,
# lattice fit, GMM-EM), for diagnostics and reports: the host time of each
# stage's span (``identify.<stage>``), which waits for the card only where
# the stage itself pulls a result. Overwritten by every identify_mrbles
# call.
last_decode_timings: dict[str, float] = {}


@component("identify_mrbles")
def identify_mrbles(assay, spectra, codes, reference="eu", device="cuda"):
    """Spectral decoding of MRBLEs beads.

    ``spectra``: CSV (path or file-like) with a ``name`` column and one
    column per imaging channel; ``codes``: CSV with a ``name`` column and
    one column per lanthanide. ``device`` is where the intensities, the
    lattice fit and the EM run.
    """
    device = torch.device(device)
    last_decode_timings.clear()
    with diagnostics.span("identify.intensities_lstsq", device) as timed:
        spectra_tab = _read_csv(spectra)
        spectra_names = _name_column(spectra_tab, spectra)
        order = _reference_first(spectra_names, reference)
        lns = [str(spectra_names[i]) for i in order]
        num_lns = len(lns)

        codes_tab = _read_csv(codes)
        tag_names = _name_column(codes_tab, codes)
        if set(codes_tab) - {"name"} != set(lns):
            raise ValueError(
                f"Lanthanide names in {codes} do not match lanthanide names "
                f"in {spectra}."
            )

        if assay.sizes.get("mark", 0) == 0:
            # Empty field (find_beads found nothing): nothing to decode. The
            # lattice fit and the GMM need >= 1 point; return the
            # empty-but-valid schema.
            assay = assay.assign_coords(ln=(("ln",), np.asarray(lns)))
            assay["ln_vol"] = (("mark", "ln"), np.zeros((0, num_lns)))
            assay["ln_ratio"] = (("mark", "ln"), np.zeros((0, num_lns)))
            return assay.assign_coords(
                tag=(("mark",), np.zeros(0, dtype="<U64")))

        # Step 1: lanthanide volumes from SV = I least squares.
        channels = [c for c in assay["channel"].values.tolist()
                    if c in spectra_tab]
        sp = np.stack([np.asarray(spectra_tab[c], np.float64)[order]
                       for c in channels], axis=1)
        sel = assay.roi.isel(time=0).sel(channel=channels)
        fg = assay["fg"].isel(time=0)
        bg = assay["bg"].isel(time=0)
        # A ROI store that was spilled to disk reduces on the host twin: the
        # data already lives in host files, and uploading it would cost more
        # than the device reduction saves. A property of the data, so decided
        # here and nowhere else.
        reduce_device = ("cpu" if is_memmap_backed(assay["roi"].data)
                         else device)
        intensities = fg_mean_bg_median(sel.to_numpy(), fg.to_numpy(),
                                        bg.to_numpy(), device=reduce_device)
        volumes = np.linalg.lstsq(sp.T, intensities.T, rcond=None)[0].T
        ratios = volumes / volumes[:, 0:1]
    last_decode_timings["intensities_lstsq"] = round(timed.seconds, 4)
    with diagnostics.span("identify.knn_trim", device) as timed:
        assay = assay.assign_coords(ln=(("ln",), np.asarray(lns)))
        assay["ln_vol"] = (("mark", "ln"), volumes)
        assay["ln_ratio"] = (("mark", "ln"), ratios)

        # Step 2: aggressive kNN outlier trim.
        X = ratios[:, 1:]
        num_codes = len(tag_names)
        n_neighbor = round(len(X) / (20 * num_codes)) + 2
        dist = (
            scipy.spatial.KDTree(X, leafsize=n_neighbor)
            .query(X, k=[n_neighbor], workers=-1)[0]
            .flatten()
        )
        X_r = X[dist <= np.percentile(dist, 95)]
    last_decode_timings["knn_trim"] = round(timed.seconds, 4)

    # Step 3: per-dim affine lattice fit, then nearest-code assignment.
    with diagnostics.span("identify.lattice_fit", device) as timed:
        code_ratios = np.stack([codes_tab[ln] for ln in lns[1:]], axis=1)
        A = np.zeros(num_lns - 1)
        p = np.zeros(num_lns - 1)
        for i in range(num_lns - 1):
            c, counts = np.unique(code_ratios[:, i], return_counts=True)
            if len(c) == 1:
                A[i], p[i] = 1.0, X_r[:, i].mean()
                continue
            a_i, p_i = _fit_affine_1d(np.sort(X_r[:, i]), c, counts,
                                      device=device)
            A[i], p[i] = float(a_i), float(p_i)
    last_decode_timings["lattice_fit"] = round(timed.seconds, 4)
    with diagnostics.span("identify.gmm_em", device) as timed:
        lattice = A * code_ratios + p
        tag_idxs = np.argmin(
            np.linalg.norm(X_r[:, None] - lattice[None], axis=-1), axis=1
        )

        # Step 4: GMM refinement with a uniform outlier component.
        d = num_lns - 1
        means = np.zeros((num_codes, d))
        covs = np.zeros((num_codes, d, d)) + np.eye(d) * 1e-10
        proportions = np.zeros(num_codes + 1)
        for i in range(num_codes):
            members = X_r[tag_idxs == i]
            proportions[i] = len(members) + 1
            means[i] = (np.median(members, axis=0) if len(members)
                        else lattice[i])
            if len(members) > 1:
                covs[i] += np.cov(members, rowvar=False).reshape(d, d)
        covs[:] = np.median(covs, axis=0)
        # The ELEMENTWISE median of PSD matrices need not be PSD: with noise
        # members inflating cross terms, med(c00)*med(c11) can fall below
        # med(c01)^2, and a non-PD init kills EM at iteration 0 — the
        # nearest-code fallback then codes every noise detection. Regularize
        # like the in-loop update; if still not PD, drop the cross terms (the
        # diagonal of variances is PD by construction).
        covs += np.eye(d) * np.abs(np.diagonal(covs[0])).mean() / 10
        if np.linalg.eigvalsh(covs[0]).min() <= 0:
            covs[:] = np.diag(np.maximum(np.diagonal(covs[0]), 1e-10))
        proportions[-1] = 1e-10
        proportions /= proportions.sum()
        span = np.log(X_r.max(axis=0) - X_r.min(axis=0)).sum()

        def to_dev(a):
            return torch.as_tensor(np.asarray(a, np.float32)).to(device)

        probs, ok, had_probs = _gmm_em(to_dev(X), to_dev(means), to_dev(covs),
                                       to_dev(proportions), float(span))
        probs = probs.cpu().numpy()  # waits for the EM
    last_decode_timings["gmm_em"] = round(timed.seconds, 4)
    tag_names = np.append(tag_names, "outlier")
    if not bool(ok):
        # Warn, keep the last good posteriors if any iteration succeeded,
        # else fall back to nearest-code assignment.
        print("Warning: Code clustering did not converge.")
    if bool(had_probs):
        final_idxs = np.argmax(probs, axis=1)
    else:
        final_idxs = np.argmin(
            np.linalg.norm(X[:, None] - lattice[None], axis=-1), axis=1
        )
    return assay.assign_coords(tag=(("mark",), tag_names[final_idxs]))
