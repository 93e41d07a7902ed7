"""MRBLEs cluster visualization: the torch port's copy of
``magnify_tpu.plot.mrbles`` (counterpart of the reference's plot/mrbles.py).

Scatter of per-bead lanthanide ratios colored by decoded tag, with 1/2/3
sigma Gaussian ellipses per cluster, rendered with matplotlib. Parameter
surface mirrors the reference ``mrbles_clusters`` (plot/mrbles.py:277):
lanthanides are selected by name from the ``ln`` coordinate, outliers are
excluded by default (or drawn red), and precomputed ``means``/``covars``
(e.g. the GMM's) can replace the per-tag empirical moments.
"""

from __future__ import annotations

import functools

import numpy as np

from magnify_tpu_torch.plot.style import pyplot

__all__ = ["categorical_colors", "mrbles_clusters"]


def _srgb_to_lab(rgb: np.ndarray) -> np.ndarray:
    """sRGB (N, 3) in [0, 1] -> CIELAB (N, 3), D65 white point."""
    c = np.where(rgb > 0.04045, ((rgb + 0.055) / 1.055) ** 2.4, rgb / 12.92)
    m = np.array([[0.4124564, 0.3575761, 0.1804375],
                  [0.2126729, 0.7151522, 0.0721750],
                  [0.0193339, 0.1191920, 0.9503041]])
    xyz = c @ m.T / np.array([0.95047, 1.0, 1.08883])
    f = np.where(xyz > (6 / 29) ** 3, np.cbrt(xyz),
                 xyz / (3 * (6 / 29) ** 2) + 4 / 29)
    lab = np.empty_like(xyz)
    lab[:, 0] = 116 * f[:, 1] - 16
    lab[:, 1] = 500 * (f[:, 0] - f[:, 1])
    lab[:, 2] = 200 * (f[:, 1] - f[:, 2])
    return lab


@functools.lru_cache(maxsize=4)
def categorical_colors(n: int = 274) -> np.ndarray:
    """Deterministic maximally-distinct categorical palette, (n, 3) in
    [0, 1].

    Replaces the reference's hand-curated 274-entry categorical colormap
    (reference plot/mrbles.py:5-275) with a generated equivalent of the
    same size: Glasbey-style greedy farthest-point selection over an RGB
    lattice, measured in CIELAB, so every pair of entries stays
    perceptually separated — real MRBLEs panels run 24-48+ codes, far past
    matplotlib's 20-color cycles.
    """
    grid = np.linspace(0.0, 1.0, 17)
    cand = np.stack(np.meshgrid(grid, grid, grid,
                                indexing="ij"), axis=-1).reshape(-1, 3)
    lab = _srgb_to_lab(cand)
    # Drop colors too close to the white figure background or near-black
    # (unreadable as 4pt scatter dots).
    ok = (lab[:, 0] > 18) & (lab[:, 0] < 92)
    cand, lab = cand[ok], lab[ok]
    chosen = [int(np.argmax(np.abs(lab[:, 1]) + np.abs(lab[:, 2])))]
    mind = np.linalg.norm(lab - lab[chosen[0]], axis=1)
    for _ in range(n - 1):
        nxt = int(np.argmax(mind))
        chosen.append(nxt)
        mind = np.minimum(mind, np.linalg.norm(lab - lab[nxt], axis=1))
    return cand[np.array(chosen)]


def _ellipse_path(mean, cov, n_sigma):
    vals, vecs = np.linalg.eigh(cov)
    vals = np.maximum(vals, 0)
    theta = np.linspace(0, 2 * np.pi, 100)
    circle = np.stack([np.cos(theta), np.sin(theta)])
    pts = vecs @ (np.sqrt(vals)[:, None] * circle) * n_sigma
    return mean[0] + pts[0], mean[1] + pts[1]


def _resolve_ln(xp, name, default_idx, n_cols):
    """Column index of a lanthanide: by name when the ``ln`` coordinate
    carries labels, else the positional default (reference ln order puts
    the reference lanthanide first, so dy/sm default to columns 1/2).
    Raises a clear ValueError when the resolved index falls outside the
    ``ln_ratio`` columns (unknown lanthanide on a small panel)."""
    idx = None
    if "ln" in xp.coords:
        labels = [str(v) for v in np.asarray(xp["ln"].values).tolist()]
        if str(name) in labels:
            idx = labels.index(str(name))
        elif not isinstance(name, int):
            # A labeled panel must not silently plot the positional default
            # for a NAME it does not carry — that mislabels another
            # lanthanide's ratios as the requested one.
            raise ValueError(
                f"unknown lanthanide {name!r}: not in this panel's ln "
                f"labels {labels}")
    if idx is None:
        idx = name if isinstance(name, int) else default_idx
    if not 0 <= idx < n_cols:
        known = (list(np.asarray(xp["ln"].values)) if "ln" in xp.coords
                 else list(range(n_cols)))
        raise ValueError(
            f"unknown lanthanide {name!r}: resolved column {idx} is outside "
            f"the {n_cols}-column ln_ratio panel (known: {known})")
    return idx


def mrbles_clusters(xp, x="dy", y="sm", z=None, means=None, covars=None,
                    exclude_outliers: bool = True, show: bool = True):
    """Scatter ``ln_ratio`` pairs colored by tag with sigma contours.

    Mirrors the reference signature (plot/mrbles.py:277): ``x``/``y`` (and
    optional ``z`` for a 3-D scatter) name the lanthanide-ratio columns;
    ``means``/``covars`` override the per-tag empirical moments used for
    the 1/2/3 sigma ellipses; ``exclude_outliers`` drops "outlier"-tagged
    beads (otherwise they plot in red).
    """
    plt = pyplot()

    ratios = np.asarray(xp.ln_ratio.to_numpy())
    tags = np.asarray(xp.tag.values)
    i = _resolve_ln(xp, x, 1, ratios.shape[1])
    j = _resolve_ln(xp, y, 2, ratios.shape[1])
    k = _resolve_ln(xp, z, 3, ratios.shape[1]) if z is not None else None

    fig = plt.figure()
    if k is None:
        ax = fig.add_subplot()
    else:
        ax = fig.add_subplot(projection="3d")

    is_outlier = tags == "outlier"
    plot_tags = np.unique(tags[~is_outlier] if exclude_outliers else tags)
    palette = categorical_colors(max(274, len(plot_tags)))
    for t_idx, tag in enumerate(plot_tags):
        members = ratios[tags == tag]
        color = "red" if tag == "outlier" else tuple(palette[t_idx])
        cols = (members[:, i], members[:, j]) if k is None else (
            members[:, i], members[:, j], members[:, k])
        ax.scatter(*cols, s=4, color=color, label=str(tag),
                   linewidths=0.5)

    # Gaussian contours always exclude outliers (reference behavior).
    sel = [i, j] if k is None else [i, j, k]
    contour_tags = np.unique(tags[~is_outlier])
    if means is None or covars is None:
        means = np.stack([
            ratios[tags == t][:, sel].mean(axis=0) for t in contour_tags
        ]) if len(contour_tags) else np.zeros((0, len(sel)))
        covars = np.stack([
            np.cov(ratios[tags == t][:, sel], rowvar=False)
            if (tags == t).sum() > 1 else np.eye(len(sel))
            for t in contour_tags
        ]) if len(contour_tags) else np.zeros((0, len(sel), len(sel)))
    else:
        means = np.asarray(means)
        covars = np.asarray(covars)

    if k is None:
        for m in range(means.shape[0]):
            for level in (1, 2, 3):
                ex, ey = _ellipse_path(means[m, :2], covars[m, :2, :2],
                                       level)
                ax.plot(ex, ey, color="gray", alpha=0.2, linewidth=0.8)

    def _label(v, idx):
        return str(v) if v is not None and not isinstance(v, int) \
            else f"ln_ratio[{idx}]"

    ax.set_xlabel(_label(x, i))
    ax.set_ylabel(_label(y, j))
    ax.legend(fontsize=6, markerscale=2)
    if show:
        import matplotlib

        if matplotlib.get_backend().lower() != "agg":
            plt.show(block=False)
    return fig
