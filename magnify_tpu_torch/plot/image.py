"""Image and ROI viewers: the torch port's copy of ``magnify_tpu.plot.image``
(matplotlib counterpart of the reference's plot/image.py).

``imshow`` renders the stitched image with foreground/background label
overlays and ROI rectangles, and — like the napari viewer of reference
plot/image.py:52-154, which splits channels into layers and exposes extra
dims as sliders — makes every (channel, time) plane browsable: interactive
backends get matplotlib sliders, and headless callers drive the same
rendering through ``fig.magnify_viewer.set_plane(channel=..., time=...)``.
``roishow`` tiles per-tag ROI galleries with fg AND bg label overlays
(reference plot/image.py:28-41 renders both label layers per ROI). Both
return the matplotlib figure so headless callers can save it. Without
matplotlib both raise ImportError.
"""

from __future__ import annotations

import numpy as np

from magnify_tpu_torch import utils
from magnify_tpu_torch.plot.style import pyplot

__all__ = ["imshow", "roishow", "roi_to_image_labels"]


def roi_to_image_labels(roi_masks: np.ndarray, bboxes: np.ndarray,
                        img_shape: tuple) -> np.ndarray:
    """Paint per-mark ROI masks into full-image label maps.

    Vectorized equivalent of the reference's numba kernel
    (plot/image.py:157-168): later marks overwrite earlier ones inside
    their mask.
    """
    n_marks, n_extra = roi_masks.shape[:2]
    labels = np.zeros((n_extra,) + tuple(img_shape), dtype=np.int32)
    for i in range(n_marks):
        for j in range(n_extra):
            top, bottom, left, right = bboxes[i, j]
            mask = roi_masks[i, j]
            region = labels[j, top:bottom, left:right]
            labels[j, top:bottom, left:right] = (
                (i + 1) * mask + region * (1 - mask)
            )
    return labels


def _multiscale(img: np.ndarray, limit: int = 512) -> np.ndarray:
    """Downsample by 2 until the plane fits limit^2 (plot/image.py:60-62)."""
    while img.shape[-1] * img.shape[-2] > limit**2:
        img = img[..., ::2, ::2]
    return img


def _isel(da, **indexers):
    for dim, i in indexers.items():
        if dim in da.dims:
            da = da.isel(**{dim: i})
    return da


class ImageViewer:
    """Stateful renderer behind :func:`imshow`.

    Holds the dataset and the selected plane along EVERY non-spatial dim
    (the reference napari viewer exposes each extra dim as a slider,
    plot/image.py:60-71); ``set_plane`` re-renders base image, fg (green) /
    bg (magenta) label overlays, ROI rectangles, and tag annotations — the
    same layer stack the reference builds in napari (plot/image.py:73-150),
    re-rendered per plane instead of kept as always-loaded layers. Rendered
    pyramid levels are cached per plane (each <= limit^2 pixels), so
    browsing back to a visited plane — or re-rendering the current one —
    never re-reads or re-decimates the full-resolution plane.
    """

    #: cached decimated planes kept per viewer (each <= _MS_LIMIT^2 px).
    CACHE_PLANES = 256
    _MS_LIMIT = 512

    def __init__(self, xp, ax):
        self.xp = xp
        self.ax = ax
        img_dims = xp.image.dims
        self.spatial_dims = tuple(img_dims[-2:])
        self.extra_dims = tuple(d for d in img_dims
                                if d not in self.spatial_dims)
        self.dim_sizes = {d: xp.sizes[d] for d in self.extra_dims}
        self.index = {d: 0 for d in self.extra_dims}
        self._plane_cache: dict = {}

    # Backwards-compatible accessors (the original viewer browsed only
    # channel/time).
    @property
    def n_channel(self):
        return self.dim_sizes.get("channel", 1)

    @property
    def n_time(self):
        return self.dim_sizes.get("time", 1)

    @property
    def channel(self):
        return self.index.get("channel", 0)

    @property
    def time(self):
        return self.index.get("time", 0)

    # -- data for the current plane -------------------------------------

    def _plane(self):
        key = tuple(sorted(self.index.items()))
        hit = self._plane_cache.get(key)
        if hit is not None:
            return hit
        disp = _isel(self.xp.image, **self.index)
        full_shape = disp.shape
        # Copy the decimated level: _multiscale returns a strided VIEW whose
        # .base is the full-resolution plane — caching the view would pin
        # one full plane per cache entry (256 entries x a full 8k^2 parent
        # each), not the <= _MS_LIMIT^2 footprint the cache is sized for.
        plane = np.ascontiguousarray(
            _multiscale(disp.to_numpy(), limit=self._MS_LIMIT))
        scale = full_shape[-1] / plane.shape[-1]
        if len(self._plane_cache) >= self.CACHE_PLANES:
            self._plane_cache.pop(next(iter(self._plane_cache)))
        self._plane_cache[key] = (plane, scale, full_shape)
        return plane, scale, full_shape

    def _overlays(self, full_shape, scale, bboxes):
        """(fg_labels, bg_labels) downsampled to display resolution, or
        (None, None) when the dataset has no roi layer. ``bboxes`` are the
        per-mark boxes the caller already computed (avoids paying the
        centers + bounding-box pass twice per rendered plane)."""
        xp = self.xp
        if "roi" not in xp:
            return None, None
        fg = _isel(xp.fg, **self.index).to_numpy()
        bg = _isel(xp.bg, **self.index).to_numpy() if "bg" in xp.coords \
            else None
        h, w = full_shape[-2], full_shape[-1]
        fg_full = roi_to_image_labels(fg[:, None], bboxes, (h, w))[0]
        step = max(1, int(round(scale)))
        fg_ds = fg_full[::step, ::step]
        if bg is None:
            return fg_ds, None
        bg_full = roi_to_image_labels(bg[:, None], bboxes, (h, w))[0]
        return fg_ds, bg_full[::step, ::step]

    def _centers(self):
        xs = _isel(self.xp.x, **self.index)
        ys = _isel(self.xp.y, **self.index)
        return (np.round(xs.to_numpy()).astype(int),
                np.round(ys.to_numpy()).astype(int))

    # -- rendering -------------------------------------------------------

    def render(self):
        from matplotlib import patches

        ax = self.ax
        ax.clear()
        plane, scale, full_shape = self._plane()
        ax.imshow(plane, cmap="gray")
        xp = self.xp
        if "roi" in xp:
            xs, ys = self._centers()
            roi_len = xp.sizes["roi_y"]
            h, w = full_shape[-2], full_shape[-1]
            bboxes = np.array([
                [utils.bounding_box(xs[i], ys[i], roi_len, w, h)]
                for i in range(xp.sizes["mark"])
            ])
            fg_ds, bg_ds = self._overlays(full_shape, scale, bboxes)
            for labels, cmap in ((bg_ds, "spring"), (fg_ds, "summer")):
                if labels is not None and labels.any():
                    ax.imshow(
                        np.ma.masked_where(labels == 0, labels),
                        cmap=cmap, alpha=0.5, interpolation="nearest",
                    )
            tags = (xp.tag.values if "tag" in xp.coords
                    else np.array([""] * xp.sizes["mark"]))
            for i in range(xp.sizes["mark"]):
                top, bottom, left, right = bboxes[i, 0]
                rect = patches.Rectangle(
                    (left / scale, top / scale), (right - left) / scale,
                    (bottom - top) / scale, fill=False, edgecolor="white",
                    linewidth=0.5,
                )
                ax.add_patch(rect)
                if tags.ndim and i < len(tags) and tags[i]:
                    ax.annotate(str(tags[i]), ((left + right) / 2 / scale,
                                               top / scale - 2),
                                color="yellow", fontsize=5, ha="center")
        title = [f"{d} {self.index[d]}" for d in self.extra_dims
                 if self.dim_sizes[d] > 1]
        if title:
            ax.set_title(", ".join(title), fontsize=8)
        ax.figure.canvas.draw_idle()

    def set_plane(self, channel: int | None = None, time: int | None = None,
                  **indexers: int):
        """Select and render another plane along ANY non-spatial dim(s) —
        the headless twin of the browsing sliders (one per extra dim, like
        the reference napari viewer's dim sliders). ``channel``/``time``
        stay positional-friendly (the pre-extra-dims signature), and a dim
        the image doesn't carry accepts index 0 — its implicit size."""
        merged = dict(indexers)
        if channel is not None:
            merged["channel"] = channel
        if time is not None:
            merged["time"] = time
        for dim, i in merged.items():
            if i is None:
                continue
            if dim not in self.index:
                # Dims absent from the image behave as size-1 (the old
                # channel/time contract): index 0 is a no-op, anything
                # else is out of range.
                if i == 0:
                    continue
                raise KeyError(
                    f"{dim!r} is not a browsable dim "
                    f"(have {list(self.extra_dims)})")
            if not 0 <= i < self.dim_sizes[dim]:
                raise IndexError(
                    f"{dim} {i} out of range ({self.dim_sizes[dim]})")
            self.index[dim] = int(i)
        self.render()
        return self


def imshow(xp, show: bool = True):
    """Show the stitched image with fg/bg overlays, ROI boxes and browsing
    along EVERY extra dim (one slider per non-spatial dim, like the
    reference napari viewer, plot/image.py:60-71). Returns the figure;
    ``fig.magnify_viewer`` exposes :meth:`ImageViewer.set_plane` for
    programmatic browsing."""
    plt = pyplot()
    from matplotlib.widgets import Slider

    if "mark_row" in xp.dims and "mark_col" in xp.dims and "mark" not in xp.dims:
        xp = xp.stack(mark=("mark_row", "mark_col"))

    img_dims = xp.image.dims
    browse = [(d, xp.sizes[d]) for d in img_dims[:-2] if xp.sizes[d] > 1]
    n_sliders = len(browse)

    fig = plt.figure(figsize=(6, 6 + 0.4 * n_sliders))
    bottom = 0.02 + 0.07 * n_sliders
    ax = fig.add_axes([0.05, bottom + 0.03, 0.9, 0.93 - bottom])
    viewer = ImageViewer(xp, ax)
    fig.magnify_viewer = viewer

    sliders = []
    for slot, (dim, n) in enumerate(browse):
        sax = fig.add_axes([0.25, 0.02 + 0.06 * slot, 0.55, 0.03])
        slider = Slider(sax, dim, 0, n - 1, valinit=0, valstep=1)

        def on_change(val, dim=dim):
            viewer.set_plane(**{dim: int(val)})

        slider.on_changed(on_change)
        sliders.append(slider)
    fig._magnify_sliders = sliders  # keep refs alive for the figure's life

    viewer.render()
    if show:
        import matplotlib

        if matplotlib.get_backend().lower() != "agg":
            plt.show(block=False)
    return fig


def roishow(xp, show: bool = True, max_cols: int = 12):
    """Grid of per-mark ROIs grouped by tag with fg AND bg overlays
    (reference plot/image.py:28-41 adds both label layers per ROI)."""
    plt = pyplot()

    tags = (xp.tag.values if "tag" in xp.coords
            else np.array([""] * xp.sizes["mark"]))
    uniq = np.unique(tags)
    counts = [(tags == t).sum() for t in uniq]
    n_rows = len(uniq)
    n_cols = min(int(max(counts)), max_cols)
    fig, axes = plt.subplots(n_rows, n_cols, squeeze=False,
                             figsize=(1.2 * n_cols, 1.2 * n_rows))
    roi = _isel(xp.roi, channel=0, time=0)
    fg = _isel(xp.fg, time=0)
    bg = _isel(xp.bg, time=0) if "bg" in xp.coords else None
    for r, t in enumerate(uniq):
        idxs = np.nonzero(tags == t)[0][:n_cols]
        for c in range(n_cols):
            ax = axes[r][c]
            ax.set_axis_off()
            if c < len(idxs):
                i = int(idxs[c])
                ax.imshow(roi.isel(mark=i).to_numpy(), cmap="gray")
                if bg is not None:
                    bgm = bg.isel(mark=i).to_numpy()
                    if bgm.any():
                        ax.contour(bgm, levels=[0.5], colors="magenta",
                                   linewidths=0.5)
                ax.contour(fg.isel(mark=i).to_numpy(), levels=[0.5],
                           colors="lime", linewidths=0.5)
                if c == 0:
                    ax.set_title(str(t), fontsize=6)
    if show:
        import matplotlib

        if matplotlib.get_backend().lower() != "agg":
            plt.show(block=False)
    return fig
