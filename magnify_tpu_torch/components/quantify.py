"""Per-marker intensity over the whole (channel, time) stack.

The port of ``magnify_tpu.components.quantify``: the ``quantify`` component
reads the marker ROI stack in time batches and attaches ``intensity``, the
foreground mean minus the background median per (mark, channel, time), so
that only summaries come back from a terabyte-scale 4-D run.
"""

from __future__ import annotations

import concurrent.futures

import numpy as np

from magnify_tpu_torch.core.lazy import evict_backing_pages, is_memmap_backed
from magnify_tpu_torch.core.registry import component
from magnify_tpu_torch.ops.reduce import fg_mean_bg_median

__all__ = ["quantify"]

# Host bytes of ROI crops staged per batch (one batch is read ahead).
BATCH_BYTES = 128 << 20


@component("quantify")
def quantify(assay, batch_timesteps: int = 8, device="cuda"):
    """Attach ``intensity`` (mark, channel, time): fg mean minus bg median.

    Reduces ``batch_timesteps`` timesteps per call of
    :func:`magnify_tpu_torch.ops.reduce.fg_mean_bg_median` (the mark and
    time axes fold into one batch axis), at most ``BATCH_BYTES`` of crops a
    batch, while a thread reads the next batch from the ROI store. Each
    batch's pages of a spilled store are dropped once it has been copied.

    Placement, the JAX package's rule (``magnify_tpu/ops/reduce.py:84``):
    an ROI store that is a disk spill (a memmap, as ``find_beads`` makes
    for large outputs) reduces on the host, with the numpy twin, on a card
    as well: its bytes already live in host files, and moving them to the
    device costs more than the reduction saves. Every other store reduces
    on ``device``. The bg medians are bit-identical on both; the fg means
    agree to ``ops.reduce.MEAN_RTOL`` (f32 summation order), so an
    intensity can move by ``MEAN_RTOL`` times the pixel values between the
    two.
    """
    # Single-channel / single-timestep datasets come out of restore_format
    # with those dims squeezed away; treat missing dims as size 1 and
    # attach `intensity` over only the dims that exist.
    n_t = assay.sizes.get("time", 1)
    n_marks = assay.sizes["mark"]
    n_ch = assay.sizes.get("channel", 1)
    bytes_per_t = (n_marks * n_ch * assay.sizes["roi_y"]
                   * assay.sizes["roi_x"]
                   * np.dtype(assay.roi.dtype).itemsize)
    batch_timesteps = max(1, min(batch_timesteps,
                                 BATCH_BYTES // max(bytes_per_t, 1)))
    reduce_on = "cpu" if is_memmap_backed(assay["roi"].data) else device
    out = np.empty((n_marks, n_ch, n_t), np.float32)
    starts = list(range(0, n_t, batch_timesteps))

    def ordered(da, want):
        """Window ``da`` over time (when present), order its axes as
        ``want``, and insert size-1 axes for absent dims."""
        present = [d for d in want if d in da.dims]
        da = da.transpose(*present)

        def fetch(window):
            arr = (da.isel(time=window) if "time" in da.dims
                   else da).to_numpy()
            for i, d in enumerate(want):
                if d not in da.dims:
                    arr = np.expand_dims(arr, i)
            return arr

        return fetch

    roi_f = ordered(assay.roi, ("mark", "channel", "time", "roi_y", "roi_x"))
    fg_f = ordered(assay["fg"], ("mark", "time", "roi_y", "roi_x"))
    bg_f = ordered(assay["bg"], ("mark", "time", "roi_y", "roi_x"))

    def load(start):
        stop = min(start + batch_timesteps, n_t)
        window = slice(start, stop)
        return (start, stop, roi_f(window), fg_f(window), bg_f(window))

    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
        pending = pool.submit(load, starts[0])
        for i in range(len(starts)):
            start, stop, roi, fg, bg = pending.result()
            # This batch is copied out; drop the pages of a spilled store
            # before the next read starts (evicting after the reduction
            # would race the reading thread).
            evict_backing_pages(assay["roi"].data)
            if i + 1 < len(starts):
                pending = pool.submit(load, starts[i + 1])
            b = stop - start
            length_y, length_x = roi.shape[-2:]
            roi_b = roi.transpose(0, 2, 1, 3, 4).reshape(
                n_marks * b, n_ch, length_y, length_x)
            fg_b = fg.reshape(n_marks * b, length_y, length_x)
            bg_b = bg.reshape(n_marks * b, length_y, length_x)
            vals = fg_mean_bg_median(roi_b, fg_b, bg_b, device=reduce_on)
            out[:, :, start:stop] = vals.reshape(n_marks, b,
                                                 n_ch).transpose(0, 2, 1)
    dims = ["mark"] + [d for d in ("channel", "time") if d in assay.roi.dims]
    shape = [n_marks] + ([n_ch] if "channel" in assay.roi.dims else []) \
        + ([n_t] if "time" in assay.roi.dims else [])
    assay["intensity"] = (tuple(dims), out.reshape(shape))
    return assay
