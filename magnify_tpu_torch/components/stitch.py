"""Tile stitching (reference magnify/stitch.py).

Take-the-middle semantics: crop ``overlap // 2`` pixels from each tile edge
(plus the remainder from the far edge for odd overlaps), then join the tile
grid into a single image plane. The reference's double ``xr.concat`` is a
data-movement no-op in disguise; here it is a transpose + reshape for numpy
tiles, and a pure index remap (one output chunk per tile, cropped at read
time) for lazy tiles — nothing materializes until a consumer asks.
"""

from __future__ import annotations

import numpy as np

from magnify_tpu_torch.core import Variable
from magnify_tpu_torch.core.lazy import ChunkedArray
from magnify_tpu_torch.core.registry import components


class Stitcher:
    def __init__(self, overlap: int = 102):
        if overlap < 0:
            raise ValueError("Overlap must be non-negative.")
        self.overlap = overlap

    def __call__(self, assay):
        if "tile" not in assay:
            raise AttributeError("Dataset must contain 'tile' data variable.")

        sizes = assay.sizes
        th, tw = sizes["tile_y"], sizes["tile_x"]
        if self.overlap >= th or self.overlap >= tw:
            raise ValueError(
                f"Overlap ({self.overlap}) must be smaller than tile size "
                + f"({th}x{tw})."
            )

        clip = self.overlap // 2
        remainder = self.overlap % 2
        ch = th - 2 * clip - remainder
        cw = tw - 2 * clip - remainder
        y_lo, y_hi = clip, th - clip - remainder
        x_lo, x_hi = clip, tw - clip - remainder

        tile_var = assay["tile"].transpose(
            "channel", "time", "tile_row", "tile_col", "tile_y", "tile_x"
        ).variable
        nc, nt, nr, ncol = (sizes["channel"], sizes["time"],
                            sizes["tile_row"], sizes["tile_col"])

        data = tile_var.data
        if isinstance(data, ChunkedArray):
            def loader(idx, _data=data):
                ci, ti, ri, cj = idx
                block = _data[ci, ti, ri, cj, y_lo:y_hi, x_lo:x_hi]
                return block[None, None]

            image = ChunkedArray(
                loader,
                shape=(nc, nt, nr * ch, ncol * cw),
                dtype=data.dtype,
                chunks=((1,) * nc, (1,) * nt, (ch,) * nr, (cw,) * ncol),
                depth=data.depth,  # pure index remap: no compute added
            )
        else:
            cropped = np.asarray(data)[..., y_lo:y_hi, x_lo:x_hi]
            image = np.ascontiguousarray(
                cropped.transpose(0, 1, 2, 4, 3, 5)
            ).reshape(nc, nt, nr * ch, ncol * cw)

        assay["image"] = Variable(("channel", "time", "im_y", "im_x"), image)
        assay.cache("image")
        return assay

    @components.register("stitch")
    def make(overlap: int = 102):
        return Stitcher(overlap=overlap)
