"""Input normalization, in-memory inputs only.

The ``Reader`` registered as ``"read"`` turns a DataArray/Dataset, or a
sequence of them, into an iterator of raw per-assay datasets, as the
in-memory branch of ``magnify_tpu.io.reader.Reader`` does. Path patterns,
TIFF stacks and stores are not ported yet (ROADMAP, queue 1) and raise.
"""

from __future__ import annotations

from magnify_tpu_torch import utils
from magnify_tpu_torch.core import DataArray, Dataset
from magnify_tpu_torch.core.registry import readers

__all__ = ["Reader"]


class Reader:
    """Normalize input into an iterator of raw assay datasets."""

    def __call__(self, data):
        items = ([data] if isinstance(data, utils.PathLike | DataArray | Dataset)
                 else data)
        for item in items:
            if not isinstance(item, (DataArray, Dataset)):
                raise NotImplementedError(
                    f"reading {type(item).__name__} inputs (paths, TIFF, "
                    "stores) is not ported yet; pass a DataArray or Dataset "
                    "(ROADMAP queue 1: io)"
                )
            yield item

    @readers.register("read")
    def make():
        return Reader()
