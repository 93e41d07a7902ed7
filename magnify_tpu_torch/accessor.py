"""Dataset cache accessor (compatibility surface).

magnify exposes caching as the ``.mg`` xarray accessor
(magnify/accessor.py); here, as in ``magnify_tpu.accessor``, the same
operation lives on the Dataset itself (``ds.cache(...)``) with an ``.mg``
property shim for drop-in code. This module re-exports the pieces for users
who imported ``magnify.accessor`` directly.
"""

from __future__ import annotations

from magnify_tpu_torch.core.lazy import spill_to_store
from magnify_tpu_torch.core.xd import _Accessor as MagnifyAccessor

__all__ = ["MagnifyAccessor", "cache", "spill_to_store"]


def cache(dataset, variables=None):
    """Spill lazy variables of ``dataset`` to the on-disk store."""
    return dataset.cache(variables)
