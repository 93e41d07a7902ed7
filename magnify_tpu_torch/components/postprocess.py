"""Postprocessing components: drop and restore_format
(reference magnify/postprocess.py)."""

from __future__ import annotations

from magnify_tpu_torch.core import DataArray
from magnify_tpu_torch.core.registry import component

_STANDARD_DIMS = ["channel", "time", "tile_row", "tile_col", "tile_y", "tile_x"]


@component("drop")
def drop(xp, roi_only: bool = False, drop_tiles: bool = True):
    if roi_only:
        return xp["roi"].assign_attrs(xp.attrs)
    if drop_tiles:
        return xp.drop_vars(["tile", "tile_row", "tile_col"], errors="ignore")
    return xp


@component("restore_format")
def restore_format(xp):
    """Undo standardize_format: unstack, restore the original time name,
    squeeze dims that were added, and restore each variable's original dim
    order contiguously (reference postprocess.py:20-49)."""
    xp = xp.unstack()

    if "__time__" in xp.dims:
        xp = xp.rename({"__time__": "time"})

    original = xp.attrs["__original_tile_dims__"]
    for dim in _STANDARD_DIMS:
        if dim not in original and dim in xp.dims and xp.sizes[dim] == 1:
            xp = xp.squeeze(dim)

    if isinstance(xp, DataArray):
        dims = list(xp.dims)
        present = [d for d in original if d in dims]
        if present:
            idxs = [i for i, d in enumerate(dims) if d in present]
            start, end = idxs[0], idxs[-1] + 1
            order = dims[:start] + present + dims[end:]
            xp = xp.transpose(*order)
        del xp.attrs["__original_tile_dims__"]
        return xp

    out = xp.copy()
    for name in list(out.variables):
        var = out.variables[name]
        var_dims = list(var.dims)
        present = [d for d in original if d in var_dims]
        if not present:
            continue
        idxs = [i for i, d in enumerate(var_dims) if d in present]
        start, end = idxs[0], idxs[-1] + 1
        order = var_dims[:start] + present + var_dims[end:]
        out._vars[name] = var.transpose(order)
    del out.attrs["__original_tile_dims__"]
    return out
