"""Whole-dataset save/load round-trip (magnify/file.py:6-17), the port's
copy of ``magnify_tpu.io.file``.

Formats by extension:

* ``.nc`` / ``.cdf`` / ``.netcdf`` / ``.h5`` — netCDF4-style HDF5, magnify's
  own save format (classic netCDF-3 files also load), via
  :mod:`magnify_tpu_torch.io.netcdf` (h5py, optional);
* anything else — a single ``.npz`` carrying every variable plus a JSON
  manifest of dims/coords/attrs.

Saving unstacks any multi-index (netCDF can't store them either); loading
re-stacks ``mark = (mark_row, mark_col)`` for chip datasets, as magnify
does. Files written by either package load in the other.
"""

from __future__ import annotations


import json
import pathlib

import numpy as np

from magnify_tpu_torch.core import DataArray, Dataset
from magnify_tpu_torch.core.lazy import evict_backing_pages

__all__ = ["load", "save"]

_NETCDF_SUFFIXES = {".nc", ".cdf", ".netcdf", ".h5"}


def _as_dataset(xp):
    if isinstance(xp, DataArray):
        return Dataset({xp.name or "data": xp}, attrs=xp.attrs)
    return xp


def _restack(ds: Dataset) -> Dataset:
    if "mark_row" in ds.dims and "mark_col" in ds.dims:
        ds = ds.stack(mark=("mark_row", "mark_col")).transpose("mark", ...)
    return ds


def save(file, xp: Dataset) -> None:
    """Save a dataset (or DataArray); format picked by file extension."""
    if (isinstance(file, (str, pathlib.Path))
            and pathlib.Path(file).suffix.lower() in _NETCDF_SUFFIXES):
        from magnify_tpu_torch.io.netcdf import write_netcdf

        write_netcdf(file, _as_dataset(xp).unstack())
        return
    _save_npz(file, xp)


def load(file) -> Dataset:
    """Load a dataset saved by :func:`save` (or by magnify's xarray-based
    save); re-stacks chip multi-indexes."""
    if isinstance(file, (str, pathlib.Path)):
        magic = pathlib.Path(file).open("rb").read(8)
        if magic.startswith(b"\x89HDF") or magic.startswith(b"CDF"):
            from magnify_tpu_torch.io.netcdf import read_netcdf

            return _restack(read_netcdf(file))
    return _load_npz(file)


def _save_npz(file, xp: Dataset) -> None:
    """Save a dataset (or DataArray) to a single npz file."""
    xp = _as_dataset(xp)
    xp = xp.unstack()
    manifest = {"attrs": xp.attrs, "vars": {}, "coords": []}
    arrays = {}
    for name, var in xp.variables.items():
        manifest["vars"][name] = {"dims": list(var.dims)}
        if name in xp._coord_names:
            manifest["coords"].append(name)
        values = var.values
        if values.dtype == object:
            values = values.astype(str)
        arrays[f"var_{name}"] = values
    arrays["__manifest__"] = np.frombuffer(
        json.dumps(manifest, default=str).encode(), dtype=np.uint8
    )
    np.savez(file, **arrays)
    # A spilled (memmap) ROI store was just read through once: drop its
    # pages, so saving an out-of-core result does not keep it in RSS.
    for values in arrays.values():
        evict_backing_pages(values)


def _load_npz(file) -> Dataset:
    with np.load(file, allow_pickle=False) as npz:
        manifest = json.loads(bytes(npz["__manifest__"]).decode())
        ds = Dataset(attrs=manifest.get("attrs", {}))
        for name, spec in manifest["vars"].items():
            ds[name] = (tuple(spec["dims"]), npz[f"var_{name}"])
        for name in manifest.get("coords", []):
            ds._coord_names.add(name)
    return _restack(ds)
