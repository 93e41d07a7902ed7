"""netCDF interchange: read/write magnify's save format.

The port's copy of ``magnify_tpu.io.netcdf``. magnify round-trips datasets
through ``xr.Dataset.to_netcdf`` / ``xr.open_dataset`` (magnify/file.py:6-17),
whose default engine writes netCDF4, an HDF5 file using dimension scales.
This module reads and writes that layout with h5py (no netCDF4/xarray
dependency) and reads classic netCDF-3 through ``scipy.io.netcdf_file``.
h5py is optional: without it netCDF4 files raise ``ImportError``, and
netCDF-3 files still load.

Layout notes (netCDF4-on-HDF5 conventions):

* every dimension is an HDF5 *dimension scale*; a dimension with a
  coordinate variable stores its values in the scale dataset itself, a
  bare dimension gets a placeholder scale whose NAME attribute starts
  "This is a netCDF dimension but not a netCDF variable".
* each data variable lists its dimensions via DIMENSION_LIST references.
"""

from __future__ import annotations

import pathlib

import numpy as np

from magnify_tpu_torch.core import Dataset

__all__ = ["read_netcdf", "write_netcdf"]

_PHONY = b"This is a netCDF dimension but not a netCDF variable."
_HIDDEN_ATTRS = {
    "CLASS", "NAME", "DIMENSION_LIST", "REFERENCE_LIST",
    "_Netcdf4Coordinates", "_Netcdf4Dimid", "_NCProperties",
}


def _h5py():
    """The optional h5py package, which netCDF4 (HDF5) files need."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError("netCDF4 (HDF5) files need the h5py package; "
                          "netCDF-3 files and .npz need nothing") from e
    return h5py


def _to_h5_value(values: np.ndarray):
    h5py = _h5py()

    if values.dtype.kind in ("U", "O"):
        return values.astype(object), h5py.string_dtype()
    if values.dtype.kind == "M":
        # Datetimes as int64 nanoseconds with a units attribute would be
        # the CF way; keep it simple and store raw int64 ns.
        return values.astype("datetime64[ns]").astype(np.int64), None
    return values, None


def write_netcdf(path, dataset: Dataset) -> None:
    """Write a Dataset as a netCDF4-style HDF5 file (h5py)."""
    h5py = _h5py()

    ds = dataset
    dim_sizes = dict(ds.sizes)
    coord_names = set(ds._coord_names)

    with h5py.File(path, "w") as f:
        f.attrs["_NCProperties"] = np.bytes_(
            b"version=2,magnify_tpu_torch=netcdf-writer"
        )
        for key, value in ds.attrs.items():
            try:
                f.attrs[key] = value
            except TypeError:
                f.attrs[key] = str(value)

        # Dimension scales first: coordinate variables hold real values,
        # bare dimensions a placeholder.
        scales = {}
        for dim, size in dim_sizes.items():
            if dim in ds.variables and ds.variables[dim].dims == (dim,):
                values, dt = _to_h5_value(ds.variables[dim].values)
                dset = f.create_dataset(dim, data=values, dtype=dt)
                dset.make_scale(dim)
            else:
                dset = f.create_dataset(dim, shape=(size,), dtype=np.float32)
                dset.make_scale(_PHONY.decode())
            scales[dim] = dset

        aux_coords = [n for n in coord_names
                      if n not in dim_sizes and n in ds.variables]
        for name, var in ds.variables.items():
            if name in dim_sizes:
                continue  # already written as a scale
            values, dt = _to_h5_value(var.values)
            dset = f.create_dataset(name, data=values, dtype=dt)
            for axis, dim in enumerate(var.dims):
                dset.dims[axis].attach_scale(scales[dim])
            if name in coord_names:
                dset.attrs["_magnify_coord"] = np.bytes_(b"1")
            else:
                # The CF/xarray convention: data variables list their
                # auxiliary coordinate variables.
                listed = [c for c in aux_coords
                          if set(ds.variables[c].dims) <= set(var.dims)]
                if listed:
                    dset.attrs["coordinates"] = np.bytes_(
                        " ".join(sorted(listed)).encode()
                    )


def _is_phony_scale(dset) -> bool:
    name = dset.attrs.get("NAME")
    if isinstance(name, bytes):
        return name.startswith(_PHONY[:30])
    if isinstance(name, str):
        return name.startswith(_PHONY[:30].decode())
    return False


def _decode_h5(values: np.ndarray) -> np.ndarray:
    if values.dtype.kind == "O":
        return np.array(
            [v.decode() if isinstance(v, bytes) else str(v)
             for v in values.reshape(-1)]
        ).reshape(values.shape)
    if values.dtype.kind == "S":
        return values.astype(str)
    return values


def _read_netcdf4(path) -> Dataset:
    h5py = _h5py()

    ds = Dataset()
    listed_coords: set[str] = set()
    with h5py.File(path, "r") as f:
        for key, value in f.attrs.items():
            if key in _HIDDEN_ATTRS:
                continue
            if isinstance(value, bytes):
                value = value.decode()
            if key == "coordinates":
                listed_coords |= set(str(value).split())
                continue
            ds.attrs[key] = value

        for name, dset in f.items():
            if not isinstance(dset, h5py.Dataset):
                continue
            if dset.attrs.get("CLASS") == b"DIMENSION_SCALE":
                if _is_phony_scale(dset):
                    continue
                ds[name] = ((name,), _decode_h5(dset[()]))
                ds._coord_names.add(name)
                continue
            dims = []
            for axis in range(dset.ndim):
                proxy = dset.dims[axis]
                if len(proxy) > 0:
                    dims.append(proxy[0].name.lstrip("/"))
                else:
                    dims.append(f"{name}_dim{axis}")
            ds[name] = (tuple(dims), _decode_h5(dset[()]))
            if dset.attrs.get("_magnify_coord") is not None:
                ds._coord_names.add(name)
            coord_attr = dset.attrs.get("coordinates")
            if coord_attr is not None:
                if isinstance(coord_attr, bytes):
                    coord_attr = coord_attr.decode()
                listed_coords |= set(str(coord_attr).split())
    for name in listed_coords:
        if name in ds.variables:
            ds._coord_names.add(name)
    return ds


def _read_netcdf3(path) -> Dataset:
    import scipy.io

    ds = Dataset()
    with scipy.io.netcdf_file(str(path), "r", mmap=False) as f:
        for key, value in (f._attributes or {}).items():
            if isinstance(value, bytes):
                value = value.decode()
            ds.attrs[key] = value
        for name, var in f.variables.items():
            values = np.array(var.data)
            if values.dtype.kind == "S":
                values = values.astype(str)
            ds[name] = (tuple(var.dimensions), values)
            if var.dimensions == (name,):
                ds._coord_names.add(name)
    return ds


def read_netcdf(path) -> Dataset:
    """Read a netCDF file: netCDF4/HDF5 (the reference's default engine) or
    classic netCDF-3."""
    magic = pathlib.Path(path).open("rb").read(8)
    if magic.startswith(b"\x89HDF"):
        return _read_netcdf4(path)
    if magic.startswith(b"CDF"):
        return _read_netcdf3(path)
    raise ValueError(f"{path} is not a netCDF (HDF5 or classic) file.")
