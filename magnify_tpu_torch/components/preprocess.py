"""Preprocessing components: canonical layout, flat-field correction and
rotation.

Host numpy code copied from ``magnify_tpu.components.preprocess``:
``standardize_format`` and ``flatfield_correct`` with scalar or array
fields; ``rotate`` resamples every plane on a device
(:func:`magnify_tpu_torch.ops.geom.rotate_plane`). Flat and dark fields
may be scalars, arrays, TIFF paths or store directories.
``basic_correct`` is not ported yet (ROADMAP, queue 1).
"""

from __future__ import annotations

import os
import pathlib

import numpy as np

from magnify_tpu_torch.core import DataArray, Dataset, Variable
from magnify_tpu_torch.core.lazy import ChunkedArray
from magnify_tpu_torch.core.registry import component

STANDARD_DIMS = ["channel", "time", "tile_row", "tile_col", "tile_y", "tile_x"]


@component("standardize_format")
def standardize_format(xp):
    """Normalize any input layout into the canonical 6-D tile stack.

    Same dim gymnastics as magnify/preprocess.py:11-41:
    rename x/y/row/col to tile_*, fold extra dims into time (renaming a real
    time dim to __time__ first), add missing dims, record the original order
    in ``__original_tile_dims__`` for restore_format, and transpose to
    (channel, time, tile_row, tile_col, tile_y, tile_x).
    """
    if isinstance(xp, DataArray):
        ds = Dataset({"tile": xp}, attrs=xp.attrs)
        xp = ds

    renames = {old: "tile_" + old for old in ["x", "y", "row", "col"]
               if old in xp.tile.dims}
    if renames:
        xp = xp.rename(renames)

    xp.attrs["__original_tile_dims__"] = list(xp.tile.dims)

    extra_dims = [d for d in xp.tile.dims if d not in STANDARD_DIMS]
    if extra_dims:
        if "time" in xp.tile.dims:
            xp = xp.rename({"time": "__time__"})
            extra_dims.append("__time__")
        xp = xp.stack(time=tuple(extra_dims))

    tile = xp["tile"]
    for dim in STANDARD_DIMS:
        if dim not in tile.dims:
            tile = tile.expand_dims(dim)
    xp["tile"] = tile

    return xp.transpose(*STANDARD_DIMS, missing_dims="ignore")


@component("rotate")
def rotate(xp, rotation=0, device="cuda"):
    """Rotate the stitched image about its center by ``rotation`` degrees:
    bilinear resampling with zero fill on ``device``, shape and dtype
    preserved. ``rotation=0`` is a no-op and touches no device."""
    if rotation == 0 or "image" not in xp:
        return xp
    import torch

    from magnify_tpu_torch.ops.geom import rotate_plane

    var = xp["image"]
    image = var.values
    flat = image.reshape((-1,) + image.shape[-2:])
    out = np.empty(flat.shape, image.dtype)
    for k, plane in enumerate(flat):
        rotated = rotate_plane(
            torch.as_tensor(np.ascontiguousarray(plane).astype(np.float32))
            .to(device), float(rotation))
        out[k] = rotated.cpu().numpy().astype(image.dtype)
    xp["image"] = Variable(var.dims, out.reshape(image.shape),
                           var.variable.attrs)
    return xp


def _load_field(value, group):
    """Resolve a scalar, array, TIFF path or store directory into an array
    or a scalar. A store directory holds the field as its variable
    ``group`` ("flatfield" or "darkfield"), in a subdirectory ``group`` or
    at its root."""
    if isinstance(value, os.PathLike | str):
        path = pathlib.Path(value).expanduser()
        if path.is_dir():
            from magnify_tpu_torch.io.zarrlite import open_store

            return open_store(path, group=group)[group]
        from magnify_tpu_torch.io.tiff import read_tiff

        return read_tiff(path)
    return value


@component("flatfield_correct")
def flatfield_correct(xp, flatfield=1.0, darkfield=0.0):
    """Illumination correction: ``clip(tile - darkfield) / flatfield``,
    rescaled to preserve the maximum and cast back to the input dtype
    (reference preprocess.py:62-88). Scalar, array, TIFF-path or
    store-dir corrections are accepted; lazy tiles stay lazy (two chunk
    passes: one reduction for the rescale factors, one deferred map).
    """
    flatfield = _load_field(flatfield, "flatfield")
    darkfield = _load_field(darkfield, "darkfield")
    if isinstance(flatfield, DataArray):
        flatfield = flatfield.values
    if isinstance(darkfield, DataArray):
        darkfield = darkfield.values

    # Identity correction (the pipeline defaults): mathematically a no-op on
    # non-negative data — skip the passes entirely. Unsigned dtypes are
    # non-negative by construction; eager signed/float data gets one cheap
    # min() check (the clip-at-zero still matters when negatives exist).
    identity = (np.isscalar(flatfield) and flatfield == 1.0
                and np.isscalar(darkfield) and darkfield == 0.0)
    if identity:
        if np.issubdtype(np.dtype(xp["tile"].dtype), np.unsignedinteger):
            return xp
        data = xp["tile"].data
        if (not isinstance(data, ChunkedArray)
                and np.asarray(data).size > 0
                and np.asarray(data).min() >= 0):
            return xp

    tile_var = xp["tile"]
    dtype = tile_var.dtype
    data = tile_var.data
    # float32 keeps uint16/float32 data exact; only widen for f64 inputs.
    work_dtype = np.result_type(dtype, np.float32)

    def corrected(block):
        return np.clip(block.astype(work_dtype) - darkfield, 0, None)

    if isinstance(data, ChunkedArray):
        if np.isscalar(flatfield) and flatfield == 1.0:
            # Unit flatfield: the rescale factor is exactly 1 (max_pre and
            # max_post are maxima of the SAME array), so the eager global-
            # max passes would read the whole lazy stack for nothing.
            # Defer the darkfield clip as a single chunk map — zero eager
            # reads; out-of-core stacks stay on disk.
            out = data.map_chunks(
                lambda b: corrected(b).astype(dtype), dtype=dtype,
            )
            xp["tile"] = Variable(tile_var.dims, out, tile_var.attrs)
            return xp
        # Pass 1: the two global maxima that set the rescale factor.
        max_pre = -np.inf
        max_post = -np.inf
        for idx in np.ndindex(*data.numblocks):
            block = corrected(data._block(idx))
            max_pre = max(max_pre, block.max(initial=-np.inf))
            max_post = max(max_post, (block / flatfield).max(initial=-np.inf))
        scale = max_pre / max_post if max_post > 0 else 1.0

        out = data.map_chunks(
            lambda b: ((corrected(b) / flatfield) * scale).astype(dtype),
            dtype=dtype,
        )
        xp["tile"] = Variable(tile_var.dims, out, tile_var.attrs)
    else:
        pre = corrected(np.asarray(data))
        if np.isscalar(flatfield) and flatfield == 1.0:
            # Unit flatfield: the rescale factor is exactly 1 and the
            # divide/multiply passes are identities — only the darkfield
            # clip (already applied) matters.
            xp["tile"] = Variable(tile_var.dims, pre.astype(dtype),
                                  tile_var.attrs)
            return xp
        max_pre = pre.max(initial=-np.inf)
        post = pre / flatfield
        max_post = post.max(initial=-np.inf)
        scale = max_pre / max_post if max_post > 0 else 1.0
        xp["tile"] = Variable(tile_var.dims, (post * scale).astype(dtype),
                              tile_var.attrs)
    return xp
