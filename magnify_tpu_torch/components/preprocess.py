"""Preprocessing components: canonical layout, labels, illumination
correction, rotation, flips and masks.

The components of ``magnify_tpu.components.preprocess``, under its names:
``standardize_format``, ``rename_labels``, ``flatfield_correct`` (scalar,
array, TIFF-path or store-directory fields), ``horizontal_flip``,
``vertical_flip`` and ``circle_mask`` are host numpy code copied from the
JAX package; ``rotate`` resamples every plane on a device
(:func:`magnify_tpu_torch.ops.geom.rotate_plane`), and ``basic_correct``
fits its BaSiC fields on a device
(:func:`magnify_tpu_torch.ops.basic.fit_basic`) and applies them on the
host.
"""

from __future__ import annotations

import os
import pathlib

import numpy as np

from magnify_tpu_torch import utils
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


@component("rename_labels")
def rename_labels(xp, **coords):
    """Reassign coordinate labels by a replacement dict or a full list
    (reference preprocess.py:44-51)."""
    for name, new_labels in coords.items():
        if isinstance(new_labels, dict):
            vals = np.asarray(
                [new_labels.get(v, v) for v in xp[name].values.tolist()]
            )
            xp = xp.assign_coords({name: ((name,), vals)})
        else:
            xp = xp.assign_coords({name: ((name,), np.asarray(new_labels))})
    return xp


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


@component("basic_correct")
def basic_correct(xp, device="cuda"):
    """Retrospective illumination correction (reference preprocess.py:91-115).

    Per channel, a BaSiC flat field and dark field are fitted on the t = 0
    tiles on ``device`` (:func:`magnify_tpu_torch.ops.basic.fit_basic`)
    and applied to every tile of that channel as ``(tile - darkfield) /
    flatfield`` in float64, clipped at 0 and cast back to the tile dtype.
    Lazy tiles stay lazy: the correction is a deferred chunk map, and the
    result is cached as the JAX package caches it. ``basicpy``, which the
    JAX package prefers when it is installed, is built on JAX and is never
    used here.
    """
    from magnify_tpu_torch.ops.basic import fit_basic

    tile_var = xp["tile"]
    dtype = tile_var.dtype
    models = []
    for ci in range(xp.sizes["channel"]):
        train = np.asarray(xp.tile.isel(channel=ci, time=0).values)
        train = train.reshape(-1, train.shape[-2], train.shape[-1])
        models.append(fit_basic(train, get_darkfield=True,
                                smoothness_flatfield=1.0, device=device))

    def correct(block, slices):
        out = np.empty_like(block, dtype=float)
        for k, ci in enumerate(range(slices[0].start, slices[0].stop)):
            flat, dark = models[ci]
            out[k] = (block[k].astype(float) - dark) / flat
        return np.clip(out, 0, None).astype(dtype)

    data = tile_var.data
    if isinstance(data, ChunkedArray):
        xp["tile"] = Variable(
            tile_var.dims, data.map_chunks(correct, with_slices=True),
            tile_var.attrs,
        )
    else:
        data = np.asarray(data)
        out = np.empty_like(data)
        for ci, (flat, dark) in enumerate(models):
            out[ci] = np.clip((data[ci].astype(float) - dark) / flat, 0,
                              None).astype(dtype)
        xp["tile"] = Variable(tile_var.dims, out, tile_var.attrs)
    xp.cache("tile")
    return xp


@component("horizontal_flip")
def horizontal_flip(xp):
    """Mirror the image (or, before stitching, every tile) left to right."""
    if "image" in xp:
        xp["image"] = xp.image.isel(im_x=slice(None, None, -1))
    else:
        xp["tile"] = xp.tile.isel(tile_x=slice(None, None, -1))
    return xp


@component("vertical_flip")
def vertical_flip(xp):
    """Mirror the image (or, before stitching, every tile) top to bottom."""
    if "image" in xp:
        xp["image"] = xp.image.isel(im_y=slice(None, None, -1))
    else:
        xp["tile"] = xp.tile.isel(tile_y=slice(None, None, -1))
    return xp


@component("circle_mask")
def circle_mask(xp, center, diameter, mask_inner=False):
    """Zero out the pixels outside (or, with ``mask_inner``, inside) a
    circle (reference preprocess.py:136-153)."""
    radius = diameter // 2
    name = "image" if "image" in xp else "tile"
    shape = xp[name].shape[-2:]
    mask = utils.circle(shape, center, radius, True)
    mask = ~mask if mask_inner else mask
    var = xp[name]
    xp[name] = Variable(var.dims, var.values * mask, var.variable.attrs)
    return xp
