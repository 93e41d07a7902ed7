"""Chunked lazy arrays: the out-of-core execution layer (L1).

The reference gets terabyte-scale laziness from Dask chunked arrays created by
the reader (magnify/reader.py:284-292), rechunked after
stitching (magnify/stitch.py:42-45) and spilled to a zarr
cache between stages (magnify/accessor.py:18-35).

This module provides the same capability without Dask:

* :class:`ChunkedArray` — shape/dtype/chunk-grid plus a per-chunk loader
  callable; elementwise ops are deferred per chunk (``map_chunks``), and
  ``__getitem__`` materializes only the chunks intersecting the request.
* :func:`spill_to_store` — materializes a lazy array into an on-disk
  ``np.memmap`` (the zarr-spill equivalent); the returned memmap is an
  OS-paged ndarray, so downstream slicing stays out-of-core.

This layer only manages host memory.
"""

from __future__ import annotations

import atexit
import math
import os
import shutil
import tempfile
from collections.abc import Callable

import numpy as np

__all__ = ["ChunkedArray", "from_block_function", "spill_to_store"]

# Keep spill directories alive for the process lifetime, mirroring the
# module-global cache list in the reference accessor (accessor.py:8).
_spill_dirs: list[str] = []


def _cleanup_spill_dirs():
    for d in _spill_dirs:
        shutil.rmtree(d, ignore_errors=True)


atexit.register(_cleanup_spill_dirs)


def normalize_chunks(chunks, shape):
    """Expand per-dim chunk sizes into dask-style tuples of block lengths."""
    out = []
    for c, s in zip(chunks, shape):
        if isinstance(c, (int, np.integer)):
            c = int(c)
            if c <= 0:
                c = s
            n = max(1, math.ceil(s / c)) if s else 1
            sizes = tuple(min(c, s - i * c) for i in range(n)) if s else (0,)
            out.append(sizes)
        else:
            out.append(tuple(int(x) for x in c))
    return tuple(out)


class ChunkedArray:
    """A lazily evaluated array defined by a chunk grid and a loader.

    ``loader(block_index) -> np.ndarray`` returns one block. All other
    behavior (slicing, elementwise maps, transposes, full materialization)
    is derived from it.
    """

    def __init__(self, loader: Callable, shape, dtype, chunks, depth=0):
        self.shape = tuple(int(s) for s in shape)
        self.dtype = np.dtype(dtype)
        self.chunks = normalize_chunks(chunks, self.shape)
        self._loader = loader
        # Deferred-compute depth: 0 = reads straight from the source
        # (TIFF page, store chunk, generator); each map_chunks layer adds
        # 1. Pure index remaps (transpose/expand_dims/stitch) keep it.
        # Dataset.cache uses it to decide whether a spill actually pays
        # (re-reading a depth<=1 array from its source is cheaper than
        # writing + re-reading a full on-disk copy).
        self.depth = int(depth)
        self._offsets = tuple(
            np.concatenate([[0], np.cumsum(c)]).astype(np.int64) for c in self.chunks
        )

    # -- introspection ---------------------------------------------------------
    @property
    def ndim(self):
        return len(self.shape)

    @property
    def numblocks(self):
        return tuple(len(c) for c in self.chunks)

    @property
    def size(self):
        return int(np.prod(self.shape)) if self.shape else 1

    @property
    def nbytes(self):
        return self.size * self.dtype.itemsize

    def __repr__(self):
        return (f"ChunkedArray(shape={self.shape}, dtype={self.dtype}, "
                f"numblocks={self.numblocks})")

    def _block(self, idx) -> np.ndarray:
        out = np.asarray(self._loader(tuple(idx)))
        expected = tuple(self.chunks[d][idx[d]] for d in range(self.ndim))
        if out.shape != expected:
            raise ValueError(
                f"loader returned block of shape {out.shape}, expected {expected} "
                f"for block index {tuple(idx)}"
            )
        return out

    # -- materialization ---------------------------------------------------------
    def compute(self) -> np.ndarray:
        out = np.empty(self.shape, dtype=self.dtype)
        self._fill(out)
        return out

    def _fill(self, out: np.ndarray):
        for idx in np.ndindex(*self.numblocks):
            sl = tuple(
                slice(self._offsets[d][i], self._offsets[d][i + 1])
                for d, i in enumerate(idx)
            )
            out[sl] = self._block(idx)

    def __array__(self, dtype=None, copy=None):
        arr = self.compute()
        return arr.astype(dtype) if dtype is not None else arr

    # -- region read --------------------------------------------------------------
    def __getitem__(self, key) -> np.ndarray:
        """Materialize only the requested region (reads intersecting chunks)."""
        if not isinstance(key, tuple):
            key = (key,)
        if any(k is Ellipsis for k in key):
            i = key.index(Ellipsis)
            fill = self.ndim - (len(key) - 1)
            key = key[:i] + (slice(None),) * fill + key[i + 1:]
        key = key + (slice(None),) * (self.ndim - len(key))

        # Normalize each index into (start, stop) bounds + post-selection.
        bounds = []
        post = []
        for d, k in enumerate(key):
            n = self.shape[d]
            if isinstance(k, (int, np.integer)):
                k = int(k) + (n if k < 0 else 0)
                bounds.append((k, k + 1))
                post.append(0)  # collapse dim
            elif isinstance(k, slice):
                start, stop, step = k.indices(n)
                if step == 1:
                    bounds.append((start, max(start, stop)))
                    post.append(slice(None))
                else:
                    idx = np.arange(start, stop, step)
                    if idx.size == 0:
                        bounds.append((0, 0))
                        post.append(idx)
                    else:
                        lo, hi = int(idx.min()), int(idx.max()) + 1
                        bounds.append((lo, hi))
                        post.append(idx - lo)
            else:
                idx = np.asarray(k)
                if idx.dtype == bool:
                    idx = np.nonzero(idx)[0]
                if idx.size == 0:
                    lo, hi = 0, 0
                else:
                    lo, hi = int(idx.min()), int(idx.max()) + 1
                bounds.append((lo, hi))
                post.append(idx - lo)

        region_shape = tuple(hi - lo for lo, hi in bounds)
        out = np.empty(region_shape, dtype=self.dtype)
        # Read intersecting chunks.
        ranges = []
        for d, (lo, hi) in enumerate(bounds):
            offs = self._offsets[d]
            first = int(np.searchsorted(offs, lo, side="right")) - 1
            last = int(np.searchsorted(offs, max(hi - 1, lo), side="right")) - 1
            ranges.append(range(max(first, 0), min(last, self.numblocks[d] - 1) + 1))
        if all(len(r) > 0 for r in ranges) and 0 not in region_shape:
            for idx in np.ndindex(*[len(r) for r in ranges]):
                bidx = tuple(ranges[d][i] for d, i in enumerate(idx))
                block = None
                src_sl, dst_sl = [], []
                skip = False
                for d, bi in enumerate(bidx):
                    b0 = int(self._offsets[d][bi])
                    b1 = int(self._offsets[d][bi + 1])
                    lo, hi = bounds[d]
                    s0, s1 = max(lo, b0), min(hi, b1)
                    if s0 >= s1:
                        skip = True
                        break
                    src_sl.append(slice(s0 - b0, s1 - b0))
                    dst_sl.append(slice(s0 - lo, s1 - lo))
                if skip:
                    continue
                block = self._block(bidx)
                out[tuple(dst_sl)] = block[tuple(src_sl)]
        # Apply strides/fancy indices and collapse int dims.
        result = out
        # Apply per-dim post selections one dim at a time (to keep fancy
        # indexers independent).
        offset = 0
        for d, p in enumerate(post):
            ax = d - offset
            if isinstance(p, int):
                # View, not np.take: collapsing an int dim must not copy the
                # region (the buffer extent along this dim is already 1).
                result = result[(slice(None),) * ax + (0,)]
                offset += 1
            elif isinstance(p, slice):
                if p != slice(None):
                    sl = [slice(None)] * result.ndim
                    sl[ax] = p
                    result = result[tuple(sl)]
            else:
                result = np.take(result, p, axis=ax)
        return result

    # -- lazy transforms ---------------------------------------------------------
    def map_chunks(self, fn, dtype=None, with_slices=False) -> "ChunkedArray":
        """Apply ``fn`` elementwise per chunk, deferred.

        ``with_slices=True`` passes the chunk's global slice tuple as a second
        argument so broadcast operands can be sliced to match (the equivalent
        of ``da.map_blocks`` with ``block_info``).
        """
        parent = self
        if with_slices:
            def loader(idx):
                sl = tuple(
                    slice(parent._offsets[d][i], parent._offsets[d][i + 1])
                    for d, i in enumerate(idx)
                )
                return fn(parent._block(idx), sl)
        else:
            def loader(idx):
                return fn(parent._block(idx))
        return ChunkedArray(loader, self.shape, dtype or self.dtype, self.chunks,
                            depth=self.depth + 1)

    def astype(self, dtype) -> "ChunkedArray":
        return self.map_chunks(lambda b: b.astype(dtype), dtype=dtype)

    def transpose(self, axes) -> "ChunkedArray":
        parent = self
        axes = tuple(axes)

        def loader(idx):
            # idx[k] indexes new dim k, which is parent dim axes[k].
            parent_idx = [0] * parent.ndim
            for k, d in enumerate(axes):
                parent_idx[d] = idx[k]
            return parent._block(tuple(parent_idx)).transpose(axes)

        shape = tuple(self.shape[d] for d in axes)
        chunks = tuple(self.chunks[d] for d in axes)
        return ChunkedArray(loader, shape, self.dtype, chunks,
                            depth=self.depth)

    def expand_dims(self, axis=0) -> "ChunkedArray":
        parent = self

        def loader(idx):
            pidx = idx[:axis] + idx[axis + 1:]
            return np.expand_dims(parent._block(pidx), axis)

        shape = self.shape[:axis] + (1,) + self.shape[axis:]
        chunks = self.chunks[:axis] + ((1,),) + self.chunks[axis:]
        return ChunkedArray(loader, shape, self.dtype, chunks,
                            depth=self.depth)


def from_block_function(fn, shape, dtype, chunks) -> ChunkedArray:
    """Build a lazy array from ``fn(block_index) -> np.ndarray``."""
    return ChunkedArray(fn, shape, dtype, chunks)


# Arrays below this size are kept resident; larger ones go to disk memmaps.
RESIDENT_BYTES_LIMIT = 256 * 1024 * 1024


def alloc_output(name: str, shape, dtype) -> np.ndarray:
    """Allocate a result array: RAM if small, disk-backed memmap if large.

    The out-of-core stand-in for the reference's empty dask allocations
    (magnify/find.py:70-116): marker ROI stacks can
    exceed host memory, so large outputs are OS-paged from a spill file.
    """
    nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
    if nbytes <= RESIDENT_BYTES_LIMIT:
        return np.zeros(shape, dtype)
    directory = tempfile.mkdtemp(prefix="magnify_tpu_spill_")
    _spill_dirs.append(directory)
    return np.lib.format.open_memmap(
        os.path.join(directory, f"{name}.npy"), mode="w+", dtype=dtype,
        shape=tuple(int(s) for s in shape),
    )


# A spill truncates deferred work, but for a shallow lazy array (a pure
# remap over its source, depth <= 1) the "work" being truncated is cheaper
# than writing and re-reading a full on-disk copy — and on >RAM stacks the
# extra copy doubles IO and floods the page cache. Spill only when the
# deferred chain is deep enough to pay, or the array is small enough that
# the copy is free anyway.
SPILL_DEPTH = 2


def worth_spilling(arr) -> bool:
    """Whether ``Dataset.cache`` should materialize this array."""
    if not isinstance(arr, ChunkedArray):
        return True  # ndarray: spilling is a no-op or trivial
    return arr.depth >= SPILL_DEPTH or arr.nbytes <= RESIDENT_BYTES_LIMIT


def _evict_pages(mm: np.memmap) -> None:
    """Flush and drop a memmap's resident pages (best effort).

    Bounds peak RSS during large spills: dirty page-cache pages of the
    mapped file otherwise accumulate to the full array size before the
    kernel writes them back.
    """
    try:
        import mmap as _mmap

        mm.flush()
        mm._mmap.madvise(_mmap.MADV_DONTNEED)
    except (AttributeError, ValueError, OSError):
        pass


def is_memmap_backed(arr) -> bool:
    """Whether ``arr`` is (a view of) an on-disk memmap (walks ``.base``).

    The reduction-placement signal shared by ``quantify`` and
    ``identify_mrbles``: a disk-spilled store reduces on host — streaming
    data that already lives in host spill files through the device costs
    more in host->HBM transfer than the reduction saves.
    """
    seen = set()
    a = arr
    while a is not None and id(a) not in seen:
        seen.add(id(a))
        if isinstance(a, np.memmap):
            return True
        a = getattr(a, "base", None)
    return False


def evict_backing_pages(arr) -> None:
    """Evict the page cache behind ``arr`` if it is (a view of) a memmap.

    Walks ``.base`` to the root mapping so transposed/sliced views work.
    Used by streaming consumers (ROI crop writes, quantify batch reads) to
    keep already-consumed pages of a big spill file from accumulating in
    RSS; the data stays on disk and re-faults on later access.
    """
    seen = set()
    a = arr
    while a is not None and id(a) not in seen:
        seen.add(id(a))
        if isinstance(a, np.memmap):
            _evict_pages(a)
            return
        a = getattr(a, "base", None)


# Evict spill pages after this many dirty bytes.
_EVICT_INTERVAL_BYTES = 256 * 1024 * 1024


def spill_to_store(arr, name="array", directory=None) -> np.memmap:
    """Materialize a lazy array into an on-disk memmap and return it.

    The zarr-spill equivalent of the reference's ``.mg.cache``
    (magnify/accessor.py:18-35): bounds the deferred-op
    graph while keeping the data OS-paged rather than resident. Written
    pages are periodically flushed and evicted so peak RSS stays bounded
    by the eviction interval, not the array size.
    """
    if isinstance(arr, np.memmap):
        return arr
    if directory is None:
        directory = tempfile.mkdtemp(prefix="magnify_tpu_spill_")
        _spill_dirs.append(directory)
    path = os.path.join(directory, f"{name}.npy")
    if isinstance(arr, np.ndarray):
        mm = np.lib.format.open_memmap(path, mode="w+", dtype=arr.dtype,
                                       shape=arr.shape)
        mm[...] = arr
        mm.flush()
        return mm
    mm = np.lib.format.open_memmap(path, mode="w+", dtype=arr.dtype,
                                   shape=arr.shape)
    written = 0
    for idx in np.ndindex(*arr.numblocks):
        sl = tuple(
            slice(arr._offsets[d][i], arr._offsets[d][i + 1])
            for d, i in enumerate(idx)
        )
        block = arr._block(idx)
        mm[sl] = block
        written += block.nbytes
        if written >= _EVICT_INTERVAL_BYTES:
            _evict_pages(mm)
            written = 0
    mm.flush()
    return mm
