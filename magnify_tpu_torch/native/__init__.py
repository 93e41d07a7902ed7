"""Native (C++) IO runtime, built on first use and bound with ctypes.

The port's copy of ``magnify_tpu.native``: :func:`read_regions` pread()s
many file regions on a thread pool, inflating zlib/DEFLATE streams where
asked, into one buffer (the TIFF loader's batched page decode), and
:func:`lz4_decompress` decodes one LZ4 block (the codec inside blosc-lz4
zarr chunks).

``io_native.cpp`` is compiled by ``g++`` into
``.cache/magnify_tpu_torch/native/`` beside the package, keyed by a hash of
the source, the first time a caller asks for it. A failed build leaves
:func:`available` False, its message in :data:`build_error` and a warning
on the package's logger; callers then decode in Python.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess

import numpy as np

from magnify_tpu_torch.diagnostics import log

__all__ = ["available", "build_error", "lz4_decompress", "read_regions"]

SRC = pathlib.Path(__file__).with_name("io_native.cpp")
CACHE = SRC.parent.parent.parent / ".cache" / "magnify_tpu_torch" / "native"
VERSION = 2

#: Why the library is not available: the compiler's output, or "".
build_error = ""

_lib = None
_tried = False


def _build() -> pathlib.Path | None:
    global build_error
    tag = hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]
    so = CACHE / f"io_native_{tag}.so"
    if so.exists():
        return so
    CACHE.mkdir(parents=True, exist_ok=True)
    tmp = CACHE / f"io_native_{tag}.{os.getpid()}.so"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(SRC),
           "-o", str(tmp), "-lz", "-pthread"]
    try:
        done = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        build_error = f"{' '.join(cmd)}: {e}"
        return None
    if done.returncode != 0:
        build_error = f"{' '.join(cmd)}:\n{done.stdout}{done.stderr}"
        return None
    os.replace(tmp, so)  # atomic: concurrent builders never see half a file
    return so


def _load():
    global _lib, _tried, build_error
    if _tried:
        return _lib
    _tried = True
    so, lib = _build(), None
    try:
        lib = None if so is None else ctypes.CDLL(str(so))
    except OSError as e:
        build_error = f"loading {so}: {e}"
    if lib is None:
        log.warning("native IO library unavailable, decoding in Python: %s",
                    build_error)
        return None
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.mgtpu_read_regions.restype = ctypes.c_int
    lib.mgtpu_read_regions.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, i64p, i64p, i64p, i64p, u8p,
        ctypes.c_int, ctypes.c_int,
    ]
    lib.mgtpu_lz4_decompress.restype = ctypes.c_int64
    lib.mgtpu_lz4_decompress.argtypes = [u8p, ctypes.c_int64, u8p,
                                         ctypes.c_int64]
    if lib.mgtpu_version() != VERSION:
        build_error = f"{so}: version {lib.mgtpu_version()} != {VERSION}"
        log.warning("native IO library unavailable: %s", build_error)
        return None
    _lib = lib
    return _lib


def available() -> bool:
    """Whether the native library built and loaded (built on first call)."""
    return _load() is not None


def _require():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native IO library unavailable: {build_error}")
    return lib


def read_regions(path, src_offsets, src_sizes, dst_offsets, dst_sizes,
                 out: np.ndarray, compression: int = 0,
                 n_threads: int | None = None) -> None:
    """Fill ``out`` (uint8, writable, C-contiguous) with file regions.

    compression 0 copies raw bytes; 8 inflates zlib/DEFLATE streams of
    ``dst_sizes`` decompressed bytes each.
    """
    lib = _require()
    if out.dtype != np.uint8 or not out.flags.c_contiguous:
        raise ValueError("out must be a C-contiguous uint8 array")
    n = len(src_offsets)
    so, ss, do, ds = (np.ascontiguousarray(np.asarray(v, dtype=np.int64))
                      for v in (src_offsets, src_sizes, dst_offsets,
                                dst_sizes))
    if n_threads is None:
        n_threads = min(16, os.cpu_count() or 4)
    i64p = ctypes.POINTER(ctypes.c_int64)
    rc = lib.mgtpu_read_regions(
        str(path).encode(), n, so.ctypes.data_as(i64p),
        ss.ctypes.data_as(i64p), do.ctypes.data_as(i64p),
        ds.ctypes.data_as(i64p),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        int(compression), int(n_threads),
    )
    if rc != 0:
        raise OSError(f"native read_regions failed with status {rc} for "
                      f"{path}")


def lz4_decompress(src: bytes, max_out: int) -> bytes:
    """Decode one LZ4 block of at most ``max_out`` bytes; ValueError on a
    corrupt block."""
    lib = _require()
    out = np.empty(max_out, np.uint8)
    src_arr = np.frombuffer(src, np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    n = lib.mgtpu_lz4_decompress(src_arr.ctypes.data_as(u8p), len(src),
                                 out.ctypes.data_as(u8p), max_out)
    if n < 0:
        raise ValueError(f"corrupt LZ4 block (native status {n})")
    return out[:n].tobytes()
