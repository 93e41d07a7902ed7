"""Self-contained TIFF / OME-TIFF reading and writing.

The port's own copy of ``magnify_tpu.io.tiff``: a struct-level
baseline-TIFF parser (classic and BigTIFF offsets, uncompressed or
zlib/deflate strips, the horizontal predictor) that probes a file's layout
without decoding, decodes pages on demand (the unit of lazy chunking), and
parses OME-XML and MicroManager metadata; and a writer that emits
multi-page OME-TIFFs, byte for byte the JAX package's files.

Differences from the JAX module, none of which changes a result:

* OME-XML is parsed with the standard library's ``xml.etree.ElementTree``
  (elements matched by local name, as BeautifulSoup's ``"xml"`` parser
  matches them), so no optional package decides whether a stack keeps its
  channel and time axes. Malformed XML gives ``None``; nothing else is
  swallowed.
* LZW, PackBits, JPEG and tiled pages decode through PIL, which is
  optional: without it such a page raises ``ImportError``.
* :func:`read_page` decodes through the same batched reader as
  :func:`read_pages` (the native pread/inflate pool where it built).
* :func:`write_tiff` streams page by page to the file instead of building
  it in memory.
* :data:`page_reads` counts the pages decoded, per (path, page).
"""

from __future__ import annotations

import collections
import dataclasses
import datetime
import json
import mmap
import struct
import threading
import xml.etree.ElementTree as ElementTree
import zlib

import numpy as np

from magnify_tpu_torch import native

__all__ = ["TiffInfo", "page_reads", "probe", "read_page", "read_pages",
           "read_tiff", "write_tiff"]

#: Pages decoded since the last ``page_reads.clear()``, per (path, page):
#: the out-of-core checks read it to show that each plane is read once.
page_reads: collections.Counter = collections.Counter()
_reads_lock = threading.Lock()

_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8,
               11: 4, 12: 8, 16: 8, 17: 8, 18: 8}
_TYPE_FMT = {1: "B", 3: "H", 4: "I", 8: "h", 9: "i", 11: "f", 12: "d",
             16: "Q", 17: "q"}


@dataclasses.dataclass
class _Page:
    width: int
    height: int
    bits: int
    sample_format: int
    compression: int
    strip_offsets: list
    strip_counts: list
    rows_per_strip: int
    description: str | None
    samples_per_pixel: int = 1
    predictor: int = 1


@dataclasses.dataclass
class TiffInfo:
    """Probe result: enough to build a lazy page-chunked array."""

    n_pages: int
    page_shape: tuple
    dtype: np.dtype
    axes: str                  # e.g. "TCYX"; one letter per series dim
    shape: tuple               # series shape matching axes
    description: str | None
    channels: list | None      # channel names, if present in metadata
    times: list | None         # per-timepoint datetimes, if present


def _dtype_of(bits: int, fmt: int) -> np.dtype:
    kind = {1: "u", 2: "i", 3: "f"}.get(fmt, "u")
    return np.dtype(f"{kind}{bits // 8}")


class _Parser:
    def __init__(self, path):
        self.path = str(path)
        self._file = open(self.path, "rb")
        try:
            self.data = mmap.mmap(self._file.fileno(), 0,
                                  access=mmap.ACCESS_READ)
        except (ValueError, OSError):
            # Empty or unmappable file: fall back to an eager read.
            self.data = self._file.read()
        magic = self.data[:4]
        if magic[:2] == b"II":
            self.end = "<"
        elif magic[:2] == b"MM":
            self.end = ">"
        else:
            raise ValueError(f"{path} is not a TIFF file.")
        version = struct.unpack(self.end + "H", self.data[2:4])[0]
        self.big = version == 43
        if self.big:
            first = struct.unpack(self.end + "Q", self.data[8:16])[0]
        elif version == 42:
            first = struct.unpack(self.end + "I", self.data[4:8])[0]
        else:
            raise ValueError(f"{path}: unknown TIFF version {version}.")
        self.page_offsets = []
        off = first
        while off:
            self.page_offsets.append(off)
            off = self._next_ifd(off)

    def _read_entry_count(self, off):
        if self.big:
            return struct.unpack(self.end + "Q", self.data[off:off + 8])[0], off + 8, 20
        return struct.unpack(self.end + "H", self.data[off:off + 2])[0], off + 2, 12

    def _next_ifd(self, off):
        n, start, esize = self._read_entry_count(off)
        pos = start + n * esize
        if self.big:
            return struct.unpack(self.end + "Q", self.data[pos:pos + 8])[0]
        return struct.unpack(self.end + "I", self.data[pos:pos + 4])[0]

    def _tag_values(self, tag_type, count, inline):
        size = _TYPE_SIZES.get(tag_type, 1) * count
        inline_cap = 8 if self.big else 4
        if size <= inline_cap:
            raw = inline[:size]
        else:
            off = struct.unpack(self.end + ("Q" if self.big else "I"),
                                inline[: 8 if self.big else 4])[0]
            raw = self.data[off: off + size]
        if tag_type == 2:  # ASCII
            return raw.rstrip(b"\0").decode("utf-8", "replace")
        if tag_type in (5, 10):  # rationals
            fmt = "I" if tag_type == 5 else "i"
            vals = struct.unpack(self.end + fmt * (2 * count), raw)
            return [vals[2 * i] / max(vals[2 * i + 1], 1) for i in range(count)]
        if tag_type == 7:  # UNDEFINED: raw bytes
            return raw
        fmt = _TYPE_FMT.get(tag_type)
        if fmt is None:
            return raw
        return list(struct.unpack(self.end + fmt * count, raw))

    def tags(self, page_idx):
        off = self.page_offsets[page_idx]
        n, start, esize = self._read_entry_count(off)
        out = {}
        for i in range(n):
            entry = self.data[start + i * esize: start + (i + 1) * esize]
            tag, typ = struct.unpack(self.end + "HH", entry[:4])
            if self.big:
                count = struct.unpack(self.end + "Q", entry[4:12])[0]
                inline = entry[12:20]
            else:
                count = struct.unpack(self.end + "I", entry[4:8])[0]
                inline = entry[8:12]
            out[tag] = self._tag_values(typ, count, inline)
        return out

    def page(self, page_idx) -> _Page:
        t = self.tags(page_idx)

        def one(tag, default=None):
            v = t.get(tag, default)
            if isinstance(v, list):
                return v[0]
            return v

        bits = one(258, 8)
        return _Page(
            width=int(one(256)),
            height=int(one(257)),
            bits=int(bits),
            sample_format=int(one(339, 1)),
            compression=int(one(259, 1)),
            strip_offsets=t.get(273, []),
            strip_counts=t.get(279, []),
            rows_per_strip=int(one(278, one(257))),
            description=t.get(270) if isinstance(t.get(270), str) else None,
            samples_per_pixel=int(one(277, 1)),
            predictor=int(one(317, 1)),
        )

    def decode(self, page_idx) -> np.ndarray:
        p = self.page(page_idx)
        dtype = _dtype_of(p.bits, p.sample_format).newbyteorder(self.end)
        if (p.compression not in (1, 8, 32946)
                or p.predictor not in (1, 2)
                or not p.strip_offsets):
            # LZW/PackBits/JPEG, the floating-point predictor, and tiled
            # layouts (no strip tags) decode through PIL, if installed.
            return self._decode_via_pil(page_idx, p)
        chunks = []
        for off, cnt in zip(p.strip_offsets, p.strip_counts):
            raw = self.data[int(off): int(off) + int(cnt)]
            if p.compression in (8, 32946):
                raw = zlib.decompress(raw)
            chunks.append(raw)
        buf = b"".join(chunks)
        n = p.height * p.width * p.samples_per_pixel
        arr = np.frombuffer(buf[: n * dtype.itemsize], dtype=dtype)
        arr = arr.reshape(p.height, p.width, p.samples_per_pixel)
        arr = arr.astype(arr.dtype.newbyteorder("="))
        if p.predictor == 2:
            # Horizontal differencing: each row stores per-sample deltas;
            # reverse with a wrapping cumsum along the row in the storage
            # dtype.
            arr = np.cumsum(arr, axis=1, dtype=arr.dtype)
        return arr.squeeze(-1) if p.samples_per_pixel == 1 else arr

    def _decode_via_pil(self, page_idx, p):
        try:
            from PIL import Image
        except ImportError as e:
            raise ImportError(
                f"{self.path} page {page_idx} (compression {p.compression}, "
                f"predictor {p.predictor}, "
                f"{'strips' if p.strip_offsets else 'tiles'}) needs PIL "
                "(pillow) to decode; only uncompressed and deflate strips "
                "decode without it") from e

        with Image.open(self.path) as im:
            im.seek(page_idx)
            return np.asarray(im)


def _local(tag: str) -> str:
    """An element's name without its ``{namespace}``."""
    return tag.rpartition("}")[2]


def _parse_ome(description: str):
    """Extract (order, sizes, channels, deltas) from OME-XML, or None.

    The first ``Pixels`` element in document order gives the dimension
    order and sizes; every ``Channel`` and ``Plane`` element of the
    document gives the names and the plane times, in ms (``DeltaT`` in
    seconds when every plane says ``DeltaTUnit="s"``). Elements match by
    local name, whatever their namespace. A description that is not XML
    (an ImageJ header, say) or has non-integer sizes gives None.
    """
    try:
        root = ElementTree.fromstring(description)
    except ElementTree.ParseError:
        return None
    elements = list(root.iter())
    pixels = next((e for e in elements if _local(e.tag) == "Pixels"), None)
    if pixels is None:
        return None
    order = pixels.get("DimensionOrder", "XYCZT")
    try:
        sizes = {d: int(pixels.get(f"Size{d}", 1)) for d in "XYCZT"}
    except ValueError:
        return None
    channels = [e.get("Name") for e in elements if _local(e.tag) == "Channel"]
    if not any(channels):
        channels = None
    planes = [e for e in elements if _local(e.tag) == "Plane"]
    deltas = None
    if planes and all(pl.get("DeltaT") is not None for pl in planes):
        try:
            deltas = [float(pl.get("DeltaT")) for pl in planes]
        except ValueError:
            return None
        if {pl.get("DeltaTUnit") for pl in planes} == {"s"}:
            deltas = [d * 1000 for d in deltas]
    return order, sizes, channels, deltas


def _parse_micromanager_summary(parser: _Parser):
    """MicroManager Summary metadata (StartTime, ChNames) from tag 51123."""
    try:
        tags = parser.tags(0)
        raw = tags.get(51123)
        if raw is None:
            return None
        if isinstance(raw, bytes):
            raw = raw.decode("utf-8", "replace").rstrip("\0")
        if isinstance(raw, list):
            return None
        meta = json.loads(raw)
        return meta.get("Summary", meta)
    except Exception:
        return None


def probe(path) -> TiffInfo:
    """Read layout + metadata without decoding pixel data.

    The equivalent of the reference's header probe (reader.py:190-260):
    derives series axes (OME DimensionOrder when present, a plain T axis for
    bare multi-page files), per-plane MicroManager acquisition times, and
    channel names.
    """
    parser = _Parser(path)
    p0 = parser.page(0)
    n_pages = len(parser.page_offsets)
    page_shape = (p0.height, p0.width)
    dtype = _dtype_of(p0.bits, p0.sample_format)

    channels = None
    times = None
    axes = "YX"
    shape = page_shape

    ome = _parse_ome(p0.description) if p0.description else None
    if ome is not None:
        order, sizes, channels, deltas = ome
        outer = [d for d in reversed(order) if d in "CZT" and sizes[d] > 1]
        axes = "".join(outer) + "YX"
        shape = tuple(sizes[d] for d in outer) + page_shape
        summary = _parse_micromanager_summary(parser)
        start = None
        if summary and "StartTime" in summary:
            try:
                start = datetime.datetime.strptime(
                    summary["StartTime"][:-6], "%Y-%m-%d %H:%M:%S.%f"
                )
            except ValueError:
                start = None
        if start is not None:
            if "T" in axes and deltas is not None:
                stride = sizes["C"] if "C" in axes else 1
                ts = deltas[::stride][: sizes["T"]]
                times = [start + datetime.timedelta(milliseconds=ms)
                         for ms in ts]
            else:
                times = [start]
        if channels is None and summary and "ChNames" in summary:
            channels = list(summary["ChNames"])
    elif n_pages > 1:
        axes = "TYX"
        shape = (n_pages,) + page_shape

    return TiffInfo(
        n_pages=n_pages, page_shape=page_shape, dtype=dtype, axes=axes,
        shape=shape, description=p0.description, channels=channels,
        times=times,
    )


def read_page(path, page_idx: int) -> np.ndarray:
    """Decode a single page: the unit of lazy chunking."""
    return read_pages(path, [page_idx])[0]


def read_pages(path, page_indices) -> np.ndarray:
    """Decode pages of one file into a (n, h, w) array.

    Same-shaped uncompressed or deflate strips without a predictor go
    through the native thread-pooled region reader
    (:mod:`magnify_tpu_torch.native`), which pread()s and inflates every
    strip of every requested page at once;
    anything else is decoded page by page in Python.
    """
    parser = _Parser(path)
    page_indices = [int(i) for i in page_indices]
    if not page_indices:
        p0 = parser.page(0)
        dtype = _dtype_of(p0.bits, p0.sample_format)
        return np.empty((0, p0.height, p0.width), dtype)
    with _reads_lock:
        page_reads.update((str(path), i) for i in page_indices)

    pages = [parser.page(i) for i in page_indices]
    p0 = pages[0]
    same = all(
        p.width == p0.width and p.height == p0.height and p.bits == p0.bits
        and p.sample_format == p0.sample_format
        and p.compression == p0.compression and p.samples_per_pixel == 1
        for p in pages
    )
    native_ok = (same and p0.compression in (1, 8, 32946)
                 and p0.predictor == 1 and bool(p0.strip_offsets)
                 and native.available())
    if not native_ok:
        return np.stack([parser.decode(i) for i in page_indices])

    dtype = _dtype_of(p0.bits, p0.sample_format).newbyteorder(parser.end)
    page_bytes = p0.height * p0.width * dtype.itemsize
    out = np.empty(len(pages) * page_bytes, np.uint8)
    src_off, src_sz, dst_off, dst_sz = [], [], [], []
    for pi, page in enumerate(pages):
        pos = pi * page_bytes
        rows_left = page.height
        for off, cnt in zip(page.strip_offsets, page.strip_counts):
            rows = min(page.rows_per_strip, rows_left)
            rows_left -= rows
            strip_bytes = rows * page.width * dtype.itemsize
            src_off.append(int(off))
            src_sz.append(int(cnt))
            dst_off.append(pos)
            dst_sz.append(strip_bytes)
            pos += strip_bytes

    native.read_regions(
        path, src_off, src_sz, dst_off, dst_sz, out,
        compression=0 if p0.compression == 1 else 8,
    )
    arr = out.view(dtype).reshape(len(pages), p0.height, p0.width)
    return arr.astype(dtype.newbyteorder("="), copy=False)


def read_tiff(path) -> np.ndarray:
    """Decode the full series into one array shaped per ``probe().shape``."""
    n = len(_Parser(path).page_offsets)
    return read_pages(path, range(n)).reshape(probe(path).shape)


def _ome_description(shape, axes, dtype, channels=None):
    sizes = dict.fromkeys("XYCZT", 1)
    for d, s in zip(axes, shape):
        sizes[{"Y": "Y", "X": "X", "C": "C", "T": "T", "Z": "Z"}[d]] = s
    dtype_names = {"uint8": "uint8", "uint16": "uint16", "uint32": "uint32",
                   "int16": "int16", "float32": "float", "float64": "double"}
    dname = dtype_names.get(np.dtype(dtype).name, "uint16")
    chans = ""
    n_c = sizes["C"]
    names = channels or [f"C{i}" for i in range(n_c)]
    for i in range(n_c):
        chans += f'<Channel ID="Channel:0:{i}" Name="{names[i]}" SamplesPerPixel="1"/>'
    return (
        '<?xml version="1.0" encoding="UTF-8"?>'
        '<OME xmlns="http://www.openmicroscopy.org/Schemas/OME/2016-06">'
        '<Image ID="Image:0"><Pixels ID="Pixels:0" DimensionOrder="XYCZT" '
        f'Type="{dname}" SizeX="{sizes["X"]}" SizeY="{sizes["Y"]}" '
        f'SizeC="{sizes["C"]}" SizeZ="{sizes["Z"]}" SizeT="{sizes["T"]}">'
        f"{chans}</Pixels></Image></OME>"
    )


def write_tiff(path, array: np.ndarray, axes: str | None = None,
               channels=None, ome: bool = True) -> None:
    """Write a (multi-page) baseline TIFF, optionally with OME-XML metadata.

    Pages are the leading dims flattened in C order (matching the OME
    XYCZT dimension order with T slowest), written one at a time: a stack
    larger than memory can be written from a memmap.
    """
    array = np.asarray(array)
    if array.ndim < 2:
        raise ValueError("array must be at least 2-D")
    if axes is None:
        axes = {2: "YX", 3: "CYX", 4: "TCYX"}.get(array.ndim)
        if axes is None:
            raise ValueError("pass axes for >4-D arrays")
    pages = array.reshape((-1,) + array.shape[-2:])
    h, w = array.shape[-2:]
    dtype = array.dtype
    fmt = {"u": 1, "i": 2, "f": 3}[dtype.kind]
    description = (_ome_description(array.shape, axes, dtype, channels)
                   if ome else None)

    # Layout: header(8) | for each page: pixel data | description | all
    # IFDs, each followed by the next one.
    page_bytes = h * w * dtype.itemsize
    desc_bytes = (description.encode() + b"\0") if description else None
    desc_offset = 8 + len(pages) * page_bytes
    ifd_start = desc_offset + (len(desc_bytes) if desc_bytes else 0)
    ifds = bytearray()
    pos = ifd_start
    for i in range(len(pages)):
        tags = [
            (256, 4, 1, w),
            (257, 4, 1, h),
            (258, 3, 1, dtype.itemsize * 8),
            (259, 3, 1, 1),
            (262, 3, 1, 1),
            (273, 4, 1, 8 + i * page_bytes),
            (277, 3, 1, 1),
            (278, 4, 1, h),
            (279, 4, 1, page_bytes),
            (339, 3, 1, fmt),
        ]
        if i == 0 and desc_bytes is not None:
            tags.append((270, 2, len(desc_bytes), desc_offset))
        tags.sort()
        n = len(tags)
        ifds += struct.pack("<H", n)
        for tag, typ, count, value in tags:
            ifds += struct.pack("<HHII", tag, typ, count, value)
        next_off = pos + 2 + n * 12 + 4
        ifds += struct.pack("<I", 0 if i == len(pages) - 1 else next_off)
        pos = next_off
    if pos > 2**32 - 1:
        raise ValueError(f"{path}: {pos} bytes do not fit a classic TIFF")

    little = dtype.newbyteorder("<")
    with open(path, "wb") as f:
        f.write(b"II*\x00" + struct.pack("<I", ifd_start))
        for page in pages:
            f.write(np.ascontiguousarray(page, dtype=little).data)
        if desc_bytes is not None:
            f.write(desc_bytes)
        f.write(ifds)
