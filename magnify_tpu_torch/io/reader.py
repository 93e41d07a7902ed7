"""Input normalization: path patterns, lazy TIFF stacks, stores.

The port's copy of ``magnify_tpu.io.reader``, which implements the magnify
reader contract (magnify/reader.py): the ``Reader`` registered as
``"read"`` turns a path/glob (with ``(assay)``, ``(channel)``,
``(time|FMT)``, ``(row)``, ``(col)`` specifiers and attached metadata
``(NAME_KEY|TYPE|FMT)``), an in-memory DataArray/Dataset, or a sequence of
them into an iterator of raw per-assay datasets. TIFF stacks load lazily,
one chunk per page, through :mod:`magnify_tpu_torch.io.tiff`; a directory
that is a store opens through :mod:`magnify_tpu_torch.io.zarrlite`.
"""

from __future__ import annotations

import collections
import datetime
import fnmatch
import glob as _glob
import os
import pathlib
import re

import numpy as np

from magnify_tpu_torch import utils
from magnify_tpu_torch.core import DataArray, Dataset
from magnify_tpu_torch.core.lazy import ChunkedArray
from magnify_tpu_torch.core.registry import readers
from magnify_tpu_torch.io import tiff as tiff_io

__all__ = ["Reader", "extract_paths", "read_tiffs"]


class Reader:
    """Normalize input into an iterator of raw assay datasets
    (magnify/reader.py:23-77)."""

    def __call__(self, data):
        items = ([data] if isinstance(data, utils.PathLike | DataArray | Dataset)
                 else data)
        for item in items:
            if isinstance(item, (DataArray, Dataset)):
                yield item
                continue

            path_dict, meta_dict = extract_paths(
                item, assay="str", channel="str", time="time", row="int",
                col="int",
            )
            if len(path_dict) == 0:
                raise FileNotFoundError(
                    f"The pattern {item} did not lead to any files."
                )

            # Nameless experiments get the empty-string name.
            path_dict = {("",) + k[1:] if k[0] is None else k: v
                         for k, v in path_dict.items()}
            names = sorted({k[0] for k in path_dict},
                           key=utils.natural_sort_key)
            for name in names:
                sub = {
                    tuple(-1 if v is None else v for v in k[1:]): p
                    for k, p in path_dict.items() if k[0] == name
                }
                path = pathlib.Path(next(iter(sub.values())))
                if len(sub) == 1 and path.is_dir():
                    from magnify_tpu_torch.io.zarrlite import open_any_store

                    ds = open_any_store(path)
                    ds.attrs["name"] = name
                    yield ds
                else:
                    yield read_tiffs(sub, name=name, meta_dict=meta_dict)

    @readers.register("read")
    def make():
        return Reader()


_DEFAULT_FORMATTERS = {
    "": lambda x, y: x,
    "str": lambda x, y: x,
    "time": lambda x, y: datetime.datetime.strptime(
        x, y if y else "%Y%m%d-%H%M%S"
    ),
    "int": lambda x, y: int(x),
    "float": lambda x, y: float(x),
}

# One (NAME) / (NAME|ARG) / (NAME|ARG|ARG) token of the specifier grammar.
_SPECIFIER = re.compile(r"\(\s*([^\s()|]+)\s*((?:\s*\|[^()|]*)*)\)")

# fnmatch.translate wraps its output in a fixed prefix/suffix (e.g.
# "(?s:" ... ")\Z"); measuring them on the empty pattern lets translated
# literal segments be spliced into a larger regex.
_FN_EMPTY = fnmatch.translate("")
_FN_PRE_LEN = _FN_EMPTY.rindex(")")
_FN_SUF_LEN = len(_FN_EMPTY) - _FN_EMPTY.rindex(")")


def _fn_body(segment: str) -> str:
    translated = fnmatch.translate(segment)
    return translated[_FN_PRE_LEN: len(translated) - _FN_SUF_LEN]


class _Capture:
    """One named capture in a path pattern: either the index value for a
    key ("(channel)") or a metadata coord attached to a key
    ("(conc_channel|float)")."""

    __slots__ = ("group", "key", "meta_name", "parse")

    def __init__(self, group, key, meta_name, parse):
        self.group = group
        self.key = key
        self.meta_name = meta_name
        self.parse = parse


def _classify_specifier(name: str, args: list, parsers: dict):
    """Map a (NAME|...) token to a _Capture, or None for plain text.

    ``(key)`` / ``(key|FMT)`` is an index capture when ``key`` is a known
    key; ``(name_key)`` / ``(name_key|TYPE|FMT)`` is a metadata capture
    attached to ``key``. Anything else is literal path text.
    """
    if name in parsers:
        fmt = args[0] if args else None
        fn = parsers[name]
        return _Capture(name, name, None,
                        lambda s, f=fn, y=fmt: f(s, y))
    stem, _, key = name.rpartition("_")
    if stem and key in parsers:
        type_fn = _DEFAULT_FORMATTERS[args[0] if args else ""]
        fmt = args[1] if len(args) > 1 else None
        return _Capture(stem, key, stem,
                        lambda s, f=type_fn, y=fmt: f(s, y))
    return None


def extract_paths(pattern, **keys):
    """Expand a glob+specifier pattern into indexed paths and metadata.

    The grammar of magnify/reader.py:80-160: each ``(key)`` or
    ``(key|FMT)`` names a path component captured into that key's index;
    ``(name_key)`` / ``(name_key|TYPE|FMT)`` captures extra metadata mapped
    by that key. Returns (path_dict, meta_dict) where path_dict maps
    ``(assay, channel, time, row, col)`` index tuples (None for unused keys)
    to absolute paths; duplicate index tuples raise ValueError.

    Implementation: the pattern is tokenized once into literal runs and
    specifier tokens, building the shell glob (specifier -> ``*``) and the
    capture regex side by side — a single pass instead of per-key text
    rewriting.
    """
    parsers = {k: (fn if callable(fn) else _DEFAULT_FORMATTERS[fn])
               for k, fn in keys.items()}
    index_order = list(keys)
    pattern = os.path.expanduser(str(pattern))

    captures: list[_Capture] = []
    glob_parts: list[str] = []
    regex_parts: list[str] = []
    cursor = 0
    for token in _SPECIFIER.finditer(pattern):
        literal = pattern[cursor:token.start()]
        glob_parts.append(literal)
        regex_parts.append(_fn_body(literal))
        cursor = token.end()

        args = [a.strip() for a in token.group(2).split("|")[1:]]
        capture = _classify_specifier(token.group(1).strip(), args, parsers)
        if capture is None:
            glob_parts.append(token.group(0))
            regex_parts.append(_fn_body(token.group(0)))
        else:
            captures.append(capture)
            glob_parts.append("*")
            regex_parts.append(rf"(?P<{capture.group}>[^/\\]*?)")
    tail = pattern[cursor:]
    glob_parts.append(tail)
    regex_parts.append(_fn_body(tail))

    regex = re.compile("".join(regex_parts), re.IGNORECASE | re.DOTALL)

    path_dict = {}
    meta_dict = collections.defaultdict(dict)
    for path in _glob.glob("".join(glob_parts), recursive=True):
        match = regex.fullmatch(path)
        if match is None:
            continue
        parsed = {c.group: c.parse(match.group(c.group)) for c in captures}
        index = tuple(parsed.get(k) for k in index_order)
        if index in path_dict:
            raise ValueError(
                f"{path} and {path_dict[index]} resolve to the same index; "
                "add specifiers to the pattern to tell them apart."
            )
        path_dict[index] = os.path.abspath(path)
        for c in captures:
            if c.meta_name is not None and c.key in parsed:
                meta_dict[c.meta_name, c.key][parsed[c.key]] = parsed[c.group]

    return path_dict, meta_dict


_LETTER_TO_DIM = {
    "C": "channel",
    "T": "time",
    "Z": "depth",
    "Y": "tile_y",
    "X": "tile_x",
    "R": "tile_pos",
}


def read_tiffs(xp_dict, name, meta_dict) -> Dataset:
    """Assemble a lazy tile stack from indexed TIFF paths
    (magnify/reader.py:163-324): one lazy chunk per TIFF page."""
    channel_idxs, time_idxs, row_idxs, col_idxs = (
        sorted(set(idx)) for idx in zip(*xp_dict.keys())
    )

    dims_in_path = []
    outer_shape = ()
    if channel_idxs[0] != -1:
        dims_in_path.append("channel")
        outer_shape += (len(channel_idxs),)
    if time_idxs[0] != -1:
        dims_in_path.append("time")
        outer_shape += (len(time_idxs),)
    if row_idxs[0] != -1:
        dims_in_path.append("tile_row")
        outer_shape += (len(row_idxs),)
    if col_idxs[0] != -1:
        dims_in_path.append("tile_col")
        outer_shape += (len(col_idxs),)

    times = time_idxs if "time" in dims_in_path else None
    channels = channel_idxs if "channel" in dims_in_path else None

    first_path = next(iter(xp_dict.values()))
    info = tiff_io.probe(first_path)
    dims_in_file = [_LETTER_TO_DIM[c] for c in info.axes]
    inner_shape = tuple(info.shape)

    if times is None and info.times is not None:
        times = list(info.times)
    if channels is None and info.channels is not None:
        channels = list(info.channels)

    if "tile_pos" in dims_in_file:
        # Tiles always span files; users must specify tiles in the path.
        i = dims_in_file.index("tile_pos")
        inner_shape = inner_shape[:i] + inner_shape[i + 1:]
        dims_in_file = dims_in_file[:i] + dims_in_file[i + 1:]
    if "depth" in dims_in_file:
        raise ValueError("tiff files with a Z dimension are not yet supported.")
    if "tile_y" not in dims_in_file or "tile_x" not in dims_in_file:
        raise ValueError("tiff files must contain an X and Y dimension.")
    if set(dims_in_file).intersection(dims_in_path):
        raise ValueError(
            "Dimensions specified in the path names and inside the tiff file "
            "overlap."
        )

    filenames = [p for _, p in sorted(xp_dict.items())]
    page_shape = info.page_shape
    page_lead = inner_shape[: len(inner_shape) - len(page_shape)]

    def load_page(block_idx):
        outer_id = block_idx[: len(outer_shape)]
        inner_id = block_idx[len(outer_shape):]
        file_idx = (int(np.ravel_multi_index(outer_id, outer_shape))
                    if outer_shape else 0)
        page_idx = (int(np.ravel_multi_index(inner_id[: len(page_lead)],
                                             page_lead))
                    if page_lead else 0)
        page = tiff_io.read_page(filenames[file_idx], page_idx)
        lead = len(block_idx) - page.ndim
        return page.reshape((1,) * lead + page.shape)

    shape = outer_shape + inner_shape
    chunks = ((1,) * len(outer_shape) + (1,) * len(page_lead)
              + page_shape)
    tiles = ChunkedArray(load_page, shape=shape, dtype=info.dtype,
                         chunks=chunks)

    coords = {}
    if channels is not None:
        coords["channel"] = (("channel",), np.asarray(channels))
    if times is not None:
        # Full float-second precision: MicroManager per-plane DeltaT times
        # are sub-second, and truncating to whole seconds would collapse
        # distinct planes into duplicate time labels.
        stamps = [t.timestamp() if isinstance(t, datetime.datetime)
                  else t for t in times]
        coords["time"] = (("time",), np.asarray(stamps))

    xp = Dataset(
        {"tile": (tuple(dims_in_path + dims_in_file), tiles)},
        coords=coords,
        attrs={"name": name},
    )
    xp = xp.transpose("channel", "time", "tile_row", "tile_col", "tile_y",
                      "tile_x", missing_dims="ignore")

    for (meta_name, dim), mapping in meta_dict.items():
        if dim not in xp.dims or dim not in xp.coords:
            continue
        if dim == "time":
            # The time coord stores t.timestamp() floats; re-key the mapping
            # the same way so the lookup is exact float equality.
            mapping = {
                (k.timestamp() if isinstance(k, datetime.datetime) else k): v
                for k, v in mapping.items()
            }
        dim_vals = xp[dim].values.tolist()
        meta_vals = [mapping[v] for v in dim_vals]
        xp = xp.assign_coords({meta_name: ((dim,), np.asarray(meta_vals))})

    return xp
