"""The port's io layer against the JAX package's, on files both can read.

* TIFF: files written by each package's ``write_tiff`` are byte-equal, and
  ``probe``/``read_page``/``read_pages``/``read_tiff`` give the same layout
  and pixels on OME multi-page stacks, deflate strips with the horizontal
  predictor, PIL-decoded (LZW) pages and through the native batched
  reader and the Python loop; ``_parse_ome`` (ElementTree) gives the
  BeautifulSoup version's ``(order, sizes, channels, deltas)`` on the OME
  strings of ``tests/test_io.py`` and on hand-written ones (namespaces,
  ``DeltaTUnit="s"``); the optional packages raise ``ImportError`` when a
  file needs them and they are missing.
* Paths: ``extract_paths`` and ``Reader`` build the same datasets from
  channel directories, row/col tiles, in-file times, path times, metadata
  captures and store directories.
* Interchange: an npz, a netCDF4 and a netCDF-3 file saved by either
  package loads equal in the other; zarr v2/v3 stores (blosc-lz4, zlib,
  gzip) open equal in both.
* ``image``/``image_pipe`` from a TIFF tile grid at rotation 0 (exact) and
  3 degrees (within the rotate component's tolerance).
* Flat and dark fields given as a TIFF path or a store directory correct
  as the same array does.
* ``microfluidic_chip`` on an OME-TIFF and ``beads`` on a store directory
  equal the same entry points on the arrays in memory.

Everything here is host numpy code in both packages, so the JAX functions
run in this process.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import magnify_tpu as mg
import magnify_tpu_torch as mt
from magnify_tpu.io import reader as jreader
from magnify_tpu.io import tiff as jtiff
from magnify_tpu.io import zarrlite as jzarr
from magnify_tpu_torch import native as tnative
from magnify_tpu_torch.io import reader as treader
from magnify_tpu_torch.io import tiff as ttiff
from magnify_tpu_torch.io import zarrlite as tzarr

sys.path.insert(0, os.path.dirname(__file__))
from test_io import (  # noqa: E402
    _blosc_frame,
    _lz4_block_build,
    _lz4_compress_literals,
    _write_deflate_predictor_tiff,
)

torch.set_num_threads(1)

KEYS = dict(assay="str", channel="str", time="time", row="int", col="int")


def _values(v):
    v = np.asarray(v)
    return v.astype(str) if v.dtype == object else v


def assert_same_dataset(got, want, attrs=True):
    """Same variables, dims, coordinate names, dtypes and values."""
    assert sorted(got.variables) == sorted(want.variables)
    assert sorted(got.coords) == sorted(want.coords)
    for name in want.variables:
        g, w = got[name], want[name]
        assert g.dims == w.dims, name
        gv, wv = _values(g.values), _values(w.values)
        assert gv.dtype == wv.dtype, name
        np.testing.assert_array_equal(gv, wv, err_msg=name)
    if attrs:
        assert got.attrs == want.attrs


# ----------------------------------------------------------------------
# (a) TIFF
# ----------------------------------------------------------------------

def _arrays():
    rng = np.random.default_rng(0)
    return {
        "yx_u16": (rng.integers(0, 65535, (33, 47)).astype(np.uint16), {}),
        "yx_f32": (rng.normal(0, 1, (20, 31)).astype(np.float32), {}),
        "cyx_u8_bare": (rng.integers(0, 255, (3, 16, 24)).astype(np.uint8),
                        {"ome": False}),
        "tcyx_ome": (rng.integers(0, 999, (3, 2, 16, 16)).astype(np.uint16),
                     {"channels": ["bf", "gfp"]}),
        "tyx_bare": (rng.integers(0, 999, (6, 33, 47)).astype(np.uint16),
                     {"axes": "TYX", "ome": False}),
        "tcyx_one_channel": (rng.integers(0, 999, (3, 1, 12, 14))
                             .astype(np.uint16), {}),
    }


@pytest.mark.parametrize("name", sorted(_arrays()))
def test_write_tiff_byte_equal_and_reads_match(tmp_path, name):
    arr, kw = _arrays()[name]
    tp, jp = tmp_path / "t.tif", tmp_path / "j.tif"
    ttiff.write_tiff(tp, arr, **kw)
    jtiff.write_tiff(jp, arr, **kw)
    assert tp.read_bytes() == jp.read_bytes()
    ti, ji = ttiff.probe(tp), jtiff.probe(jp)
    for field in ("n_pages", "page_shape", "dtype", "axes", "shape",
                  "description", "channels", "times"):
        assert getattr(ti, field) == getattr(ji, field), field
    got, want = ttiff.read_tiff(tp), jtiff.read_tiff(jp)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got.reshape(want.shape), arr.reshape(
        want.shape))
    last = ti.n_pages - 1
    np.testing.assert_array_equal(ttiff.read_page(tp, last),
                                  jtiff.read_page(jp, last))
    idx = [last, 0] if last else [0]
    np.testing.assert_array_equal(ttiff.read_pages(tp, idx),
                                  jtiff.read_pages(jp, idx))


def _without_native(monkeypatch):
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_tried", True)


def test_native_batched_reader_and_python_loop_agree(tmp_path, monkeypatch):
    """The port's native library builds here; its batched page reads equal
    the JAX package's and the port's own Python loop."""
    assert tnative.available(), tnative.build_error
    arr = np.random.default_rng(9).integers(0, 999, (6, 33, 47)).astype(
        np.uint16)
    p = tmp_path / "batch.tif"
    ttiff.write_tiff(p, arr, axes="TYX", ome=False)
    native = ttiff.read_pages(p, [0, 3, 5])
    np.testing.assert_array_equal(native, jtiff.read_pages(p, [0, 3, 5]))
    np.testing.assert_array_equal(native, arr[[0, 3, 5]])
    _without_native(monkeypatch)
    np.testing.assert_array_equal(ttiff.read_pages(p, [0, 3, 5]), native)


def test_page_reads_counts_each_decoded_page(tmp_path):
    arr = np.zeros((4, 8, 8), np.uint16)
    p = tmp_path / "s.tif"
    ttiff.write_tiff(p, arr, axes="TYX", ome=False)
    ttiff.page_reads.clear()
    ttiff.read_pages(p, [0, 2])
    ttiff.read_page(p, 2)
    assert dict(ttiff.page_reads) == {(str(p), 0): 1, (str(p), 2): 2}
    ttiff.page_reads.clear()


@pytest.mark.parametrize("rows_per_strip", [3, 7])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_deflate_predictor_strips_match(tmp_path, rows_per_strip, dtype):
    rng = np.random.default_rng(11)
    arr = rng.integers(0, np.iinfo(dtype).max, (7, 13)).astype(dtype)
    p = tmp_path / "pred.tif"
    _write_deflate_predictor_tiff(p, arr, rows_per_strip=rows_per_strip)
    got = ttiff.read_tiff(p)
    np.testing.assert_array_equal(got, jtiff.read_tiff(p))
    np.testing.assert_array_equal(got, arr)


def test_deflate_strips_through_native_reader(tmp_path):
    """Deflate strips without a predictor take the native inflate pool."""
    import struct
    import zlib

    arr = np.random.default_rng(4).integers(0, 999, (9, 10)).astype(np.uint16)
    payload = zlib.compress(arr.tobytes())
    tags = [(256, 3, 1, 10), (257, 3, 1, 9), (258, 3, 1, 16), (259, 3, 1, 8),
            (262, 3, 1, 1), (273, 4, 1, 0), (277, 3, 1, 1), (278, 3, 1, 9),
            (279, 4, 1, len(payload))]
    ifd_len = 2 + 12 * len(tags) + 4
    tags[5] = (273, 4, 1, 8 + ifd_len)
    ifd = struct.pack("<H", len(tags)) + b"".join(
        struct.pack("<HHII", *t) for t in tags) + struct.pack("<I", 0)
    p = tmp_path / "deflate.tif"
    p.write_bytes(struct.pack("<2sHI", b"II", 42, 8) + ifd + payload)
    np.testing.assert_array_equal(ttiff.read_pages(p, [0])[0], arr)
    np.testing.assert_array_equal(jtiff.read_pages(p, [0])[0], arr)


def _pil_files(tmp_path):
    from PIL import Image

    arr = (np.arange(128 * 96) % 251).astype(np.uint8).reshape(128, 96)
    lzw, tiled = tmp_path / "lzw.tif", tmp_path / "tiled.tif"
    Image.fromarray(arr).save(lzw, compression="tiff_lzw")
    Image.fromarray(arr).save(tiled, compression="tiff_adobe_deflate",
                              tiffinfo={322: 64, 323: 64})
    return arr, (lzw, tiled)


def test_pil_pages_match_and_need_pil(tmp_path, monkeypatch):
    arr, paths = _pil_files(tmp_path)
    for p in paths:
        got = ttiff.read_tiff(p)
        np.testing.assert_array_equal(got, jtiff.read_tiff(p))
        np.testing.assert_array_equal(got, arr)
    # The LZW page needs PIL; the second file, which PIL writes as deflate
    # strips whatever tile tags it is given, does not.
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="needs PIL"):
        ttiff.read_tiff(paths[0])
    np.testing.assert_array_equal(ttiff.read_tiff(paths[1]), arr)


def _ome_strings():
    """The OME-XML descriptions written for the stacks of tests/test_io.py,
    and hand-written MicroManager-style documents."""
    out = []
    for shape, axes, channels in (((3, 2, 16, 16), "TCYX", ["a", "b"]),
                                  ((3, 2, 16, 16), "TCYX", ["bf", "gfp"]),
                                  ((3, 1, 12, 14), "TCYX", None),
                                  ((3, 1, 8, 8), "TCYX", None),
                                  ((32, 48), "YX", None),
                                  ((2, 4, 4), "CYX", None)):
        out.append(jtiff._ome_description(shape, axes, np.uint16, channels))
    ns = "http://www.openmicroscopy.org/Schemas/OME/2016-06"
    planes = "".join(f'<Plane TheT="{t}" DeltaT="{0.5 * t}" DeltaTUnit="s"/>'
                     for t in range(3))
    out.append(f'<?xml version="1.0" encoding="UTF-8"?><OME xmlns="{ns}">'
               '<Image ID="Image:0"><Pixels DimensionOrder="XYZCT" '
               'SizeX="4" SizeY="4" SizeT="3"><Channel Name="Cy5"/>'
               f"{planes}</Pixels></Image></OME>")
    out.append(f'<ome:OME xmlns:ome="{ns}"><ome:Image><ome:Pixels '
               'DimensionOrder="XYCTZ" SizeX="4" SizeY="4" SizeC="2" '
               'SizeT="2"><ome:Channel Name="a"/><ome:Channel/>'
               '<ome:Plane DeltaT="10" DeltaTUnit="ms"/>'
               '<ome:Plane DeltaT="20"/></ome:Pixels></ome:Image></ome:OME>')
    out.append('<OME><Image><Pixels SizeX="4" SizeY="4" SizeT="2">'
               '<Plane DeltaT="1" DeltaTUnit="s"/><Plane/></Pixels></Image>'
               '<Image><Pixels SizeX="9"/><Channel Name=""/></Image></OME>')
    out.append('<OME><Image><Pixels SizeX="4" SizeY="4" SizeT="2">'
               '<Plane DeltaT="1" DeltaTUnit="s"/>'
               '<Plane DeltaT="2" DeltaTUnit="ms"/></Pixels></Image></OME>')
    out.append("<OME><Image/></OME>")
    return out


@pytest.mark.parametrize("k", range(len(_ome_strings())))
def test_parse_ome_equals_bs4(k):
    text = _ome_strings()[k]
    want = jtiff._parse_ome(text)
    assert want is not None or k == len(_ome_strings()) - 1
    assert ttiff._parse_ome(text) == want


def test_parse_ome_is_none_for_non_xml():
    assert ttiff._parse_ome("ImageJ=1.54f\nimages=3\n") is None
    assert ttiff._parse_ome('<OME><Pixels SizeX="four"/></OME>') is None


def test_lz4_native_and_python_match_jax(monkeypatch):
    rng = np.random.default_rng(5)
    blocks = []
    for _ in range(20):
        first = rng.integers(0, 256, int(rng.integers(1, 40)),
                             dtype=np.uint8).tobytes()
        seqs = [(first, int(rng.integers(1, len(first) + 1)),
                 int(rng.integers(4, 300)))]
        tail = rng.integers(0, 256, int(rng.choice([0, 5, 270])),
                            dtype=np.uint8).tobytes()
        blocks.append(_lz4_block_build(seqs, tail))
    for block, expect in blocks:
        assert tnative.lz4_decompress(block, len(expect)) == expect
        assert jzarr._lz4_block_decompress(block, len(expect)) == expect
    _without_native(monkeypatch)
    for block, expect in blocks:
        assert tzarr._lz4_block_decompress(block, len(expect)) == expect


# ----------------------------------------------------------------------
# (b) path patterns and the Reader
# ----------------------------------------------------------------------

def _tree(root, layout, **kw):
    for rel, arr in layout.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        ttiff.write_tiff(p, arr, **kw)


def _layouts(root):
    rng = np.random.default_rng(3)

    def img(*shape):
        return rng.integers(0, 999, shape).astype(np.uint16)

    cases = {}
    cases["channels"] = ("(channel)/a.tif",
                         {"egfp/a.tif": img(8, 8), "cy5/a.tif": img(8, 8)},
                         {"ome": False})
    tiles = {f"{t}/img_{r}_{c}.tif": img(6, 7)
             for t in ("20240101-000000", "20240101-000100")
             for r in range(2) for c in range(3)}
    cases["time_row_col"] = ("(time)/img_(row)_(col).tif", tiles,
                             {"ome": False})
    cases["in_file_times"] = ("(channel)/s.ome.tif",
                              {"red/s.ome.tif": img(3, 1, 12, 14),
                               "green/s.ome.tif": img(3, 1, 12, 14)}, {})
    cases["ome_stack"] = ("s.ome.tif", {"s.ome.tif": img(3, 2, 16, 16)},
                          {"channels": ["bf", "gfp"]})
    cases["metadata"] = ("ch(channel)_(conc_channel|float)nM/x.tif",
                         {"ch0_100nM/x.tif": img(8, 8),
                          "ch1_250nM/x.tif": img(8, 8)}, {"ome": False})
    cases["custom_time"] = ("t_(time|%H%M)/x.tif",
                            {"t_0130/x.tif": img(4, 4),
                             "t_0200/x.tif": img(4, 4)}, {"ome": False})
    cases["assays"] = ("(assay)/x.tif", {"exp2/x.tif": img(8, 8),
                                         "exp10/x.tif": img(8, 8)},
                       {"ome": False})
    return cases


@pytest.mark.parametrize("case", ["channels", "time_row_col",
                                  "in_file_times", "ome_stack", "metadata",
                                  "custom_time", "assays"])
def test_reader_builds_the_same_datasets(tmp_path, case):
    pattern, layout, kw = _layouts(tmp_path)[case]
    _tree(tmp_path, layout, **kw)
    pattern = str(tmp_path / pattern)
    got_paths, got_meta = treader.extract_paths(pattern, **KEYS)
    want_paths, want_meta = jreader.extract_paths(pattern, **KEYS)
    assert got_paths == want_paths
    assert dict(got_meta) == dict(want_meta)
    got = list(treader.Reader()(pattern))
    want = list(jreader.Reader()(pattern))
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        assert_same_dataset(g, w)


def test_reader_opens_store_dirs(tmp_path):
    ds = mt.Dataset({"tile": (("tile_y", "tile_x"),
                              np.arange(48.0).reshape(6, 8))},
                    attrs={"name": "run1"})
    tzarr.write_store(tmp_path / "run1", ds)
    jzarr.write_zarr_v2(tmp_path / "run2", mg.Dataset(
        {"tile": (("tile_y", "tile_x"), np.arange(48.0).reshape(6, 8))}))
    for name in ("run1", "run2"):
        (got,) = treader.Reader()(str(tmp_path / name))
        (want,) = jreader.Reader()(str(tmp_path / name))
        assert_same_dataset(got, want)


def test_reader_errors_match(tmp_path):
    with pytest.raises(FileNotFoundError):
        list(treader.Reader()("/nonexistent/(channel)/*.tif"))
    _tree(tmp_path, {"t0/s.ome.tif": np.zeros((3, 1, 8, 8), np.uint16),
                     "a/x.tif": np.zeros((4, 4), np.uint16),
                     "a/y.tif": np.zeros((4, 4), np.uint16)})
    with pytest.raises(ValueError, match="overlap"):
        list(treader.Reader()(str(tmp_path / "t(time|%S)/s.ome.tif")))
    with pytest.raises(ValueError, match="same index"):
        treader.extract_paths(str(tmp_path / "(channel)/*.tif"), **KEYS)


# ----------------------------------------------------------------------
# (c) save/load and stores across the packages
# ----------------------------------------------------------------------

def _beads_like(pkg):
    ds = pkg.Dataset(
        {"roi": (("mark", "channel", "roi_y", "roi_x"),
                 np.arange(2 * 2 * 3 * 3, dtype=np.uint16).reshape(
                     2, 2, 3, 3))},
        coords={"x": (("mark",), np.array([1.0, 2.5])),
                "tag": (("mark",), np.array(["a", "bb"])),
                "channel": (("channel",), np.array(["red", "green"]))},
        attrs={"name": "run"},
    )
    return ds


def _chip_like(pkg):
    """The chip-shaped dataset of tests/test_io.py, stacked over marks."""
    ds = pkg.Dataset({"roi": (("mark_row", "mark_col", "roi_y", "roi_x"),
                              np.arange(2 * 3 * 4 * 4, dtype=np.uint16)
                              .reshape(2, 3, 4, 4))},
                     attrs={"name": "exp1"})
    ds = ds.assign_coords(
        tag=(("mark_row", "mark_col"),
             np.array([["a", "b", ""], ["c", "d", "e"]])),
        x=(("mark_row", "mark_col"), np.arange(6, dtype=float).reshape(2, 3)),
        mark_row=(("mark_row",), np.array([0, 1])),
    )
    return ds.stack(mark=("mark_row", "mark_col")).transpose("mark", ...)


@pytest.mark.parametrize("fmt", ["npz", "nc"])
@pytest.mark.parametrize("kind", ["beads", "chip"])
@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_save_load_across_packages(tmp_path, fmt, kind, writer):
    make = _beads_like if kind == "beads" else _chip_like
    path = tmp_path / f"out.{fmt}"
    src, dst = (mt, mg) if writer == "torch" else (mg, mt)
    src.save(path, make(src))
    got, want = dst.load(path), src.load(path)
    assert ("mark" in got.dims) and got.roi.sizes["mark"] == (
        2 if kind == "beads" else 6)
    assert_same_dataset(got.unstack(), want.unstack())


def test_netcdf3_loads_in_both(tmp_path):
    import scipy.io

    path = tmp_path / "classic.nc"
    f = scipy.io.netcdf_file(str(path), "w")
    f.createDimension("t", 3)
    f.createVariable("t", "i4", ("t",))[:] = [1, 2, 3]
    f.createVariable("signal", "f4", ("t",))[:] = [0.5, 1.5, 2.5]
    f._attributes["name"] = "classic"
    f.close()
    assert_same_dataset(mt.load(path), mg.load(path))


def test_netcdf4_needs_h5py(tmp_path, monkeypatch):
    path = tmp_path / "out.nc"
    mg.save(path, _beads_like(mg))
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        mt.load(path)
    with pytest.raises(ImportError, match="h5py"):
        mt.save(tmp_path / "again.nc", _beads_like(mt))


def _zarr_v2_blosc(root):
    (root / "image").mkdir(parents=True)
    data = np.arange(64 * 40, dtype=np.uint16).reshape(64, 40) % 1000
    (root / ".zgroup").write_text('{"zarr_format": 2}')
    (root / ".zattrs").write_text('{"name": "blosc-run"}')
    (root / "image" / ".zarray").write_text(json.dumps({
        "zarr_format": 2, "shape": [64, 40], "chunks": [32, 40],
        "dtype": "<u2", "order": "C", "fill_value": 0,
        "compressor": {"id": "blosc", "cname": "lz4", "clevel": 5,
                       "shuffle": 1},
    }))
    (root / "image" / ".zattrs").write_text(
        '{"_ARRAY_DIMENSIONS": ["y", "x"]}')
    for i in range(2):
        chunk = np.ascontiguousarray(data[32 * i:32 * (i + 1)])
        (root / "image" / f"{i}.0").write_bytes(_blosc_frame(
            chunk.ravel(), 1, _lz4_compress_literals, shuffle=True,
            blocksize=1024))


def _zarr_v3(root, codec):
    import gzip
    import zlib

    root.mkdir()
    (root / "zarr.json").write_text(json.dumps({
        "zarr_format": 3, "node_type": "group",
        "attributes": {"name": "v3exp"}}))
    img = np.arange(96, dtype=np.float32).reshape(8, 12)
    adir = root / "image"
    (adir / "c" / "0").mkdir(parents=True)
    if codec == "blosc":
        compress = lambda b: _blosc_frame(  # noqa: E731
            np.frombuffer(b, np.float32), 1, _lz4_compress_literals,
            shuffle=True, blocksize=len(b))
    else:
        compress = gzip.compress if codec == "gzip" else zlib.compress
    (adir / "zarr.json").write_text(json.dumps({
        "zarr_format": 3, "node_type": "array", "shape": [8, 12],
        "data_type": "float32",
        "chunk_grid": {"name": "regular",
                       "configuration": {"chunk_shape": [8, 6]}},
        "chunk_key_encoding": {"name": "default",
                               "configuration": {"separator": "/"}},
        "codecs": [{"name": "bytes", "configuration": {"endian": "little"}},
                   {"name": codec}],
        "fill_value": 0.0, "dimension_names": ["y", "x"],
    }))
    for j in range(2):
        chunk = np.ascontiguousarray(img[:, j * 6:(j + 1) * 6])
        (adir / "c" / "0" / str(j)).write_bytes(compress(chunk.tobytes()))


@pytest.mark.parametrize("store", ["v2_blosc_lz4", "v2_zlib_written",
                                   "v3_blosc", "v3_gzip", "native"])
def test_stores_open_equal(tmp_path, store):
    root = tmp_path / "store"
    if store == "v2_blosc_lz4":
        _zarr_v2_blosc(root)
    elif store == "v2_zlib_written":
        tzarr.write_zarr_v2(root, _beads_like(mt))
        other = tmp_path / "jstore"
        jzarr.write_zarr_v2(other, _beads_like(mg))
        for f in sorted(p.relative_to(other) for p in other.rglob("*")
                        if p.is_file()):
            assert (root / f).read_bytes() == (other / f).read_bytes(), f
    elif store.startswith("v3"):
        _zarr_v3(root, store[3:])
    else:
        tzarr.write_store(root, _beads_like(mt))
    got, want = tzarr.open_any_store(root), jzarr.open_any_store(root)
    assert_same_dataset(got, want)


def test_zstd_store_needs_zstandard(tmp_path, monkeypatch):
    import zstandard

    root = tmp_path / "store"
    (root / "image").mkdir(parents=True)
    (root / ".zgroup").write_text('{"zarr_format": 2}')
    (root / "image" / ".zarray").write_text(json.dumps({
        "zarr_format": 2, "shape": [4], "chunks": [4], "dtype": "<u2",
        "order": "C", "fill_value": 0, "compressor": {"id": "zstd"}}))
    (root / "image" / "0").write_bytes(zstandard.ZstdCompressor().compress(
        np.arange(4, dtype=np.uint16).tobytes()))
    assert_same_dataset(tzarr.open_any_store(root),
                        jzarr.open_any_store(root))
    monkeypatch.setitem(sys.modules, "zstandard", None)
    with pytest.raises(ImportError, match="zstandard"):
        tzarr.open_any_store(root)


def test_accessor_cache_spills_lazy_variables():
    from magnify_tpu_torch.core.lazy import ChunkedArray

    arr = np.arange(24.0).reshape(2, 3, 4)
    lazy = ChunkedArray(lambda idx: arr[idx[0]:idx[0] + 1], shape=arr.shape,
                        dtype=arr.dtype, chunks=(1, 3, 4))
    ds = mt.Dataset({"image": (("c", "y", "x"), lazy)})
    out = mt.accessor.cache(ds, ["image"])
    assert not isinstance(out["image"].data, ChunkedArray)
    np.testing.assert_array_equal(out["image"].values, arr)
    assert mt.accessor.spill_to_store is not None
    assert sorted(mt.accessor.__all__) == sorted(mg.accessor.__all__)


# ----------------------------------------------------------------------
# (d) image / image_pipe from a TIFF tile grid
# ----------------------------------------------------------------------

@pytest.mark.parametrize("rotation", [0, 3])
def test_image_from_tiff_grid_matches_jax(tmp_path, rotation):
    rng = np.random.default_rng(2)
    layout = {f"{ch}/tile_{r}_{c}.tif": rng.integers(0, 999, (40, 36))
              .astype(np.uint16)
              for ch in ("red", "green") for r in range(2) for c in range(2)}
    _tree(tmp_path, layout, ome=False)
    pattern = str(tmp_path / "(channel)/tile_(row)_(col).tif")
    got = mt.image(pattern, overlap=6, rotation=rotation, device="cpu")
    want = mg.image(pattern, overlap=6, rotation=rotation)
    piped = mt.image_pipe(overlap=6, rotation=rotation, device="cpu")(
        data=pattern)
    assert_same_dataset(piped, got)
    assert got.image.dims == want.image.dims
    assert got.image.shape == (2, 2 * 34, 2 * 30)
    if rotation == 0:
        assert_same_dataset(got, want)
        np.testing.assert_array_equal(
            got.image.sel(channel="red").values[:34, 30:],
            layout["red/tile_0_1.tif"][3:37, 3:33])
        return
    # The rotate component's tolerance (tests/test_torch_chip.py).
    diff = np.abs(got.image.values.astype(np.int64)
                  - want.image.values.astype(np.int64))
    assert diff.max() <= 1e-4 * 1000.0 + 1.0
    assert (diff == 0).mean() > 0.99


# ----------------------------------------------------------------------
# (g) flat and dark fields from files
# ----------------------------------------------------------------------

def _field_case():
    rng = np.random.default_rng(7)
    tiles = rng.normal(300, 20, (2, 1, 32, 40)).astype(np.uint16)
    yy, xx = np.mgrid[0:32, 0:40]
    flat = (1.0 + 0.2 * np.exp(-((yy - 16) ** 2 + (xx - 20) ** 2) / 300.0)
            ).astype(np.float32)
    dark = np.full((32, 40), 7.0, np.float32)
    return tiles, flat, dark


def _correct(pkg, tiles, **fields):
    ds = pkg.Dataset({"tile": (("channel", "time", "tile_y", "tile_x"),
                               tiles.copy())})
    return pkg.core.registry.components.get("flatfield_correct")(**fields)(
        ds)["tile"].values


@pytest.mark.parametrize("form", ["tiff", "store", "store_group_dir"])
def test_fields_from_files_equal_arrays(tmp_path, form):
    tiles, flat, dark = _field_case()
    if form == "tiff":
        fpath, dpath = tmp_path / "flat.tif", tmp_path / "dark.tif"
        ttiff.write_tiff(fpath, flat)
        ttiff.write_tiff(dpath, dark)
    else:
        fpath = dpath = tmp_path / "fields"
        if form == "store":
            tzarr.write_store(fpath, mt.Dataset({
                "flatfield": (("y", "x"), flat),
                "darkfield": (("y", "x"), dark)}))
        else:
            for name, arr in (("flatfield", flat), ("darkfield", dark)):
                tzarr.write_store(fpath, mt.Dataset({name: (("y", "x"),
                                                            arr)}),
                                  group=name)
    want = _correct(mt, tiles, flatfield=flat, darkfield=dark)
    got = _correct(mt, tiles, flatfield=str(fpath), darkfield=str(dpath))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, _correct(mg, tiles, flatfield=str(fpath), darkfield=str(dpath)))
    assert not np.array_equal(got, tiles)


def test_failed_native_build_is_reported(tmp_path, monkeypatch, caplog):
    """A native library that does not build leaves ``available()`` False,
    says why in ``build_error`` and on the logger, and the reader decodes
    the same pages in Python."""
    bad = tmp_path / "io_native.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "SRC", bad)
    monkeypatch.setattr(tnative, "CACHE", tmp_path / "cache")
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_tried", False)
    monkeypatch.setattr(tnative, "build_error", "")
    with caplog.at_level("WARNING", logger="magnify_tpu_torch"):
        assert not tnative.available()
    assert "io_native.cpp" in tnative.build_error
    assert any("native IO library unavailable" in r.getMessage()
               for r in caplog.records)
    with pytest.raises(RuntimeError, match="unavailable"):
        tnative.lz4_decompress(b"\x00", 1)
    arr = np.arange(3 * 8 * 8, dtype=np.uint16).reshape(3, 8, 8)
    ttiff.write_tiff(tmp_path / "s.tif", arr, axes="TYX", ome=False)
    np.testing.assert_array_equal(ttiff.read_pages(tmp_path / "s.tif",
                                                   [2, 0]), arr[[2, 0]])


# ----------------------------------------------------------------------
# The entry points on files equal them on the same arrays in memory
# ----------------------------------------------------------------------

def test_chip_from_an_ome_tiff_equals_in_memory(tmp_path):
    """``microfluidic_chip`` on the 2-channel, 2-timestep chip fixture of
    tests/test_torch_chip.py written as one OME-TIFF (TCYX, channel names
    in the OME-XML): every variable equals the in-memory run."""
    from test_torch_chip import case_inputs

    img, dims, coords, kw = case_inputs("2ch2t")
    path = tmp_path / "chip.ome.tif"
    ttiff.write_tiff(path, img.transpose(1, 0, 2, 3),
                     channels=list(coords["channel"]))
    got = mt.microfluidic_chip(str(path), device="cpu", **kw)
    want = mt.microfluidic_chip(mt.DataArray(img, dims=dims, coords=coords),
                                device="cpu", **kw)
    assert_same_dataset(got, want, attrs=False)


def test_beads_from_a_store_dir_equals_in_memory(tmp_path):
    """``beads`` on the two-channel fixture of tests/test_torch_slice.py
    stored as a native directory store: every variable equals the
    in-memory run."""
    from test_torch_slice import case_inputs

    img, dims, coords, kw = case_inputs("two_channel")
    tzarr.write_store(tmp_path / "run", mt.Dataset(
        {"tile": (("channel", "tile_y", "tile_x"), img)},
        coords={"channel": (("channel",), np.array(coords["channel"]))}))
    got = mt.beads(str(tmp_path / "run"), device="cpu", **kw)
    want = mt.beads(mt.DataArray(img, dims=dims, coords=coords),
                    device="cpu", **kw)
    assert got["roi"].sizes["mark"] >= 4
    assert_same_dataset(got, want, attrs=False)
