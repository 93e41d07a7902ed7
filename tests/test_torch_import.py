"""The PyTorch port stands apart from JAX and shares the JAX package's tables.

``import magnify_tpu_torch`` must load none of jax, magnify_tpu and pandas,
and the constant state both packages use must be equal: the Bresenham rings,
the disk-extent LUT, the float and int8 ring kernels and their scales (built
with copied numpy code instead of converted), and for the decode the parsed
spectra/codes/pinlist tables (``csv`` module against pandas on the same
text, the reference-first reordering included), the lattice fit's search
grids and its prefix sums (against jitted JAX: eager ``jnp.linspace`` and
eager arithmetic give other last bits than the jitted program).
"""

import functools
import io
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import magnify_tpu_torch as mt
from magnify_tpu_torch.components import identify as tid
from magnify_tpu import utils as jutils
from magnify_tpu.ops import geom as jgeom
from magnify_tpu.ops import score as jscore
from magnify_tpu_torch import utils as tutils
from magnify_tpu_torch.ops import geom as tgeom
from magnify_tpu_torch.ops import hysteresis as thyst
from magnify_tpu_torch.ops import score as tscore

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))


# One intra-op thread per test process: the suite runs several pytest
# workers at once, and oversubscribed torch thread pools spin for the cores
# the others need.
torch.set_num_threads(1)


def test_import_loads_neither_jax_nor_magnify_tpu():
    """Neither the package nor any of its modules (the mesh, multihost and
    plot modules included) loads jax, magnify_tpu, pandas, or the optional
    io packages (bs4, h5py, PIL, zstandard): those load only where a file
    needs them."""
    code = ("import sys, magnify_tpu_torch, chip_smoke\n"
            "import magnify_tpu_torch.components.identify\n"
            "import magnify_tpu_torch.ops.reduce\n"
            "import magnify_tpu_torch.parallel.streaming\n"
            "import magnify_tpu_torch.ops.gridfit\n"
            "import magnify_tpu_torch.components.filter\n"
            "import magnify_tpu_torch.diagnostics\n"
            "import magnify_tpu_torch.ops.prng\n"
            "import magnify_tpu_torch.ops.ransac\n"
            "import magnify_tpu_torch.native\n"
            "import magnify_tpu_torch.io.tiff\n"
            "import magnify_tpu_torch.io.reader\n"
            "import magnify_tpu_torch.io.zarrlite\n"
            "import magnify_tpu_torch.io.netcdf\n"
            "import magnify_tpu_torch.io.file\n"
            "import magnify_tpu_torch.accessor\n"
            "import magnify_tpu_torch.components.quantify\n"
            "import magnify_tpu_torch.components.preprocess\n"
            "import magnify_tpu_torch.ops.basic\n"
            "import magnify_tpu_torch.ops.detect\n"
            "import magnify_tpu_torch.core.pipeline\n"
            "import magnify_tpu_torch.parallel.mesh\n"
            "import magnify_tpu_torch.parallel.multihost\n"
            "import magnify_tpu_torch.plot\n"
            "import magnify_tpu_torch.plot.image\n"
            "import magnify_tpu_torch.plot.mrbles\n"
            "import magnify_tpu_torch.plot.style\n"
            "import magnify_tpu_torch.plot.vis\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'magnify_tpu',\n"
            "                                    'pandas', 'bs4', 'h5py',\n"
            "                                    'PIL', 'zstandard'))\n"
            "assert not bad, bad\n"
            "for name in ('mrbles', 'mrbles_pipe', 'beads_stream',\n"
            "             'mrbles_stream', 'parallel', 'microfluidic_chip',\n"
            "             'microfluidic_chip_pipe'):\n"
            "    assert name in magnify_tpu_torch.__all__, name\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def test_public_names_are_the_jax_packages():
    """``__all__`` holds every name of the JAX package's, each bound: the
    io entry points (``image``, ``image_pipe``, ``save``, ``load``,
    ``quantify``) and the ``io`` and ``accessor`` modules included."""
    import magnify_tpu as mg

    assert set(mg.__all__) <= set(mt.__all__)
    for name in mt.__all__:
        assert getattr(mt, name) is not None, name
    for name in ("image", "image_pipe", "save", "load", "quantify"):
        assert callable(getattr(mt, name)), name
    assert mt.accessor.cache is not None and mt.io.reader.Reader is not None


@pytest.mark.parametrize("four_connected", [False, True])
def test_bresenham_rings_equal(four_connected):
    for r in range(0, 40):
        np.testing.assert_array_equal(
            tutils.circle_points(r, four_connected),
            jutils.circle_points(r, four_connected))
        np.testing.assert_array_equal(tutils.filled_circle_points(r),
                                      jutils.filled_circle_points(r))


def test_extent_lut_equal():
    for max_radius in (5, 12, 25):
        np.testing.assert_array_equal(tgeom.extent_lut(max_radius),
                                      jgeom.extent_lut(max_radius))


@pytest.mark.parametrize("radii", [(5, 8), (8, 12), (5, 25)])
def test_ring_kernels_equal(radii):
    np.testing.assert_array_equal(tscore._ring_conv_kernel(*radii),
                                  jscore._ring_conv_kernel(*radii))
    tq, tsc = tscore._ring_conv_kernel_q8(*radii)
    jq, jsc = jscore._ring_conv_kernel_q8(*radii)
    np.testing.assert_array_equal(tq, jq)
    np.testing.assert_array_equal(tsc, jsc)
    assert tq.dtype == np.int8 and tsc.dtype == np.float32


def test_compact_taps_round_trip():
    """The CUDA kernel's position table at the bead frame's radii: 292
    positions holding the 2,128 nonzero weights, no position shared by two
    radii, and every radius's sum of |weights| times 127 below 2^24."""
    q, _ = tscore._ring_conv_kernel_q8(8, 12)
    table, offsets = tscore.pack_positions(q)
    assert offsets[-1] == len(table) == 292
    weights = table[:, 1:3].copy().view(np.int8)
    assert np.count_nonzero(weights) == np.count_nonzero(q) == 2128
    assert len(set(table[:, 0].tolist())) == len(table)
    assert 127 * np.abs(q.astype(np.int64)).sum(axis=(1, 2, 3)).max() < 2**24


def test_wrappers_refuse_non_cpu_non_cuda_tensors():
    """No detour to the plain twins: a tensor that is not on the CPU goes
    to the kernel or raises."""
    m = torch.zeros((8, 8), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError):
        thyst.hysteresis(m, m)
    weights = tscore.ring_weights(tscore._ring_conv_kernel_q8(2, 3)[0],
                                  "meta")
    with pytest.raises(ValueError):
        tscore.ring_corr(torch.zeros((8, 16, 16), dtype=torch.int8,
                                     device="meta"), weights)
    with pytest.raises(ValueError):
        tscore.score_circles(torch.zeros((40, 40), device="meta"),
                             torch.zeros((40, 40), dtype=torch.bool,
                                         device="meta"),
                             torch.zeros((3, 3), dtype=torch.int32,
                                         device="meta"), max_radius=8)


def test_unported_options_raise():
    """The tuning UI is ported: headless it runs each stage once with the
    defaults and returns the result without it. A path (input or flat
    field) that names no file raises as the JAX package's reader does."""
    from magnify_tpu_torch.utils import filled_circle_points

    plane = np.zeros((128, 128), np.uint16)
    pts = filled_circle_points(10)
    plane[pts[:, 0] + 60, pts[:, 1] + 64] = 1000
    img = mt.DataArray(plane, dims=("y", "x"))
    kw = dict(min_bead_diameter=16, max_bead_diameter=24, overlap=0,
              device="cpu")
    got = mt.beads(img, interactive=True, **kw)
    want = mt.beads(img, **kw)
    assert got["roi"].sizes["mark"] == 1
    for name in ("x", "y", "fg", "bg", "roi"):
        np.testing.assert_array_equal(np.asarray(got[name].values),
                                      np.asarray(want[name].values))
    with pytest.raises(FileNotFoundError):
        mt.beads("some/path/*.tif", device="cpu")
    with pytest.raises(FileNotFoundError):
        mt.beads(img, flatfield="flat.tif", device="cpu")


# ----------------------------------------------------------------------
# What the decode shares
# ----------------------------------------------------------------------

SPECTRA_TEXT = ("name,435,474,536,620\n"
                "dy,0.1,1.0,0.3,0\n"
                "eu,1.0,0.2,0.1,0.9\n"
                "\n"
                "sm,0.0,0.1,0.9,0.1\n")
CODES_TEXT = ("name,eu,sm,dy\n"
              "code_a,1,0,0\n"
              "code_b,1.0,0.0,1.5\n"
              "7,1.0,2,0\n")
PINLIST_TEXT = ("Indices,MutantID\n"
                '"(1, 1)",alpha\n'
                '"(2, 1)",BLANK\n'
                '"(2, 2)",\n')


@pytest.mark.parametrize("text", [SPECTRA_TEXT, CODES_TEXT, PINLIST_TEXT])
def test_csv_tables_equal_pandas(text):
    """Column order from the header, numeric columns as float64 values,
    text columns as str with blanks missing, blank lines skipped; a
    file-like is rewound, so a second read gives the same table."""
    handle = io.StringIO(text)
    want = pd.read_csv(io.StringIO(text))
    for _ in range(2):
        got = tid._read_csv(handle)
        assert list(got) == list(want.columns)
        for col in want.columns:
            w = want[col]
            if pd.api.types.is_numeric_dtype(w):
                assert got[col].dtype == np.float64
                np.testing.assert_array_equal(
                    got[col], w.to_numpy(dtype=np.float64))
            else:
                assert got[col].dtype == object
                assert [None if v is None else str(v) for v in got[col]] == [
                    None if pd.isna(v) else str(v) for v in w]


def test_csv_reads_paths(tmp_path):
    path = tmp_path / "spectra.csv"
    path.write_text(SPECTRA_TEXT)
    got, want = tid._read_csv(str(path)), tid._read_csv(io.StringIO(SPECTRA_TEXT))
    assert list(got) == list(want)
    for col in want:
        np.testing.assert_array_equal(got[col], want[col])
    with pytest.raises(ValueError, match="empty"):
        tid._read_csv(io.StringIO(""))


@pytest.mark.parametrize("reference", ["eu", "dy", "sm"])
def test_reference_first_reordering_equals_pandas_reindex(reference):
    """The spectra matrix and lanthanide order after the reference-first
    reordering, against the JAX package's pandas recipe."""
    channels = ["435", "620"]
    df = pd.read_csv(io.StringIO(SPECTRA_TEXT))
    ref_idx = df[df["name"] == reference].index[0]
    df = df.reindex([ref_idx] + [i for i in range(len(df)) if i != ref_idx])
    table = tid._read_csv(io.StringIO(SPECTRA_TEXT))
    names = tid._name_column(table, "spectra")
    order = tid._reference_first(names, reference)
    assert [str(names[i]) for i in order] == df["name"].to_list()
    got = np.stack([table[c][order] for c in channels], axis=1)
    np.testing.assert_array_equal(got, df[channels].to_numpy())
    with pytest.raises(ValueError, match="Reference lanthanide 'tb'"):
        tid._reference_first(names, "tb")


def test_codes_names_and_sets_equal_pandas():
    df = pd.read_csv(io.StringIO(CODES_TEXT))
    table = tid._read_csv(io.StringIO(CODES_TEXT))
    names = tid._name_column(table, "codes")
    assert names.dtype == object
    assert list(names) == [str(v) for v in df["name"]] == [
        "code_a", "code_b", "7"]
    assert set(table) - {"name"} == set(df.columns) - {"name"}
    assert np.append(names, "outlier").dtype == object


@functools.partial(jax.jit, static_argnames=("n_grid",))
def _jax_grids(lo, hi, codes, n_grid=100):
    """The grid expressions of the JAX package's ``search``, jitted."""
    code_span = jnp.maximum(codes[-1] - codes[0], 1e-30)
    scale = (hi - lo) / code_span
    return (jnp.linspace(0.75 * scale, 1.25 * scale, n_grid),
            jnp.linspace(lo, 0.25 * hi + 0.75 * lo, n_grid))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_search_grids_match_jitted_linspace(seed):
    rng = np.random.default_rng(seed)
    codes = (np.arange(3) * rng.uniform(0.8, 2.5)).astype(np.float32)
    lo, hi = np.sort(rng.normal(1, 2, 2)).astype(np.float32)
    want_a, want_p = _jax_grids(lo, hi, jnp.asarray(codes))
    got_a, got_p = tid._search_grids(
        lo, hi, np.maximum(codes[-1] - codes[0], np.float32(1e-30)), 100)
    assert got_a.dtype == got_p.dtype == np.float32
    np.testing.assert_array_equal(got_a, np.asarray(want_a))
    np.testing.assert_array_equal(got_p, np.asarray(want_p))


def test_prefix_sums_match_jitted_cumsum():
    rng = np.random.default_rng(0)
    for n in (1, 7, 16, 17, 200, 513, 4100):
        x = np.sort(rng.normal(1, 1, n)).astype(np.float32)
        np.testing.assert_array_equal(
            tid._prefix_sums(x), np.asarray(jax.jit(jnp.cumsum)(x)))
