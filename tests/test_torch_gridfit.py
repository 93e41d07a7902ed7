"""The chip path's geometry in the port against the JAX package's:
``ops/gridfit.py`` (1-D cluster sweep, fixed labelling, per-cluster
regression), ``ops/geom.py`` (``extract_rois``, ``rotate_plane``) and the
host quantizations of the search planes.

The fixtures are those of tests/test_gridfit.py (random scatters from numpy
seeds), plus 1 x N and N x 1 grids, empty clusters and no points at all.
Tolerances: cluster labels exact; regression slopes within ``SLOPE_ATOL``
and intercepts within ``INTERCEPT_ATOL`` pixels of the jitted JAX functions
(both f32; the sums reduce in another order in torch than in XLA) and of the
f64 host twins at their looser bounds; ``extract_rois`` and the
quantizations exact; ``rotate_plane`` within ``ROT_RTOL`` of the plane's
maximum (sin/cos come from another library).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magnify_tpu.components.find import (cluster_1d, label_clusters,
                                         regress_clusters)
from magnify_tpu.ops import detect as jdetect
from magnify_tpu.ops import geom as jgeom
from magnify_tpu.ops import gridfit as jgrid
from magnify_tpu_torch.ops import detect as tdetect
from magnify_tpu_torch.ops import geom as tgeom
from magnify_tpu_torch.ops import gridfit as tgrid

SLOPE_ATOL = 1e-6      # slopes are ~1e-2, sums of ~10 f32 terms
INTERCEPT_ATOL = 1e-4  # pixels
ROT_RTOL = 1e-4


# One intra-op thread per test process: the suite runs several pytest
# workers at once, and oversubscribed torch thread pools spin for the cores
# the others need.
torch.set_num_threads(1)


def _t(a, dtype=None):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _scatter(seed):
    rng = np.random.default_rng(seed)
    n_clusters = int(rng.integers(2, 10))
    length = float(rng.choice([60, 80, 100, 68.18]))
    total = int(n_clusters * length + rng.integers(40, 400))
    truth = np.arange(n_clusters) * length + rng.uniform(5, 30)
    pts = np.concatenate(
        [truth + rng.normal(0, 2, n_clusters) for _ in range(5)])
    pts = np.clip(np.concatenate([pts, rng.uniform(0, total, 4)]), 0,
                  total - 1)
    return np.round(pts), n_clusters, length, total


@pytest.mark.parametrize("seed", range(5))
def test_cluster_1d_matches_jax_and_host(seed):
    pts, c, length, total = _scatter(seed)
    ideal = np.full(c, 5.0, np.float32)
    kw = dict(total_length=total, num_clusters=c, cluster_length=length,
              penalty=10.0)
    got = tgrid.cluster_1d_dev(_t(pts, torch.float32),
                               torch.ones(len(pts), dtype=torch.bool),
                               ideal_num_points=ideal, **kw)
    assert got.dtype == torch.int32
    want = jgrid.cluster_1d_dev(jnp.asarray(pts, jnp.float32),
                                jnp.ones(len(pts), bool),
                                ideal_num_points=jnp.asarray(ideal), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), cluster_1d(pts, ideal_num_points=ideal, **kw))
    assert tgrid.num_offsets(total, c, length) == jgrid.num_offsets(
        total, c, length)


def test_cluster_1d_sweep_does_not_depend_on_chunking(monkeypatch):
    pts, c, length, total = _scatter(1)
    args = (_t(pts, torch.float32), torch.ones(len(pts), dtype=torch.bool))
    kw = dict(total_length=total, num_clusters=c, cluster_length=length,
              ideal_num_points=np.full(c, 5.0), penalty=10.0)
    whole = tgrid.cluster_1d_dev(*args, **kw)
    monkeypatch.setattr(tgrid, "_SWEEP_BYTES", 12 * c * len(pts) * 7)
    assert torch.equal(tgrid.cluster_1d_dev(*args, **kw), whole)


def test_cluster_1d_invalid_and_empty_points():
    pts, c, length, total = _scatter(2)
    valid = np.arange(len(pts)) % 3 != 0
    kw = dict(total_length=total, num_clusters=c, cluster_length=length,
              ideal_num_points=np.full(c, 3.0, np.float32), penalty=10.0)
    got = tgrid.cluster_1d_dev(_t(pts, torch.float32), _t(valid), **kw)
    want = jgrid.cluster_1d_dev(jnp.asarray(pts, jnp.float32),
                                jnp.asarray(valid), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy()[~valid] == -1).all()
    none = tgrid.cluster_1d_dev(torch.zeros(0), torch.zeros(0, dtype=bool),
                                **kw)
    assert none.shape == (0,)


@pytest.mark.parametrize("seed", range(3))
def test_label_clusters_matches_jax_and_host(seed):
    rng = np.random.default_rng(seed)
    pts = np.round(rng.uniform(0, 800, 40))
    kw = dict(offset=37.0, num_clusters=6, cluster_length=50.0,
              cluster_gap=70.0)
    got = tgrid.label_clusters_dev(_t(pts, torch.float32),
                                   torch.ones(40, dtype=torch.bool), **kw)
    want = jgrid.label_clusters_dev(jnp.asarray(pts, jnp.float32),
                                    jnp.ones(40, bool), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), label_clusters(pts, **kw))


def _clusters(seed, n_clusters=None, sizes=None):
    rng = np.random.default_rng(100 + seed)
    n_clusters = n_clusters or int(rng.integers(2, 9))
    slope_true = rng.uniform(-0.02, 0.02)
    xs, ys, labels = [], [], []
    for c in range(n_clusters):
        m = int(rng.integers(0, 7)) if sizes is None else sizes[c]
        x = rng.uniform(0, 900, m)
        xs.append(x)
        ys.append(c * 100.0 + 50 + slope_true * x + rng.normal(0, 1, m))
        labels.append(np.full(m, c))
    ideal = rng.integers(0, 7, n_clusters).astype(np.float32)
    return (np.concatenate(xs), np.concatenate(ys),
            np.concatenate(labels).astype(np.int32), ideal, n_clusters)


def _regress_both(xs, ys, labels, ideal, c):
    got = tgrid.regress_clusters_dev(
        _t(xs, torch.float32), _t(ys, torch.float32), _t(labels),
        num_clusters=c, ideal_num_points=ideal)
    want = jgrid.regress_clusters_dev(
        jnp.asarray(xs, jnp.float32), jnp.asarray(ys, jnp.float32),
        jnp.asarray(labels), num_clusters=c,
        ideal_num_points=jnp.asarray(ideal))
    return ([np.asarray(g.numpy(), np.float64) for g in got],
            [np.asarray(w, np.float64) for w in want])


@pytest.mark.parametrize("seed", range(5))
def test_regress_clusters_matches_jax_and_host(seed):
    xs, ys, labels, ideal, c = _clusters(seed)
    # A few outliers (label -1) that must not count.
    xs = np.append(xs, [10.0, 500.0])
    ys = np.append(ys, [-400.0, 9000.0])
    labels = np.append(labels, [-1, -1]).astype(np.int32)
    got, want = _regress_both(xs, ys, labels, ideal, c)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=SLOPE_ATOL,
                               equal_nan=True)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=INTERCEPT_ATOL,
                               equal_nan=True)
    np.testing.assert_array_equal(got[2], want[2])
    live = labels >= 0
    h_slope, h_int = regress_clusters(xs[live], ys[live], labels=labels[live],
                                      num_clusters=c, ideal_num_points=ideal)
    if np.isnan(h_slope):
        assert np.isnan(got[0])
    else:
        assert abs(got[0] - h_slope) < 1e-4
    h_int = np.asarray(h_int, float)
    np.testing.assert_array_equal(np.isnan(h_int), np.isnan(got[1]))
    ok = ~np.isnan(h_int)
    np.testing.assert_allclose(got[1][ok], h_int[ok], rtol=0, atol=1e-2)


@pytest.mark.parametrize("sizes", [(1, 1, 1), (1,), (4,), (0, 3, 0, 2),
                                   (0, 0), (2, 2)])
def test_regress_clusters_degenerate_grids(sizes):
    """N x 1 and 1 x N grids (one point per cluster: no slope, taken as 0;
    a single cluster with one or several points), empty clusters between
    observed ones, and no points at all (NaN everywhere)."""
    xs, ys, labels, ideal, c = _clusters(7, n_clusters=len(sizes),
                                         sizes=sizes)
    ideal = np.maximum(ideal, 1.0)
    got, want = _regress_both(xs, ys, labels, ideal, c)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=SLOPE_ATOL,
                               equal_nan=True)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=INTERCEPT_ATOL,
                               equal_nan=True)
    np.testing.assert_array_equal(got[2], want[2])
    if max(sizes) <= 1 and sum(sizes) > 0:
        assert got[0] == 0.0


def test_nanmedian_averages_the_two_middles():
    for vals in ([3.0, np.nan, 1.0, 2.0, 10.0], [np.nan, np.nan], [5.0],
                 [1.0, 2.0], [np.nan, 4.0, -2.0]):
        v = np.asarray(vals, np.float32)
        got = tgrid._nanmedian_small(_t(v)).numpy()
        want = np.asarray(jax.jit(jgrid._nanmedian_small)(jnp.asarray(v)))
        np.testing.assert_array_equal(got, want)
    assert float(tgrid._nanmedian_small(_t([1.0, 2.0, 3.0, 10.0]))) == 2.5


def test_extract_rois_is_the_exact_gather():
    rng = np.random.default_rng(0)
    image = rng.integers(0, 60000, (3, 90, 110)).astype(np.uint16)
    tops = np.array([0, 5, 42, 90 - 24, 17], np.int32)
    lefts = np.array([110 - 24, 0, 33, 8, 60], np.int32)
    want = jgeom.extract_rois(jnp.asarray(image), jnp.asarray(tops),
                              jnp.asarray(lefts), 24)
    got = tgeom.extract_rois(_t(image.astype(np.int32)), _t(tops), _t(lefts),
                             24)
    assert got.shape == (5, 3, 24, 24)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    one = tgeom.extract_rois(_t(image[0].astype(np.float32)), _t(tops),
                             _t(lefts), 24)
    np.testing.assert_array_equal(one.numpy(), got[:, 0].numpy())
    u8 = tgeom.extract_rois(_t(image.astype(np.uint8)), _t(tops), _t(lefts),
                            24)
    assert u8.dtype == torch.uint8


@pytest.mark.parametrize("degrees", [0.0, 3.0, -17.5, 90.0])
def test_rotate_plane_matches_jax(degrees):
    rng = np.random.default_rng(1)
    plane = rng.uniform(0, 4000, (37, 52)).astype(np.float32)
    want = np.asarray(jgeom.rotate_plane(jnp.asarray(plane), degrees))
    got = tgeom.rotate_plane(_t(plane), degrees)
    assert got.dtype == torch.float32 and got.shape == plane.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=ROT_RTOL * float(plane.max()))
    if degrees == 0.0:
        np.testing.assert_array_equal(got.numpy(), plane)


def test_upload_precision_and_u16_quantization(monkeypatch):
    rng = np.random.default_rng(5)
    plain = rng.normal(1000, 200, (2, 300, 300)).astype(np.float32)
    speck = plain.copy()
    speck[1, 7, 9] = 65000.0  # one saturated pixel compresses the range
    flat = np.full((1, 64, 64), 9, np.uint16)
    monkeypatch.delenv("MAGNIFY_TPU_UPLOAD_PRECISION", raising=False)
    for planes in (plain, speck, flat, plain.astype(np.uint16)):
        assert (tdetect.choose_upload_precision(planes)
                == jdetect.choose_upload_precision(planes))
        np.testing.assert_array_equal(tdetect.normalize_planes_u16(planes),
                                      jdetect.normalize_planes_u16(planes))
    assert tdetect.choose_upload_precision(plain) == "u8"
    assert tdetect.choose_upload_precision(speck) == "u16"
    assert tdetect.normalize_planes_u16(plain).dtype == np.uint16
    monkeypatch.setenv("MAGNIFY_TPU_UPLOAD_PRECISION", "u16")
    assert tdetect.choose_upload_precision(plain) == "u16"
    monkeypatch.setenv("MAGNIFY_TPU_UPLOAD_PRECISION", "u8")
    assert tdetect.choose_upload_precision(speck) == "u8"
    monkeypatch.setenv("MAGNIFY_TPU_UPLOAD_PRECISION", "u12")
    with pytest.raises(ValueError, match="MAGNIFY_TPU_UPLOAD_PRECISION"):
        tdetect.choose_upload_precision(plain)
