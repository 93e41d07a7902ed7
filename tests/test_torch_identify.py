"""The port's MRBLE decoder against the JAX package's.

Module by module on seeded numpy inputs, ``device="cpu"``:

* the lattice fit ``_fit_affine_1d`` against the JITTED JAX function: the
  returned (scale, offset) are bit-equal on every fixture, in both search
  windows. The port reproduces what XLA compiles the jitted program to
  (blocked prefix sums, reciprocal constants, contracted FMAs); the grids
  and prefix sums alone are held in test_torch_import;
* the EM ``_gmm_em`` against the jitted JAX function: the ``ok`` latch and
  ``had_probs`` equal, the argmax of the posteriors equal, the posteriors
  within ``EM_ATOL`` (the two LU factorizations and logsumexp differ in the
  last f32 bits and 50 iterations carry that along; measured 3.6e-7 to
  3.2e-6 on these fixtures);
* ``identify_mrbles`` against the JAX component on the synthetic assays of
  ``tests/test_identify.py``: tags, ``ln_vol`` and ``ln_ratio`` exactly
  equal, dtypes included;
* ``identify_buttons`` (pinlist and shape forms).
"""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import magnify_tpu_torch as mt
from magnify_tpu.components import identify as jid
from magnify_tpu_torch.components import identify as tid
from tests import test_identify as ref

EM_ATOL = 1e-5


# ----------------------------------------------------------------------
# Lattice fit
# ----------------------------------------------------------------------

# One intra-op thread per test process: the suite runs several pytest
# workers at once, and oversubscribed torch thread pools spin for the cores
# the others need.
torch.set_num_threads(1)


def lattice_points(seed, n, levels, outliers=0, rare_top=False):
    """Sorted 1-D points scattered around an affine image of a code
    lattice, the lattice's levels and how many codes use each level."""
    rng = np.random.default_rng(seed)
    codes = np.arange(levels) * rng.uniform(0.8, 2.5)
    counts = rng.integers(2, 8, levels).astype(np.float64)
    weights = counts / counts.sum()
    if rare_top:  # the top level holds ~3% of the points
        weights = np.append(weights[:-1] * 0.97 / weights[:-1].sum(), 0.03)
    pts = (rng.choice(codes, n, p=weights) * rng.uniform(0.8, 1.2)
           + rng.uniform(-0.3, 0.3) + rng.normal(0, 0.05, n))
    if outliers:
        pts[:outliers] = pts.max() * rng.uniform(1.5, 3, outliers)
    return (np.sort(pts).astype(np.float32), codes.astype(np.float32),
            counts.astype(np.float32))


# (seed, points, levels, outliers, rare top level, window expected to win)
FIT_CASES = [
    (0, 200, 3, 0, False, None),
    (1, 200, 3, 0, False, None),
    (2, 200, 3, 2, False, "quantile"),
    (3, 200, 3, 4, False, "quantile"),
    (4, 200, 4, 0, True, "minmax"),
    (5, 91, 2, 0, False, None),
    (6, 2000, 4, 0, False, None),
    (7, 17, 2, 0, False, None),
]


@pytest.mark.parametrize("seed,n,levels,outliers,rare,window", FIT_CASES)
def test_fit_affine_1d_matches_jitted_jax(seed, n, levels, outliers, rare,
                                          window):
    pts, codes, counts = lattice_points(seed, n, levels, outliers, rare)
    want_a, want_p = jid._fit_affine_1d(
        jnp.asarray(pts), jnp.asarray(codes), jnp.asarray(counts))
    got_a, got_p = tid._fit_affine_1d(pts, codes, counts, device="cpu")
    assert np.float32(want_a) == got_a and np.float32(want_p) == got_p
    if window is not None:
        # The fit came from the window the fixture was built for.
        span = np.maximum(codes[-1] - codes[0], np.float32(1e-30))
        mm, _ = tid._search_grids(pts[0], pts[-1], span, 100)
        q, _ = tid._search_grids(pts[(n - 1) * 5 // 100],
                                 pts[-(-(n - 1) * 95 // 100)], span, 100)
        assert (got_a in q, got_a in mm) == (window == "quantile",
                                             window == "minmax")


# ----------------------------------------------------------------------
# EM
# ----------------------------------------------------------------------

def em_case(seed, n=180, k=4, d=2, spread=0.25):
    """Overlapping clusters (posteriors strictly between 0 and 1) and a few
    far points for the outlier component."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0, 3, (k, d))
    X = centers[rng.integers(0, k, n)] + rng.normal(0, spread, (n, d))
    X[:6] = rng.uniform(-6, 9, (6, d))
    means = centers + rng.normal(0, 0.05, (k, d))
    covs = np.tile(np.eye(d) * spread ** 2, (k, 1, 1))
    props = np.append(np.full(k, n / k + 1), 1e-10)
    props /= props.sum()
    span = float(np.log(X.max(0) - X.min(0)).sum())
    return [a.astype(np.float32) for a in (X, means, covs, props)] + [span]


def run_em_both(X, means, covs, props, span):
    want = [np.asarray(v) for v in jid._gmm_em(
        jnp.asarray(X), jnp.asarray(means), jnp.asarray(covs),
        jnp.asarray(props), span)]
    got = [v.numpy() for v in tid._gmm_em(
        torch.as_tensor(X), torch.as_tensor(means), torch.as_tensor(covs),
        torch.as_tensor(props), span)]
    return want, got


@pytest.mark.parametrize("seed,d", [(0, 2), (1, 2), (2, 3)])
def test_gmm_em_matches_jitted_jax(seed, d):
    want, got = run_em_both(*em_case(seed, d=d))
    assert bool(want[1]) and bool(got[1]) and bool(want[2]) and bool(got[2])
    assert got[0].dtype == np.float32 and got[0].shape == want[0].shape
    soft = ((want[0] > 0.02) & (want[0] < 0.98)).any(axis=1).sum()
    assert soft >= 5  # the fixture does exercise soft assignments
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=EM_ATOL)
    np.testing.assert_array_equal(got[0].argmax(1), want[0].argmax(1))


def test_gmm_em_singular_start_has_no_posteriors():
    """det == 0 at iteration 0: the latch trips at once, the posteriors
    stay all zero and ``had_probs`` is False (the caller then falls back
    to the nearest code)."""
    X, means, covs, props, span = em_case(3)
    covs[:] = 0.0
    want, got = run_em_both(X, means, covs, props, span)
    for res in (want, got):
        assert not bool(res[1]) and not bool(res[2])
        assert not res[0].any()


def test_gmm_em_latch_keeps_last_good_posteriors():
    """A component no point belongs to gets weight 0 and NaN moments after
    the first update; the second iteration trips the latch and the first
    iteration's posteriors are kept."""
    X, means, covs, props, span = em_case(4)
    means[-1] = 1e4
    want, got = run_em_both(X, means, covs, props, span)
    for res in (want, got):
        assert not bool(res[1]) and bool(res[2])
        assert np.isfinite(res[0]).all()
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=EM_ATOL)
    np.testing.assert_array_equal(got[0].argmax(1), want[0].argmax(1))


def test_median_all_averages_the_two_middles():
    x = np.array([[4.0, 1.0], [3.0, 10.0]], np.float32)
    assert float(tid._median_all(torch.as_tensor(x))) == float(jnp.median(x))
    assert float(tid._median_all(torch.as_tensor(x))) == 3.5
    x[0, 0] = np.nan
    assert np.isnan(float(tid._median_all(torch.as_tensor(x))))
    assert np.isnan(float(jnp.median(x)))


# ----------------------------------------------------------------------
# identify_mrbles
# ----------------------------------------------------------------------

def as_port(ds):
    """A JAX-package Dataset of the synthetic assays as the port's."""
    return mt.Dataset(
        {"roi": (ds.roi.dims, ds.roi.values)},
        coords={"channel": list(ds.channel.values),
                "fg": (ds.fg.dims, ds.fg.values),
                "bg": (ds.bg.dims, ds.bg.values)})


def extreme_outlier_assay():
    ds, truth = ref.synthetic_bead_assay(n_per_code=24, seed=2)
    roi = ds.roi.values.copy()
    rng = np.random.default_rng(0)
    for i in rng.choice(len(truth), 4, replace=False):
        vols = np.array([1.0, rng.uniform(40, 120), rng.uniform(-60, 60)])
        roi[i, :, 0, 3:6, 3:6] = (vols @ ref.SPECTRA)[:, None, None]
    ds["roi"] = (("mark", "channel", "time", "roi_y", "roi_x"), roi)
    return ds


def correlated_assay():
    ds, _ = ref.synthetic_bead_assay(n_per_code=30, seed=3)
    roi = ds.roi.values.copy()
    rng = np.random.default_rng(1)
    i = 0
    for dy_r, sm_r in ref.CODES.values():
        for _ in range(30):
            eu = rng.uniform(90, 110)
            c = rng.normal(0, 6.0)
            e = rng.normal(0, 0.2, 2)
            vols = np.array([eu, dy_r * eu + c + e[0], sm_r * eu + c + e[1]])
            roi[i, :, 0, 3:6, 3:6] = (vols @ ref.SPECTRA)[:, None, None]
            i += 1
    ds["roi"] = (("mark", "channel", "time", "roi_y", "roi_x"), roi)
    return ds


RARE_CODES = {f"code_{d}{s}{t}": (1.5 * d, 2.0 * s, 2.5 * t)
              for d in range(2) for s in range(3) for t in range(2)}
RARE_CODES["code_rare"] = (4.5, 0.0, 0.0)


def rare_codes_csv():
    rows = ["name,eu,dy,sm,tm"]
    rows += [f"{n},1.0,{d},{s},{t}" for n, (d, s, t) in RARE_CODES.items()]
    return io.StringIO("\n".join(rows))


ASSAYS = {
    "4_codes": (lambda: ref.synthetic_bead_assay()[0], ref.spectra_csv,
                ref.codes_csv),
    "24_codes": (lambda: ref.synthetic_bead_assay_24()[0], ref.spectra4_csv,
                 ref.codes24_csv),
    "extreme_outliers": (extreme_outlier_assay, ref.spectra_csv,
                         ref.codes_csv),
    "correlated_clusters": (correlated_assay, ref.spectra_csv,
                            ref.codes_csv),
    "rare_level": (lambda: ref.synthetic_bead_assay_24(
        n_per_code=8, seed=9, codes=RARE_CODES)[0], ref.spectra4_csv,
        rare_codes_csv),
}


@pytest.mark.parametrize("name", list(ASSAYS))
def test_identify_mrbles_matches_jax(name):
    make, spectra, codes = ASSAYS[name]
    ds = make()
    want = jid.identify_mrbles(ds, spectra=spectra(), codes=codes(),
                               reference="eu")
    got = tid.identify_mrbles(as_port(ds), spectra=spectra(), codes=codes(),
                              reference="eu", device="cpu")
    assert sorted(got.variables) == sorted(want.variables)
    for var in ("tag", "ln", "ln_vol", "ln_ratio"):
        g, w = np.asarray(got[var].values), np.asarray(want[var].values)
        assert got[var].dims == want[var].dims, var
        assert g.dtype == w.dtype, (var, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=var)
    assert (got.tag.values != "outlier").mean() > 0.8
    assert set(tid.last_decode_timings) == {
        "intensities_lstsq", "knn_trim", "lattice_fit", "gmm_em"}


def test_identify_mrbles_spilled_store_reduces_on_host(tmp_path):
    """A memmap-backed ROI store takes the host twin whatever the device:
    with a device that does not exist, only the lattice fit would raise,
    so give it the CPU and compare with the in-memory decode."""
    ds, _ = ref.synthetic_bead_assay(n_per_code=8, seed=5)
    roi = ds.roi.values
    mm = np.memmap(tmp_path / "roi.dat", dtype=roi.dtype, mode="w+",
                   shape=roi.shape)
    mm[:] = roi
    port = as_port(ds)
    spilled = mt.Dataset(
        {"roi": (ds.roi.dims, mm)},
        coords={"channel": list(ds.channel.values),
                "fg": (ds.fg.dims, ds.fg.values),
                "bg": (ds.bg.dims, ds.bg.values)})
    a = tid.identify_mrbles(port, spectra=ref.spectra_csv(),
                            codes=ref.codes_csv(), device="cpu")
    b = tid.identify_mrbles(spilled, spectra=ref.spectra_csv(),
                            codes=ref.codes_csv(), device="cpu")
    np.testing.assert_array_equal(a.tag.values, b.tag.values)
    np.testing.assert_array_equal(a.ln_vol.values, b.ln_vol.values)


def test_identify_mrbles_errors_match_jax():
    ds, _ = ref.synthetic_bead_assay(n_per_code=4)
    port = as_port(ds)
    for fn, data, kw in ((jid.identify_mrbles, ds, {}),
                         (tid.identify_mrbles, port, {"device": "cpu"})):
        with pytest.raises(ValueError, match="Reference lanthanide 'tb' not "
                                             "found in spectra file"):
            fn(data, spectra=ref.spectra_csv(), codes=ref.codes_csv(),
               reference="tb", **kw)
        bad_codes = io.StringIO("name,eu,dy\ncode_a,1.0,0.0\n")
        with pytest.raises(ValueError, match="do not match lanthanide"):
            fn(data, spectra=ref.spectra_csv(), codes=bad_codes, **kw)


def test_identify_mrbles_defaults_to_the_card():
    ds, _ = ref.synthetic_bead_assay(n_per_code=4)
    if torch.cuda.is_available():
        out = tid.identify_mrbles(as_port(ds), spectra=ref.spectra_csv(),
                                  codes=ref.codes_csv())
        assert out.tag.shape == (16,)
        return
    with pytest.raises((RuntimeError, AssertionError)):
        tid.identify_mrbles(as_port(ds), spectra=ref.spectra_csv(),
                            codes=ref.codes_csv())


def test_empty_field_schema_matches_jax():
    def empty(pkg):
        return pkg.Dataset(
            {"roi": (("mark", "channel", "time", "roi_y", "roi_x"),
                     np.zeros((0, 4, 1, 9, 9), np.float32))},
            coords={"channel": ref.CHANNELS,
                    "fg": (("mark", "time", "roi_y", "roi_x"),
                           np.zeros((0, 1, 9, 9), bool)),
                    "bg": (("mark", "time", "roi_y", "roi_x"),
                           np.zeros((0, 1, 9, 9), bool))})

    import magnify_tpu as mg

    want = jid.identify_mrbles(empty(mg), spectra=ref.spectra_csv(),
                               codes=ref.codes_csv())
    got = tid.identify_mrbles(empty(mt), spectra=ref.spectra_csv(),
                              codes=ref.codes_csv(), device="cpu")
    for var in ("tag", "ln", "ln_vol", "ln_ratio"):
        g, w = np.asarray(got[var].values), np.asarray(want[var].values)
        assert g.shape == w.shape and g.dtype == w.dtype, var
    assert got.tag.shape == (0,) and got.ln_ratio.shape == (0, 3)


# ----------------------------------------------------------------------
# identify_buttons
# ----------------------------------------------------------------------

PINLIST = ("Indices,MutantID\n"
           '"(1, 1)",alpha\n'
           '"(2, 1)",BLANK\n'
           '"(1, 2)",beta\n'
           '"(2, 2)",\n'
           '"(3, 2)",7\n')


def button_assay(pkg):
    return pkg.Dataset({"image": (("channel", "time", "im_y", "im_x"),
                                  np.zeros((1, 2, 8, 8)))})


def test_identify_buttons_pinlist_matches_jax():
    import magnify_tpu as mg

    handle = io.StringIO(PINLIST)
    want = jid.identify_buttons(button_assay(mg), pinlist=io.StringIO(PINLIST))
    got = tid.identify_buttons(button_assay(mt), pinlist=handle)
    again = tid.identify_buttons(button_assay(mt), pinlist=handle)  # rewound
    np.testing.assert_array_equal(got.tag.values, want.tag.values)
    np.testing.assert_array_equal(again.tag.values, want.tag.values)
    assert got.tag.dims == want.tag.dims
    assert got.tag.values[0, 1] == "" and got.tag.values[1, 1] == ""
    assert got.valid.shape == want.valid.shape == (2, 3, 2)


def test_identify_buttons_shape_and_missing_layout():
    out = tid.identify_buttons(button_assay(mt), shape=(2, 3))
    assert out.tag.shape == (2, 3) and (out.tag.values == "default").all()
    assert out.tag.values.dtype == np.dtype("<U200")
    assert out.valid.shape == (2, 3, 2) and out.valid.values.all()
    with pytest.raises(ValueError, match="pinlist or shape"):
        tid.identify_buttons(button_assay(mt))
