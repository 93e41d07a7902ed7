"""The port's masked ROI reductions against the JAX package's.

``magnify_tpu_torch.ops.reduce`` on seeded numpy inputs against
``magnify_tpu.ops.reduce`` through both of the JAX package's routes: its
numpy twin (numpy inputs below its size threshold) and its jitted body
(``jax.Array`` inputs). The port's two routes are both held: the numpy twin
that ``device="cpu"`` takes, and the torch body that a card runs, here on
CPU tensors.

Tolerances: medians are exact on every route (each selects the same
elements of the same sorted row). Means are exact between the two numpy
twins (same code) and within ``MEAN_RTOL`` of the mean's magnitude between a
twin and a device body: an f32 sum of a few hundred terms of like sign
differs by a few ulp between numpy's pairwise order, XLA's and torch's
reduction trees. ``fg_mean_bg_median`` subtracts a median of the same size
from the mean, so its error is held absolutely, against ``MEAN_RTOL`` times
the largest pixel value.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magnify_tpu.ops import reduce as jreduce
from magnify_tpu_torch.ops import reduce as treduce


# One intra-op thread per test process: the suite runs several pytest
# workers at once, and oversubscribed torch thread pools spin for the cores
# the others need.
torch.set_num_threads(1)


def _roi_case(seed, n_marks=13, n_ch=3, side=9, empty=(2, 5)):
    """ROI stack with random masks; marks in ``empty`` have an empty fg
    mask and an empty bg mask, the others bg counts of both parities."""
    rng = np.random.default_rng(seed)
    roi = rng.normal(200, 40, (n_marks, n_ch, side, side)).astype(np.float32)
    fg = rng.random((n_marks, side, side)) < 0.3
    bg = rng.random((n_marks, side, side)) < 0.4
    for i in range(n_marks):
        flat = bg[i].reshape(-1)
        if flat.sum() % 2 != i % 2:  # even marks even counts, odd marks odd
            flat[np.flatnonzero(~flat)[0]] = True
    for i in empty:
        fg[i] = False
        bg[i] = False
    return roi, fg, bg


def _torch_body(fn, *arrays):
    return fn(*(torch.as_tensor(a) for a in arrays)).numpy()


@pytest.mark.parametrize("seed", [0, 1])
def test_fg_mean_bg_median_matches_jax(seed):
    roi, fg, bg = _roi_case(seed)
    twin = jreduce.fg_mean_bg_median(roi, fg, bg)
    jitted = jreduce.fg_mean_bg_median(jnp.asarray(roi), jnp.asarray(fg),
                                       jnp.asarray(bg))
    got = treduce.fg_mean_bg_median(roi, fg, bg, device="cpu")
    body = _torch_body(treduce._fg_mean_bg_median_torch, roi, fg, bg)

    assert got.dtype == twin.dtype and got.shape == twin.shape == (13, 3)
    np.testing.assert_array_equal(got, twin)  # the same twin: exact
    assert np.isnan(got[[2, 5]]).all() and np.isfinite(
        np.delete(got, [2, 5], axis=0)).all()
    assert body.dtype == np.float32
    np.testing.assert_array_equal(np.isnan(body), np.isnan(twin))
    atol = treduce.MEAN_RTOL * float(np.abs(roi).max())
    for other in (twin, np.asarray(jitted)):
        np.testing.assert_allclose(body, other, rtol=0, atol=atol,
                                   equal_nan=True)


@pytest.mark.parametrize("seed", [0, 1])
def test_bg_median_part_is_exact(seed):
    """With an all-False fg mask the statistic would be NaN; isolate the
    median by giving every mark one fg pixel of value 0."""
    roi, fg, bg = _roi_case(seed, empty=())
    roi[:, :, 0, 0] = 0.0
    fg[:] = False
    fg[:, 0, 0] = True
    bg[:, 0, 0] = False
    twin = jreduce.fg_mean_bg_median(roi, fg, bg)
    jitted = np.asarray(jreduce.fg_mean_bg_median(
        jnp.asarray(roi), jnp.asarray(fg), jnp.asarray(bg)))
    body = _torch_body(treduce._fg_mean_bg_median_torch, roi, fg, bg)
    np.testing.assert_array_equal(body, twin)
    np.testing.assert_array_equal(body, jitted)
    np.testing.assert_array_equal(
        treduce.fg_mean_bg_median(roi, fg, bg, device="cpu"), twin)


def _rows_case(seed, n=11, shape=(6, 7)):
    rng = np.random.default_rng(seed)
    values = rng.normal(50, 20, (n,) + shape).astype(np.float32)
    mask = rng.random((n,) + shape) < 0.45
    mask[3] = False                       # empty -> NaN
    mask[4] = False
    mask[4].reshape(-1)[:1] = True        # one element
    mask[5] = False
    mask[5].reshape(-1)[:2] = True        # two elements (even)
    mask[6] = True                        # all 42 (even)
    mask[7] = True
    mask[7].reshape(-1)[0] = False        # 41 (odd)
    return values, mask


@pytest.mark.parametrize("seed", [0, 1])
def test_masked_median_matches_jax_exactly(seed):
    values, mask = _rows_case(seed)
    twin = jreduce.masked_median(values, mask)
    jitted = np.asarray(jreduce.masked_median(jnp.asarray(values),
                                              jnp.asarray(mask)))
    got = treduce.masked_median(values, mask, device="cpu")
    body = _torch_body(treduce._masked_median_torch, values, mask)
    assert got.dtype == body.dtype == np.float32
    assert np.isnan(got[3]) and got[4] == values[4].reshape(-1)[0]
    for other in (twin, jitted, body):
        np.testing.assert_array_equal(got, other)


@pytest.mark.parametrize("seed", [0, 1])
def test_masked_mean_matches_jax(seed):
    values, mask = _rows_case(seed)
    twin = jreduce.masked_mean(values, mask)
    jitted = np.asarray(jreduce.masked_mean(jnp.asarray(values),
                                            jnp.asarray(mask)))
    got = treduce.masked_mean(values, mask, device="cpu")
    body = _torch_body(treduce._masked_mean_torch, values, mask)
    assert got.dtype == body.dtype == np.float32
    np.testing.assert_array_equal(got, twin)  # the same twin: exact
    assert np.isnan(got[3]) and np.isnan(body[3])
    for other in (twin, jitted):
        np.testing.assert_allclose(body, other, rtol=treduce.MEAN_RTOL,
                                   equal_nan=True)


def test_twins_chunk_over_rows(monkeypatch):
    """The chunked route of the numpy twins (large stores) equals the
    one-block route. (As in the JAX package, the one-block
    ``fg_mean_bg_median`` twin comes out float64, an f32 sum over an int64
    count, and the chunked one stores the same values as float32.)"""
    roi, fg, bg = _roi_case(3)
    values, mask = _rows_case(3)
    whole = (treduce.fg_mean_bg_median(roi, fg, bg, device="cpu"),
             treduce.masked_median(values, mask, device="cpu"),
             treduce.masked_mean(values, mask, device="cpu"))
    monkeypatch.setattr(treduce, "_row_chunk", lambda shape, **kw: 4)
    chunked = (treduce.fg_mean_bg_median(roi, fg, bg, device="cpu"),
               treduce.masked_median(values, mask, device="cpu"),
               treduce.masked_mean(values, mask, device="cpu"))
    for a, b in zip(whole, chunked):
        assert b.dtype == np.float32
        np.testing.assert_array_equal(a.astype(np.float32), b)


def test_missing_device_raises():
    """The device defaults to "cuda"; where there is no card the call
    raises, it does not reduce on the host."""
    roi, fg, bg = _roi_case(0)
    if torch.cuda.is_available():
        assert treduce.fg_mean_bg_median(roi, fg, bg).shape == (13, 3)
        return
    with pytest.raises((RuntimeError, AssertionError)):
        treduce.fg_mean_bg_median(roi, fg, bg)
