"""The port's BaSiC solver and ``basic_correct`` against the JAX package's.

``magnify_tpu_torch.ops.basic.fit_basic(device="cpu")`` runs against the
jitted ``magnify_tpu.ops.basic.fit_basic`` on stacks of tiles drawn from
numpy seeds: per-tile background levels of 100-1000 counts (the per-image
baseline of BaSiC's model), one bead per tile, a vignette flat field, a dark
field rising from 100 to 300 counts and Gaussian noise. The solver is the
JAX package's step for step but not bit-equal (XLA fuses its reductions and
contracts multiply-adds inside the scan), so the results are held to:

* flat field: max |diff| <= 1e-4;
* dark field: max |diff| <= 1e-5 x the stack's mean;
* the corrected integer tiles: |diff| <= 1 count, at <= 0.5% of pixels;

or, for a field, within twice the reference's own spread where that is the
larger: the JAX solver's change when its working stack is multiplied by
``1 + 1e-7 * noise``, below float32 resolution. That spread must itself stay
under a fixed ceiling (1e-4 flat, 5e-5 x the mean dark), so a stack on
which the reference is chaotic fails instead of widening the bound. (On the
192 x 320 stack the dark spread is 2.9e-5 x the mean and the port is
1.4e-5 x the mean from JAX.) Every stack with the dark field fitted is one
where the fit recovers the drawn flat field (within 2%, checked here).
Where it does not (every tile at one background level, or dense content),
the JAX solver's own spread is far larger (``scripts/basic_conditioning.py``
prints both), and no float32 port can be held to it there. The antialiased resizes are checked on their own, and
``basic_correct`` on in-memory and lazy tiles against the JAX component.
The JAX functions run in this process (on the CPU); they are imported
inside the tests, so that ``tests/test_torch_cuda.py`` can import the
stacks on a machine without JAX.
"""

import numpy as np
import pytest
import torch

from magnify_tpu_torch.components import preprocess as tpre
from magnify_tpu_torch.core import Dataset as TDataset
from magnify_tpu_torch.core.lazy import ChunkedArray, from_block_function
from magnify_tpu_torch.ops import basic as tbasic
from magnify_tpu_torch.utils import filled_circle_points

torch.set_num_threads(1)

FLAT_ATOL = 1e-4
DARK_RTOL = 1e-5  # of the stack's mean
TILE_FRAC = 0.005  # of pixels that may differ, by one count
#: The most the reference's own spread may be before a stack is refused.
FLAT_SPREAD_MAX = 1e-4
DARK_SPREAD_MAX_RTOL = 5e-5  # of the stack's mean
RECOVERY = 0.02  # the fitted flat field against the drawn one


def shading_tiles(n: int, h: int, w: int, seed: int):
    """(n, h, w) uint16 tiles and the drawn flat field (h, w)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    rr = ((yy - (h - 1) / 2) / h) ** 2 + ((xx - (w - 1) / 2) / w) ** 2
    flat = 1.0 - 0.8 * rr
    dark = 100.0 + 100.0 * (yy / (h - 1) + xx / (w - 1))
    out = np.empty((n, h, w))
    for i in range(n):
        img = rng.uniform(100, 1000) + rng.normal(0, 5, (h, w))
        r = int(rng.integers(8, 12))
        y = int(rng.integers(r + 2, h - r - 2))
        x = int(rng.integers(r + 2, w - r - 2))
        p = filled_circle_points(r) + [y, x]
        img[p[:, 0], p[:, 1]] += 1500
        out[i] = img * flat + dark
    return np.clip(np.round(out), 0, 65535).astype(np.uint16), flat


def reference_spread(tiles, **kw):
    """How far the jitted JAX solver's (flat, dark) move when its working
    stack is multiplied by ``1 + 1e-7 * noise``: max |diff| of each, the
    dark field in counts."""
    import jax
    import jax.numpy as jnp
    from magnify_tpu.ops import basic as jbasic

    x = tiles.astype(np.float32)
    work = np.asarray(jax.image.resize(
        jnp.asarray(x), (x.shape[0], 128, 128), method="linear"))
    scale = float(np.maximum(x.mean(), 1e-6))
    noise = np.random.default_rng(0).standard_normal(work.shape)
    fits = []
    for stack in (work, (work * (1 + 1e-7 * noise)).astype(np.float32)):
        s, d, _b = jbasic._fit_basic_working(
            jnp.asarray(stack / scale), float(kw.get("smoothness_flatfield",
                                                     1.0)),
            float(kw.get("smoothness_darkfield", 3.0)),
            get_darkfield=kw.get("get_darkfield", True),
            max_iters=kw.get("max_iters", 40),
            reweight_iters=kw.get("reweight_iters", 8))
        fits.append((np.asarray(s), np.asarray(d) * scale))
    return (float(np.abs(fits[0][0] - fits[1][0]).max()),
            float(np.abs(fits[0][1] - fits[1][1]).max()))


def assert_within_tolerance(tiles, got, want, **kw):
    from magnify_tpu.ops import basic as jbasic

    (f_t, d_t), (f_j, d_j) = got, want
    assert f_t.dtype == d_t.dtype == np.float32
    assert f_t.shape == d_t.shape == tiles.shape[1:]
    mean = float(tiles.astype(np.float32).mean())
    flat_spread, dark_spread = reference_spread(tiles, **kw)
    assert flat_spread <= FLAT_SPREAD_MAX
    assert dark_spread <= DARK_SPREAD_MAX_RTOL * mean
    np.testing.assert_allclose(f_t, f_j, rtol=0,
                               atol=max(FLAT_ATOL, 2 * flat_spread))
    np.testing.assert_allclose(d_t, d_j, rtol=0,
                               atol=max(DARK_RTOL * mean, 2 * dark_spread))
    corr_t = np.clip(tbasic.basic_transform(tiles, f_t, d_t), 0, None)
    corr_j = np.clip(jbasic.basic_transform(tiles, f_j, d_j), 0, None)
    diff = np.abs(corr_t.astype(np.uint16).astype(np.int64)
                  - corr_j.astype(np.uint16).astype(np.int64))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= TILE_FRAC


@pytest.mark.parametrize("shape,seed", [((8, 256, 256), 0),
                                        ((8, 256, 256), 1),
                                        ((8, 192, 320), 2)])
@pytest.mark.parametrize("darkfield", [True, False])
def test_fit_basic_matches_jax(shape, seed, darkfield):
    from magnify_tpu.ops import basic as jbasic

    tiles, flat = shading_tiles(*shape, seed)
    got = tbasic.fit_basic(tiles, get_darkfield=darkfield, device="cpu")
    want = jbasic.fit_basic(tiles, get_darkfield=darkfield)
    assert_within_tolerance(tiles, got, [np.asarray(v) for v in want],
                            get_darkfield=darkfield)
    if darkfield:
        # The regime where the comparison means something: the fit finds
        # the drawn shading.
        assert_recovers(got[0], flat)
    else:
        assert not got[1].any()


def assert_recovers(fitted_flat, flat):
    rel = fitted_flat / (flat / flat.mean()) - 1
    assert np.abs(rel).max() < RECOVERY


def test_fit_basic_knobs_match_jax():
    """Every knob away from its default, with enough iterations for the
    fit to converge on the drawn shading."""
    from magnify_tpu.ops import basic as jbasic

    tiles, flat = shading_tiles(8, 256, 256, 3)
    kw = dict(smoothness_flatfield=2.0, smoothness_darkfield=1.0,
              max_iters=25, reweight_iters=5)
    got = tbasic.fit_basic(tiles, device="cpu", **kw)
    want = [np.asarray(v) for v in jbasic.fit_basic(tiles, **kw)]
    assert_within_tolerance(tiles, got, want, **kw)
    assert_recovers(got[0], flat)


@pytest.mark.parametrize("src,dst", [((2, 1000, 1000), (128, 128)),
                                     ((2, 300, 520), (128, 128)),
                                     ((1, 128, 128), (1000, 1000)),
                                     ((1, 128, 128), (300, 520))])
def test_resize_matches_jax(src, dst):
    """``jax.image.resize(method="linear")`` antialiases when it shrinks;
    the port's bilinear resize with ``antialias=True`` gives the same
    values within float32 rounding."""
    import jax
    import jax.numpy as jnp

    x = np.random.default_rng(0).uniform(0, 1000, src).astype(np.float32)
    got = tbasic._resize(torch.from_numpy(x), dst).numpy()
    want = np.asarray(jax.image.resize(jnp.asarray(x), (src[0],) + dst,
                                       method="linear"))
    np.testing.assert_allclose(got, want, rtol=0, atol=1000 * 1e-6)


def test_dct_and_schedule_match_jax():
    from magnify_tpu.ops import basic as jbasic

    np.testing.assert_array_equal(tbasic._dct_matrix(128),
                                  jbasic._dct_matrix(128))
    for total, n_rw in ((40, 8), (1, 8), (7, 3), (12, 12)):
        want = np.zeros(max(total, 1), bool)
        n = max(min(n_rw, total), 1)
        want[np.round(np.linspace(0, total - 1, n)).astype(int)] = True
        np.testing.assert_array_equal(
            tbasic._reweight_schedule(total, n_rw), want)


def _tile_stack(seed: int = 4):
    """(channel 2, time 2, tile_row 2, tile_col 4, y, x) uint16: each
    channel's eight tiles from :func:`shading_tiles` (with its own seed),
    the second timestep 20% brighter."""
    out = np.empty((2, 2, 2, 4, 192, 256), np.uint16)
    for c in range(2):
        tiles, _flat = shading_tiles(8, 192, 256, seed + c)
        out[c, 0] = tiles.reshape(2, 4, 192, 256)
        out[c, 1] = np.minimum(tiles.astype(np.float64) * 1.2,
                               65535).astype(np.uint16).reshape(2, 4, 192, 256)
    return out


DIMS = ("channel", "time", "tile_row", "tile_col", "tile_y", "tile_x")


def test_basic_correct_matches_jax():
    from magnify_tpu.components import preprocess as jpre
    from magnify_tpu.core import Dataset as JDataset

    tiles = _tile_stack()
    want = jpre.basic_correct(JDataset({"tile": (DIMS, tiles.copy())}))
    got = tpre.basic_correct(TDataset({"tile": (DIMS, tiles.copy())}),
                             device="cpu")
    g = np.asarray(got["tile"].values)
    w = np.asarray(want["tile"].values)
    assert g.dtype == w.dtype == np.uint16 and g.shape == tiles.shape
    diff = np.abs(g.astype(np.int64) - w.astype(np.int64))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= TILE_FRAC
    # It did correct: the vignette's corner-to-centre ratio of the t = 0
    # background moved toward 1.
    bg = np.median(tiles[0, 0].reshape(-1, 192, 256), axis=0)
    bg_c = np.median(g[0, 0].reshape(-1, 192, 256), axis=0)
    assert abs(bg_c[5, 5] / bg_c[96, 128] - 1) < abs(bg[5, 5] / bg[96, 128]
                                                    - 1)


def test_basic_correct_on_lazy_tiles(monkeypatch):
    """Lazy tiles: the fit reads each channel's t = 0 tiles, the correction
    is a deferred chunk map until the result is cached, and the cached
    result equals the eager one."""
    tiles = _tile_stack(6)
    eager = tpre.basic_correct(TDataset({"tile": (DIMS, tiles.copy())}),
                               device="cpu")
    reads = []

    def block(idx):
        reads.append(tuple(idx[:4]))
        c, t, r, col = idx[:4]
        return tiles[c:c + 1, t:t + 1, r:r + 1, col:col + 1]

    lazy = from_block_function(block, tiles.shape, tiles.dtype,
                               (1, 1, 1, 1, 192, 256))
    before_cache = []
    real_cache = TDataset.cache

    def cache(ds, variables=None):
        before_cache.append((sorted(set(reads)), ds["tile"].data))
        return real_cache(ds, variables)

    monkeypatch.setattr(TDataset, "cache", cache)
    out = tpre.basic_correct(TDataset({"tile": (DIMS, lazy)}), device="cpu")
    fit_reads, deferred = before_cache[0]
    assert fit_reads == sorted((c, 0, r, col) for c in range(2)
                               for r in range(2) for col in range(4))
    assert isinstance(deferred, ChunkedArray)
    np.testing.assert_array_equal(np.asarray(out["tile"].values),
                                  np.asarray(eager["tile"].values))
