"""The port's RANSAC detector, module by module, against the JAX package's
jitted functions on the CPU.

* ``ops/geom.perimeter_tables``: array-equal;
* ``ops/edge.atan2_f32`` and the gradient angles of ``edge_pipeline``:
  bit-equal to XLA's CPU ``atan2`` (the C library's ``atan2f``, not
  correctly rounded);
* ``ops/ransac.candidate_circles``: the three f32 vectors and ``any_edges``
  bit-equal, on a random mask, an all-zero mask, a mask with one edge
  pixel and a batch of crops with one key each;
* ``ops/score.dedupe_circles``: the uniques and their count exactly equal,
  with NaN, +-inf and +-1e20 coordinates and radii among the proposals,
  for one plane and for a capped batch;
* ``ops/score.score_circles``: bit-equal, the port fed the unpadded angles
  and edges and the JAX package their padded copies, on the frame's
  proposals at perimeters of 24 (the 8-lane sum), 68 and 88 positions (the
  32-wide windowed sum), and on random planes at every sum form (1, 8, 12,
  16, 24, 32 and 68 positions), with circles past the padded plane and
  batches of planes;
* ``ops/detect.detect_ransac`` and ``detect_best_in_rois(detector=
  "ransac")``: circles and scores bit-equal to ``find_circles``/
  ``detect_best_in_rois`` with the gather scorer.
"""

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from magnify_tpu_torch.ops import detect as tdetect  # noqa: E402
from magnify_tpu_torch.ops import edge as tedge  # noqa: E402
from magnify_tpu_torch.ops import geom as tgeom  # noqa: E402
from magnify_tpu_torch.ops import prng  # noqa: E402
from magnify_tpu_torch.ops import ransac as transac  # noqa: E402
from magnify_tpu_torch.ops import score as tscore  # noqa: E402
from magnify_tpu_torch.utils import filled_circle_points  # noqa: E402


# One intra-op thread per test process: the suite runs several pytest
# workers at once, and oversubscribed torch thread pools spin for the cores
# the others need.
torch.set_num_threads(1)


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def _frame(h=96, w=112, seed=0):
    """uint16 noise with four drawn disks of radius 8-11."""
    rng = np.random.default_rng(seed)
    img = rng.normal(100, 5, (h, w)).astype(np.uint16)
    for (y, x), r in zip([(25, 25), (30, 80), (70, 40), (75, 95)],
                         [8, 9, 10, 11]):
        pts = filled_circle_points(r) + np.array([y, x])
        ok = ((pts >= 0) & (pts < (h, w))).all(axis=1)
        img[pts[ok, 0], pts[ok, 1]] = 1000
    return img


@pytest.fixture(scope="module")
def jax_edges():
    """The jitted JAX edge stack of :func:`_frame`: edges, angles."""
    from magnify_tpu.ops.edge import edge_pipeline

    edges, _dx, _dy, angles = jax.jit(edge_pipeline)(
        jnp.asarray(_frame()), 0.5, 0.9)
    return np.asarray(edges), np.asarray(angles)


@pytest.mark.parametrize("max_radius", (5, 12, 16))
def test_perimeter_tables_match(max_radius):
    from magnify_tpu.ops.geom import perimeter_tables

    for got, want in zip(tgeom.perimeter_tables(max_radius),
                         perimeter_tables(max_radius)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_atan2_matches_xla():
    """Integer gradients (the Scharr range), the axes, x = 1, and fractions,
    against the jitted ``jnp.arctan2``."""
    rng = np.random.default_rng(1)
    y = np.round(rng.normal(0, 600, 400_000)).astype(np.float32)
    x = np.round(rng.normal(0, 600, 400_000)).astype(np.float32)
    y[:200] = 0
    x[200:400] = 0
    x[400:600] = 1
    y[600:800] = rng.normal(0, 3, 200)
    want = jax.jit(jnp.arctan2)(y, x)
    got = tedge.atan2_f32(torch.from_numpy(y), torch.from_numpy(x))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # Not correctly rounded: the reference needs this algorithm.
    exact = np.arctan2(y.astype(np.float64), x.astype(np.float64))
    assert (_bits(exact) != _bits(want)).mean() > 0.05


def test_edge_pipeline_angles_match(jax_edges):
    edges, angles = jax_edges
    got = tedge.edge_pipeline(torch.from_numpy(_frame().astype(np.float32)),
                              0.5, 0.9, normalized=False, angles=True)
    np.testing.assert_array_equal(got[0].numpy(), edges)
    np.testing.assert_array_equal(_bits(got[3]), _bits(angles))


def _mask(case):
    rng = np.random.default_rng(2)
    if case == "random":
        return rng.random((101, 57)) < 0.08
    mask = np.zeros((40, 44), bool)
    if case == "one pixel":
        mask[17, 23] = True
    return mask


@pytest.mark.parametrize("case", ("random", "empty", "one pixel"))
def test_candidate_circles_match(case):
    from magnify_tpu.ops.ransac import candidate_circles

    mask = _mask(case)
    want, want_any = candidate_circles(jnp.asarray(mask), grid_length=20,
                                       num_iter=5000,
                                       key=jax.random.PRNGKey(3))
    got, got_any = transac.candidate_circles(torch.from_numpy(mask), 20, 5000,
                                             prng.prng_key(3))
    assert bool(got_any) == bool(want_any) == (case != "empty")
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(_bits(g), _bits(w))


def test_candidate_circles_batch_matches_vmap():
    from magnify_tpu.ops.ransac import candidate_circles

    masks = np.random.default_rng(4).random((5, 48, 48)) < 0.1
    masks[2] = False
    keys = jax.random.split(jax.random.PRNGKey(0), 5)
    want, want_any = jax.vmap(lambda m, k: candidate_circles(
        m, grid_length=20, num_iter=3000, key=k))(jnp.asarray(masks), keys)
    got, got_any = transac.candidate_circles(
        torch.from_numpy(masks), 20, 3000, prng.split(prng.prng_key(0), 5))
    np.testing.assert_array_equal(got_any.numpy(), np.asarray(want_any))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g), _bits(w))


def test_candidate_fmas_are_needed(monkeypatch):
    """With plain two-rounding arithmetic in place of the two FMAs the
    proposals miss XLA's on some rows: the contraction is part of the
    reference."""
    from magnify_tpu.ops.ransac import candidate_circles

    mask = _mask("random")
    want, _ = candidate_circles(jnp.asarray(mask), grid_length=20,
                                num_iter=5000, key=jax.random.PRNGKey(3))
    monkeypatch.setattr(transac, "fma_f32", lambda a, b, c: a * b + c)
    got, _ = transac.candidate_circles(torch.from_numpy(mask), 20, 5000,
                                       prng.prng_key(3))
    assert any((_bits(g) != _bits(w)).any() for g, w in zip(got, want))


def _proposals(m=6000, seed=5):
    rng = np.random.default_rng(seed)
    rows = rng.uniform(-30, 90, m).astype(np.float32)
    cols = rng.uniform(-30, 100, m).astype(np.float32)
    rads = rng.uniform(0, 16, m).astype(np.float32)
    special = np.array([np.nan, np.inf, -np.inf, 1e20, -1e20, 2.5, 3.5, 0.5,
                        -0.5], np.float32)
    rows[:9] = special
    cols[9:18] = special
    rads[18:27] = special
    rows[27:36] = cols[27:36] = rads[27:36] = np.nan
    return rows, cols, rads, rng.random(m) < 0.9


@pytest.mark.parametrize("min_radius", (0, 4))
def test_dedupe_matches(min_radius):
    """min_radius 0 keeps the all-NaN proposals: XLA casts NaN to 0."""
    from magnify_tpu.ops.score import dedupe_circles

    rows, cols, rads, valid = _proposals()
    kw = dict(height=60, width=70, min_radius=min_radius, max_radius=12)
    want, _v, n = dedupe_circles(
        (jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(rads)),
        jnp.asarray(valid), cap=rows.size, **kw)
    got, got_n = tscore.dedupe_circles(
        tuple(torch.from_numpy(a) for a in (rows, cols, rads)),
        torch.from_numpy(valid), **kw)
    assert got_n == int(n) > 100
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want)[:int(n)])
    if min_radius == 0:
        assert (got.numpy() == 0).all(axis=1).any()


def test_dedupe_batch_keeps_the_first_cap_uniques():
    from magnify_tpu.ops.score import dedupe_circles

    rows, cols, rads, valid = (a.reshape(5, -1) for a in _proposals())
    kw = dict(height=60, width=70, min_radius=4, max_radius=12)
    cap = 300
    got, got_valid, got_n = tscore.dedupe_circles(
        tuple(torch.from_numpy(a) for a in (rows, cols, rads)),
        torch.from_numpy(valid), cap=cap, **kw)
    assert (got_n.numpy() > 0).all()
    for b in range(5):
        want, want_valid, n = dedupe_circles(
            (jnp.asarray(rows[b]), jnp.asarray(cols[b]),
             jnp.asarray(rads[b])), jnp.asarray(valid[b]), cap=cap, **kw)
        k = min(int(n), cap)
        assert int(got_n[b]) == int(n)
        np.testing.assert_array_equal(got_valid[b].numpy(),
                                      np.asarray(want_valid))
        np.testing.assert_array_equal(got[b, :k].numpy(),
                                      np.asarray(want)[:k])


@pytest.mark.parametrize("radii", ((3, 4), (8, 12), (10, 15)))
def test_score_circles_match(jax_edges, radii):
    """Scores of every unique proposal of the frame (and of invalid rows):
    the port scores the unpadded angles and edges, the JAX package their
    padded copies; bit-equal."""
    from magnify_tpu.ops.ransac import candidate_circles
    from magnify_tpu.ops.score import dedupe_circles, score_circles

    edges, angles = jax_edges
    min_r, max_r = radii
    h, w = edges.shape
    cands, any_edges = candidate_circles(jnp.asarray(edges), grid_length=20,
                                         num_iter=20000,
                                         key=jax.random.PRNGKey(0))
    uniq, uvalid, _n = dedupe_circles(
        cands, jnp.full((20000,), True) & any_edges, height=h, width=w,
        min_radius=min_r, max_radius=max_r, cap=8192)
    pad = 2 * max_r
    ga = jnp.pad(jnp.asarray(angles), pad)
    eg = jnp.pad(jnp.asarray(edges), pad)
    shifted = uniq.at[:, :2].add(pad)
    want = score_circles(ga, eg, shifted, uvalid, max_radius=max_r)
    got = tscore.score_circles(
        torch.from_numpy(np.array(angles)), torch.from_numpy(np.array(edges)),
        torch.from_numpy(np.array(shifted)),
        torch.from_numpy(np.array(uvalid)), max_radius=max_r, pad=pad)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert np.isfinite(np.asarray(want)).sum() > 300


def _random_scorer_inputs(seed, planes, h, w, n, max_radius, pad):
    """Random angles and edges, and circles whose perimeters reach up to 3
    pixels past the padded plane on every side, with radii from -1 to
    ``max_radius + 1`` (outside the table: clipped) and 10% invalid."""
    rng = np.random.default_rng(seed)
    hp, wp = h + 2 * pad, w + 2 * pad
    angles = rng.uniform(-np.pi, np.pi, (planes, h, w)).astype(np.float32)
    edges = rng.random((planes, h, w)) < 0.5
    circles = np.stack([rng.integers(-3, hp + 3, (planes, n)),
                        rng.integers(-3, wp + 3, (planes, n)),
                        rng.integers(-1, max_radius + 2, (planes, n))],
                       axis=-1).astype(np.int32)
    valid = rng.random((planes, n)) < 0.9
    return angles, edges, circles, valid


@pytest.mark.parametrize("max_radius,pad,planes", [
    (0, 0, 1), (1, 2, 1), (2, 4, 1), (3, 6, 1), (4, 8, 1), (5, 10, 1),
    (4, 1, 1), (2, 4, 3), (12, 24, 2)])
def test_score_circles_unpadded_planes_match(max_radius, pad, planes):
    """Perimeters of 1, 8, 12, 16, 24, 32 and 68 positions (every sum form
    of XLA's CPU program, -0.0 included at 1), circles past the padded
    plane (the flat index clamped, a column past the edge wrapping into the
    next row: into image pixels where the pad is 1), radii outside the
    table, and batches: the port on unpadded planes and ``pad``, the JAX
    package on their ``jnp.pad`` copies, plane by plane; bit-equal."""
    from magnify_tpu.ops.score import score_circles

    h, w = 34, 29
    angles, edges, circles, valid = _random_scorer_inputs(
        max_radius, planes, h, w, 1500, max_radius, pad)
    want = np.stack([np.asarray(score_circles(
        jnp.pad(jnp.asarray(angles[b]), pad),
        jnp.pad(jnp.asarray(edges[b]), pad), jnp.asarray(circles[b]),
        jnp.asarray(valid[b]), max_radius=max_radius))
        for b in range(planes)])
    args = [torch.from_numpy(a) for a in (angles, edges, circles, valid)]
    if planes == 1:
        args = [a[0] for a in args]
        want = want[0]
    got = tscore.score_circles(*args, max_radius=max_radius, pad=pad)
    assert got.shape == want.shape
    np.testing.assert_array_equal(_bits(got), _bits(want))
    if max_radius == 0:
        assert (_bits(want) == np.int32(-2**31)).sum() > 100


@pytest.mark.parametrize("normalized", (True, False))
def test_detect_ransac_matches_find_circles(normalized):
    """The bead path hands u8 planes (normalized again by the JAX package,
    an identity); the chip's grid search hands raw planes."""
    from magnify_tpu.ops import detect as jdetect

    img = _frame()
    if normalized:
        img = tdetect.normalize_planes_u8(img[None])[0]
    want = jdetect.find_circles(img, 0.5, 0.9, 20, 20000, 8, 12, 0.3, 8,
                                detector="ransac")
    circles, scores, n_unique = tdetect.detect_ransac(
        torch.from_numpy(img.astype(np.float32)), 0.5, 0.9, 0.3,
        grid_length=20, num_iter=20000, min_radius=8, max_radius=12,
        min_dist=8, key=prng.prng_key(0), normalized=normalized)
    assert len(circles) == len(want[0]) == 4 and n_unique > 300
    np.testing.assert_array_equal(circles.numpy(), want[0])
    np.testing.assert_array_equal(_bits(scores), _bits(want[1]))


@pytest.mark.parametrize("num_iter", (300, 4000))
def test_detect_best_in_rois_ransac_matches(num_iter):
    """Five 48^2 crops, one of them constant (no edges: not found); with
    300 proposals per crop the hill-climb has work to do."""
    from magnify_tpu.ops import detect as jdetect

    img = _frame()
    rois = np.stack([img[y - 24:y + 24, x - 24:x + 24]
                     for y, x in [(25, 25), (30, 80), (70, 40), (72, 88)]]
                    + [np.full((48, 48), 7, np.uint16)])
    want = jdetect.detect_best_in_rois(rois, 0.5, 0.95, 20, num_iter, 5, 12,
                                       0.2, detector="ransac")
    got = tdetect.detect_best_in_rois(rois, 0.5, 0.95, 5, 12, 0.2,
                                      device="cpu", detector="ransac",
                                      num_iter=num_iter)
    np.testing.assert_array_equal(got[2], want[2])
    assert got[2][:4].all() and not got[2][4]
    np.testing.assert_array_equal(got[0][got[2]], want[0][want[2]])
    np.testing.assert_array_equal(_bits(got[1]), _bits(want[1]))


def test_reference_scorer_is_gather_on_cpu():
    """The JAX references above run the exact perimeter scorer: the CPU
    default, unless the environment forces the conv scorer."""
    from magnify_tpu.ops.detect import _use_conv_scorer

    assert os.environ.get("MAGNIFY_TPU_SCORER", "auto") != "conv"
    assert not _use_conv_scorer()
