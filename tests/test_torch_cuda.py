"""The port's CUDA kernels and its entry points on the card (marker
``cuda``).

Each kernel against its plain twin, bit for bit, at small shapes that
stress the tiling (tile borders, ragged edges, chains across many tiles;
the uint8 normalization also off 16-byte alignment);
``beads``, ``mrbles`` and ``microfluidic_chip`` with ``device="cuda"``
against ``device="cpu"`` on the end-to-end fixtures of test_torch_slice and
test_torch_chip, with the dense and the RANSAC detector; the RANSAC stages
(threefry streams, proposals, dedupe, the perimeter scorer) against the CPU;
the decode's device stages
(masked reductions, lattice fit, EM, ``identify_mrbles``) against the CPU;
the frame streams against the single-frame calls; the RANSAC conv scorer,
the BaSiC fit and ``find_circles``/``find_circles_stack`` against the
CPU; the bead ownership masks against the host's numpy pass. Without a
CUDA device
every test skips. On a machine with one (and no JAX), run:

    MAGNIFY_TPU_TEST_BACKEND=gpu python -m pytest tests/test_torch_cuda.py -m cuda
"""

import io
import os
import sys

import numpy as np
import pytest
import torch

from magnify_tpu_torch.components import identify as tid
from magnify_tpu_torch.ops import detect as tdetect
from magnify_tpu_torch.ops import edge as tedge
from magnify_tpu_torch.ops import geom as tgeom
from magnify_tpu_torch.ops import hysteresis as thyst
from magnify_tpu_torch.ops import reduce as treduce
from magnify_tpu_torch.ops import score as tscore

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


def _masks(seed, shape, p_strong=0.01, p_weak=0.35):
    rng = np.random.default_rng(seed)
    strong = rng.random(shape) < p_strong
    weak = strong | (rng.random(shape) < p_weak)
    return strong, weak


@pytest.mark.parametrize("shape,tile_rows", [((100, 150), 8),
                                             ((100, 150), 16),
                                             ((100, 150), 48),
                                             ((1000, 777), None),
                                             ((3, 5), None)])
def test_hysteresis_kernel_matches_plain(cuda, shape, tile_rows):
    s, w = (torch.as_tensor(a).to(cuda) for a in _masks(1, shape))
    before = thyst.launches
    got = thyst.hysteresis(s, w, tile_rows=tile_rows)
    assert thyst.launches > before
    assert torch.equal(got, thyst.hysteresis_plain(s, w))


def _serpentine():
    chain = np.zeros((96, 300), bool)
    for k, r in enumerate(range(4, 92, 4)):
        chain[r, 4:296] = True
        if r + 4 < 92:
            chain[r:r + 5, 295 if k % 2 == 0 else 4] = True
    strong = np.zeros_like(chain)
    strong[4, 4] = True
    return strong, chain


def test_hysteresis_kernel_serpentine(cuda):
    s, w = (torch.as_tensor(a).to(cuda) for a in _serpentine())
    got = thyst.hysteresis(s, w, tile_rows=8)
    assert torch.equal(got, thyst.hysteresis_plain(s, w))
    assert int(got.sum()) == int(w.sum())


@pytest.mark.parametrize("shape", [(1, 1), (3, 5), (1000, 777), (1844, 1844)])
def test_hysteresis_kernel_strong_outside_weak(cuda, shape):
    rng = np.random.default_rng(5)
    strong = rng.random(shape) < 0.02
    weak = rng.random(shape) < 0.4
    strong.flat[0], weak.flat[0] = True, False
    s, w = torch.as_tensor(strong).to(cuda), torch.as_tensor(weak).to(cuda)
    got = thyst.hysteresis(s, w)
    assert torch.equal(got, thyst.hysteresis_plain(s, w))


def test_hysteresis_launches_fixed_by_shape(cuda):
    """An empty mask takes as many launches as a chain across every tile."""
    strong, chain = _serpentine()
    counts = []
    for s, w in ((np.zeros_like(chain), np.zeros_like(chain)),
                 (strong, chain)):
        before = thyst.launches
        thyst.hysteresis(torch.as_tensor(s).to(cuda),
                         torch.as_tensor(w).to(cuda), tile_rows=8)
        counts.append(thyst.launches - before)
    assert counts == [thyst.LAUNCHES_PER_CALL] * 2


@pytest.mark.parametrize("radii,shape", [((5, 8), (70, 93)),
                                         ((8, 12), (130, 97)),
                                         ((2, 3), (33, 32)),
                                         ((8, 12), (20, 50)),
                                         ((8, 12), (9, 300)),
                                         ((5, 8), (200, 13)),
                                         ((5, 25), (64, 200)),
                                         ((8, 12), (1892, 1892))])
def test_ring_corr_kernel_matches_plain(cuda, radii, shape):
    rng = np.random.default_rng(3)
    feats = torch.as_tensor(
        rng.integers(-127, 128, (8,) + shape).astype(np.int8)).to(cuda)
    weights = tscore.ring_weights(tscore._ring_conv_kernel_q8(*radii)[0],
                                  cuda)
    before = tscore.launches
    got = tscore.ring_corr(feats, weights)
    assert tscore.launches == before + 1
    assert torch.equal(got, tscore.ring_corr_plain(feats, weights))


@pytest.mark.parametrize("shape,tile_rows", [((7, 40, 17), None),
                                             ((64, 72, 72), None),
                                             ((5, 33, 130), 8),
                                             ((3, 100, 150), 48),
                                             ((9, 5, 300), None),
                                             ((1, 64, 64), None)])
def test_hysteresis_kernel_batch_matches_plain(cuda, shape, tile_rows):
    """A batch of planes in the launches of one plane, each plane grown on
    its own: widths below the 128-column tile and no multiple of 4, heights
    below the tile's rows."""
    s, w = (torch.as_tensor(a).to(cuda) for a in _masks(2, shape))
    before = thyst.launches
    got = thyst.hysteresis(s, w, tile_rows=tile_rows)
    assert thyst.launches == before + thyst.LAUNCHES_PER_CALL
    assert torch.equal(got, thyst.hysteresis_plain(s, w))
    for k in (0, shape[0] - 1):
        assert torch.equal(got[k], thyst.hysteresis(s[k], w[k]))


def test_hysteresis_kernel_batch_keeps_planes_apart(cuda):
    """Plane k ends in a strong row and plane k + 1 starts in a weak row:
    consecutive in memory, they must not join."""
    strong = np.zeros((4, 24, 72), bool)
    weak = np.zeros_like(strong)
    strong[0::2, -1, :] = True
    weak[0::2, -1, :] = True
    weak[1::2, 0:3, :] = True
    s, w = torch.as_tensor(strong).to(cuda), torch.as_tensor(weak).to(cuda)
    got = thyst.hysteresis(s, w)
    assert torch.equal(got, thyst.hysteresis_plain(s, w))
    assert not bool(got[1::2].any()) and bool(got[0::2, -1].all())


@pytest.mark.parametrize("radii,shape", [((4, 15), (64, 8, 132, 132)),
                                         ((4, 15), (3, 8, 131, 133)),
                                         ((8, 16), (9, 8, 136, 136)),
                                         ((5, 10), (7, 8, 80, 61)),
                                         ((2, 3), (1, 8, 33, 32))])
def test_ring_corr_kernel_batch_matches_plain(cuda, radii, shape):
    rng = np.random.default_rng(4)
    feats = torch.as_tensor(
        rng.integers(-127, 128, shape).astype(np.int8)).to(cuda)
    weights = tscore.ring_weights(tscore._ring_conv_kernel_q8(*radii)[0],
                                  cuda)
    before = tscore.launches
    got = tscore.ring_corr(feats, weights)
    assert tscore.launches == before + 1
    assert torch.equal(got, tscore.ring_corr_plain(feats, weights))
    assert torch.equal(got[-1], tscore.ring_corr(feats[-1], weights))


def _score_inputs(seed, planes, h, w, n, max_radius, pad, ordered=False,
                  prefix=False):
    """Random angles and edges, ``n`` circles per plane reaching 3 pixels
    past the padded plane with radii -1 .. max_radius + 1 (``ordered``:
    sorted by (row, col, radius) as the dedupe emits them), and valid flags:
    10% invalid at random, or (``prefix``) a valid prefix of random length
    per plane, the first plane's empty."""
    rng = np.random.default_rng(seed)
    angles = rng.uniform(-np.pi, np.pi, (planes, h, w)).astype(np.float32)
    edges = rng.random((planes, h, w)) < 0.3
    circles = np.stack([rng.integers(-3, h + 2 * pad + 3, (planes, n)),
                        rng.integers(-3, w + 2 * pad + 3, (planes, n)),
                        rng.integers(-1, max_radius + 2, (planes, n))],
                       axis=-1).astype(np.int32)
    if ordered:
        for b in range(planes):
            order = np.lexsort(circles[b].T[::-1])
            circles[b] = circles[b][order]
    if prefix:
        n_valid = rng.integers(0, n + 1, planes)
        n_valid[0] = 0
        valid = np.arange(n)[None, :] < n_valid[:, None]
    else:
        valid = rng.random((planes, n)) < 0.9
    return angles, edges, circles, valid


@pytest.mark.parametrize(
    "max_radius,planes,h,w,n,ordered,prefix", [
        # Every sum form (L = 1, 8, 12, 24, 68, 88, 92), and a sparse
        # 2000 x 2100 plane.
        (0, 1, 120, 150, 2000, False, False),
        (1, 1, 120, 150, 2000, False, False),
        (2, 1, 120, 150, 2000, False, False),
        (4, 1, 120, 150, 2000, False, False),
        (12, 1, 120, 150, 2000, False, False),
        (15, 1, 120, 150, 2000, False, False),
        (16, 1, 120, 150, 2000, False, False),
        (15, 1, 2000, 2100, 200000, True, False),
        # Dense planes of odd widths, the circles sorted (as the dedupe
        # emits them) or not.
        (12, 1, 150, 171, 30000, True, False),
        (12, 1, 150, 171, 30000, False, False),
        (0, 1, 40, 45, 20000, True, False),
        (2, 1, 57, 131, 20000, True, False),
        (16, 1, 90, 201, 40000, True, False),
        # A radius whose table (81 x 456 entries, 295 KB) is larger than a
        # block's shared memory.
        (80, 1, 300, 317, 3000, True, False),
        # Batches of planes with valid prefixes and an all-invalid plane;
        # and the hill-climb's few circles per plane.
        (15, 7, 72, 72, 4096, True, True),
        (16, 5, 72, 72, 4096, False, False),
        (4, 3, 33, 47, 3000, False, True),
        (1, 5, 20, 21, 1000, False, True),
        (16, 64, 72, 72, 27, False, False),
        (2, 9, 35, 37, 60, False, True),
    ])
def test_perimeter_score_kernel_matches_plain(cuda, max_radius, planes, h, w,
                                              n, ordered, prefix):
    """Bit for bit against the twin (on the CPU and on the card), in the
    plan the shapes give and in the other: one lane a circle, or the lanes
    that spread its positions; one launch per call."""
    pad = 2 * max_radius
    angles, edges, circles, valid = _score_inputs(
        max_radius * 100 + planes, planes, h, w, n, max_radius, pad,
        ordered, prefix)
    args = [torch.as_tensor(a) for a in (angles, edges, circles, valid)]
    if planes == 1:
        args = [a[0] for a in args]
    kw = dict(max_radius=max_radius, pad=pad)
    want = tscore.score_circles_plain(*args, **kw)
    on_card = [a.to(cuda) for a in args]
    n_pos = tscore._perimeter_tensors(max_radius, "cpu")[0].shape[1]
    spread = tscore.spread_lanes(n_pos)
    for plan in (None, 1, spread):
        before = tscore.perimeter_launches
        if plan is None:
            got = tscore.score_circles(*on_card, **kw)
        else:
            got = tscore.perimeter_score(*on_card, **kw, plan=plan)
        assert tscore.perimeter_launches == before + 1
        np.testing.assert_array_equal(got.cpu().numpy().view(np.int32),
                                      want.numpy().view(np.int32),
                                      err_msg=f"plan {plan}")
    # The twin is the same on the card.
    assert torch.equal(tscore.score_circles_plain(*on_card, **kw).cpu(),
                       want)


def test_perimeter_plan_follows_the_circles(cuda):
    """One lane a circle where a call has circles for 32 warps a SM, else
    the lanes of the sum's partial sums."""
    full = tscore._sm_count(cuda) * 32 * 32
    for n, max_radius, want in ((27, 12, 2), (full - 1, 12, 2),
                                (full, 12, 1), (5, 4, 8), (5, 2, 1),
                                (5, 80, 8)):
        circles = torch.zeros((n, 3), dtype=torch.int32, device=cuda)
        assert tscore.perimeter_plan(circles, max_radius=max_radius) == want
    circles = torch.zeros((64, 27, 3), dtype=torch.int32, device=cuda)
    assert tscore.perimeter_plan(circles, max_radius=15) == 2


def test_ransac_stages_on_the_card_equal_the_cpu(cuda):
    """Threefry streams, gradient angles, proposals and uniques: the same
    bits on the card as on the CPU."""
    from magnify_tpu_torch.ops import edge as tedge
    from magnify_tpu_torch.ops import prng
    from magnify_tpu_torch.ops import ransac as transac

    key = prng.prng_key(7)
    for fn in (lambda k: prng.randint(k, 4097, 0, 2**20 + 3),
               lambda k: prng.uniform(k, 4097).view(torch.int32),
               lambda k: prng.split(k, 1568)):
        assert torch.equal(fn(key.to(cuda)).cpu(), fn(key))
    rng = np.random.default_rng(3)
    y = torch.as_tensor(np.round(rng.normal(0, 600, 10**5)), dtype=torch.float32)
    x = torch.as_tensor(np.round(rng.normal(0, 600, 10**5)), dtype=torch.float32)
    assert torch.equal(tedge.atan2_f32(y.to(cuda), x.to(cuda)).cpu(),
                       tedge.atan2_f32(y, x))
    masks = torch.as_tensor(rng.random((5, 64, 80)) < 0.05)
    keys = prng.split(key, 5)
    want, want_any = transac.candidate_circles(masks, 20, 20000, keys)
    got, got_any = transac.candidate_circles(masks.to(cuda), 20, 20000,
                                             keys.to(cuda))
    assert torch.equal(got_any.cpu(), want_any)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu().view(torch.int32), w.view(torch.int32))
    kw = dict(height=64, width=80, min_radius=4, max_radius=12)
    u_want = tscore.dedupe_circles(want, want_any[:, None], cap=4096, **kw)
    u_got = tscore.dedupe_circles(got, got_any[:, None], cap=4096, **kw)
    for g, w in zip(u_got, u_want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("offset", [0, 1, 3])
@pytest.mark.parametrize("case", ["constant", "extremes", "exact_integers",
                                  "random", "random_dim", "width_1",
                                  "width_7", "width_8", "width_6755",
                                  "two_planes_two_ranges", "large"])
def test_normalize_u8_kernel_matches_plain(cuda, case, offset):
    """The kernel against the host's planes and the plain twin on the card,
    each input placed ``offset`` pixels past a 16-byte boundary (a view)."""
    from test_torch_normalize import plane

    raw = (np.random.default_rng(4).normal(100, 5, (2, 517, 6755))
           .clip(0).astype(np.uint16) if case == "large" else plane(case))
    buf = torch.empty(offset + raw.size, dtype=torch.uint16, device=cuda)
    buf[offset:] = torch.from_numpy(raw.reshape(-1)).to(cuda)
    view = buf[offset:].view(raw.shape)
    before = tedge.normalize_u8_launches
    got = tedge.normalize_u8(view)
    assert (tedge.normalize_u8_launches - before
            == tedge.NORMALIZE_U8_LAUNCHES_PER_CALL)
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  tdetect.normalize_planes_u8(raw))
    assert torch.equal(got, tedge.normalize_to_u8(view).to(torch.uint8))


def test_wrappers_check_types(cuda):
    with pytest.raises(TypeError):
        tedge.normalize_u8(torch.zeros((8, 8), device=cuda))
    with pytest.raises(ValueError):
        tedge.normalize_u8(torch.zeros((8, 8), dtype=torch.uint16,
                                       device=cuda)[:, ::2])
    with pytest.raises(TypeError):
        thyst.hysteresis(torch.zeros((8, 8), device=cuda),
                         torch.zeros((8, 8), device=cuda))
    weights = tscore.ring_weights(tscore._ring_conv_kernel_q8(2, 3)[0], cuda)
    with pytest.raises(TypeError):
        tscore.ring_corr(torch.zeros((8, 16, 16), device=cuda), weights)
    with pytest.raises(TypeError):
        tscore.perimeter_score(torch.zeros((40, 40), device=cuda),
                               torch.zeros((40, 40), device=cuda),
                               torch.zeros((3, 3), dtype=torch.int32,
                                           device=cuda), max_radius=8)


def _ownership_case(case):
    """(marks, h, w, roi_length, max_radius) of a kernel case."""
    from test_torch_ownership import cell_marks, cluster_marks

    if case == "cell":  # the bead cell's 1,764 marks on 3,688^2
        return cell_marks(), 3688, 3688, 60, 15
    if case == "overflow":  # 600 marks meet every window: the list flushes
        return cluster_marks(3, 600, 100, 120, (0, 15)), 256, 256, 20, 15
    if case == "chunks":  # L^2 = 9,409: three passes of 4,096 pixels
        return cluster_marks(4, 60, 0, 400, (0, 30)), 400, 450, 97, 25
    if case == "odd_length":  # L^2 odd: byte stores
        return cluster_marks(5, 40, 0, 256, (3, 12)), 256, 256, 33, 9
    return np.zeros((0, 3)), 256, 256, 60, 15  # "n0"


@pytest.mark.parametrize("case", ["cell", "overflow", "chunks", "odd_length",
                                  "n0"])
def test_bead_ownership_kernel_matches_host(cuda, case):
    """The kernel against the wrapper's CPU branch, the host's numpy masks
    (held to the JAX package's in test_torch_ownership); one launch a
    call, none for no marks."""
    from magnify_tpu_torch.components import find

    marks, h, w, L, max_radius = _ownership_case(case)
    marks = np.asarray(marks, np.int32).reshape(-1, 3)
    tops, lefts = find._bead_windows(marks, h, w, L)
    args = [torch.from_numpy(np.ascontiguousarray(a, np.int32))
            for a in (marks, tops, lefts)]
    want = tgeom.bead_ownership(*args, L, max_radius)
    before = tgeom.bead_ownership_launches
    got = tgeom.bead_ownership(*(a.to(cuda) for a in args), L, max_radius)
    torch.cuda.synchronize()
    assert tgeom.bead_ownership_launches - before == int(len(marks) > 0)
    assert got.dtype == torch.uint8 and got.shape == want.shape
    assert torch.equal(got.cpu(), want)


def test_bead_finder_makes_its_masks_on_the_card(cuda, monkeypatch):
    """A CUDA finder counts every mark in ``ownership_device_windows``, none
    on the host, launches the kernel once and gives the CPU's masks."""
    import magnify_tpu_torch as mt
    from magnify_tpu_torch import diagnostics
    from test_torch_normalize import _bead_frame

    data = mt.DataArray(_bead_frame(), dims=("channel", "y", "x"),
                        coords={"channel": ["a", "b"]})
    kw = dict(min_bead_diameter=10, max_bead_diameter=14, overlap=0)
    monkeypatch.setenv("MAGNIFY_TPU_TRACE", "1")
    diagnostics.reset_stages()
    before = tgeom.bead_ownership_launches
    got = mt.beads(data, device=cuda, **kw)
    counters = diagnostics.counter_report()
    diagnostics.reset_stages()
    assert tgeom.bead_ownership_launches - before == 1
    assert counters["ownership_device_windows"] == got.sizes["mark"] == 3
    assert "ownership_host_windows" not in counters
    want = mt.beads(data, device="cpu", **kw)
    for name in ("x", "y", "fg", "bg", "roi"):
        np.testing.assert_array_equal(np.asarray(got[name].values),
                                      np.asarray(want[name].values), name)


@pytest.mark.parametrize("case", ["single", "two_channel", "tiled"])
def test_beads_cuda_matches_cpu(cuda, case):
    import magnify_tpu_torch as mt
    from test_torch_slice import flatten, run_case

    got = flatten(run_case(mt, case, device="cuda"), case)
    want = flatten(run_case(mt, case, device="cpu"), case)
    assert sorted(got) == sorted(want)
    for key, val in want.items():
        np.testing.assert_array_equal(got[key], val, err_msg=key)


@pytest.mark.parametrize("case", ["single", "two_channel", "tiled",
                                  "mrbles"])
def test_ransac_cuda_matches_cpu(cuda, case):
    """``detector="ransac"``: the card launches hysteresis and the
    perimeter scorer and gives the CPU's result, every variable (the
    MRBLE decode's f32 sums as in the dense case)."""
    import magnify_tpu_torch as mt
    from test_torch_slice import RANSAC_ITER, flatten, run_case

    before = thyst.launches, tscore.perimeter_launches
    got = flatten(run_case(mt, case, device="cuda", detector="ransac",
                           num_iter=RANSAC_ITER), case)
    assert thyst.launches > before[0]
    assert tscore.perimeter_launches > before[1]
    want = flatten(run_case(mt, case, device="cpu", detector="ransac",
                            num_iter=RANSAC_ITER), case)
    assert sorted(got) == sorted(want)
    for key, val in want.items():
        if key in ("mrbles/ln_vol", "mrbles/ln_ratio"):
            np.testing.assert_allclose(got[key], val, rtol=1e-4, atol=1e-3,
                                       err_msg=key)
        else:
            np.testing.assert_array_equal(got[key], val, err_msg=key)


@pytest.mark.parametrize("case", ["2x2", "3x3_blanks", "3x5"])
def test_ransac_chip_cuda_matches_cpu(cuda, case):
    """The RANSAC grid search: one whole-plane detection and one batched
    ROI detection (its proposals and the hill-climb: two scorer launches)
    per search channel; every variable equal to the CPU's."""
    import magnify_tpu_torch as mt
    from test_torch_chip import RANSAC_ITER, run_case
    from test_torch_slice import flatten

    before = thyst.launches, tscore.perimeter_launches
    got = flatten(run_case(mt, case, device="cuda", detector="ransac",
                           num_iter=RANSAC_ITER), case)
    assert thyst.launches - before[0] == 2 * thyst.LAUNCHES_PER_CALL
    assert tscore.perimeter_launches - before[1] == 3
    want = flatten(run_case(mt, case, device="cpu", detector="ransac",
                            num_iter=RANSAC_ITER), case)
    assert sorted(got) == sorted(want)
    for key, val in want.items():
        np.testing.assert_array_equal(got[key], val, err_msg=key)


def test_mrbles_cuda_matches_cpu(cuda):
    import magnify_tpu_torch as mt
    from test_torch_slice import flatten, run_case

    got = flatten(run_case(mt, "mrbles", device="cuda"), "mrbles")
    want = flatten(run_case(mt, "mrbles", device="cpu"), "mrbles")
    assert sorted(got) == sorted(want)
    for key, val in want.items():
        if key in ("mrbles/ln_vol", "mrbles/ln_ratio"):
            # f32 sums of the fg pixels in another order on the card.
            np.testing.assert_allclose(got[key], val, rtol=1e-4, atol=1e-3,
                                       err_msg=key)
        else:
            np.testing.assert_array_equal(got[key], val, err_msg=key)


@pytest.mark.parametrize("case", ["2x2", "3x3_blanks", "3x5", "2ch2t",
                                  "fixed"])
def test_chip_cuda_matches_cpu(cuda, case):
    """Every variable equal, the f32 grid intersections of blank chambers
    included: the grid fit's sums are short, and where they differ in the
    last bits the test's bound is that of the CPU comparison with the JAX
    package."""
    import magnify_tpu_torch as mt
    from test_torch_chip import GRID_ATOL, run_case
    from test_torch_slice import flatten

    before = thyst.launches, tscore.launches
    got = flatten(run_case(mt, case, device="cuda"), case)
    n_search = 1
    # Per search channel: detection + the whole refinement batch.
    assert thyst.launches - before[0] == 2 * n_search * thyst.LAUNCHES_PER_CALL
    assert tscore.launches - before[1] == 2 * n_search
    want = flatten(run_case(mt, case, device="cpu"), case)
    assert sorted(got) == sorted(want)
    for key, val in want.items():
        if key in (f"{case}/x", f"{case}/y"):
            np.testing.assert_allclose(got[key], val, rtol=0, atol=GRID_ATOL,
                                       err_msg=key)
        else:
            np.testing.assert_array_equal(got[key], val, err_msg=key)


def test_detect_rois_dense_cuda_matches_cpu(cuda):
    from magnify_tpu_torch.ops import detect as tdetect
    from test_torch_chip import ROI_ARGS, ROI_KW, roi_batches

    for rois in roi_batches().values():
        t = torch.as_tensor(rois.astype(np.int32))
        want = tdetect.detect_rois_dense(t, *ROI_ARGS, **ROI_KW)
        got = tdetect.detect_rois_dense(t.to(cuda), *ROI_ARGS, **ROI_KW)
        assert torch.equal(got[0].cpu(), want[0])
        assert torch.equal(got[1].cpu(), want[1])


def test_reductions_on_the_card_match_the_twins(cuda):
    rng = np.random.default_rng(0)
    roi = rng.normal(200, 40, (50, 3, 16, 16)).astype(np.float32)
    fg = rng.random((50, 16, 16)) < 0.3
    bg = rng.random((50, 16, 16)) < 0.4
    fg[7], bg[7] = False, False
    got = treduce.fg_mean_bg_median(roi, fg, bg, device=cuda)
    want = treduce.fg_mean_bg_median(roi, fg, bg, device="cpu")
    assert np.isnan(got[7]).all()
    np.testing.assert_allclose(
        got, want, rtol=0, atol=treduce.MEAN_RTOL * float(np.abs(roi).max()),
        equal_nan=True)
    values, mask = roi[:, 0], bg
    np.testing.assert_array_equal(
        treduce.masked_median(values, mask, device=cuda),
        treduce.masked_median(values, mask, device="cpu"))
    np.testing.assert_allclose(
        treduce.masked_mean(values, mask, device=cuda),
        treduce.masked_mean(values, mask, device="cpu"),
        rtol=treduce.MEAN_RTOL, equal_nan=True)


@pytest.mark.parametrize("seed,n,levels", [(0, 200, 3), (1, 2000, 4),
                                           (2, 7782, 4), (3, 91, 2)])
def test_lattice_fit_on_the_card_equals_the_cpu(cuda, seed, n, levels):
    """Every step is an IEEE f32 or f64 operation in a fixed order, so the
    card gives the CPU's bits."""
    rng = np.random.default_rng(seed)
    codes = np.arange(levels) * rng.uniform(0.8, 2.5)
    counts = rng.integers(2, 8, levels).astype(np.float64)
    pts = np.sort(rng.choice(codes, n, p=counts / counts.sum())
                  * rng.uniform(0.8, 1.2) + rng.normal(0, 0.05, n))
    assert (tid._fit_affine_1d(pts, codes, counts, device=cuda)
            == tid._fit_affine_1d(pts, codes, counts, device="cpu"))


def _decode_assay(n, side):
    sys.path.insert(0, os.path.abspath(
        os.path.join(os.path.dirname(__file__), os.pardir)))
    import chip_smoke
    import magnify_tpu_torch as mt

    return chip_smoke.decode_assay(mt, n=n, side=side, seed=3)


def test_identify_mrbles_cuda_matches_cpu(cuda):
    ds, spectra, codes = _decode_assay(480, 12)
    got = tid.identify_mrbles(ds, spectra=spectra, codes=codes, device=cuda)
    want = tid.identify_mrbles(ds, spectra=spectra, codes=codes, device="cpu")
    np.testing.assert_array_equal(got.tag.values, want.tag.values)
    assert len(np.unique(got.tag.values)) >= 24
    np.testing.assert_allclose(got["ln_vol"].values, want["ln_vol"].values,
                               rtol=1e-4, atol=1e-3)


def test_gmm_em_on_the_card_matches_the_cpu(cuda):
    rng = np.random.default_rng(0)
    centers = rng.uniform(0, 3, (4, 2))
    X = centers[rng.integers(0, 4, 180)] + rng.normal(0, 0.25, (180, 2))
    covs = np.tile(np.eye(2) * 0.0625, (4, 1, 1))
    props = np.append(np.full(4, 46.0), 1e-10)
    props /= props.sum()
    args = [torch.as_tensor(np.asarray(a, np.float32))
            for a in (X, centers, covs, props)]
    span = float(np.log(X.max(0) - X.min(0)).sum())
    want = tid._gmm_em(*args, span)
    got = tid._gmm_em(*(a.to(cuda) for a in args), span)
    assert bool(got[1]) == bool(want[1]) and bool(got[2]) == bool(want[2])
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].numpy(), rtol=0,
                               atol=1e-5)
    covs[:] = 0
    bad = tid._gmm_em(args[0].to(cuda), args[1].to(cuda),
                      torch.zeros((4, 2, 2), device=cuda), args[3].to(cuda),
                      span)
    assert not bool(bad[1]) and not bool(bad[2])


def _stream_frames():
    import magnify_tpu_torch as mt
    from test_torch_slice import case_inputs

    img, dims, coords, kw = case_inputs("two_channel")
    frames = []
    for shift in (0, 3, 7):
        frames.append(mt.DataArray(np.roll(img, shift, axis=-1), dims=dims,
                                   coords=coords))
    return frames, kw


def test_beads_stream_cuda_matches_single(cuda):
    import magnify_tpu_torch as mt
    from test_torch_slice import flatten

    frames, kw = _stream_frames()
    before = thyst.launches, tscore.launches
    outs = list(mt.beads_stream(frames, device="cuda", stream_depth=2, **kw))
    streamed = thyst.launches - before[0], tscore.launches - before[1]
    before = thyst.launches, tscore.launches
    refs = [mt.beads(f, device="cuda", **kw) for f in frames]
    serial = thyst.launches - before[0], tscore.launches - before[1]
    assert streamed == serial and min(streamed) > 0
    assert len(outs) == len(refs)
    for out, ref in zip(outs, refs):
        got, want = flatten(out, "s"), flatten(ref, "s")
        assert sorted(got) == sorted(want)
        for key, val in want.items():
            np.testing.assert_array_equal(got[key], val, err_msg=key)


def test_mrbles_stream_cuda_matches_single(cuda):
    import magnify_tpu_torch as mt
    from test_torch_slice import (MRBLES_CODES, MRBLES_SPECTRA, flatten,
                                  mrbles_inputs)

    img, dims, coords, kw = mrbles_inputs()
    frames = [mt.DataArray(np.roll(img, s, axis=-1), dims=dims, coords=coords)
              for s in (0, 5, 11)]
    spectra, codes = io.StringIO(MRBLES_SPECTRA), io.StringIO(MRBLES_CODES)
    outs = list(mt.mrbles_stream(frames, spectra=spectra, codes=codes,
                                 device="cuda", **kw))
    for frame, out in zip(frames, outs):
        ref = mt.mrbles(frame, spectra=spectra, codes=codes, device="cuda",
                        **kw)
        got, want = flatten(out, "m"), flatten(ref, "m")
        assert sorted(got) == sorted(want)
        for key, val in want.items():
            np.testing.assert_array_equal(got[key], val, err_msg=key)


def test_device_prefetcher_on_the_card(cuda):
    from magnify_tpu_torch.parallel import streaming

    blocks = {k: np.full((64, 64), k, np.uint8) for k in range(7)}
    got = list(streaming.DevicePrefetcher(range(7), blocks.__getitem__,
                                          depth=2, device=cuda))
    assert [k for k, _ in got] == list(range(7))
    for k, t in got:
        assert t.device.type == "cuda"
        assert torch.equal(t.cpu(), torch.from_numpy(blocks[k]))


def test_out_of_core_beads_and_quantify_on_the_card(cuda, tmp_path,
                                                    monkeypatch):
    """The out-of-core path of tests/test_torch_out_of_core.py (both
    limits lowered: the stack stays on disk, the ROI store is a memmap) on
    the card equals the CPU: marks, masks, crops, and the intensities,
    which both reduce on the host from the memmap. ``quantify`` of the same
    crops held in memory reduces on the card, within ``MEAN_RTOL`` of the
    pixel magnitude."""
    sys.path.insert(0, os.path.dirname(__file__))
    import test_torch_out_of_core as ooc

    import magnify_tpu_torch as mt
    from magnify_tpu_torch.components import find
    from magnify_tpu_torch.core import lazy

    monkeypatch.setattr(find, "MAX_RESIDENT_BYTES", 1)
    monkeypatch.setattr(lazy, "RESIDENT_BYTES_LIMIT", 1)
    pattern = ooc.write_stack(str(tmp_path))
    out = {}
    for dev in (cuda, "cpu"):
        before = thyst.launches
        xp = mt.beads(pattern, device=dev, **ooc.KW)
        assert (thyst.launches > before) == (dev == cuda)
        out[str(dev)] = mt.quantify(xp, device=dev)
    for name in ("x", "y", "fg", "bg", "roi", "valid", "intensity"):
        np.testing.assert_array_equal(np.asarray(out["cuda"][name].values),
                                      np.asarray(out["cpu"][name].values),
                                      err_msg=name)
    ram = out["cpu"].copy()
    ram["roi"] = (ram["roi"].dims, np.array(ram["roi"].values))
    on_card = mt.quantify(ram, device=cuda).intensity.values
    magnitude = float(np.abs(ram["roi"].values).max())
    assert np.abs(on_card - out["cpu"].intensity.values).max() <= (
        treduce.MEAN_RTOL * magnitude)


@pytest.mark.parametrize("case", ["single", "2x2", "3x5"])
def test_ransac_conv_cuda_matches_cpu(cuda, case, monkeypatch):
    """The conv scorer (``MAGNIFY_TPU_SCORER=conv``): the card launches
    hysteresis and the ring correlation (the whole plane's maps, and for a
    chip the chamber batch's), never the perimeter scorer, and gives the
    CPU's result in every variable."""
    import magnify_tpu_torch as mt
    import test_torch_chip
    import test_torch_slice

    run_case, iters = ((test_torch_slice.run_case,
                        test_torch_slice.RANSAC_ITER) if case == "single"
                       else (test_torch_chip.run_case,
                             test_torch_chip.RANSAC_ITER))
    monkeypatch.setenv("MAGNIFY_TPU_SCORER", "conv")
    before = thyst.launches, tscore.launches, tscore.perimeter_launches
    got = test_torch_slice.flatten(run_case(mt, case, device="cuda",
                                            detector="ransac",
                                            num_iter=iters), case)
    n_calls = 1 if case == "single" else 2
    assert thyst.launches - before[0] == n_calls * thyst.LAUNCHES_PER_CALL
    assert tscore.launches - before[1] == n_calls
    assert tscore.perimeter_launches == before[2]
    want = test_torch_slice.flatten(run_case(mt, case, device="cpu",
                                             detector="ransac",
                                             num_iter=iters), case)
    assert sorted(got) == sorted(want)
    for key, val in want.items():
        np.testing.assert_array_equal(got[key], val, err_msg=key)


@pytest.mark.parametrize("darkfield", [True, False])
def test_fit_basic_cuda_matches_cpu(cuda, darkfield):
    """The BaSiC solver on the card (matrix products in full float32)
    within the tolerances it keeps against the JAX package on the CPU."""
    from magnify_tpu_torch.ops import basic as tbasic
    from test_torch_basic import DARK_RTOL, FLAT_ATOL, shading_tiles

    tiles, _flat = shading_tiles(8, 256, 256, 0)
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")  # TF32: the fit must not use it
    try:
        f_g, d_g = tbasic.fit_basic(tiles, get_darkfield=darkfield,
                                    device="cuda")
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(saved)
    f_c, d_c = tbasic.fit_basic(tiles, get_darkfield=darkfield, device="cpu")
    np.testing.assert_allclose(f_g, f_c, rtol=0, atol=FLAT_ATOL)
    mean = float(tiles.astype(np.float32).mean())
    np.testing.assert_allclose(d_g, d_c, rtol=0, atol=DARK_RTOL * mean)


@pytest.mark.parametrize("detector,scorer", [("dense", None),
                                             ("ransac", "gather"),
                                             ("ransac", "conv")])
def test_find_circles_cuda_matches_cpu(cuda, detector, scorer, monkeypatch):
    import magnify_tpu_torch as mt
    from test_torch_ops_api import ARGS, STACK_KW, plane

    if scorer:
        monkeypatch.setenv("MAGNIFY_TPU_SCORER", scorer)
    got = mt.ops.find_circles(plane(2), *ARGS, detector=detector,
                              device="cuda")
    want = mt.ops.find_circles(plane(2), *ARGS, detector=detector,
                               device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if detector == "dense":
        stack = np.stack([plane(s) for s in (3, 4, 5)])
        for g, w in zip(
                mt.ops.find_circles_stack(stack, **STACK_KW, batch=2,
                                          device="cuda"),
                mt.ops.find_circles_stack(stack, **STACK_KW, batch=2,
                                          device="cpu")):
            np.testing.assert_array_equal(g[0], w[0])
            np.testing.assert_array_equal(g[1], w[1])


def _mesh(dev, batch, space):
    from magnify_tpu_torch.parallel import make_mesh

    return make_mesh(batch, space, devices=[dev] * (batch * space))


@pytest.mark.parametrize("space", [2, 4])
def test_sharded_hysteresis_cuda_matches_cpu(cuda, space):
    """The rounds of the sharded hysteresis through the kernel on a (2,
    space) mesh of the card: equal to the CPU mesh and to the plain twin,
    on a serpentine across every band boundary and on random masks."""
    from magnify_tpu_torch.parallel.mesh import sharded_hysteresis

    s1, w1 = _serpentine()
    s2, w2 = _masks(7, s1.shape)
    strong = torch.as_tensor(np.stack([s1, s2]))
    weak = torch.as_tensor(np.stack([w1, w2]))
    before = thyst.launches
    got, rounds = sharded_hysteresis(strong.to(cuda), weak.to(cuda),
                                     _mesh("cuda", 2, space))
    assert thyst.launches - before == rounds * thyst.LAUNCHES_PER_CALL
    want, want_rounds = sharded_hysteresis(strong, weak, _mesh("cpu", 2,
                                                               space))
    assert rounds == want_rounds > 1
    assert torch.equal(got.cpu(), want)
    assert torch.equal(want, thyst.hysteresis_plain(strong, weak))


@pytest.mark.parametrize("batch,space", [(2, 4), (1, 8)])
def test_sharded_detection_cuda_matches_cpu(cuda, batch, space):
    """Dense detection over a mesh of the card equals the CPU mesh and the
    one-device detection; ring_corr launches once a call."""
    from magnify_tpu_torch.ops import detect
    from magnify_tpu_torch.parallel import sharded_find_circles_batch
    from test_torch_ops_api import plane

    planes = np.stack([plane(s) for s in (2, 3, 4)]).astype(np.float32)
    args = (0.1, 0.9, 0.3)
    kw = dict(min_radius=8, max_radius=12, min_dist=8)
    before = tscore.launches
    got = sharded_find_circles_batch(planes, _mesh("cuda", batch, space),
                                     *args, **kw)
    assert tscore.launches - before == 1
    want = sharded_find_circles_batch(planes, _mesh("cpu", batch, space),
                                      *args, **kw)
    for (c, s), (wc, ws), p in zip(got, want, planes):
        assert torch.equal(c.cpu(), wc) and torch.equal(s.cpu(), ws)
        oc, os_ = detect.detect_dense(torch.as_tensor(p).to(cuda), *args,
                                      normalized=False, **kw)
        assert torch.equal(c, oc) and torch.equal(s, os_)
