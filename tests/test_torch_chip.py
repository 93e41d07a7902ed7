"""The port's ``microfluidic_chip`` end to end against the JAX package's, and
the pieces of the chip path that hold no kernel of their own.

``magnify_tpu_torch.microfluidic_chip(..., device="cpu")`` runs against
``magnify_tpu.microfluidic_chip(..., detector="dense")`` with int8 score
maps on small grids drawn from numpy seeds: 2 x 2, 3 x 3 with blank chambers
from a pinlist, 3 x 5 with unequal pitches, a 2-channel 2-timestep stack
with one empty channel and ``search_channel``, and the fixed labelling of
``top_chamber``/``left_chamber``. Every output variable must have the same
dims and dtype; ``roi``, ``fg``, ``bg``, ``tag``, ``valid`` and the ``x``/``y``
of refined chambers (integers: crop corner + detected circle) must be equal;
the ``x``/``y`` of blank chambers are the f32 grid intersections themselves
and must agree within ``GRID_ATOL`` pixels (the grid fit's f32 sums reduce in
another order in torch than in XLA). The QC filters run on the chip output
in both packages and must give the same ``valid``. The batched per-ROI
detector (``detect_rois_dense``) is held against ``_detect_rois_dense`` on
nine crops of 48 and 72 pixels, circles and scores exact, an empty crop
(score ``-inf``) included. With ``detector="ransac"`` (the JAX package's
unfused grid search: RANSAC per search channel, the float64 numpy grid fit
and one RANSAC + hill-climb batch over the chamber crops) the 2 x 2, the
3 x 3 with blanks and the 3 x 5 grids must come out equal in every
variable, the blank chambers' float64 intersections included; the 2 x 2 and
the 3 x 5 grids run again with the conv scorer (``MAGNIFY_TPU_SCORER=conv``:
the whole-plane search reads its plane's int8 score maps, the chamber batch
and its hill-climb read the maps of all crops from one ring correlation),
equal in every variable to the JAX package's conv scorer.

The reference runs in ONE subprocess for the whole file (this file run as
a script), for the reasons given in test_torch_slice: the quantization mode
is read at import and the CPU defaults are another program.
"""

import io
import os
import sys

import numpy as np
import pytest
import torch
import torch_reference

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))

#: Blank chambers' positions are grid intersections computed in f32 on both
#: sides, from sums reduced in different orders: pixels.
GRID_ATOL = 1e-3

KW = dict(min_button_diameter=10, max_button_diameter=18,
          chamber_diameter=40, overlap=0)


# One intra-op thread per test process: the suite runs several pytest
# workers at once, and oversubscribed torch thread pools spin for the cores
# the others need.
torch.set_num_threads(1)


def _draw(img, centers, radius, value):
    from magnify_tpu_torch.utils import filled_circle_points

    pts = filled_circle_points(radius)
    for y, x in centers:
        img[..., pts[:, 0] + y, pts[:, 1] + x] = value


def _grid_centers(grid, row_dist, col_dist, skip=()):
    return [((i + 1) * row_dist, (j + 1) * col_dist)
            for i in range(grid[0]) for j in range(grid[1])
            if (i, j) not in skip]


def _pinlist(grid, blanks):
    lines = ["Indices,MutantID"]
    for i in range(grid[0]):
        for j in range(grid[1]):
            name = "BLANK" if (i, j) in blanks else f"m{i}{j}"
            lines.append(f'"({j + 1}, {i + 1})",{name}')
    return "\n".join(lines) + "\n"


def case_inputs(case):
    """(array, dims, coords, kwargs) of one fixture, from numpy seeds."""
    rng = np.random.default_rng({"2x2": 0, "3x3_blanks": 1, "3x5": 2,
                                 "2ch2t": 3, "fixed": 4}[case])
    if case == "2x2":
        img = np.zeros((240, 240), np.uint16)
        _draw(img, _grid_centers((2, 2), 80, 80), 7, 1000)
        return img, ("y", "x"), None, dict(KW, shape=(2, 2), row_dist=80,
                                           col_dist=80)
    if case == "3x3_blanks":
        blanks = {(0, 2), (1, 1)}
        img = rng.normal(100, 4, (1, 320, 320)).astype(np.uint16)
        _draw(img, _grid_centers((3, 3), 80, 80, blanks), 7, 900)
        # A channel dim, so the result keeps one for the filters.
        return img, ("channel", "y", "x"), {"channel": ["egfp"]}, dict(
            KW, pinlist=_pinlist((3, 3), blanks), row_dist=80, col_dist=80)
    if case == "3x5":
        img = rng.normal(100, 4, (280, 390)).astype(np.uint16)
        centers = [(y + int(rng.integers(-2, 3)), x + int(rng.integers(-2, 3)))
                   for y, x in _grid_centers((3, 5), 70, 65)]
        _draw(img, centers, 6, 1000)
        return img, ("y", "x"), None, dict(KW, shape=(3, 5), row_dist=70,
                                           col_dist=65)
    if case == "2ch2t":
        img = rng.normal(100, 4, (2, 2, 240, 240)).astype(np.uint16)
        _draw(img[1, 0], _grid_centers((2, 2), 80, 80), 7, 1000)
        _draw(img[1, 1], [(y + 3, x + 2) for y, x in
                          _grid_centers((2, 2), 80, 80)], 7, 1000)
        return (img, ("channel", "time", "y", "x"),
                {"channel": ["empty", "egfp"]},
                dict(KW, shape=(2, 2), row_dist=80, col_dist=80,
                     search_channel="egfp", search_timestep=0))
    img = np.zeros((320, 320), np.uint16)
    _draw(img, _grid_centers((3, 3), 80, 80), 7, 1000)
    return img, ("y", "x"), None, dict(KW, shape=(3, 3), row_dist=80,
                                       col_dist=80, top_chamber=60,
                                       left_chamber=60)


CASES = ("2x2", "3x3_blanks", "3x5", "2ch2t", "fixed")
RANSAC_CASES = ("2x2", "3x3_blanks", "3x5")
CONV_CASES = ("2x2", "3x5")
#: Whole-plane RANSAC proposals of the chip cases; each chamber gets
#: RANSAC_ITER // n_chambers.
RANSAC_ITER = 20000
FILTERS = (("filter_expression", {}), ("filter_nonround", {}),
           ("filter_leaky", {}))


def run_case(pkg, case, **extra):
    img, dims, coords, kw = case_inputs(case)
    kw = dict(kw)
    if "pinlist" in kw:
        kw["pinlist"] = io.StringIO(kw["pinlist"])
    data = pkg.DataArray(img, dims=dims, coords=coords)
    return pkg.microfluidic_chip(data, **kw, **extra)


def run_filters(pkg, chip_extra, **extra):
    """``valid`` after each QC filter, applied alone to the 3 x 3 chip
    result in the pipeline's own layout (before ``restore_format``, where
    ``examples/chip_example.py`` attaches them)."""
    from copy import deepcopy

    img, dims, coords, kw = case_inputs("3x3_blanks")
    kw = dict(kw, pinlist=io.StringIO(kw["pinlist"]))
    pipe = pkg.microfluidic_chip_pipe(**kw, **chip_extra)
    pipe.remove_pipe("restore_format")
    xp = pipe(data=pkg.DataArray(img, dims=dims, coords=coords))
    out = {"tag": np.asarray(xp["tag"].values).astype(str)}
    for name, kw in FILTERS:
        make = pkg.core.registry.components.get(name)
        call_kw = dict(kw, **extra) if name != "filter_nonround" else kw
        out[name] = np.asarray(make(**call_kw)(deepcopy(xp))["valid"].values)
    return out


ROI_KW = dict(min_radius=5, max_radius=9)
ROI_ARGS = (0.1, 0.97, 0.2)  # low_q, high_q, min_roundness


def roi_batches():
    """Two batches of uint16 crops, (6, 48, 48) and (3, 72, 72): buttons of
    radius 5-9 on noise at several places (one at the border, one dim, two
    in one crop), a constant crop and a pure-noise crop."""
    rng = np.random.default_rng(17)
    small = rng.normal(200, 6, (6, 48, 48)).astype(np.uint16)
    _draw(small[0], [(24, 24)], 7, 1500)
    _draw(small[1], [(12, 30)], 5, 400)
    _draw(small[2], [(36, 10)], 9, 1500)
    _draw(small[3], [(14, 14), (32, 33)], 6, 900)
    small[4] = 300
    big = rng.normal(200, 6, (3, 72, 72)).astype(np.uint16)
    _draw(big[0], [(40, 31)], 8, 1200)
    _draw(big[2], [(20, 55)], 9, 260)
    return {"small": small, "big": big}


def _flatten(xp, case):
    from test_torch_slice import flatten

    return flatten(xp, case)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_chip_ref") / "ref.npz"
    return torch_reference.run(__file__, path)


@pytest.fixture(scope="module")
def results():
    """The port's result of each case, computed once."""
    import magnify_tpu_torch as mt

    cache = {}

    def get(case):
        if case not in cache:
            cache[case] = run_case(mt, case, device="cpu")
        return cache[case]

    return get


@pytest.mark.parametrize("case", CASES)
def test_chip_matches_jax_dense(reference, results, case):
    got = _flatten(results(case), case)
    want = {k: v for k, v in reference.items() if k.startswith(case + "/")}
    assert sorted(got) == sorted(want)
    tag = got[f"{case}/tag"]
    assert (tag != "").sum() >= 4
    for key, val in want.items():
        assert got[key].dtype == val.dtype, key
        if key in (f"{case}/x", f"{case}/y"):
            # (..., mark_row, mark_col): refined chambers are integers and
            # exact, blank ones are the grid intersections.
            assert str(got[key + "/dims"]).endswith("mark_row,mark_col")
            refined = np.broadcast_to(tag != "", val.shape)
            np.testing.assert_array_equal(got[key][refined], val[refined],
                                          err_msg=key)
            np.testing.assert_allclose(got[key][~refined], val[~refined],
                                       rtol=0, atol=GRID_ATOL, err_msg=key)
        else:
            np.testing.assert_array_equal(got[key], val, err_msg=key)


@pytest.mark.parametrize("case", RANSAC_CASES)
def test_chip_matches_jax_ransac(reference, case):
    import magnify_tpu_torch as mt

    tag = f"ransac/{case}"
    got = _flatten(run_case(mt, case, device="cpu", detector="ransac",
                            num_iter=RANSAC_ITER), tag)
    want = {k: v for k, v in reference.items() if k.startswith(tag + "/")}
    assert sorted(got) == sorted(want)
    assert (got[f"{tag}/tag"] != "").sum() >= 4
    for key, val in want.items():
        assert got[key].dtype == val.dtype, key
        np.testing.assert_array_equal(got[key], val, err_msg=key)


@pytest.mark.parametrize("case", CONV_CASES)
def test_chip_matches_jax_ransac_conv(reference, case, monkeypatch):
    import magnify_tpu_torch as mt
    from magnify_tpu_torch.ops import detect as tdetect

    def no_perimeter(*args, **kwargs):
        raise AssertionError("the conv scorer reached the perimeter scorer")

    tag = f"conv/{case}"
    monkeypatch.setenv("MAGNIFY_TPU_SCORER", "conv")
    monkeypatch.setattr(tdetect, "score_circles", no_perimeter)
    got = _flatten(run_case(mt, case, device="cpu", detector="ransac",
                            num_iter=RANSAC_ITER), tag)
    want = {k: v for k, v in reference.items() if k.startswith(tag + "/")}
    assert sorted(got) == sorted(want)
    assert (got[f"{tag}/tag"] != "").sum() >= 4
    for key, val in want.items():
        assert got[key].dtype == val.dtype, key
        np.testing.assert_array_equal(got[key], val, err_msg=key)


@pytest.mark.parametrize("name", ["small", "big"])
def test_detect_rois_dense_matches_jax(reference, name):
    from magnify_tpu_torch.ops import detect as tdetect

    rois = roi_batches()[name]
    circles, scores = tdetect.detect_rois_dense(
        torch.as_tensor(rois.astype(np.int32)), *ROI_ARGS, **ROI_KW)
    assert circles.dtype == torch.int32 and scores.dtype == torch.float32
    np.testing.assert_array_equal(circles.numpy(),
                                  reference[f"rois/{name}/circles"])
    np.testing.assert_array_equal(scores.numpy(),
                                  reference[f"rois/{name}/scores"])
    found = np.isfinite(scores.numpy())
    if name == "small":
        # Noise alone can reach min_roundness 0.2; the constant crop cannot.
        assert found[:4].all() and not found[4]
        np.testing.assert_array_equal(
            circles.numpy()[:3], [[24, 24, 7], [12, 30, 5], [36, 10, 9]])
        assert scores.numpy()[4] == -np.inf
        pad = 2 * ROI_KW["max_radius"]
        np.testing.assert_array_equal(circles.numpy()[4],
                                      [-pad, -pad, ROI_KW["min_radius"]])
    got = tdetect.detect_best_in_rois(rois, ROI_ARGS[0], ROI_ARGS[1],
                                      min_roundness=ROI_ARGS[2], device="cpu",
                                      **ROI_KW)
    np.testing.assert_array_equal(got[0], circles.numpy())
    np.testing.assert_array_equal(got[2], found)


def test_chip_finds_the_drawn_buttons(results):
    """Independent of the reference: 3 x 5 centers within 2.5 px of where
    they were drawn (+-2 px jitter), fg disks of the drawn radius."""
    xp = results("3x5")
    xs = np.asarray(xp.x.values).reshape(3, 5)
    ys = np.asarray(xp.y.values).reshape(3, 5)
    assert xp.fg.dims[-2:] == ("mark_row", "mark_col")
    for i in range(3):
        for j in range(5):
            assert abs(ys[i, j] - (i + 1) * 70) <= 2.5
            assert abs(xs[i, j] - (j + 1) * 65) <= 2.5
    radii = np.sqrt(np.asarray(xp.fg.values).reshape(-1, 15).sum(0) / np.pi)
    assert 5.0 < radii.min() and radii.max() < 7.5


def test_copied_timestep_keeps_positions(results):
    xp = results("2ch2t")
    assert xp.x.dims == xp.y.dims == ("time", "mark_row", "mark_col")
    x, y = np.asarray(xp.x.values), np.asarray(xp.y.values)
    np.testing.assert_array_equal(x[0], x[1])
    np.testing.assert_array_equal(y[0], y[1])
    np.testing.assert_array_equal(y[0], [[80, 80], [160, 160]])
    assert xp["roi"].sizes["channel"] == 2 and xp["roi"].sizes["time"] == 2


@pytest.fixture(scope="module")
def filtered():
    import magnify_tpu_torch as mt

    return run_filters(mt, {"device": "cpu"}, device="cpu")


@pytest.mark.parametrize("name", [n for n, _ in FILTERS])
def test_filters_match_jax(reference, filtered, name):
    got = filtered[name]
    want = reference[f"filters/{name}"]
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if name == "filter_expression":
        # (mark, time): the auto bound filters out exactly the blanks.
        np.testing.assert_array_equal(got[:, 0], filtered["tag"] != "")
        np.testing.assert_array_equal(filtered["tag"],
                                      reference["filters/tag"])


def test_chip_parameter_surface_and_errors():
    import inspect

    import magnify_tpu as mg
    import magnify_tpu_torch as mt

    for name in ("microfluidic_chip", "microfluidic_chip_pipe"):
        want = inspect.signature(getattr(mg, name)).parameters
        got = inspect.signature(getattr(mt, name)).parameters
        assert list(got) == list(want) + ["device"], name
        for key, par in want.items():
            assert got[key].default == par.default, (name, key)
        assert got["device"].default == "cuda"
    assert mt.registry.CHIP_PRESETS == mg.registry.CHIP_PRESETS
    pipe = mt.microfluidic_chip_pipe(chip_type="pc", device="cpu")
    assert pipe.component_names == mg.microfluidic_chip_pipe(
        chip_type="pc").component_names
    finder = dict(pipe.components)["find_buttons"]
    assert (finder.row_dist, finder.col_dist) == mt.registry.CHIP_PRESETS["pc"]
    img = mt.DataArray(np.zeros((64, 64), np.uint16), dims=("y", "x"))
    with pytest.raises(ValueError, match="Invalid chip type"):
        mt.microfluidic_chip(img, chip_type="nope", device="cpu")
    with pytest.raises(ValueError, match="exceeds total_length"):
        # The RANSAC grid search refuses the same geometry, on the host.
        mt.microfluidic_chip(img, shape=(2, 2), detector="ransac",
                             num_iter=1000, device="cpu", **KW)
    # The tuning UI runs headless (each stage once, with the defaults): the
    # result is the one without it.
    got = _flatten(run_case(mt, "2x2", device="cpu", interactive=True), "i")
    want = _flatten(run_case(mt, "2x2", device="cpu"), "i")
    assert sorted(got) == sorted(want)
    for key, val in want.items():
        np.testing.assert_array_equal(got[key], val, err_msg=key)
    with pytest.raises(ValueError, match="exceeds total_length"):
        mt.microfluidic_chip(img, shape=(2, 2), device="cpu", **KW)
    if not torch.cuda.is_available():
        # No card: the default device raises, it never carries on on the CPU.
        big = mt.DataArray(np.zeros((240, 240), np.uint16), dims=("y", "x"))
        with pytest.raises((RuntimeError, AssertionError)):
            mt.microfluidic_chip(big, shape=(2, 2), row_dist=80, col_dist=80,
                                 **KW)


def test_sparse_edge_warning(caplog):
    """An edge row with one button of three expected logs the JAX
    package's warning on the port's logger."""
    import logging

    import magnify_tpu_torch as mt

    img = np.zeros((320, 320), np.uint16)
    centers = [c for c in _grid_centers((3, 3), 80, 80)
               if c[0] != 80 or c[1] == 80]
    _draw(img, centers, 7, 1000)
    with caplog.at_level(logging.WARNING, logger="magnify_tpu_torch"):
        mt.microfluidic_chip(mt.DataArray(img, dims=("y", "x")), shape=(3, 3),
                             row_dist=80, col_dist=80, top_chamber=60,
                             left_chamber=60, device="cpu", **KW)
    assert any("edge cluster 0 has 1 point(s)" in r.getMessage()
               for r in caplog.records)


def test_rotate_component_matches_jax():
    """``rotate`` on a small 2-channel stack: within ROT_ATOL of the JAX
    package's bilinear resampling (sin/cos from another library, f32 sums),
    dtype and shape kept; 0 degrees returns the input object."""
    import magnify_tpu as mg
    import magnify_tpu_torch as mt

    rot_atol = 1e-4 * 1000.0 + 1.0  # 1e-4 of the range, plus the int cast
    rng = np.random.default_rng(0)
    img = rng.integers(0, 1000, (2, 1, 40, 56)).astype(np.uint16)
    out = {}
    for pkg, extra in ((mg, {}), (mt, {"device": "cpu"})):
        ds = pkg.Dataset({"image": (("channel", "time", "im_y", "im_x"),
                                    img.copy())})
        make = pkg.core.registry.components.get("rotate")
        assert make(rotation=0, **extra)(ds) is ds
        out[pkg] = np.asarray(
            make(rotation=7.5, **extra)(ds)["image"].values)
    assert out[mt].dtype == np.uint16 and out[mt].shape == img.shape
    diff = np.abs(out[mt].astype(np.int64) - out[mg].astype(np.int64))
    assert diff.max() <= rot_atol
    assert (diff == 0).mean() > 0.99


if __name__ == "__main__":
    # The reference run: the JAX package, dense detector, int8 maps, then
    # the RANSAC cases.
    torch_reference.check_env()
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import magnify_tpu as mg

    result = {}
    for name in CASES:
        xp = run_case(mg, name, detector="dense")
        result.update(_flatten(xp, name))
    for key, val in run_filters(mg, {"detector": "dense"}).items():
        result[f"filters/{key}"] = val
    from magnify_tpu.ops.detect import _detect_rois_dense

    for name, rois in roi_batches().items():
        circles, scores = _detect_rois_dense(rois, *ROI_ARGS, **ROI_KW)
        result[f"rois/{name}/circles"] = np.asarray(circles)
        result[f"rois/{name}/scores"] = np.asarray(scores)
    # RANSAC with the exact perimeter scorer: the detector is read per call.
    os.environ.update(MAGNIFY_TPU_DETECTOR="ransac",
                      MAGNIFY_TPU_SCORER="gather")
    for name in RANSAC_CASES:
        xp = run_case(mg, name, detector="ransac", num_iter=RANSAC_ITER)
        result.update(_flatten(xp, f"ransac/{name}"))
    os.environ["MAGNIFY_TPU_SCORER"] = "conv"
    for name in CONV_CASES:
        xp = run_case(mg, name, detector="ransac", num_iter=RANSAC_ITER)
        result.update(_flatten(xp, f"conv/{name}"))
    np.savez(sys.argv[1], **result)
