"""The port's ``beads`` and ``mrbles`` end to end against the JAX package's,
exactly, with the dense and with the RANSAC detector.

``magnify_tpu_torch.beads(..., device="cpu")`` runs against
``magnify_tpu.beads(..., detector="dense")`` with int8 score maps on three
fixtures: a 256^2 single-channel frame (with an array flat field), a
2-channel frame with shared and disjoint beads (the cross-channel dedupe),
and a 2 x 2-tile stack with overlap (stitch, with a darkfield). Every output
variable (``roi``, ``fg``, ``bg``, ``x``, ``y``, ``valid``, channel coords)
must have the same dims and identical values. ``mrbles`` runs the same way
on a two-channel 300^2 frame with five beads of two codes: every variable
and coordinate equal, the decoded ``tag`` (an object array of ``str`` in
both packages) and the f64 ``ln_vol``/``ln_ratio`` included. The same
four fixtures run again with ``detector="ransac"`` (``RANSAC_ITER``
proposals per search channel, seed 0, the exact perimeter scorer) against
the JAX package's RANSAC detector with the gather scorer: every variable
equal. ``CONV_CASES`` run once more with the conv scorer
(``MAGNIFY_TPU_SCORER=conv``: each unique proposal's score read out of the
plane's int8 score maps) against the JAX package's conv scorer: every
variable equal.

The reference runs in ONE subprocess per session (this file run as a
script): the JAX package reads its score-quantization mode once at import,
its CPU defaults are the bf16 scorer and the ransac detector, and its jitted
stages cache traces per process, so an in-process run could meet a trace
or mode left by another test file. The RANSAC references come from the same
subprocess, which switches ``MAGNIFY_TPU_DETECTOR`` (read per call) to
"ransac" and pins ``MAGNIFY_TPU_SCORER=gather`` after the dense runs, then
``conv`` for the conv cases. The port reads both variables per call too;
its conv test sets the scorer only for its own duration.
"""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
KW = dict(min_bead_diameter=16, max_bead_diameter=24, min_roundness=0.3)


# One intra-op thread per test process: the suite runs several pytest
# workers at once, and oversubscribed torch thread pools spin for the cores
# the others need.
torch.set_num_threads(1)


def _paint(img, positions, radii, value):
    from magnify_tpu_torch.utils import filled_circle_points

    for (y, x), r in zip(positions, radii):
        pts = filled_circle_points(r) + np.array([y, x])
        ok = ((pts[:, 0] >= 0) & (pts[:, 0] < img.shape[-2])
              & (pts[:, 1] >= 0) & (pts[:, 1] < img.shape[-1]))
        img[..., pts[ok, 0], pts[ok, 1]] = value


def case_inputs(case):
    """(array, dims, coords, kwargs) of one fixture, from numpy seeds."""
    rng = np.random.default_rng({"single": 0, "two_channel": 1,
                                 "tiled": 2}[case])
    if case == "single":
        img = rng.normal(100, 5, (256, 256)).astype(np.uint16)
        pos = [(40, 40), (40, 130), (45, 215), (128, 90), (132, 180),
               (210, 50), (215, 140), (250, 230), (5, 250)]
        _paint(img, pos, [8, 9, 10, 11, 10, 9, 8, 10, 9], 1000)
        yy, xx = np.mgrid[0:256, 0:256]
        flat = (1.0 + 0.3 * np.exp(-((yy - 128) ** 2 + (xx - 128) ** 2)
                                    / 2e4)).astype(np.float32)
        return img, ("y", "x"), None, dict(KW, overlap=0, flatfield=flat)
    if case == "two_channel":
        img = rng.normal(100, 5, (2, 256, 256)).astype(np.uint16)
        shared = [(50, 50), (60, 180), (190, 70)]
        _paint(img[0], shared + [(180, 200)], [10, 9, 11, 10], 1000)
        _paint(img[1], [(y + 3, x + 4) for y, x in shared[:2]]
               + [(120, 120), (220, 220)], [10, 9, 10, 8], 900)
        return (img, ("channel", "y", "x"),
                {"channel": ["red", "green"]},
                dict(KW, overlap=0, search_channel=["red", "green"]))
    tile, ov = 160, 32
    step = tile - ov
    img = rng.normal(100, 5, (2, 2, tile, tile)).astype(np.uint16)
    field = [(40, 40), (60, 150), (120, 125), (150, 60), (200, 200),
             (230, 90), (100, 240)]
    for tr in range(2):
        for tc in range(2):
            _paint(img[tr, tc], [(y - tr * step + ov // 2,
                                  x - tc * step + ov // 2) for y, x in field],
                   [9, 10, 11, 10, 9, 8, 10], 1000)
    return (img, ("row", "col", "y", "x"), None,
            dict(KW, overlap=ov, darkfield=10.0))


CASES = ("single", "two_channel", "tiled")

#: Proposals per search channel of the RANSAC cases (the JAX package's own
#: bead tests run 100 to 20,000).
RANSAC_ITER = 20000

#: The RANSAC cases run again with the conv scorer.
CONV_CASES = ("single", "two_channel")

MRBLES_SPECTRA = "name,c1,c2\neu,1.0,0.1\ndy,0.1,1.0\n"
MRBLES_CODES = "name,eu,dy\ncode_a,1.0,0.0\ncode_b,1.0,1.0\n"


def mrbles_inputs():
    """The two-channel decode frame: five beads, dy/eu ratio 0 or 1, drawn
    as uint16 disks of radius 10 under Gaussian background noise."""
    rng = np.random.default_rng(0)
    spectra_m = np.array([[1.0, 0.1], [0.1, 1.0]])
    chans = np.zeros((2, 300, 300), np.float32)
    for k, dy in enumerate([0.0, 1.0, 0.0, 1.0, 0.0]):
        inten = np.array([100.0, 100.0 * dy]) @ spectra_m
        for ci in range(2):
            disk = np.zeros((300, 300), np.uint16)
            _paint(disk, [(60 + 50 * k, 60 + 40 * k)], [10],
                   float(inten[ci]) + 1)
            chans[ci] += disk
    chans += rng.normal(8.0, 1.5, chans.shape).astype(np.float32)
    return (np.maximum(chans, 0), ("channel", "y", "x"),
            {"channel": ["c1", "c2"]},
            dict(KW, overlap=0, search_channel="c1"))


def run_case(pkg, case, **extra):
    if case == "mrbles":
        import io

        img, dims, coords, kw = mrbles_inputs()
        data = pkg.DataArray(img, dims=dims, coords=coords)
        return pkg.mrbles(data, spectra=io.StringIO(MRBLES_SPECTRA),
                          codes=io.StringIO(MRBLES_CODES), **kw, **extra)
    img, dims, coords, kw = case_inputs(case)
    data = pkg.DataArray(img, dims=dims, coords=coords)
    return pkg.beads(data, **kw, **extra)


def flatten(xp, case):
    """Every variable of a result as {f"{case}/{name}": values} plus its
    dims under f"{case}/{name}/dims" and its dtype under
    f"{case}/{name}/dtype" (object arrays of ``str`` are stored as
    unicode, an ``.npz`` holds no objects)."""
    out = {}
    for name in sorted(xp.variables):
        values = np.asarray(xp[name].values)
        out[f"{case}/{name}/dtype"] = np.array(values.dtype.str)
        if values.dtype == object:
            values = values.astype(str)
        out[f"{case}/{name}"] = values
        out[f"{case}/{name}/dims"] = np.array(",".join(xp[name].dims))
    return out


@pytest.fixture(scope="session")
def reference(tmp_path_factory):
    import subprocess

    path = tmp_path_factory.mktemp("torch_slice_ref") / "ref.npz"
    env = dict(os.environ, MAGNIFY_TPU_SCORE_QUANT="int8",
               MAGNIFY_TPU_DETECTOR="dense", JAX_PLATFORMS="cpu",
               MAGNIFY_TPU_CACHE_DIR=os.path.join(ROOT, ".cache", "test_xla"))
    subprocess.run([sys.executable, os.path.abspath(__file__), str(path)],
                   env=env, cwd=ROOT, check=True, timeout=600)
    return dict(np.load(path))


@pytest.mark.parametrize("case", CASES)
def test_beads_matches_jax_dense(reference, case):
    import magnify_tpu_torch as mt

    got = flatten(run_case(mt, case, device="cpu"), case)
    want = {k: v for k, v in reference.items()
            if k.startswith(case + "/")}
    assert sorted(got) == sorted(want)
    assert got[f"{case}/roi/dims"] == want[f"{case}/roi/dims"]
    n_marks = got[f"{case}/x"].shape[0]
    assert n_marks >= 4
    for key, val in want.items():
        assert got[key].dtype == val.dtype, key
        np.testing.assert_array_equal(got[key], val, err_msg=key)


def test_mrbles_matches_jax_dense(reference):
    import magnify_tpu_torch as mt

    got = flatten(run_case(mt, "mrbles", device="cpu"), "mrbles")
    want = {k: v for k, v in reference.items() if k.startswith("mrbles/")}
    assert sorted(got) == sorted(want)
    assert got["mrbles/x"].shape[0] >= 5
    assert {"code_a", "code_b"} <= set(got["mrbles/tag"].tolist())
    assert str(got["mrbles/tag/dtype"]) == "|O"
    for var in ("tag", "ln", "ln_vol", "ln_ratio"):
        assert f"mrbles/{var}" in got
    for key, val in want.items():
        assert got[key].dtype == val.dtype, key
        np.testing.assert_array_equal(got[key], val, err_msg=key)


@pytest.mark.parametrize("case", CASES + ("mrbles",))
def test_matches_jax_ransac(reference, case):
    import magnify_tpu_torch as mt

    tag = f"ransac/{case}"
    got = flatten(run_case(mt, case, device="cpu", detector="ransac",
                           num_iter=RANSAC_ITER), tag)
    want = {k: v for k, v in reference.items() if k.startswith(tag + "/")}
    assert sorted(got) == sorted(want)
    # 20,000 proposals find 2 of the 5 dim MRBLEs, in both packages.
    assert got[f"{tag}/x"].shape[0] >= (2 if case == "mrbles" else 4)
    for key, val in want.items():
        assert got[key].dtype == val.dtype, key
        np.testing.assert_array_equal(got[key], val, err_msg=key)


@pytest.mark.parametrize("case", CONV_CASES)
def test_matches_jax_ransac_conv(reference, case, monkeypatch):
    import magnify_tpu_torch as mt
    from magnify_tpu_torch.ops import detect as tdetect

    def no_perimeter(*args, **kwargs):
        raise AssertionError("the conv scorer reached the perimeter scorer")

    tag = f"conv/{case}"
    monkeypatch.setenv("MAGNIFY_TPU_SCORER", "conv")
    monkeypatch.setattr(tdetect, "score_circles", no_perimeter)
    got = flatten(run_case(mt, case, device="cpu", detector="ransac",
                           num_iter=RANSAC_ITER), tag)
    want = {k: v for k, v in reference.items() if k.startswith(tag + "/")}
    assert sorted(got) == sorted(want)
    assert got[f"{tag}/x"].shape[0] >= 4
    for key, val in want.items():
        assert got[key].dtype == val.dtype, key
        np.testing.assert_array_equal(got[key], val, err_msg=key)


if __name__ == "__main__":
    # The reference run: the JAX package, dense detector, int8 maps; then
    # its RANSAC detector with the gather scorer and with the conv scorer.
    assert os.environ.get("MAGNIFY_TPU_SCORE_QUANT") == "int8"
    assert os.environ.get("MAGNIFY_TPU_DETECTOR") == "dense"
    sys.path.insert(0, ROOT)
    import magnify_tpu as mg

    result = {}
    for name in CASES + ("mrbles",):
        result.update(flatten(run_case(mg, name, detector="dense"), name))
    os.environ.update(MAGNIFY_TPU_DETECTOR="ransac",
                      MAGNIFY_TPU_SCORER="gather")
    for name in CASES + ("mrbles",):
        result.update(flatten(run_case(mg, name, detector="ransac",
                                       num_iter=RANSAC_ITER),
                              f"ransac/{name}"))
    os.environ["MAGNIFY_TPU_SCORER"] = "conv"
    for name in CONV_CASES:
        result.update(flatten(run_case(mg, name, detector="ransac",
                                       num_iter=RANSAC_ITER),
                              f"conv/{name}"))
    np.savez(sys.argv[1], **result)
