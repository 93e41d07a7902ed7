"""The port's public ops layer, its detector and scorer switches, the
remaining preprocess components and the stage timers, against the JAX
package.

* ``gather_map_scores`` against the jitted JAX function on one plane's maps
  and (vmapped) on a batch, exact, with invalid rows and rows whose radius,
  row or column lie outside the maps.
* ``find_circles`` (dense, with and without NMS, and RANSAC with the gather
  and with the conv scorer) and ``find_circles_stack`` (3 planes,
  ``batch=2``) against ``magnify_tpu.ops.find_circles``/
  ``find_circles_stack`` with int8 score maps, exact. The reference runs in
  ONE subprocess (this file run as a script), which sets
  ``MAGNIFY_TPU_SCORE_QUANT=int8`` before its import and the scorer per
  call; the stack equals the single-plane calls too.
* ``resolve_detector``/``use_conv_scorer`` read their variables per call
  (only inside the tests that set them, through ``monkeypatch``).
* Every ``@component`` name of the JAX package is registered in the port,
  and ``magnify_tpu.ops.__all__`` but ``prefer_host_reduction`` is in the
  port's ``ops.__all__``.
* ``rename_labels``, both flips and ``circle_mask`` (inner and outer) equal
  the JAX components, on tiles and on a stitched image.
* ``stage_timer``/``stage_report``/``reset_stages``, the pipeline's stage
  timing and ``profile``, as ``tests/test_diagnostics.py`` holds the JAX
  package's.

JAX is imported inside the tests, so that ``tests/test_torch_cuda.py`` can
import the planes on a machine without it.
"""

import inspect
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))

torch.set_num_threads(1)

# find_circles arguments: (low_q, high_q, grid_length, num_iter, min_radius,
# max_radius, min_roundness, min_dist).
ARGS = (0.1, 0.9, 20, 20000, 8, 12, 0.3, 8)
STACK_KW = dict(low_edge_quantile=0.1, high_edge_quantile=0.9, min_radius=8,
                max_radius=12, min_roundness=0.3, min_dist=8)


def plane(seed: int, shape=(200, 240)) -> np.ndarray:
    """A uint16 plane of noise with beads of radius 8-12 at seeded spots."""
    from magnify_tpu_torch.utils import filled_circle_points

    rng = np.random.default_rng(seed)
    img = rng.normal(100, 5, shape).astype(np.uint16)
    for _ in range(7):
        r = int(rng.integers(8, 13))
        y = int(rng.integers(r, shape[0] - r))
        x = int(rng.integers(r, shape[1] - r))
        p = filled_circle_points(r) + [y, x]
        img[p[:, 0], p[:, 1]] = int(rng.integers(600, 1000))
    return img


CASES = {  # name: (seed, detector, scorer, min_dist)
    "dense": (0, "dense", None, 8),
    "dense_no_nms": (1, "dense", None, 0),
    "ransac_gather": (2, "ransac", "gather", 8),
    "ransac_conv": (2, "ransac", "conv", 8),
}


def run_reference(mg, path):
    out = {}
    for name, (seed, detector, scorer, min_dist) in CASES.items():
        if scorer:
            os.environ["MAGNIFY_TPU_SCORER"] = scorer
        circles, scores = mg.ops.find_circles(
            plane(seed), *ARGS[:-1], min_dist, detector=detector)
        out[f"{name}/circles"] = np.asarray(circles)
        out[f"{name}/scores"] = np.asarray(scores)
    stack = np.stack([plane(s) for s in (3, 4, 5)])
    for k, (c, s) in enumerate(mg.ops.find_circles_stack(stack, **STACK_KW,
                                                         batch=2)):
        out[f"stack/{k}/circles"] = np.asarray(c)
        out[f"stack/{k}/scores"] = np.asarray(s)
    np.savez(path, **out)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_ops_ref") / "ref.npz"
    env = dict(os.environ, MAGNIFY_TPU_SCORE_QUANT="int8", JAX_PLATFORMS="cpu",
               MAGNIFY_TPU_CACHE_DIR=os.path.join(ROOT, ".cache", "test_xla"))
    env.pop("MAGNIFY_TPU_DETECTOR", None)
    env.pop("MAGNIFY_TPU_SCORER", None)
    subprocess.run([sys.executable, os.path.abspath(__file__), str(path)],
                   env=env, cwd=ROOT, check=True, timeout=600)
    return dict(np.load(path))


@pytest.mark.parametrize("name", list(CASES))
def test_find_circles_matches_jax(reference, name, monkeypatch):
    import magnify_tpu_torch as mt

    seed, detector, scorer, min_dist = CASES[name]
    if scorer:
        monkeypatch.setenv("MAGNIFY_TPU_SCORER", scorer)
    circles, scores = mt.ops.find_circles(plane(seed), *ARGS[:-1], min_dist,
                                          detector=detector, device="cpu")
    assert circles.dtype == np.int32 and scores.dtype == np.float32
    assert len(circles) >= 5
    np.testing.assert_array_equal(circles, reference[f"{name}/circles"])
    np.testing.assert_array_equal(scores, reference[f"{name}/scores"])
    if name == "dense_no_nms":  # overlapping candidates survive
        assert len(circles) > 7


def test_find_circles_stack_matches_jax_and_single_planes(reference):
    import magnify_tpu_torch as mt

    seeds = (3, 4, 5)
    got = mt.ops.find_circles_stack(np.stack([plane(s) for s in seeds]),
                                    **STACK_KW, batch=2, device="cpu")
    assert len(got) == len(seeds)
    for k, (c, s) in enumerate(got):
        np.testing.assert_array_equal(c, reference[f"stack/{k}/circles"])
        np.testing.assert_array_equal(s, reference[f"stack/{k}/scores"])
        one = mt.ops.find_circles(plane(seeds[k]), *ARGS[:-1], ARGS[-1],
                                  detector="dense", device="cpu")
        np.testing.assert_array_equal(c, one[0])
        np.testing.assert_array_equal(s, one[1])


def test_find_circles_gui_raises():
    """A ``gui`` that is no tuning UI raises; the port's InteractiveUI runs
    headless (each stage once) and returns the result without a gui."""
    import magnify_tpu_torch as mt
    from magnify_tpu_torch.plot.vis import InteractiveUI

    with pytest.raises(AttributeError, match="run_widget"):
        mt.ops.find_circles(plane(0), *ARGS, gui=object(), device="cpu")
    ui = InteractiveUI()
    got = mt.ops.find_circles(plane(0), *ARGS, gui=ui, detector="dense",
                              device="cpu")
    want = mt.ops.find_circles(plane(0), *ARGS, detector="dense",
                               device="cpu")
    assert len(ui.sessions) == 2 and len(want[0]) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _maps_and_circles(seed, n=40, batch=None):
    rng = np.random.default_rng(seed)
    lead = () if batch is None else (batch,)
    maps = rng.normal(0, 1, lead + (5, 30, 34)).astype(np.float32)
    circles = np.stack([rng.integers(-6, 40, lead + (n,)),
                        rng.integers(-6, 44, lead + (n,)),
                        rng.integers(4, 16, lead + (n,))],
                       axis=-1).astype(np.int32)
    valid = rng.random(lead + (n,)) > 0.2
    return maps, circles, valid


def test_gather_map_scores_matches_jax():
    import jax
    import jax.numpy as jnp
    from magnify_tpu.ops import score as jscore
    from magnify_tpu_torch.ops import score as tscore

    jit = jax.jit(jscore.gather_map_scores, static_argnames=("min_radius",))
    maps, circles, valid = _maps_and_circles(0)
    want = np.asarray(jit(jnp.asarray(maps), jnp.asarray(circles),
                          jnp.asarray(valid), min_radius=6))
    got = tscore.gather_map_scores(torch.from_numpy(maps),
                                   torch.from_numpy(circles),
                                   torch.from_numpy(valid), min_radius=6)
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.isneginf(want[~valid]).all() and np.isfinite(want[valid]).all()

    maps, circles, valid = _maps_and_circles(1, batch=3)
    want = np.asarray(jax.jit(jax.vmap(
        lambda m, c, v: jscore.gather_map_scores(m, c, v, min_radius=6)))(
            jnp.asarray(maps), jnp.asarray(circles), jnp.asarray(valid)))
    got = tscore.gather_map_scores(torch.from_numpy(maps),
                                   torch.from_numpy(circles),
                                   torch.from_numpy(valid), min_radius=6)
    np.testing.assert_array_equal(got.numpy(), want)


def test_detector_and_scorer_switches(monkeypatch):
    from magnify_tpu_torch.ops import detect as tdetect

    monkeypatch.delenv("MAGNIFY_TPU_DETECTOR", raising=False)
    monkeypatch.delenv("MAGNIFY_TPU_SCORER", raising=False)
    assert [tdetect.resolve_detector(d) for d in ("auto", "dense", "ransac",
                                                  None)] == [
        "dense", "dense", "ransac", "dense"]
    assert tdetect.use_conv_scorer() is False
    with pytest.raises(ValueError):
        tdetect.resolve_detector("hough")
    monkeypatch.setenv("MAGNIFY_TPU_DETECTOR", "ransac")
    assert tdetect.resolve_detector("dense") == "ransac"
    monkeypatch.setenv("MAGNIFY_TPU_DETECTOR", "bogus")
    with pytest.raises(ValueError):
        tdetect.resolve_detector("dense")
    for mode, conv in (("conv", True), ("gather", False), ("auto", False)):
        monkeypatch.setenv("MAGNIFY_TPU_SCORER", mode)
        assert tdetect.use_conv_scorer() is conv
    monkeypatch.setenv("MAGNIFY_TPU_SCORER", "mxu")
    with pytest.raises(ValueError):
        tdetect.use_conv_scorer()


def test_public_ops_and_components_cover_the_jax_packages():
    import magnify_tpu as mg
    import magnify_tpu_torch as mt
    from magnify_tpu.core import registry as jreg
    from magnify_tpu_torch.core import registry as treg

    want = set(mg.ops.__all__) - {"prefer_host_reduction"}
    assert want <= set(mt.ops.__all__)
    for name in mt.ops.__all__:
        assert callable(getattr(mt.ops, name)), name
    assert set(jreg.components.get_all()) <= set(treg.components.get_all())
    from magnify_tpu_torch.ops.basic import fit_basic

    for fn in (mt.ops.find_circles, mt.ops.find_circles_stack,
               mt.ops.detect_best_in_rois, fit_basic,
               treg.components.get("basic_correct")):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def _image_dataset(pkg, img):
    return pkg.Dataset({"image": (("channel", "time", "im_y", "im_x"),
                                  img.copy())},
                       coords={"channel": ["a", "b"]})


def _tile_dataset(pkg, tiles):
    return pkg.Dataset({"tile": (("channel", "time", "tile_row", "tile_col",
                                  "tile_y", "tile_x"), tiles.copy())},
                       coords={"channel": ["a", "b"], "time": [0, 1]})


@pytest.mark.parametrize("name,kw", [
    ("horizontal_flip", {}),
    ("vertical_flip", {}),
    ("circle_mask", dict(center=(20, 30), diameter=31)),
    ("circle_mask", dict(center=(12, 50), diameter=20, mask_inner=True)),
])
@pytest.mark.parametrize("layout", ["image", "tile"])
def test_host_components_match_jax(name, kw, layout):
    import magnify_tpu as mg
    import magnify_tpu_torch as mt

    rng = np.random.default_rng(0)
    shape = (2, 1, 40, 56) if layout == "image" else (2, 2, 2, 2, 40, 56)
    data = rng.integers(0, 1000, shape).astype(np.uint16)
    make = _image_dataset if layout == "image" else _tile_dataset
    out = {}
    for pkg in (mg, mt):
        res = pkg.core.registry.components.get(name)(**kw)(make(pkg, data))
        out[pkg] = res[layout]
    assert out[mt].dims == out[mg].dims
    got, want = np.asarray(out[mt].values), np.asarray(out[mg].values)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("labels", [{"a": "red"}, ["x", "y"]])
def test_rename_labels_matches_jax(labels):
    import magnify_tpu as mg
    import magnify_tpu_torch as mt

    tiles = np.zeros((2, 2, 1, 1, 4, 4), np.uint16)
    out = {}
    for pkg in (mg, mt):
        ds = _tile_dataset(pkg, tiles)
        res = pkg.core.registry.components.get("rename_labels")(
            channel=labels, time=[5, 6])(ds)
        out[pkg] = (np.asarray(res.channel.values),
                    np.asarray(res.time.values))
    for got, want in zip(out[mt], out[mg]):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_stage_report_accumulates():
    import magnify_tpu_torch as mt
    from magnify_tpu_torch import diagnostics

    diagnostics.reset_stages()
    data = mt.DataArray(plane(0), dims=("y", "x"))
    mt.beads(data, min_bead_diameter=16, max_bead_diameter=24, overlap=0,
             device="cpu")
    report = diagnostics.stage_report()
    for stage in ("read", "standardize_format", "flatfield_correct",
                  "stitch", "find_beads", "drop", "restore_format"):
        assert stage in report, report.keys()
        assert report[stage]["calls"] == 1
    assert report["find_beads"]["seconds"] > 0
    diagnostics.reset_stages()
    assert diagnostics.stage_report() == {}


def test_trace_env_prints(capsys, monkeypatch):
    from magnify_tpu_torch import diagnostics

    monkeypatch.setenv("MAGNIFY_TPU_TRACE", "1")
    diagnostics.reset_stages()
    with diagnostics.stage_timer("demo"):
        pass
    out = capsys.readouterr().out
    assert "[magnify_tpu_torch] demo:" in out and out.endswith(" ms\n")
    assert diagnostics.stage_report()["demo"]["calls"] == 1
    monkeypatch.delenv("MAGNIFY_TPU_TRACE")
    with diagnostics.stage_timer("demo"):
        pass
    assert capsys.readouterr().out == ""
    assert diagnostics.stage_report()["demo"]["calls"] == 2
    diagnostics.reset_stages()


def test_profile_writes_a_chrome_trace(tmp_path):
    from magnify_tpu_torch import diagnostics

    with diagnostics.profile(str(tmp_path / "prof")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert trace["traceEvents"]
    assert any("mm" in e.key for e in prof.key_averages())


if __name__ == "__main__":
    assert os.environ.get("MAGNIFY_TPU_SCORE_QUANT") == "int8"
    sys.path.insert(0, ROOT)
    import magnify_tpu as mg

    run_reference(mg, sys.argv[1])
