"""The port's plot sublibrary (``magnify_tpu_torch.plot``) on the Agg
backend, against the JAX package's.

The port's copies of ``imshow``, ``roishow`` and ``mrbles_clusters`` draw
the same image data into their artists as the JAX package's on the same
dataset (each package's ``Dataset`` built from one set of arrays, a port
``beads`` result); ``roi_to_image_labels`` and ``categorical_colors`` are
equal array for array; the tuning UI's sessions re-run on a change of
parameter; headless ``find_circles(gui=InteractiveUI())``, ``beads(...,
interactive=True)`` and ``microfluidic_chip(..., interactive=True)``
return what the calls without the UI return (the chip's refined chambers
exactly, its blank ones within the grid fit's tolerance, as the UI takes
the JAX package's unfused path with its float64 grid fit); and the package
imports without matplotlib, its plots then raising ImportError.
"""

import os
import subprocess
import sys

import matplotlib

matplotlib.use("Agg")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import magnify_tpu as mg  # noqa: E402
import magnify_tpu_torch as mt  # noqa: E402
from magnify_tpu import plot as jplot  # noqa: E402
from magnify_tpu_torch import plot as tplot  # noqa: E402

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import test_torch_chip as tchip  # noqa: E402
import test_torch_slice as tslice  # noqa: E402

torch.set_num_threads(1)

FIND_ARGS = (0.1, 0.9, 20, 2000, 8, 12, 0.3, 8)


def draw(shape, positions, radius=10, value=1000):
    from magnify_tpu_torch.utils import filled_circle_points

    img = np.zeros(shape, np.uint16)
    pts = filled_circle_points(radius)
    for r, c in positions:
        img[pts[:, 0] + r, pts[:, 1] + c] = value
    return img


@pytest.fixture(scope="module")
def bead_result():
    data = mt.DataArray(draw((384, 384), [[120, 120], [260, 230]]),
                        dims=("y", "x"))
    return mt.beads(data, min_bead_diameter=16, max_bead_diameter=24,
                    overlap=0, drop_tiles=True, device="cpu")


def as_package(xp, pkg):
    """The same dataset in ``pkg``'s data model."""
    def var(name):
        return (xp[name].dims, np.asarray(xp[name].values))

    return pkg.Dataset({k: var(k) for k in xp.data_vars},
                       coords={k: var(k) for k in xp.coords})


def mrbles_dataset(pkg, n_codes=3, seed=0):
    rng = np.random.default_rng(seed)
    n = 20 * n_codes
    ratios = np.column_stack([
        np.ones(n),
        np.repeat(rng.uniform(0, 3, n_codes), 20) + rng.normal(0, 0.02, n),
        np.repeat(rng.uniform(0, 3, n_codes), 20) + rng.normal(0, 0.02, n),
        np.repeat(rng.uniform(0, 3, n_codes), 20) + rng.normal(0, 0.02, n)])
    tags = np.repeat(np.array([f"code{i:02d}" for i in range(n_codes)],
                              dtype="<U8"), 20)
    tags[-5:] = "outlier"
    return pkg.Dataset({"ln_ratio": (("mark", "ln"), ratios)},
                       coords={"tag": (("mark",), tags),
                               "ln": (("ln",),
                                      np.array(["eu", "dy", "sm", "tm"]))})


# ----------------------------------------------------------------------
# The figures against the JAX package's
# ----------------------------------------------------------------------

def test_imshow_draws_the_jax_packages_images(bead_result):
    """Base plane, bg and fg overlays and ROI boxes: the same arrays and
    patches in both packages' figures."""
    fig = tplot.imshow(bead_result, show=False)
    ref = jplot.imshow(as_package(bead_result, mg), show=False)
    ax, rax = fig.magnify_viewer.ax, ref.magnify_viewer.ax
    assert len(ax.images) >= 3 and len(ax.images) == len(rax.images)
    for a, b in zip(ax.images, rax.images):
        np.testing.assert_array_equal(np.ma.getdata(a.get_array()),
                                      np.ma.getdata(b.get_array()))
        np.testing.assert_array_equal(np.ma.getmaskarray(a.get_array()),
                                      np.ma.getmaskarray(b.get_array()))
    assert len(ax.patches) == len(rax.patches) == 2
    assert ax.get_title() == rax.get_title()


def test_roishow_draws_the_jax_packages_rois(bead_result):
    fig = tplot.roishow(bead_result, show=False)
    ref = jplot.roishow(as_package(bead_result, mg), show=False)
    filled = [ax for ax in fig.axes if ax.images]
    want = [ax for ax in ref.axes if ax.images]
    assert len(filled) == len(want) == 2
    for a, b in zip(filled, want):
        np.testing.assert_array_equal(a.images[0].get_array(),
                                      b.images[0].get_array())
        assert len(a.collections) >= 2  # fg and bg contours


@pytest.mark.parametrize("kw", [{}, {"x": "dy", "y": "tm"},
                                {"exclude_outliers": False}])
def test_mrbles_clusters_scatters_the_jax_packages_points(kw):
    fig = tplot.mrbles_clusters(mrbles_dataset(mt), show=False, **kw)
    ref = jplot.mrbles_clusters(mrbles_dataset(mg), show=False, **kw)
    got, want = fig.axes[0].collections, ref.axes[0].collections
    assert len(got) == len(want) >= 3
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.get_offsets(), b.get_offsets())
        np.testing.assert_array_equal(a.get_facecolor(), b.get_facecolor())
    labels = [t.get_text() for t in fig.axes[0].get_legend().get_texts()]
    assert ("outlier" in labels) == (kw == {"exclude_outliers": False})
    assert tplot.mrbles_clusters(mrbles_dataset(mt), z="tm",
                                 show=False) is not None
    with pytest.raises(ValueError, match="unknown lanthanide"):
        tplot.mrbles_clusters(mrbles_dataset(mt), x="pm", show=False)


def test_roi_to_image_labels_and_palette_equal_the_jax_packages():
    from magnify_tpu.plot.image import roi_to_image_labels as jlabels
    from magnify_tpu.plot.mrbles import categorical_colors as jcolors
    from magnify_tpu_torch.plot.image import roi_to_image_labels
    from magnify_tpu_torch.plot.mrbles import categorical_colors

    rng = np.random.default_rng(4)
    masks = rng.random((5, 2, 6, 6)) < 0.5
    boxes = np.stack([[[r, r + 6, c, c + 6]] * 2 for r, c in
                      rng.integers(0, 10, (5, 2))])
    np.testing.assert_array_equal(roi_to_image_labels(masks, boxes, (16, 16)),
                                  jlabels(masks, boxes, (16, 16)))
    for n in (5, 274, 300):
        np.testing.assert_array_equal(categorical_colors(n), jcolors(n))


# ----------------------------------------------------------------------
# The tuning UI
# ----------------------------------------------------------------------

def test_interactive_ui_headless_and_session_manual_run():
    from magnify_tpu_torch.plot.vis import InteractiveUI, TuningSession

    ui = InteractiveUI()
    assert not ui.interactive  # Agg
    out = ui.run_widget(lambda: [(np.zeros((4, 4)), {"name": "x"})])
    assert out[0][1]["name"] == "x" and ui.last_result is out
    seen = []

    def stage(alpha: float = 0.5):
        seen.append(alpha)
        return [(np.zeros((2, 2)), {})]

    s = TuningSession(stage, auto_call=False)
    s.run()
    s.set_param("alpha", 0.9)  # no auto_call: does not re-run
    assert seen == [0.5]
    s.run()
    assert seen == [0.5, 0.9]


def test_find_circles_with_the_ui_equals_without():
    """Headless, the two stages run once each: the edge stage shows the
    live edge map and the result is find_circles' without the UI; changing
    a parameter re-runs the stage."""
    from magnify_tpu_torch.plot.vis import InteractiveUI

    rng = np.random.default_rng(5)
    img = (draw((256, 256), [[80, 80], [180, 180]])
           + rng.normal(0, 4, (256, 256))).astype(np.float32)
    ui = InteractiveUI()
    got = mt.ops.find_circles(img, *FIND_ARGS, gui=ui, device="cpu")
    want = mt.ops.find_circles(img, *FIND_ARGS, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert len(got[0]) == 2
    edge_stage, filter_stage = ui.sessions
    edges_before = edge_stage.result[1][0]
    assert edge_stage.result[1][1]["name"] == "Edges"
    assert edges_before.shape == img.shape and edges_before.any()
    layers = edge_stage.set_param("high_edge_quantile", 0.999)
    assert layers[1][0].sum() < edges_before.sum()
    calls = filter_stage.calls
    assert len(filter_stage.set_param("min_roundness", 0.99)[1][0]) == 0
    assert len(filter_stage.set_param("min_roundness", 0.3)[1][0]) == 2
    assert filter_stage.calls == calls + 2
    with pytest.raises(KeyError):
        filter_stage.set_param("not_a_param", 1)


def test_gui_loop_builds_widgets(monkeypatch):
    """The matplotlib widget loop builds its controls and ends when the
    window closes (plt.pause closes it here)."""
    from typing import Literal

    import matplotlib.pyplot as plt

    from magnify_tpu_torch.plot.vis import (InteractiveUI, _widget_layout,
                                            _widget_spec)

    ui = InteractiveUI()
    ui.interactive = True
    monkeypatch.setattr(plt, "pause", lambda _dt: plt.close("all"))

    def stage(threshold: float = 0.4, radius: int = 8, flag: bool = False,
              mode: Literal["dense", "ransac"] = "dense",
              label: str = "beads"):
        return [(np.full((8, 8), threshold), {"name": "img"}),
                (np.array([[4.0, 4.0]]), {"size": 2 * radius}, "points")]

    out = ui.run_widget(stage, auto_call=True, last=True)
    assert out[0][1]["name"] == "img" and not plt.get_fignums()
    assert _widget_spec(stage, "flag", False) == ("checkbox", None)
    assert _widget_spec(stage, "mode", "dense") == (
        "choice", (["dense", "ransac"], ["dense", "ransac"]))
    assert _widget_spec(stage, "label", "beads") == ("text", None)
    assert _widget_spec(stage, "radius", 8)[0] == "slider"
    boxes, _h = _widget_layout([("m", "a", "choice", (["a", "b", "c"], [])),
                                ("q", 0.3, "slider", (0.0, 1.0, None))])
    assert boxes[1][0] > boxes[0][0] + boxes[0][1]


@pytest.mark.parametrize("case", ["two_channel", "mrbles"])
def test_interactive_beads_equal_non_interactive(case):
    want = tslice.flatten(tslice.run_case(mt, case, device="cpu"), case)
    got = tslice.flatten(tslice.run_case(mt, case, device="cpu",
                                         interactive=True), case)
    assert sorted(got) == sorted(want)
    for key, val in want.items():
        np.testing.assert_array_equal(got[key], val, err_msg=key)


@pytest.mark.parametrize("case", ["2x2", "3x3_blanks"])
def test_interactive_chip_equals_non_interactive(case):
    """The UI takes find_centers and find_rois: the refined chambers and
    every crop and mask equal the fused timestep's; a blank chamber keeps
    its float64 grid intersection, within GRID_ATOL of the fused f32 one."""
    want = tslice.flatten(tchip.run_case(mt, case, device="cpu"), case)
    got = tslice.flatten(tchip.run_case(mt, case, device="cpu",
                                        interactive=True), case)
    assert sorted(got) == sorted(want)
    tag = got[f"{case}/tag"]
    for key, val in want.items():
        if key in (f"{case}/x", f"{case}/y"):
            refined = np.broadcast_to(tag != "", val.shape)
            np.testing.assert_array_equal(got[key][refined], val[refined])
            np.testing.assert_allclose(got[key][~refined], val[~refined],
                                       rtol=0, atol=tchip.GRID_ATOL)
        else:
            np.testing.assert_array_equal(got[key], val, err_msg=key)


def test_import_without_matplotlib():
    """With matplotlib hidden the package imports (its style is a no-op)
    and each plot raises ImportError naming matplotlib."""
    code = (
        "import sys\n"
        "sys.modules['matplotlib'] = None\n"
        "sys.modules['matplotlib.pyplot'] = None\n"
        "import numpy as np\n"
        "import magnify_tpu_torch as mt\n"
        "from magnify_tpu_torch import plot\n"
        "from magnify_tpu_torch.plot import vis\n"
        "plot.set_style()\n"
        "assert not vis.InteractiveUI().interactive\n"
        "for fn in (plot.imshow, plot.roishow, plot.mrbles_clusters):\n"
        "    try:\n"
        "        fn(None, show=False)\n"
        "    except ImportError as e:\n"
        "        assert 'matplotlib' in str(e), e\n"
        "    else:\n"
        "        raise AssertionError(fn)\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)
