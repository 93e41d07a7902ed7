"""The bead ownership masks on the CPU route, against the JAX package.

``components.find._bead_ownership`` (the windows, and the masks of
``ops.geom.bead_ownership``, whose CPU branch is the host's numpy pass)
against ``magnify_tpu.components.find._bead_ownership_host``, bit for bit,
on the layouts of :data:`LAYOUTS`; then the finder's route: a CPU finder
counts its windows in ``ownership_host_windows``. test_torch_cuda holds
the CUDA kernel to this CPU route.
"""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from chip_smoke import cell_marks  # noqa: E402
from magnify_tpu.components import find as jfind  # noqa: E402
from magnify_tpu_torch import diagnostics  # noqa: E402
from magnify_tpu_torch.components import find  # noqa: E402
from magnify_tpu_torch.ops import geom  # noqa: E402

torch.set_num_threads(1)


def cluster_marks(seed, n, lo, hi, radii=(0, 20)):
    """``n`` overlapping disks with centres in [lo, hi)^2."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(lo, hi, n), rng.integers(lo, hi, n),
                     rng.integers(radii[0], radii[1] + 1, n)], 1)


#: name: (marks, h, w, roi_length, max_radius).
LAYOUTS = {
    "cell_grid": lambda: (cell_marks(0, 512), 512, 512, 60, 15),
    "dense_cluster": lambda: (cluster_marks(1, 80, 110, 150), 256, 256, 60,
                              15),
    "four_edges": lambda: (np.array([[0, 0, 9], [255, 3, 12], [2, 255, 15],
                                     [255, 255, 7], [128, 0, 11],
                                     [0, 128, 11], [255, 128, 4],
                                     [128, 255, 15]]), 256, 256, 60, 15),
    "n0": lambda: (np.zeros((0, 3)), 256, 256, 60, 15),
    "n1": lambda: (np.array([[100, 140, 12]]), 256, 256, 60, 15),
    "radius_0": lambda: (np.array([[100, 100, 0], [101, 100, 0],
                                   [130, 120, 6]]), 256, 256, 60, 15),
    "radius_above_max": lambda: (np.array([[100, 100, 40], [110, 125, 16],
                                           [140, 90, -3]]), 256, 256, 60,
                                 15),
    "odd_roi_length": lambda: (cluster_marks(2, 30, 20, 230, (3, 12)), 256,
                               320, 33, 9),
}


def layout(name):
    marks, h, w, L, max_radius = LAYOUTS[name]()
    return np.asarray(marks, np.int32).reshape(-1, 3), h, w, L, max_radius


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_ownership_twin_equals_the_host(name):
    """The finder's helper and the wrapper's CPU branch give the JAX
    package's windows and masks."""
    marks, h, w, L, max_radius = layout(name)
    want = jfind._bead_ownership_host(marks, h, w, L, max_radius)
    got = find._bead_ownership(marks, h, w, L, max_radius, "cpu")
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g, w_)
    masks = geom.bead_ownership(
        *(torch.from_numpy(np.ascontiguousarray(a, np.int32))
          for a in (marks, want[2], want[3])), L, max_radius)
    assert masks.dtype == torch.uint8 and masks.shape == (2, len(marks), L, L)
    np.testing.assert_array_equal(masks.numpy().view(bool),
                                  np.stack(want[:2]))


def test_cpu_finder_counts_host_windows(monkeypatch):
    """A CPU finder's masks (``_assemble`` calls ``_bead_finalize_host`` with
    the finder's device) take the host's route: the JAX package's masks and
    windows, every window counted in ``ownership_host_windows``."""
    monkeypatch.setenv("MAGNIFY_TPU_TRACE", "1")
    diagnostics.reset_stages()
    marks, h, w, L, max_radius = layout("cell_grid")
    finder = find.BeadFinder(
        min_bead_diameter=10, max_bead_diameter=30, low_edge_quantile=0.5,
        high_edge_quantile=0.9, num_iter=1, min_roundness=0.3, roi_length=L,
        search_channel=None, interactive=False, device="cpu")
    image = np.zeros((1, 1, h, w), np.uint16)
    got = find._bead_finalize_host(image, marks, L, max_radius,
                                   device=finder.device)
    want = jfind._bead_ownership_host(marks, h, w, L, max_radius)
    for g, w_ in zip(got[:2] + got[3:], want):
        np.testing.assert_array_equal(g, w_)
    assert diagnostics.counter_report() == {
        "ownership_host_windows": len(marks)}
    assert [r.name for r in diagnostics.spans()] == ["beads.ownership"]
    diagnostics.reset_stages()


def test_ownership_refuses_bad_inputs():
    marks = torch.zeros((2, 3), dtype=torch.int32)
    corner = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(TypeError):
        geom.bead_ownership(marks.long(), corner, corner, 8, 3)
    with pytest.raises(ValueError):
        geom.bead_ownership(marks, corner[:1], corner, 8, 3)
    with pytest.raises(ValueError):
        geom.bead_ownership(marks, corner, corner, 0, 3)
