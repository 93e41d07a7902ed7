"""The PyTorch port stands apart from JAX and shares the JAX package's tables.

``import magnify_tpu_torch`` must load neither jax nor magnify_tpu, and the
constant state both packages use (Bresenham rings, the disk-extent LUT, the
float and int8 ring kernels and their scales) must be array-equal: the port
builds it with copied numpy code instead of converting it.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import magnify_tpu_torch as mt
from magnify_tpu import utils as jutils
from magnify_tpu.ops import geom as jgeom
from magnify_tpu.ops import score as jscore
from magnify_tpu_torch import utils as tutils
from magnify_tpu_torch.ops import geom as tgeom
from magnify_tpu_torch.ops import hysteresis as thyst
from magnify_tpu_torch.ops import score as tscore

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))


def test_import_loads_neither_jax_nor_magnify_tpu():
    code = ("import sys, magnify_tpu_torch\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'magnify_tpu'))\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


@pytest.mark.parametrize("four_connected", [False, True])
def test_bresenham_rings_equal(four_connected):
    for r in range(0, 40):
        np.testing.assert_array_equal(
            tutils.circle_points(r, four_connected),
            jutils.circle_points(r, four_connected))
        np.testing.assert_array_equal(tutils.filled_circle_points(r),
                                      jutils.filled_circle_points(r))


def test_extent_lut_equal():
    for max_radius in (5, 12, 25):
        np.testing.assert_array_equal(tgeom.extent_lut(max_radius),
                                      jgeom.extent_lut(max_radius))


@pytest.mark.parametrize("radii", [(5, 8), (8, 12), (5, 25)])
def test_ring_kernels_equal(radii):
    np.testing.assert_array_equal(tscore._ring_conv_kernel(*radii),
                                  jscore._ring_conv_kernel(*radii))
    tq, tsc = tscore._ring_conv_kernel_q8(*radii)
    jq, jsc = jscore._ring_conv_kernel_q8(*radii)
    np.testing.assert_array_equal(tq, jq)
    np.testing.assert_array_equal(tsc, jsc)
    assert tq.dtype == np.int8 and tsc.dtype == np.float32


def test_compact_taps_round_trip():
    """The CUDA kernel's position table at the bead frame's radii: 292
    positions holding the 2,128 nonzero weights, no position shared by two
    radii, and every radius's sum of |weights| times 127 below 2^24."""
    q, _ = tscore._ring_conv_kernel_q8(8, 12)
    table, offsets = tscore.pack_positions(q)
    assert offsets[-1] == len(table) == 292
    weights = table[:, 1:3].copy().view(np.int8)
    assert np.count_nonzero(weights) == np.count_nonzero(q) == 2128
    assert len(set(table[:, 0].tolist())) == len(table)
    assert 127 * np.abs(q.astype(np.int64)).sum(axis=(1, 2, 3)).max() < 2**24


def test_wrappers_refuse_non_cpu_non_cuda_tensors():
    """No detour to the plain twins: a tensor that is not on the CPU goes
    to the kernel or raises."""
    m = torch.zeros((8, 8), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError):
        thyst.hysteresis(m, m)
    weights = tscore.ring_weights(tscore._ring_conv_kernel_q8(2, 3)[0],
                                  "meta")
    with pytest.raises(ValueError):
        tscore.ring_corr(torch.zeros((8, 16, 16), dtype=torch.int8,
                                     device="meta"), weights)


def test_unported_options_raise():
    img = mt.DataArray(np.zeros((64, 64), np.uint16), dims=("y", "x"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        mt.beads(img, detector="ransac", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        mt.beads("some/path/*.tif", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        mt.beads(img, flatfield="flat.tif", device="cpu")
