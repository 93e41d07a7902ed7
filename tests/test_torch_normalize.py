"""The dense finders' uint8 search planes made on the device, on the CPU.

``ops.edge.normalize_u8`` (the CUDA kernel ``csrc/normalize_u8.cu`` on a
card, its plain twin here) against the host's
``ops.detect.normalize_planes_u8``, bit for bit, on the planes of
:data:`PLANES`; then the finders' route: uint16 search planes go to the
device raw (2 bytes a pixel, counted in ``normalize_u8_device_planes``),
float32 ones, and every plane under a mesh, are normalized on the host
(``normalize_u8_host_planes``), and both give the same marks and masks.
test_torch_cuda holds the kernel to the twin on the same planes.
"""

import numpy as np
import pytest
import torch

from magnify_tpu_torch import diagnostics
from magnify_tpu_torch.ops import detect as tdetect
from magnify_tpu_torch.ops import edge as tedge

torch.set_num_threads(1)


def _exact_integers():
    # Peaks 255, 51 and 510: 255 * x / peak is x, 5x and x / 2, exact.
    ramp = np.arange(16 * 32).reshape(16, 32)
    return np.stack([1000 + ramp % (peak + 1) for peak in (255, 51, 510)])


def _random(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 65536, shape)


def _dim(shape, seed=1):
    rng = np.random.default_rng(seed)
    plane = rng.normal(100, 5, shape).clip(0)
    plane[rng.random(shape) < 0.01] = 9000
    return plane


def _extremes():
    plane = _random((6, 11), seed=2)
    plane[0, 0], plane[-1, -1], plane[2, 3] = 0, 65535, 65535
    return plane


def _two_ranges():
    rng = np.random.default_rng(3)
    return np.stack([rng.integers(100, 601, (12, 20)),
                     rng.integers(30000, 65536, (12, 20))])


#: uint16 planes, (H, W) or (N, H, W), each a case of the kernel's.
PLANES = {
    "constant": lambda: np.full((5, 9), 1234),
    "extremes": _extremes,
    "exact_integers": _exact_integers,
    "random": lambda: _random((2, 37, 45)),
    "random_dim": lambda: _dim((40, 52)),
    "width_1": lambda: _random((13, 1)),
    "width_7": lambda: _random((3, 11, 7)),
    "width_8": lambda: _random((9, 8)),
    "width_6755": lambda: _dim((3, 6755)),
    "two_planes_two_ranges": _two_ranges,
}


def plane(case: str) -> np.ndarray:
    return np.ascontiguousarray(PLANES[case]().astype(np.uint16))


@pytest.mark.parametrize("case", sorted(PLANES))
def test_normalize_u8_twin_equals_the_host(case):
    raw = plane(case)
    got = tedge.normalize_u8(torch.from_numpy(raw))
    assert got.dtype == torch.uint8 and got.shape == raw.shape
    np.testing.assert_array_equal(got.numpy(),
                                  tdetect.normalize_planes_u8(raw))


def test_normalize_u8_refuses_other_dtypes():
    with pytest.raises(TypeError):
        tedge.normalize_u8(torch.zeros((4, 4), dtype=torch.float32))


@pytest.fixture
def traced(monkeypatch):
    monkeypatch.setenv("MAGNIFY_TPU_TRACE", "1")
    diagnostics.reset_stages()
    yield
    diagnostics.reset_stages()


def _draw(img, centers, radius, value):
    from magnify_tpu_torch.utils import filled_circle_points

    pts = filled_circle_points(radius)
    for y, x in centers:
        img[..., pts[:, 0] + y, pts[:, 1] + x] = value


def _by_dtype(run, img):
    """``run`` on ``img`` as uint16 and as float32 (the same values), each
    traced on its own: {dtype: (result, counters)}."""
    out = {}
    for dtype in (np.uint16, np.float32):
        diagnostics.reset_stages()
        out[dtype] = run(img.astype(dtype)), diagnostics.counter_report()
    return out


def _same_marks(a, b, names):
    for name in names:
        np.testing.assert_array_equal(np.asarray(a[name].values),
                                      np.asarray(b[name].values), name)


def _bead_frame():
    rng = np.random.default_rng(5)
    img = rng.normal(100, 4, (2, 96, 96)).astype(np.uint16)
    _draw(img[0], [(30, 30), (60, 64)], 6, 2000)
    _draw(img[1], [(30, 62)], 6, 2000)
    return img


def _run_beads(a):
    import magnify_tpu_torch as mt

    return mt.beads(mt.DataArray(a, dims=("channel", "y", "x"),
                                 coords={"channel": ["a", "b"]}),
                    min_bead_diameter=10, max_bead_diameter=14, overlap=0,
                    device="cpu")


def _chip_frame():
    rng = np.random.default_rng(3)
    img = rng.normal(100, 4, (240, 240)).astype(np.uint16)
    _draw(img, [(80, 80), (80, 160), (160, 80), (160, 160)], 7, 1000)
    return img


def _run_chip(a):
    import magnify_tpu_torch as mt

    return mt.microfluidic_chip(
        mt.DataArray(a, dims=("y", "x")), shape=(2, 2), row_dist=80,
        col_dist=80, min_button_diameter=10, max_button_diameter=18,
        chamber_diameter=40, overlap=0, device="cpu")


def test_bead_finder_routes_uint16_planes_to_the_device(traced):
    out = _by_dtype(_run_beads, _bead_frame())
    (xu, cu), (xf, cf) = out[np.uint16], out[np.float32]
    # Two raw uint16 search planes, 2 bytes a pixel; the float32 frame's
    # two uint8 planes, 1 byte a pixel.
    # The CPU finder's ownership masks of its 3 marks take the host's route.
    assert cu == {"upload_bytes": 2 * 2 * 96 * 96,
                  "normalize_u8_device_planes": 2,
                  "ownership_host_windows": 3}
    assert cf == {"upload_bytes": 2 * 96 * 96, "normalize_u8_host_planes": 2,
                  "ownership_host_windows": 3}
    assert xu.sizes["mark"] == 3
    _same_marks(xu, xf, ("x", "y", "fg", "bg"))


def test_chip_finder_routes_uint16_planes_to_the_device(traced):
    out = _by_dtype(_run_chip, _chip_frame())
    (xu, cu), (xf, cf) = out[np.uint16], out[np.float32]
    # One search plane, and the grid fit's f32 points per row and column.
    assert cu == {"upload_bytes": 2 * 240 * 240 + 4 * 4,
                  "normalize_u8_device_planes": 1}
    assert cf == {"upload_bytes": 240 * 240 + 4 * 4,
                  "normalize_u8_host_planes": 1}
    _same_marks(xu, xf, ("x", "y", "fg", "bg", "valid"))


#: finder: (frame, run, search planes, the marks compared)
FINDERS = {
    "beads": (_bead_frame, _run_beads, 2, ("x", "y", "fg", "bg")),
    "chip": (_chip_frame, _run_chip, 1, ("x", "y", "fg", "bg", "valid")),
}


@pytest.mark.parametrize("finder", sorted(FINDERS))
def test_finders_normalize_on_the_host_under_a_mesh(traced, finder):
    """Under a mesh of two devices uint16 search planes are normalized on
    the host, as before the card's route, with the marks of one device."""
    from magnify_tpu_torch.parallel import make_mesh, use_mesh

    frame, run, n_planes, names = FINDERS[finder]
    img = frame()
    want = run(img)
    diagnostics.reset_stages()
    with use_mesh(make_mesh(1, 2, devices=["cpu"] * 2)):
        got = run(img)
    counters = diagnostics.counter_report()
    assert counters["normalize_u8_host_planes"] == n_planes
    assert "normalize_u8_device_planes" not in counters
    _same_marks(got, want, names)
