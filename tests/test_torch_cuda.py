"""The port's CUDA kernels and its ``beads`` on the card (marker ``cuda``).

Each kernel against its plain twin, bit for bit, at small shapes that
stress the tiling (tile borders, ragged edges, chains across many tiles),
and ``beads(device="cuda")`` against ``beads(device="cpu")`` on the
end-to-end fixtures of test_torch_slice. Without a CUDA device every test
skips. On a machine with one (and no JAX), run:

    MAGNIFY_TPU_TEST_BACKEND=gpu python -m pytest tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from magnify_tpu_torch.ops import hysteresis as thyst
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


def test_wrappers_check_types(cuda):
    with pytest.raises(TypeError):
        thyst.hysteresis(torch.zeros((8, 8), device=cuda),
                         torch.zeros((8, 8), device=cuda))
    weights = tscore.ring_weights(tscore._ring_conv_kernel_q8(2, 3)[0], cuda)
    with pytest.raises(TypeError):
        tscore.ring_corr(torch.zeros((8, 16, 16), device=cuda), weights)


@pytest.mark.parametrize("case", ["single", "two_channel", "tiled"])
def test_beads_cuda_matches_cpu(cuda, case):
    import magnify_tpu_torch as mt
    from test_torch_slice import flatten, run_case

    got = flatten(run_case(mt, case, device="cuda"), case)
    want = flatten(run_case(mt, case, device="cpu"), case)
    assert sorted(got) == sorted(want)
    for key, val in want.items():
        np.testing.assert_array_equal(got[key], val, err_msg=key)
