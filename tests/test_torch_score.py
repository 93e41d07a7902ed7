"""The port's int8 score maps against the JAX package's, bit for bit.

Features go through ``magnify_tpu.ops.score._alignment_features(...,
qdtype="int8")`` and ``alignment_features_q8``; maps through
``score_maps(..., s2d=1, qdtype="int8")`` and the port's ``score_maps``,
whose correlation on the CPU is the float64 plain twin of the CUDA kernel.
``qdtype`` is passed explicitly, so no environment variable is involved.
The JAX functions run under ``jax.jit``, as the detector runs them: XLA
then fuses the harmonic recurrence into FMAs, which the port reproduces.
Tolerance: exact (int8 features, exact int32 accumulation, one f32
multiply).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magnify_tpu.ops import edge as jedge
from magnify_tpu.ops import score as jscore
from magnify_tpu_torch.ops import detect as tdetect
from magnify_tpu_torch.ops import score as tscore
from tests.synth import draw_beads

MIN_R, MAX_R = 5, 8


# One intra-op thread per test process: the suite runs several pytest
# workers at once, and oversubscribed torch thread pools spin for the cores
# the others need.
torch.set_num_threads(1)


@jax.jit
def _jax_features(edges, dx, dy):
    return jscore._alignment_features(None, edges, grads=(dx, dy),
                                      qdtype="int8")


@jax.jit
def _jax_maps(edges, dx, dy):
    return jscore.score_maps(None, edges, min_radius=MIN_R,
                             max_radius=MAX_R, s2d=1, grads=(dx, dy),
                             qdtype="int8")


@pytest.fixture(scope="module")
def planes():
    """Padded (edges, dx, dy) of a ~128^2 bead fixture, as numpy."""
    rng = np.random.default_rng(11)
    shape = (128 - 4 * MAX_R, 128 - 4 * MAX_R)
    pos = [[20, 20], [24, 70], [70, 30], [66, 74]]
    img = draw_beads(shape, pos, diameters=[10, 12, 14, 16])
    img = img + rng.normal(100, 5, shape).astype(np.uint16)
    u8 = tdetect.normalize_planes_u8(img[None])[0]
    edges, dx, dy, _ = jedge.edge_pipeline(jnp.asarray(u8), 0.1, 0.9,
                                           normalized=True)
    pad = 2 * MAX_R
    return tuple(np.pad(np.asarray(a), pad) for a in (edges, dx, dy))


def _t(a):
    return torch.as_tensor(np.array(a))


def test_int8_features_match(planes):
    edges, dx, dy = planes
    want = np.asarray(_jax_features(edges, dx, dy))
    got = tscore.alignment_features_q8(_t(edges), _t(dx), _t(dy))
    assert got.dtype == torch.int8 and got.shape == (8,) + edges.shape
    np.testing.assert_array_equal(want, got.numpy())


def test_random_gradient_features_match():
    """Integer Scharr-range gradients on a 512^2 plane: enough pixels that
    two-rounding arithmetic would flip int8 features (it flips ~85 of
    ~29M on the 1844^2 smoke frame B)."""
    rng = np.random.default_rng(1)
    dx = rng.integers(-4080, 4081, (512, 512)).astype(np.float32)
    dy = rng.integers(-4080, 4081, (512, 512)).astype(np.float32)
    dx[::7, ::5] = 0.0
    dy[::7, ::5] = 0.0  # zero gradients take the (1, 0) branch
    edges = np.ones((512, 512), bool)
    want = np.asarray(_jax_features(edges, dx, dy))
    got = tscore.alignment_features_q8(_t(edges), _t(dx), _t(dy))
    np.testing.assert_array_equal(want, got.numpy())


def test_cpu_features_take_the_torch_route(monkeypatch):
    """CPU tensors take the torch chain: their pixels are counted in
    ``features_q8_host_px``, none on the device, the kernel is never
    launched, and the call is one span ``score.features_q8`` with no
    device interval."""
    from magnify_tpu_torch import diagnostics

    rng = np.random.default_rng(2)
    edges = _t(rng.random((2, 20, 24)) < 0.5)
    dx = _t(rng.integers(-4080, 4081, (2, 20, 24)).astype(np.float32))
    dy = _t(rng.integers(-4080, 4081, (2, 20, 24)).astype(np.float32))
    monkeypatch.setenv("MAGNIFY_TPU_TRACE", "1")
    diagnostics.reset_stages()
    before = tscore.features_q8_launches
    got = tscore.alignment_features_q8(edges, dx, dy)
    counters, report = diagnostics.counter_report(), diagnostics.span_report()
    diagnostics.reset_stages()
    assert counters == {"features_q8_host_px": 2 * 20 * 24}
    assert tscore.features_q8_launches == before
    assert report["score.features_q8"]["calls"] == 1
    assert report["score.features_q8"]["device_seconds"] is None
    assert torch.equal(got, tscore.alignment_features_q8_plain(edges, dx, dy))
    with pytest.raises(ValueError):
        tscore.features_q8(edges, dx, dy)


def test_int8_score_maps_match(planes):
    edges, dx, dy = planes
    want = np.asarray(_jax_maps(edges, dx, dy))
    got = tscore.score_maps(_t(edges), _t(dx), _t(dy), min_radius=MIN_R,
                            max_radius=MAX_R)
    assert got.dtype == torch.float32
    assert got.shape == (MAX_R - MIN_R + 1,) + edges.shape
    np.testing.assert_array_equal(want, got.numpy())
    assert (want >= 0.3).any()  # the fixture's beads score


def test_ring_corr_plain_is_the_exact_int32_correlation():
    """The plain twin against a direct int64 sum over the taps."""
    rng = np.random.default_rng(9)
    feats = rng.integers(-127, 128, (8, 40, 52)).astype(np.int8)
    q, _ = tscore._ring_conv_kernel_q8(3, 6)
    weights = tscore.ring_weights(q, "cpu")
    got = tscore.ring_corr(_t(feats), weights).numpy()
    k = q.shape[-1]
    rad = k // 2
    fp = np.pad(feats.astype(np.int64), ((0, 0), (rad, rad), (rad, rad)))
    want = np.zeros((q.shape[0],) + feats.shape[1:], np.int64)
    for r, c, i, j in zip(*np.nonzero(q)):
        want[r] += int(q[r, c, i, j]) * fp[c, i:i + feats.shape[1],
                                           j:j + feats.shape[2]]
    assert got.dtype == np.int32
    np.testing.assert_array_equal(want, got)


def _unpack(table, offsets, shape):
    """The dense (n_radii, 8, K, K) int8 kernel a position table holds."""
    dense = np.zeros(shape, np.int8)
    for r in range(shape[0]):
        rows = table[offsets[r]:offsets[r + 1]]
        w = rows[:, 1:3].copy().view(np.int8)  # (n, 8): channel c in byte c
        dense[r, :, rows[:, 0] & 0xFFFF, rows[:, 0] >> 16] = w
    return dense


@pytest.mark.parametrize("radii", [(2, 3), (5, 8), (8, 12), (5, 25)])
def test_position_table_unpacks_to_the_ring_kernel(radii):
    q, _ = tscore._ring_conv_kernel_q8(*radii)
    table, offsets = tscore.pack_positions(q)
    assert table.dtype == np.int32 and table.shape == (offsets[-1], 4)
    np.testing.assert_array_equal(table[:, 3],
                                  np.repeat(np.arange(q.shape[0]),
                                            np.diff(offsets)))
    np.testing.assert_array_equal(_unpack(table, offsets, q.shape), q)


@pytest.mark.parametrize("radii", [(2, 3), (5, 8), (8, 12), (5, 25)])
def test_position_table_evaluates_to_ring_corr_plain(radii):
    """The kernel's arithmetic on the CPU: per position, the 8 channel
    weights from the two packed words times the shifted feature planes,
    summed in int64 into the position's radius."""
    rng = np.random.default_rng(17)
    feats = rng.integers(-128, 128, (8, 70, 93)).astype(np.int8)
    q, _ = tscore._ring_conv_kernel_q8(*radii)
    table, _ = tscore.pack_positions(q)
    rad = q.shape[-1] // 2
    h, w = feats.shape[1:]
    fp = np.pad(feats.astype(np.int64), ((0, 0), (rad, rad), (rad, rad)))
    got = np.zeros((q.shape[0], h, w), np.int64)
    for ij, w_lo, w_hi, r in table:
        i, j = ij & 0xFFFF, ij >> 16
        wc = np.array([w_lo, w_hi], np.int32).view(np.int8)
        got[r] += np.tensordot(wc.astype(np.int64), fp[:, i:i + h, j:j + w],
                               axes=1)
    want = tscore.ring_corr_plain(_t(feats), tscore.ring_weights(q, "cpu"))
    np.testing.assert_array_equal(got, want.numpy())


# ----------------------------------------------------------------------
# A batch of planes and the chip's radii
# ----------------------------------------------------------------------

def test_batched_score_maps_match_per_plane_and_jax():
    """(N, Hp, Wp) through one correlation == plane by plane == the JAX
    package's leading-batch ``score_maps`` (int8, unfolded). Exact."""
    rng = np.random.default_rng(13)
    n, h, w = 4, 40, 44
    pad = 2 * MAX_R
    edges = np.zeros((n, h + 2 * pad, w + 2 * pad), bool)
    dx = np.zeros(edges.shape, np.float32)
    dy = np.zeros(edges.shape, np.float32)
    edges[:, pad:-pad, pad:-pad] = rng.random((n, h, w)) < 0.15
    dx[:, pad:-pad, pad:-pad] = rng.integers(-4080, 4081, (n, h, w))
    dy[:, pad:-pad, pad:-pad] = rng.integers(-4080, 4081, (n, h, w))
    edges[2] = False  # a plane without edges scores 0 everywhere
    want = np.asarray(_jax_maps(edges, dx, dy))
    got = tscore.score_maps(_t(edges), _t(dx), _t(dy), min_radius=MIN_R,
                            max_radius=MAX_R)
    assert got.shape == (n, MAX_R - MIN_R + 1) + edges.shape[1:]
    np.testing.assert_array_equal(want, got.numpy())
    for k in range(n):
        one = tscore.score_maps(_t(edges[k]), _t(dx[k]), _t(dy[k]),
                                min_radius=MIN_R, max_radius=MAX_R)
        assert torch.equal(one, got[k])
    assert not got[2].any()
    feats = tscore.alignment_features_q8(_t(edges), _t(dx), _t(dy))
    assert feats.shape == (n, 8) + edges.shape[1:]


@pytest.mark.parametrize("radii,n_pos", [((4, 15), 668), ((8, 16), 628)])
def test_chip_radii_fit_the_kernel(radii, n_pos):
    """The position table at the chip's radii (default diameters 8-30 give
    radii 4-15; the 8 x 8 parity frame's 16-32 give 8-16): its size, the
    int32 exactness bound 127 * sum|w| < 2^24 per radius, no position shared
    by two radii, and the kernel's shared memory (position entries plus a
    (32 + 2 halo) x (64 + 2 halo) tile of 8-byte pixels, halo 16) under one
    CTA's 227 KB."""
    q, _ = tscore._ring_conv_kernel_q8(*radii)
    table, offsets = tscore.pack_positions(q)
    assert offsets[-1] == len(table) == n_pos
    assert len(set(table[:, 0].tolist())) == len(table)
    assert 127 * np.abs(q.astype(np.int64)).sum(axis=(1, 2, 3)).max() < 2**24
    assert radii[1] <= 16
    assert 16 * n_pos + 8 * (32 + 32) * (64 + 32) <= tscore._MAX_SMEM
    np.testing.assert_array_equal(_unpack(table, offsets, q.shape), q)
