"""The port's frame streams against the port's own single-frame calls.

``beads_stream`` / ``mrbles_stream`` on ``device="cpu"``: every streamed
frame must equal ``beads`` / ``mrbles`` on that frame alone, bit for bit
and in input order, through the producer thread, detection on the calling
thread and the one-worker assembly; plus the stream's life cycle (lazy
inputs, an abandoned generator, a producer failure) and
``parallel.DevicePrefetcher``. With ``detector="ransac"`` the frames run
the single-frame path one after another, in order, with no producer thread
(one finder per stream, so a stream is all RANSAC or all dense); the test
mixes frames with and without beads. The single-frame calls themselves are held
against the JAX package in test_torch_slice.

Frames are tiny (112^2 with up to four beads; 64^2 and empty where only the
stream's life cycle is under test): the CPU twin of the ring correlation
costs ~0.1 s per 10^4 padded pixels.
"""

import io
import threading
import time

import numpy as np
import pytest
import torch

import magnify_tpu_torch as mt
from magnify_tpu_torch.parallel import streaming
from magnify_tpu_torch.utils import filled_circle_points

KW = dict(min_bead_diameter=16, max_bead_diameter=24, overlap=0,
          min_roundness=0.3, device="cpu")
SIDE = 112
SMALL = 64
VARS = ("x", "y", "roi", "fg", "bg", "valid")


# One intra-op thread per test process: the suite runs several pytest
# workers at once, and oversubscribed torch thread pools spin for the cores
# the others need.
torch.set_num_threads(1)


def _paint(img, positions, value, radius=10):
    disk = filled_circle_points(radius)
    for pos in positions:
        pts = disk + np.array(pos)
        img[..., pts[:, 0], pts[:, 1]] = value


def make_frame(seed, n_beads):
    """A small noisy frame with ``n_beads`` beads (distinct per frame so
    output order is observable)."""
    rng = np.random.default_rng(seed)
    img = rng.normal(100, 3, (SIDE, SIDE)).astype(np.float32)
    _paint(img, [(30 + 52 * (k // 2), 30 + 52 * (k % 2))
                 for k in range(n_beads)], 1000)
    return mt.DataArray(img, dims=("y", "x"))


def blank_frame(value=100):
    """A featureless 64^2 frame: no marks, a fraction of a frame's cost."""
    return mt.DataArray(np.full((SMALL, SMALL), value, np.float32),
                        dims=("y", "x"))


_single = {}


def single(seed, n_beads):
    """``beads`` on one frame alone, computed once per test run."""
    key = (seed, n_beads)
    if key not in _single:
        _single[key] = mt.beads(make_frame(seed, n_beads), **KW)
    return _single[key]


def assert_same(out, ref, variables=VARS):
    for var in variables:
        a, b = np.asarray(out[var].values), np.asarray(ref[var].values)
        assert a.dtype == b.dtype and a.shape == b.shape, var
        np.testing.assert_array_equal(a, b, err_msg=var)


def test_stream_ransac_frames_equal_single_frames():
    """RANSAC frames run serially on the calling thread, each equal to the
    single-frame call, in input order (an empty frame among them)."""
    kw = dict(KW, detector="ransac", num_iter=4000)
    frames = [make_frame(1, 3), blank_frame(), make_frame(2, 2)]
    refs = [mt.beads(f, **kw) for f in frames]
    before = set(stream_threads())
    stream = mt.beads_stream(frames, **kw)
    outs = [next(stream)]
    assert set(stream_threads()) <= before
    outs += list(stream)
    assert [o.roi.sizes["mark"] for o in outs] == [3, 0, 2]
    for out, ref in zip(outs, refs):
        assert_same(out, ref)


def stream_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("magnify-stream-producer")]


def test_stream_bit_identical_and_ordered():
    specs = list(zip(range(3), (2, 4, 1)))
    outs = list(mt.beads_stream([make_frame(*s) for s in specs], **KW))
    assert [o.roi.sizes["mark"] for o in outs] == [2, 4, 1]
    for spec, out in zip(specs, outs):
        assert_same(out, single(*spec))


@pytest.mark.parametrize("depth,pull_batch", [(1, 1), (3, 4)])
def test_stream_depths(depth, pull_batch):
    """Any depth gives the same frames; ``stream_pull_batch`` has no
    effect."""
    specs = list(zip(range(3), (2, 4, 1)))
    outs = list(mt.beads_stream([make_frame(*s) for s in specs],
                                stream_depth=depth,
                                stream_pull_batch=pull_batch, **KW))
    assert [o.roi.sizes["mark"] for o in outs] == [2, 4, 1]
    for spec, out in zip(specs, outs):
        assert_same(out, single(*spec))


def test_stream_empty_frame_mid_stream():
    empty = mt.DataArray(np.full((SIDE, SIDE), 100, np.float32),
                         dims=("y", "x"))
    outs = list(mt.beads_stream([make_frame(1, 4), empty, make_frame(2, 1)],
                                **KW))
    assert [o.roi.sizes["mark"] for o in outs] == [4, 0, 1]
    assert_same(outs[0], single(1, 4))
    assert_same(outs[1], mt.beads(empty, **KW))
    assert_same(outs[2], single(2, 1))


def test_stream_consumes_lazy_iterable_on_demand():
    """The input can be a generator; the producer runs at most
    ``stream_depth`` + 2 frames ahead of the consumer (one in its hands,
    ``depth`` + 1 queued), it does not materialize the input."""
    produced = []
    n_frames = 7

    def gen_frames():
        for s in range(n_frames):
            produced.append(s)
            yield make_frame(0, 2) if s == 0 else blank_frame(100 + s)

    gen = mt.beads_stream(gen_frames(), stream_depth=1, **KW)
    first = next(gen)
    assert_same(first, single(0, 2))
    time.sleep(0.5)  # the producer would run ahead now if nothing held it
    # One frame yielded, one in assembly or detection, then the bound above.
    assert len(produced) <= 2 + 1 + 2 < n_frames
    rest = list(gen)
    assert produced == list(range(n_frames))
    assert [o.roi.sizes["mark"] for o in rest] == [0] * (n_frames - 1)


def test_stream_abandoned_mid_iteration_frees_the_producer():
    before = len(stream_threads())
    gen = mt.beads_stream([blank_frame(100 + s) for s in range(8)],
                          stream_depth=1, **KW)
    first = next(gen)
    assert first.roi.sizes["mark"] == 0
    assert len(stream_threads()) == before + 1
    gen.close()  # must not deadlock
    deadline = time.monotonic() + 20
    while len(stream_threads()) > before and time.monotonic() < deadline:
        time.sleep(0.05)
    assert len(stream_threads()) == before


def test_stream_producer_exception_reaches_the_consumer():
    def gen_frames():
        yield make_frame(0, 2)
        yield blank_frame()
        raise OSError("frame 2 could not be read")

    outs = []
    with pytest.raises(OSError, match="frame 2 could not be read"):
        for out in mt.beads_stream(gen_frames(), **KW):
            outs.append(out)
    # The frames before the failure were delivered, in order.
    assert [o.roi.sizes["mark"] for o in outs] == [2, 0]
    # The reader runs on the producer thread too: an input it refuses (a
    # path pattern that names no file).
    with pytest.raises(FileNotFoundError, match="did not lead to any"):
        list(mt.beads_stream([blank_frame(), "frames/*.tif"], **KW))


@pytest.mark.parametrize("kwargs", [{"stream_depth": 0},
                                    {"stream_pull_batch": 0}])
def test_stream_validates_depth_and_pull_batch(kwargs):
    with pytest.raises(ValueError, match="must be >= 1"):
        list(mt.beads_stream([blank_frame()], **kwargs, **KW))


def test_streams_default_to_the_card():
    """No ``device`` argument means "cuda": without a card the stream
    raises, it does not run on the CPU."""
    kw = {k: v for k, v in KW.items() if k != "device"}
    if torch.cuda.is_available():
        assert len(list(mt.beads_stream([blank_frame()], **kw))) == 1
        return
    with pytest.raises((RuntimeError, AssertionError)):
        list(mt.beads_stream([blank_frame()], **kw))
    with pytest.raises((RuntimeError, AssertionError)):
        mt.mrbles(blank_frame(), spectra=io.StringIO(SPECTRA_CSV),
                  codes=io.StringIO(CODES_CSV), **kw)


# ----------------------------------------------------------------------
# mrbles_stream
# ----------------------------------------------------------------------

SPECTRA_CSV = "name,c1,c2\neu,1.0,0.1\ndy,0.1,1.0\n"
CODES_CSV = "name,eu,dy\ncode_a,1.0,0.0\ncode_b,1.0,1.0\n"
MRBLES_KW = dict(KW, search_channel="c1")


def mrbles_frame(seed, side=176):
    rng = np.random.default_rng(seed)
    spectra_m = np.array([[1.0, 0.1], [0.1, 1.0]])
    chans = np.zeros((2, side, side), np.float32)
    for k, dy in enumerate([0.0, 1.0, 0.0, 1.0, 0.0]):
        inten = np.array([100.0, 100.0 * dy]) @ spectra_m
        for ci in range(2):
            _paint(chans[ci], [(28 + 30 * k, 28 + 27 * k)],
                   float(inten[ci]) + 1)
    chans += rng.normal(8.0, 1.5, chans.shape).astype(np.float32)
    return mt.DataArray(np.maximum(chans, 0), dims=("channel", "y", "x"),
                        coords={"channel": ["c1", "c2"]})


def test_mrbles_stream_bit_identical_with_shared_csv_handles():
    """The decode runs per frame on the assembly worker; the SAME
    spectra/codes handles serve every frame (identify rewinds them)."""
    spectra, codes = io.StringIO(SPECTRA_CSV), io.StringIO(CODES_CSV)
    frames = [mrbles_frame(s) for s in range(3)]
    outs = list(mt.mrbles_stream(frames, spectra=spectra, codes=codes,
                                 **MRBLES_KW))
    assert len(outs) == 3
    for frame, out in zip(frames, outs):
        ref = mt.mrbles(frame, spectra=spectra, codes=codes, **MRBLES_KW)
        assert out.roi.sizes["mark"] == ref.roi.sizes["mark"] >= 5
        assert {"code_a", "code_b"} <= set(out.tag.values)
        assert_same(out, ref, VARS + ("tag", "ln", "ln_vol", "ln_ratio"))


def test_mrbles_empty_field_decodes_to_zero_marks():
    rng = np.random.default_rng(0)
    empty = mt.DataArray(
        np.stack([rng.normal(10, 2, (SMALL, SMALL)).astype(np.float32)] * 2),
        dims=("channel", "y", "x"), coords={"channel": ["c1", "c2"]})
    xp = mt.mrbles(empty, spectra=io.StringIO(SPECTRA_CSV),
                   codes=io.StringIO(CODES_CSV), **MRBLES_KW)
    assert xp.roi.sizes["mark"] == 0
    assert xp.tag.values.shape == (0,)
    assert xp.ln_ratio.values.shape == (0, 2)
    assert list(xp.ln.values) == ["eu", "dy"]


def test_mrbles_pipe_has_the_jax_components():
    pipe = mt.mrbles_pipe(spectra=io.StringIO(SPECTRA_CSV),
                          codes=io.StringIO(CODES_CSV), device="cpu")
    assert pipe.component_names == [
        "standardize_format", "flatfield_correct", "stitch", "find_beads",
        "identify_mrbles", "drop", "restore_format"]


# ----------------------------------------------------------------------
# parallel.streaming
# ----------------------------------------------------------------------

def test_device_prefetcher_orders_and_overlaps():
    loaded = []

    def loader(key):
        loaded.append(key)
        return np.full((4, 5), key, np.int16)

    it = iter(streaming.DevicePrefetcher(range(6), loader, depth=2,
                                         device="cpu"))
    key, block = next(it)
    assert key == 0 and isinstance(block, torch.Tensor)
    assert block.dtype == torch.int16 and block.shape == (4, 5)
    time.sleep(0.3)
    assert 2 <= len(loaded) <= 4  # ahead of the consumer, within the depth
    rest = list(it)
    assert [k for k, _ in rest] == [1, 2, 3, 4, 5]
    assert all(int(b[0, 0]) == k for k, b in rest)


def test_device_prefetcher_raises_loader_errors_and_cancels():
    def loader(key):
        if key == 2:
            raise KeyError("block 2")
        return np.zeros(3, np.float32)

    got = []
    with pytest.raises(KeyError, match="block 2"):
        for key, _ in streaming.DevicePrefetcher(range(5), loader,
                                                 device="cpu"):
            got.append(key)
    assert got == [0, 1]

    it = iter(streaming.DevicePrefetcher(
        range(50), lambda k: np.zeros(3, np.float32), depth=1, device="cpu"))
    next(it)
    it.close()  # releases the loader thread
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and any(
            t.name == "magnify-prefetch" for t in threading.enumerate()):
        time.sleep(0.05)
    assert not any(t.name == "magnify-prefetch"
                   for t in threading.enumerate())


def test_stream_planes_walks_channel_time():
    data = np.arange(2 * 3 * 4 * 5, dtype=np.float32).reshape(2, 3, 4, 5)
    ds = mt.Dataset({"image": (("channel", "time", "im_y", "im_x"), data)})
    got = list(streaming.stream_planes(ds, device="cpu"))
    assert [k for k, _ in got] == list(np.ndindex(2, 3))
    for (c, t), plane in got:
        np.testing.assert_array_equal(plane.numpy(), data[c, t])
