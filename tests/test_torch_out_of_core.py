"""The port's out-of-core bead path against the JAX package's, exactly.

A 2-channel stack of 3 timesteps of 256^2 uint16 planes is written as
``(channel)/s.ome.tif`` (one OME-TIFF of 3 pages per channel directory),
the form ``tests/test_io.py`` reads and ``chip_smoke.py`` drives at full
width. Channel "c1" repeats some of "c0"'s beads shifted by (3, 4) pixels
(the cross-channel dedupe drops them) and has beads of its own; every plane
is the channel's base plane scaled by ``1 + 0.05 t``.

``components.find.MAX_RESIDENT_BYTES`` and ``core.lazy.RESIDENT_BYTES_LIMIT``
are lowered in both packages, so the stack stays lazy on disk, each search
plane is read and detected alone, and the ROI store is a disk-backed memmap
filled one (channel, time) plane at a time: the path a stack above 512 MiB
takes. ``beads`` and then ``quantify`` must give every variable of the JAX
package's out-of-core run (dense detector, int8 score maps) exactly; the
intensities exactly against the JAX host twin (where the JAX package
reduces a memmap-backed store, as ``MAGNIFY_TPU_QUANTIFY=host`` would
force) and within ``ops.reduce.MEAN_RTOL`` of the pixel magnitude against
its jitted device reduction; the bg medians exactly against both. Each
page is decoded once by the ROI pass, and once more for the search
planes. The same marks come out of the port's in-memory path.

A stream whose middle frame is above the lowered limit drains and runs that
frame serially: every frame equals its single-frame call, in order.

The JAX reference runs in ONE subprocess per session (this file run as a
script), as in ``tests/test_torch_slice.py``: the JAX package reads its
score-quantization mode once at import.
"""

import os
import sys

import numpy as np
import pytest
import torch
import torch_reference

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
KW = dict(min_bead_diameter=16, max_bead_diameter=24, min_roundness=0.3,
          overlap=0, detector="dense")
N_T, SIDE = 3, 256
CHANNELS = ("c0", "c1")
PATTERN = "(channel)/s.ome.tif"

torch.set_num_threads(1)


def _paint(img, positions, radius, value):
    from magnify_tpu_torch.utils import filled_circle_points

    for y, x in positions:
        pts = filled_circle_points(radius) + np.array([y, x])
        img[pts[:, 0], pts[:, 1]] = value


def base_planes():
    """(2, SIDE, SIDE) float32 base planes of the two channels."""
    rng = np.random.default_rng(0)
    base = rng.normal(100, 5, (2, SIDE, SIDE)).astype(np.float32)
    shared = [(40, 40), (40, 130), (128, 90), (210, 50), (215, 200)]
    _paint(base[0], shared + [(130, 200)], 10, 1000)
    _paint(base[1], [(y + 3, x + 4) for y, x in shared[:3]]
           + [(60, 220), (190, 130)], 9, 900)
    return base


def write_stack(root):
    """The stack as ``root/(channel)/s.ome.tif``, TCYX with C = 1."""
    from magnify_tpu_torch.io.tiff import write_tiff

    base = base_planes()
    scale = (1.0 + 0.05 * np.arange(N_T, dtype=np.float32))
    for ci, name in enumerate(CHANNELS):
        stack = (base[ci][None] * scale[:, None, None]).astype(np.uint16)
        os.makedirs(os.path.join(root, name), exist_ok=True)
        write_tiff(os.path.join(root, name, "s.ome.tif"), stack[:, None])
    return os.path.join(root, PATTERN)


def flatten(xp, tag):
    out = {}
    for name in sorted(xp.variables):
        if name == "image":
            continue
        values = np.asarray(xp[name].values)
        if values.dtype == object:
            values = values.astype(str)
        out[f"{tag}/{name}"] = values
        out[f"{tag}/{name}/dims"] = np.array(",".join(xp[name].dims))
    return out


@pytest.fixture(scope="session")
def stack_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_ooc")
    write_stack(str(root))
    return root


@pytest.fixture(scope="session")
def reference(stack_dir):
    return torch_reference.run(__file__, stack_dir, stack_dir / "ref.npz")


@pytest.fixture
def out_of_core(monkeypatch):
    from magnify_tpu_torch.components import find
    from magnify_tpu_torch.core import lazy

    monkeypatch.setattr(find, "MAX_RESIDENT_BYTES", 1)
    monkeypatch.setattr(lazy, "RESIDENT_BYTES_LIMIT", 1)


def _run_port(stack_dir):
    import magnify_tpu_torch as mt
    from magnify_tpu_torch.io import tiff

    tiff.page_reads.clear()
    xp = mt.beads(str(stack_dir / PATTERN), device="cpu", **KW)
    reads = dict(tiff.page_reads)
    return xp, reads


def test_out_of_core_beads_and_quantify_match_jax(reference, stack_dir,
                                                  out_of_core):
    import magnify_tpu_torch as mt
    from magnify_tpu_torch.ops.reduce import MEAN_RTOL

    xp, reads = _run_port(stack_dir)
    assert isinstance(xp["roi"].data, np.memmap)
    got = flatten(xp, "beads")
    want = {k: v for k, v in reference.items() if k.startswith("beads/")}
    assert sorted(got) == sorted(want)
    assert got["beads/x"].shape[0] >= 8
    for key, val in want.items():
        assert got[key].dtype == val.dtype, key
        np.testing.assert_array_equal(got[key], val, err_msg=key)

    # Every page once in the ROI pass; the t = 0 page of each search
    # channel once more for detection.
    paths = {os.path.join(str(stack_dir), c, "s.ome.tif"): c
             for c in CHANNELS}
    assert sum(reads.values()) == len(CHANNELS) * N_T + len(CHANNELS)
    assert reads == {(p, t): 2 if t == 0 else 1
                     for p in paths for t in range(N_T)}

    q = mt.quantify(xp, device="cpu")
    inten = q.intensity.transpose("mark", "channel", "time").values
    np.testing.assert_array_equal(inten, reference["host/intensity"])
    device = reference["device/intensity"]
    magnitude = float(np.abs(q["roi"].values).max())
    assert np.abs(inten - device).max() <= MEAN_RTOL * magnitude
    # Every bead is bright in a channel that has it, and brighter there
    # with every timestep.
    lit = inten[:, :, 0] > 100
    assert lit.any(axis=1).all()
    assert (np.diff(inten, axis=-1)[lit] > 0).all()


def test_bg_medians_exact(reference, stack_dir, out_of_core):
    """The bg medians alone (fg mean dropped): exact against the JAX
    package's device reduction too."""
    from magnify_tpu_torch.ops import reduce as treduce

    xp, _ = _run_port(stack_dir)
    roi = xp["roi"].transpose("mark", "channel", "time", "roi_y",
                              "roi_x").values
    bg = xp["bg"].transpose("mark", "time", "roi_y", "roi_x").values
    n, c, t, ly, lx = roi.shape
    values = roi.transpose(0, 2, 1, 3, 4).reshape(n * t * c, ly * lx)
    mask = np.repeat(bg.reshape(n * t, 1, ly * lx), c, axis=1).reshape(
        n * t * c, ly * lx)
    med = treduce.masked_median(values, mask, device="cpu").reshape(n, t, c)
    np.testing.assert_array_equal(med.transpose(0, 2, 1),
                                  reference["device/bg_median"])


def test_out_of_core_marks_equal_in_memory_marks(stack_dir, out_of_core,
                                                 monkeypatch):
    import magnify_tpu_torch as mt
    from magnify_tpu_torch.components import find

    xp, _ = _run_port(stack_dir)
    monkeypatch.setattr(find, "MAX_RESIDENT_BYTES", 512 << 20)
    mem = mt.beads(str(stack_dir / PATTERN), device="cpu", **KW)
    for name in ("x", "y", "fg", "bg", "roi", "valid"):
        np.testing.assert_array_equal(np.asarray(xp[name].values),
                                      np.asarray(mem[name].values),
                                      err_msg=name)


def test_stream_with_an_oversized_frame_midstream(stack_dir, monkeypatch):
    """Frames 0 and 2 (in memory, one 256^2 plane) stream; frame 1 (the
    stack on disk) is above the limit: it drains the stream and runs out of
    core on the calling thread. Every frame equals its single-frame call,
    in order."""
    import magnify_tpu_torch as mt
    from magnify_tpu_torch.components import find

    base = base_planes()
    small = [mt.DataArray(base[k].astype(np.uint16), dims=("y", "x"))
             for k in (0, 1)]
    frames = [small[0], str(stack_dir / PATTERN), small[1]]
    monkeypatch.setattr(find, "MAX_RESIDENT_BYTES", 2 * SIDE * SIDE * 2)
    calls = []
    real = find.BeadFinder._out_of_core
    monkeypatch.setattr(find.BeadFinder, "_out_of_core",
                        lambda self, a: calls.append(1) or real(self, a))
    kw = {k: v for k, v in KW.items() if k != "detector"}
    outs = list(mt.beads_stream(frames, device="cpu", stream_depth=2, **kw))
    assert len(calls) == 1
    singles = [mt.beads(f, device="cpu", **kw) for f in frames]
    assert len(calls) == 2
    assert len(outs) == 3
    for k, (out, single) in enumerate(zip(outs, singles)):
        got, want = flatten(out, "f"), flatten(single, "f")
        assert sorted(got) == sorted(want), k
        for key, val in want.items():
            np.testing.assert_array_equal(got[key], val, err_msg=f"{k} {key}")
    assert outs[1]["roi"].sizes["channel"] == 2


if __name__ == "__main__":
    # The reference run: the JAX package's out-of-core path, dense detector,
    # int8 maps, on the stack the session wrote.
    torch_reference.check_env()
    sys.path.insert(0, ROOT)
    import magnify_tpu as mg
    from magnify_tpu.components import find as jfind
    from magnify_tpu.components.quantify import quantify
    from magnify_tpu.core import lazy as jlazy
    from magnify_tpu.ops import reduce as jreduce

    jfind.MAX_RESIDENT_BYTES = 1
    jlazy.RESIDENT_BYTES_LIMIT = 1
    stack_dir, out = sys.argv[1], sys.argv[2]
    xp = mg.beads(os.path.join(stack_dir, PATTERN), **KW)
    assert isinstance(xp["roi"].data, np.memmap)
    result = flatten(xp, "beads")
    # The JAX package reduces a memmap-backed store with its numpy twin.
    q = quantify(xp.copy())
    result["host/intensity"] = q.intensity.transpose(
        "mark", "channel", "time").values
    # Its device reduction (jitted XLA), on the same folded batch.
    import jax.numpy as jnp

    roi = xp["roi"].transpose("mark", "channel", "time", "roi_y",
                              "roi_x").values
    fg = xp["fg"].transpose("mark", "time", "roi_y", "roi_x").values
    bg = xp["bg"].transpose("mark", "time", "roi_y", "roi_x").values
    n, c, t, ly, lx = roi.shape
    roi_b = roi.transpose(0, 2, 1, 3, 4).reshape(n * t, c, ly, lx)
    dev = np.asarray(jreduce._fg_mean_bg_median(
        jnp.asarray(roi_b), jnp.asarray(fg.reshape(n * t, ly, lx)),
        jnp.asarray(bg.reshape(n * t, ly, lx))))
    result["device/intensity"] = dev.reshape(n, t, c).transpose(0, 2, 1)
    values = roi_b.reshape(n * t * c, ly * lx)
    mask = np.repeat(bg.reshape(n * t, 1, ly * lx), c, axis=1).reshape(
        n * t * c, ly * lx)
    med = np.asarray(jreduce._masked_median(jnp.asarray(values),
                                            jnp.asarray(mask)))
    result["device/bg_median"] = med.reshape(n, t, c).transpose(0, 2, 1)
    np.savez(out, **result)
