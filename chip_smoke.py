#!/usr/bin/env python3
"""Smoke test of magnify_tpu_torch on one NVIDIA GPU.

Run from the root of a checkout, with a CUDA device present:

    python3 chip_smoke.py

It builds the CUDA kernels of ``magnify_tpu_torch/csrc`` and then:

1. prints the card's name and power limit (``nvidia-smi``) and the build
   time;
2. kernel phase: holds each kernel against its plain torch twin on the card,
   bit for bit: hysteresis on the Canny masks of frame A (1024^2) and of
   frame B's stitched plane (1844^2), on random masks at 2048^2 and 4096^2,
   with strong pixels outside the weak mask, and on a serpentine chain
   across many small tiles; the int8 ring correlation on the padded
   features of frames A and B (8 x 1072^2, 8 x 1892^2; radii 8-12). It
   times each kernel (CUDA events), its plain twin and, for the ring
   correlation, the cuDNN ``conv2d`` that computes the same function
   (``library_ms``, a yardstick the port never calls), and computes each
   kernel's bound from the bytes it must move and the operations it must
   do;
3. main path: ``magnify_tpu_torch.beads`` on frame A (1024^2, 110 beads)
   and frame B (2 channels, 2 x 2 tiles of 1024^2, overlap 102, stitched
   to 1844^2) on ``cuda``; the marks must equal the golden file
   ``tests/data/torch_port_golden.npz`` (made by the JAX package with
   ``scripts/make_torch_port_golden.py``), frame A must find 110/110, and
   both kernels must have been launched by this run; then times warm
   frames of A;
4. prints one JSON line of kernel records (per kernel: ``launches`` in the
   main path and ``launches_per_call``, ``ms``/``plain_ms``/``bound_ms``/
   ``bound_share``/``library_ms`` at frame A's shapes and the same keys
   with ``_frame_b`` at frame B's, ``bound_by``, ``max_abs_err``) and,
   last, one JSON line ``{"ok": true, "device": {...}}``.

Any failed check raises: the script exits nonzero and prints no result.
Without a CUDA device it exits 2 at once. ``--kernels-only`` stops after
phase 2.

The frame builders (:func:`frame_a`, :func:`frame_b`) need numpy and the
port's copy of the library rasterizer only, so the golden-file script
imports them from here.
"""

from __future__ import annotations

import hashlib
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np

from magnify_tpu_torch.utils import filled_circle_points

ROOT = pathlib.Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "data" / "torch_port_golden.npz"

TILE = 1024
OVERLAP_B = 102
FRAME_A_KW = dict(min_bead_diameter=16, max_bead_diameter=24, overlap=0,
                  min_roundness=0.3)
FRAME_B_KW = dict(min_bead_diameter=16, max_bead_diameter=24,
                  overlap=OVERLAP_B, min_roundness=0.3,
                  search_channel=["red", "green"])


def frame_a(seed: int = 0):
    """The single-tile bead frame: 1024^2 uint16 noise with 110 beads of
    radius 10 (the JAX package's bench workload). Returns (image, n_beads)."""
    rng = np.random.default_rng(seed)
    img = rng.normal(100, 5, (TILE, TILE)).astype(np.uint16)
    positions = [(r * 97 + 60, c * 83 + 50) for r in range(10)
                 for c in range(11)]
    pts = filled_circle_points(10)
    for pos in positions:
        p = pts + np.array(pos)
        img[p[:, 0], p[:, 1]] = 1000
    return img, len(positions)


def frame_b(seed: int = 1) -> np.ndarray:
    """A 2-channel, 2 x 2-tile field of 1024^2 tiles that overlap by
    ``OVERLAP_B`` pixels: (channel, row, col, y, x) uint16.

    Beads of radius 8-11 sit on an 88-pixel grid in field coordinates and
    are painted into every tile that sees them; tile noise is independent.
    Channel "red" holds the grid points with (i + j) % 3 != 2, "green" those
    with (i + j) % 3 != 0, and green's shared beads ((i + j) % 3 == 1) are
    shifted by (3, 4) pixels, so the cross-channel dedupe drops them while
    green-only beads survive.
    """
    rng = np.random.default_rng(seed)
    step = TILE - OVERLAP_B
    out = rng.normal(100, 5, (2, 2, 2, TILE, TILE)).astype(np.uint16)
    field = step + TILE
    grid = [(i, j) for i in range(22) for j in range(22)
            if 40 + 88 * i + 14 < field and 40 + 88 * j + 14 < field]
    beads = {0: [], 1: []}
    for i, j in grid:
        y, x = 40 + 88 * i, 40 + 88 * j
        r = 8 + (7 * i + 3 * j) % 4
        if (i + j) % 3 != 2:
            beads[0].append((y, x, r, 1000))
        if (i + j) % 3 == 1:
            beads[1].append((y + 3, x + 4, r, 800))
        elif (i + j) % 3 == 2:
            beads[1].append((y, x, r, 800))
    for ch, items in beads.items():
        for y, x, r, val in items:
            pts = filled_circle_points(r) + np.array([y, x])
            for tr in range(2):
                for tc in range(2):
                    p = pts - np.array([tr * step, tc * step])
                    ok = ((p[:, 0] >= 0) & (p[:, 0] < TILE)
                          & (p[:, 1] >= 0) & (p[:, 1] < TILE))
                    out[ch, tr, tc, p[ok, 0], p[ok, 1]] = val
    return out


def as_dataarray(pkg, case: str):
    """Frame ``case`` ("A" or "B") as a DataArray of package ``pkg``."""
    if case == "A":
        return pkg.DataArray(frame_a()[0], dims=("y", "x"))
    return pkg.DataArray(frame_b(), dims=("channel", "row", "col", "y", "x"),
                         coords={"channel": ["red", "green"]})


def digest(a) -> str:
    a = np.ascontiguousarray(np.asarray(a))
    h = hashlib.sha256(f"{a.dtype.str}{a.shape}".encode())
    h.update(a.tobytes())
    return h.hexdigest()


def summarize(xp) -> dict:
    """What the golden file holds of one ``beads`` result: the bead rows
    (y, x) in mark order and digests of the fg/bg masks and ROI crops."""
    rows = np.stack([np.asarray(xp.y.values, float).ravel(),
                     np.asarray(xp.x.values, float).ravel()], axis=1)
    return {"rows": rows, "fg": digest(xp.fg.values),
            "bg": digest(xp.bg.values), "roi": digest(xp["roi"].values)}


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------

def _say(*args):
    print(*args, flush=True)


def _time_ms(fn, reps: int) -> float:
    """Median wall time of ``fn`` in ms, each run ending in a synchronize."""
    import torch

    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def _event_ms(fn, reps: int) -> float:
    """Device time per call of ``fn`` in ms: CUDA events around ``reps``
    back-to-back calls after one warm-up call. The inputs stay in the 50 MB
    L2 between calls, as the main path's inputs come fresh from the stage
    before."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# Published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W).
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15


def _bound(n_bytes: int, n_ops: int):
    """Least time (ms) for moving ``n_bytes`` once and doing ``n_ops`` int8
    operations, and which of the two sets it."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / INT8_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _stages(img, dev):
    """Canny masks and padded int8 features of one uint16 plane, on
    ``dev``, through the port's own stages (the shapes and values the main
    path sees)."""
    import torch
    import torch.nn.functional as F

    from magnify_tpu_torch.ops import detect, edge, score

    u8 = torch.as_tensor(detect.normalize_planes_u8(img[None])[0]).to(dev)
    blurred = edge.gaussian_blur5_u8(u8)
    dx, dy = edge.scharr(blurred)
    grad = edge.sqrt_f32(dx * dx + dy * dy)
    lo, hi = edge.histogram_quantiles(grad, [np.float32(0.1),
                                             np.float32(0.9)])
    strong, weak = edge.canny_nms(dx, dy, lo, hi)
    edges = edge.hysteresis(strong, weak)
    pad = 2 * 12
    p = (pad, pad, pad, pad)
    feats = score.alignment_features_q8(F.pad(edges, p), F.pad(dx, p),
                                        F.pad(dy, p))
    return strong, weak, feats


def _frame_b_plane() -> np.ndarray:
    """Frame B's "red" channel stitched as ``stitch`` does it (1844^2)."""
    clip, rem = OVERLAP_B // 2, OVERLAP_B % 2
    tiles = frame_b()[0][:, :, clip:TILE - clip - rem, clip:TILE - clip - rem]
    n, m, th, tw = tiles.shape
    return np.ascontiguousarray(tiles.transpose(0, 2, 1, 3)).reshape(
        n * th, m * tw)


def _serpentine(h: int, w: int):
    """A single chain that snakes down the plane in runs 4 rows apart."""
    chain = np.zeros((h, w), bool)
    rows = list(range(4, h - 4, 4))
    for k, r in enumerate(rows):
        chain[r, 8:w - 8] = True
        if k + 1 < len(rows):
            col = w - 9 if k % 2 == 0 else 8
            chain[r:r + 5, col] = True
    strong = np.zeros_like(chain)
    strong[rows[0], 8] = True
    return strong, chain


def _hysteresis_record(dev, planes) -> dict:
    import torch

    from magnify_tpu_torch.ops import hysteresis as hyst

    (strong_a, weak_a), (strong_b, weak_b) = planes
    rng = np.random.default_rng(7)
    cases = [("frame A masks", strong_a, weak_a, None),
             ("frame B masks", strong_b, weak_b, None)]
    for n in (2048, 4096):
        s = rng.random((n, n)) > 0.99
        w = s | (rng.random((n, n)) > 0.65)
        cases.append((f"random {n}^2", torch.as_tensor(s).to(dev),
                      torch.as_tensor(w).to(dev), None))
    for tr in (8, 16, 48):
        s = rng.random((100, 150)) > 0.99
        w = s | (rng.random((100, 150)) > 0.65)
        cases.append((f"random 100x150 tile_rows={tr}",
                      torch.as_tensor(s).to(dev), torch.as_tensor(w).to(dev),
                      tr))
    for shape in ((1, 1), (3, 5), (1000, 777), (1844, 1844)):
        s = rng.random(shape) < 0.02
        w = rng.random(shape) < 0.4
        s.flat[0], w.flat[0] = True, False
        cases.append((f"strong outside weak {shape[0]}x{shape[1]}",
                      torch.as_tensor(s).to(dev), torch.as_tensor(w).to(dev),
                      None))
    s, w = _serpentine(256, 512)
    cases.append(("serpentine 256x512 tile_rows=8", torch.as_tensor(s).to(dev),
                  torch.as_tensor(w).to(dev), 8))
    per_call = set()
    for name, s, w, tr in cases:
        before = hyst.launches
        got = hyst.hysteresis(s, w, tile_rows=tr)
        per_call.add(hyst.launches - before)
        want = hyst.hysteresis_plain(s, w)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"hysteresis kernel != plain twin on {name}: "
                                 f"{int((got != want).sum())} pixels differ")
        if name.startswith("serpentine") and int(got.sum()) != int(w.sum()):
            raise AssertionError("serpentine chain did not light up fully")
        _say(f"hysteresis == plain on {name} ({tuple(s.shape)}): "
             f"{int(got.sum())} edge pixels")
    if per_call != {hyst.LAUNCHES_PER_CALL}:
        raise AssertionError(f"hysteresis launches per call {per_call}")
    _say(f"hysteresis launches per call: {hyst.LAUNCHES_PER_CALL} on every "
         "case")

    rec = {"name": "hysteresis", "route": "cuda",
           "source": "magnify_tpu_torch/csrc/hysteresis.cu",
           "replaces": "magnify_tpu/ops/pallas_kernels.py:131",
           "launches_per_call": hyst.LAUNCHES_PER_CALL, "max_abs_err": 0}
    for tag, s, w in (("", strong_a, weak_a), ("_frame_b", strong_b, weak_b)):
        k_ms = _event_ms(lambda: hyst.hysteresis(s, w), 100)
        p_ms = _event_ms(lambda: hyst.hysteresis_plain(s, w), 3)
        # Strong and weak masks read once, the result written once: 3 B/px.
        bound_ms, bound_by = _bound(3 * s.numel(), 0)
        rec.update({f"ms{tag}": k_ms, f"plain_ms{tag}": p_ms,
                    f"bound_ms{tag}": bound_ms, "bound_by": bound_by,
                    f"bound_share{tag}": bound_ms / k_ms})
        _say(f"hysteresis time at {tuple(s.shape)}: kernel {k_ms:.4f} ms, "
             f"plain {p_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by})")
    for name, s, w, _ in cases[2:4]:
        kn = _event_ms(lambda: hyst.hysteresis(s, w), 20)
        _say(f"hysteresis time on {name}: kernel {kn:.4f} ms")
    rec["library_ms"] = None  # no single PyTorch call computes it
    return rec


def _ring_corr_record(dev, feats_ab) -> dict:
    import torch
    import torch.nn.functional as F

    from magnify_tpu_torch.ops import score

    weights, _dq = score._cached_tables(8, 12, str(dev))
    n_r, _c, k, _ = weights.dense.shape
    rad = k // 2
    nnz = int((weights.dense != 0).sum())
    before = score.launches
    err = 0
    for name, feats in zip(("frame A", "frame B"), feats_ab):
        got = score.ring_corr(feats, weights)
        want = score.ring_corr_plain(feats, weights)
        torch.cuda.synchronize()
        e = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        if e != 0 or got.shape != want.shape:
            raise AssertionError(f"ring_corr kernel != plain twin on {name}: "
                                 f"max |diff| {e}")
        err = max(err, e)
        _say(f"ring_corr == plain on {name} features {tuple(feats.shape)} "
             f"-> {tuple(got.shape)} int32, {int(weights.table.shape[0])} "
             f"positions, {nnz} taps")
    per_call = (score.launches - before) // 2

    tf32 = torch.backends.cudnn.allow_tf32
    bench = torch.backends.cudnn.benchmark
    dense_f = weights.dense.float()
    rec = {"name": "ring_corr", "route": "cuda",
           "source": "magnify_tpu_torch/csrc/ring_corr.cu",
           "replaces": "magnify_tpu/ops/score.py:637",
           "launches_per_call": per_call, "max_abs_err": err,
           "library_call": "F.conv2d(feats.float()[None], "
                           "weights.dense.float(), padding=R)",
           "library_cudnn_allow_tf32": tf32,
           "library_cudnn_benchmark": bench}
    for tag, feats in zip(("", "_frame_b"), feats_ab):
        _, h, w = feats.shape
        k_ms = _event_ms(lambda: score.ring_corr(feats, weights), 50)
        p_ms = _event_ms(lambda: score.ring_corr_plain(feats, weights), 3)
        ff = feats.float()[None]
        lib = F.conv2d(ff, dense_f, padding=rad)[0]
        lib_err = float((lib.double() - score.ring_corr(feats, weights)
                         .double()).abs().max())
        lib_ms = _event_ms(lambda: F.conv2d(ff, dense_f, padding=rad), 20)
        # int8 features read once, int32 maps written once; one multiply
        # and one add per nonzero weight and pixel.
        bound_ms, bound_by = _bound((8 + 4 * n_r) * h * w, 2 * nnz * h * w)
        rec.update({f"ms{tag}": k_ms, f"plain_ms{tag}": p_ms,
                    f"library_ms{tag}": lib_ms,
                    f"library_max_abs_err{tag}": lib_err,
                    f"bound_ms{tag}": bound_ms, "bound_by": bound_by,
                    f"bound_share{tag}": bound_ms / k_ms})
        _say(f"ring_corr time at {tuple(feats.shape)}: kernel {k_ms:.4f} ms, "
             f"plain (float64 conv2d) {p_ms:.4f} ms, library conv2d "
             f"{lib_ms:.4f} ms (max |diff| {lib_err}, cudnn allow_tf32="
             f"{tf32}, benchmark={bench}), bound {bound_ms:.5f} ms "
             f"({bound_by})")
    return rec


def kernel_phase(dev) -> list:
    strong_a, weak_a, feats_a = _stages(frame_a()[0], dev)
    strong_b, weak_b, feats_b = _stages(_frame_b_plane(), dev)
    return [_hysteresis_record(dev, ((strong_a, weak_a), (strong_b, weak_b))),
            _ring_corr_record(dev, (feats_a, feats_b))]


def _check_case(case: str, xp, golden) -> None:
    got = summarize(xp)
    if not np.isfinite(got["rows"]).all():
        raise AssertionError(f"frame {case}: non-finite coordinates")
    for key in ("fg", "bg", "roi"):
        want = str(golden[f"{case}_{key}"])
        if got[key] != want:
            raise AssertionError(f"frame {case}: {key} digest {got[key]} != "
                                 f"golden {want}")
    want_rows = golden[f"{case}_rows"]
    if got["rows"].shape != want_rows.shape or not np.array_equal(
            got["rows"], want_rows):
        raise AssertionError(f"frame {case}: {len(got['rows'])} bead rows "
                             f"differ from the golden {len(want_rows)}")
    _say(f"frame {case}: {len(want_rows)} marks, rows and fg/bg/roi digests "
         "equal the golden file")


def main_path(records: list, dev) -> None:
    import torch

    import magnify_tpu_torch as mt
    from magnify_tpu_torch.ops import hysteresis as hyst
    from magnify_tpu_torch.ops import score

    golden = np.load(GOLDEN)
    data_a = as_dataarray(mt, "A")
    data_b = as_dataarray(mt, "B")
    hyst.launches = 0
    score.launches = 0
    xa = mt.beads(data_a, device=dev, **FRAME_A_KW)
    xb = mt.beads(data_b, device=dev, **FRAME_B_KW)
    torch.cuda.synchronize()
    counts = {"hysteresis": hyst.launches, "ring_corr": score.launches}
    _say(f"kernel launches in the main path (frames A and B): {counts}")
    for name, n in counts.items():
        if n <= 0:
            raise AssertionError(f"the main path never launched {name}")
    for rec in records:
        rec["launches"] = counts[rec["name"]]
        _say(f"{rec['name']}: {rec['launches_per_call']} launches per call, "
             f"{rec['launches']} in the main path")

    n_true = frame_a()[1]
    n_a = xa["roi"].sizes["mark"]
    if n_a != n_true:
        raise AssertionError(f"frame A: found {n_a} of {n_true} beads")
    _say(f"frame A: found {n_a}/{n_true} beads, roi {xa['roi'].shape}")
    _check_case("A", xa, golden)
    _say(f"frame B: roi {xb['roi'].shape}")
    _check_case("B", xb, golden)

    ms = _time_ms(lambda: mt.beads(data_a, device=dev, **FRAME_A_KW), 7)
    _say(f"frame A warm beads(): {ms:.3f} ms per frame (median of 7)")
    ms_b = _time_ms(lambda: mt.beads(data_b, device=dev, **FRAME_B_KW), 3)
    _say(f"frame B warm beads(): {ms_b:.3f} ms per frame (median of 3)")


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    _say(smi.stdout.strip().splitlines()[0])
    _say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
         f"{torch.cuda.get_device_name(0)}")

    from magnify_tpu_torch import _build

    t0 = time.perf_counter()
    _build.load()
    _say(f"kernel build: {time.perf_counter() - t0:.2f} s "
         f"(cached={_build.last_build.get('cached')})")
    for line in _build.last_build.get("log", "").splitlines():
        if "registers" in line or "bytes stack" in line:
            _say("  ptxas:", line.strip())

    dev = torch.device("cuda")
    records = kernel_phase(dev)
    if "--kernels-only" in argv:
        _say(json.dumps({"kernels": records}))
        return 0
    main_path(records, dev)
    _say(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
