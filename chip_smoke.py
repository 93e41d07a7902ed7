#!/usr/bin/env python3
"""Smoke test of magnify_tpu_torch on one NVIDIA GPU.

Run from the root of a checkout, with a CUDA device present:

    python3 chip_smoke.py

It builds the CUDA kernels of ``magnify_tpu_torch/csrc`` and then:

1. prints the card's name and power limit (``nvidia-smi``) and the build
   time;
2. kernel phase: holds each kernel against its plain torch twin on the card
   (hysteresis on frame A's Canny masks, on random masks at 2048^2 and
   4096^2 and on a serpentine chain across many small tiles; the int8 ring
   correlation on frame A's features, radii 8-12), bit for bit, and times
   both;
3. main path: ``magnify_tpu_torch.beads`` on frame A (1024^2, 110 beads)
   and frame B (2 channels, 2 x 2 tiles of 1024^2, overlap 102, stitched
   to 1844^2) on ``cuda``; the marks must equal the golden file
   ``tests/data/torch_port_golden.npz`` (made by the JAX package with
   ``scripts/make_torch_port_golden.py``), frame A must find 110/110, and
   both kernels must have been launched by this run; then times warm
   frames of A;
4. prints one JSON line of kernel records and, last, one JSON line
   ``{"ok": true, "device": {...}}``.

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


def _frame_a_stages(dev):
    """Frame A's Canny masks and padded score inputs, on ``dev``, through
    the port's own stages (the shapes and values the main path sees)."""
    import torch
    import torch.nn.functional as F

    from magnify_tpu_torch.ops import detect, edge, score

    img, _ = frame_a()
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


def kernel_phase(dev) -> list:
    import torch

    from magnify_tpu_torch.ops import hysteresis as hyst
    from magnify_tpu_torch.ops import score

    records = []
    strong_a, weak_a, feats_a = _frame_a_stages(dev)

    # Hysteresis: the kernel against the plain twin, bit for bit.
    rng = np.random.default_rng(7)
    cases = [("frame A masks", strong_a, weak_a, None)]
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
    s, w = _serpentine(256, 512)
    cases.append(("serpentine 256x512 tile_rows=8", torch.as_tensor(s).to(dev),
                  torch.as_tensor(w).to(dev), 8))
    for name, s, w, tr in cases:
        got = hyst.hysteresis(s, w, tile_rows=tr)
        sweeps = hyst.last_sweeps
        want = hyst.hysteresis_plain(s, w)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"hysteresis kernel != plain twin on {name}: "
                                 f"{int((got != want).sum())} pixels differ")
        if name.startswith("serpentine") and int(got.sum()) != int(w.sum()):
            raise AssertionError("serpentine chain did not light up fully")
        _say(f"hysteresis == plain on {name} ({tuple(s.shape)}): "
             f"{int(got.sum())} edge pixels, {sweeps} sweeps")
    hyst.hysteresis(strong_a, weak_a)
    sweeps_a = hyst.last_sweeps
    k_ms = _time_ms(lambda: hyst.hysteresis(strong_a, weak_a), 20)
    p_ms = _time_ms(lambda: hyst.hysteresis_plain(strong_a, weak_a), 5)
    _say(f"hysteresis time on frame A masks: kernel {k_ms:.4f} ms "
         f"({sweeps_a} sweeps), plain {p_ms:.4f} ms")
    for n in (2048, 4096):
        s, w = cases[1 if n == 2048 else 2][1:3]
        kn = _time_ms(lambda: hyst.hysteresis(s, w), 10)
        pn = _time_ms(lambda: hyst.hysteresis_plain(s, w), 3)
        _say(f"hysteresis time on random {n}^2: kernel {kn:.4f} ms "
             f"({hyst.last_sweeps} sweeps), plain {pn:.4f} ms")
    records.append({
        "name": "hysteresis", "route": "cuda",
        "source": "magnify_tpu_torch/csrc/hysteresis.cu",
        "replaces": "magnify_tpu/ops/pallas_kernels.py:131",
        "max_abs_err": 0, "ms": k_ms, "plain_ms": p_ms,
        "sweeps_frame_a": sweeps_a,
    })

    # Ring correlation on frame A's features, radii 8-12.
    weights, _dq = score._cached_tables(8, 12, str(feats_a.device))
    got = score.ring_corr(feats_a, weights)
    want = score.ring_corr_plain(feats_a, weights)
    torch.cuda.synchronize()
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    if err != 0 or got.shape != want.shape:
        raise AssertionError(f"ring_corr kernel != plain twin: max |diff| "
                             f"{err}")
    _say(f"ring_corr == plain on frame A features {tuple(feats_a.shape)} -> "
         f"{tuple(got.shape)} int32, {int(weights.taps.numel())} taps")
    k_ms = _time_ms(lambda: score.ring_corr(feats_a, weights), 20)
    p_ms = _time_ms(lambda: score.ring_corr_plain(feats_a, weights), 5)
    _say(f"ring_corr time on frame A: kernel {k_ms:.4f} ms, "
         f"plain (float64 conv2d) {p_ms:.4f} ms")
    records.append({
        "name": "ring_corr", "route": "cuda",
        "source": "magnify_tpu_torch/csrc/ring_corr.cu",
        "replaces": "magnify_tpu/ops/score.py:536",
        "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
    })
    return records


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
