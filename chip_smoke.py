#!/usr/bin/env python3
"""Smoke test of magnify_tpu_torch on one NVIDIA GPU.

Run from the root of a checkout, with a CUDA device present:

    python3 chip_smoke.py

It builds the CUDA kernels of ``magnify_tpu_torch/csrc`` and then:

1. prints the card's name and power limit (``nvidia-smi``) and the build
   time;
2. kernel phase: holds each kernel against its plain torch twin on the card,
   bit for bit: hysteresis on the Canny masks of frame A (1024^2), of
   frame B's stitched plane (1844^2), of the out-of-core stack's base
   plane (4096^2, 1,760 beads) and of frame S's stitched plane (3688^2),
   on random masks at 2048^2 and 4096^2,
   with strong pixels outside the weak mask, and on a serpentine chain
   across many small tiles; the int8 ring correlation on the padded
   features of frames A and B, of the out-of-core plane and of frame S's
   plane (8 x 1072^2, 8 x 1892^2, 8 x 4144^2, 8 x 3736^2; radii 8-12); the
   RANSAC perimeter scorer on every input the RANSAC main paths give it,
   taken from one ``detector="ransac"`` run of each at 5,000,000 proposals:
   frame A's unique proposals (radii 8-12, L = 68 perimeter positions), and
   for frames C8 and C the whole-plane grid search, the chamber batch
   (64 crops of 72^2 at radii 8-16, at most 4,096 uniques each; 1,568 crops
   at radii 4-15, at most 3,188) and its 27-neighbour hill-climb; and on
   random 1024^2 planes at ``max_radius`` 0, 1 and 2 (L = 1, 8, 12: sum
   forms of their own, -0.0 scores at L = 1), each scorer call one launch
   with the lanes a circle ``ops.score.perimeter_plan`` gives, timed with
   CUDA events and, the kernel alone, with ``torch.profiler``.
   Batched: hysteresis on the Canny masks of the chamber crops of frame C8
   (64 x 72^2) and frame C (1,568 x 72^2), on random (N, H, W) masks with
   W in {17, 72, 130} and on a batch whose planes would join if the kernel
   ran on from one plane into the next; the ring correlation on the padded
   int8 features of the same crops (64 x 8 x 136^2 at radii 8-16, 1,568 x 8
   x 132^2 at radii 4-15). It times each kernel (CUDA events), its plain
   twin and, for the ring correlation, the cuDNN ``conv2d`` that computes
   the same function (``library_ms``, a yardstick the port never calls),
   and computes each kernel's bound from the bytes it must move and the
   operations it must do. The uint8 normalization kernel runs at the
   dense finders' search planes (frame C's 1 x 7,187 x 6,755 and frame
   S's stitched 2 x 3,688^2), bit-equal to the host's
   ``normalize_planes_u8`` and to its plain twin, timed beside both. The
   bead ownership kernel runs at frame S's drawn beads and at the bead
   cell's 1,764 marks, bit-equal to its CPU branch, timed beside it;
3. main paths, each driven with the kernels' launch counts set to 0 just
   before and read just after; every dense path must have launched
   hysteresis and ring_corr, every RANSAC path hysteresis and
   perimeter_score, and each path the uint8 normalization exactly as often
   as its route says: once a call (2 launches) where an in-memory finder
   without a mesh or the tuning UI gets uint16 search planes (beads A and
   B, RANSAC beads A, the chips' dense timesteps, the disk paths, frame S),
   never in the streams, under a mesh, out of core, in the tuning UI or on
   frame M (float32, so its planes are normalized on the host); and the
   bead ownership kernel once a bead frame (every ``beads`` and ``mrbles``
   path, their streams, meshes, RANSAC, tuning UI and out-of-core runs)
   and never in a chip or ``find_circles`` path:

   * ``beads`` on frame A (1024^2, 110 beads) and frame B (2 channels,
     2 x 2 tiles of 1024^2, overlap 102, stitched to 1844^2) on ``cuda``;
     the marks must equal the golden file
     ``tests/data/torch_port_golden.npz`` (made by the JAX package with
     ``scripts/make_torch_port_golden.py``) and frame A must find 110/110;
   * ``mrbles`` on frame M (4 channels x 1024^2, 27 beads of each of 4
     codes, the JAX package's MRBLE bench workload): rows, fg/bg/roi
     digests and decoded tags must equal the golden file, ``ln_vol`` within
     ``LN_VOL_RTOL``; prints found / coded / outliers and the decode's
     stage times with the decode on the card and on the CPU;
   * ``beads_stream`` over 8 frames A and ``mrbles_stream`` over 6 frames M
     (seeds 0-5): every streamed frame must equal the single-frame call on
     that frame (rows, digests, tags), the launch counts must be frames x
     the per-frame count, and ms per frame streamed is printed next to ms
     per frame serial;
   * ``microfluidic_chip`` on frame C8 (the JAX package's chip bench
     workload: 8 x 8 chambers on 900^2, diameters 16-32, pitch 100) and on
     its 2-channel, 2-timestep variant with one empty channel: 64/64
     buttons, rows, fg/bg/roi digests and tags equal to the golden file, and
     for C8 ``device="cuda"`` equal to ``device="cpu"`` row for row;
   * ``microfluidic_chip`` on frame C: ``chip_type="pc"``, 56 x 28 = 1,568
     chambers on a 7,187 x 6,755 uint16 image, every other parameter at its
     default, 4% of the chambers blank through a pinlist, one searched and
     one copied timestep: every non-blank button within 1 px of where it
     was drawn, tags as the pinlist says; prints found / expected, the warm
     wall time, ``last_chip_timings`` and the peak of allocated device
     memory;
   * ``detector="ransac"`` at the default ``num_iter`` (5,000,000):
     ``beads`` on frame A (110/110) and ``microfluidic_chip`` on frame C8
     (64/64), both equal to the golden file's RANSAC entries (``RA``,
     ``RC8``); ``beads_stream`` over 3 frames A, each equal to the
     single-frame call; ``microfluidic_chip`` on frame C (every non-blank
     button within 1 px, the warm wall time, the unique proposals and the
     peak device memory); ms per frame beside the dense detector's on the
     same frame;
   * the same RANSAC paths but the stream with the conv scorer
     (``MAGNIFY_TPU_SCORER=conv`` for the phase: each proposal's score read
     out of the int8 score maps, which hysteresis and the ring correlation
     make; the perimeter scorer launches 0 times): frame A 110/110 and C8
     64/64 equal to the golden file's ``RAconv``/``RC8conv``, frame C every
     button within 1 px; ms per frame beside the perimeter scorer's;
   * the ops layer: ``ops.find_circles`` on frame A's plane (dense, RANSAC
     with each scorer, 5,000,000 proposals) equal on ``cuda`` and ``cpu``
     (circles and scores); ``ops.find_circles_stack`` over 8 planes of
     frame A (seeds 0-7, ``batch=4``: two uploads, one call of each kernel
     a plane), each plane equal to its ``find_circles`` call;
   * frame S (2 channels x 4 x 4 tiles of 1024^2, overlap 102, stitched to
     3,688^2; 256 beads under a vignette and a dark-field gradient) through
     ``beads_pipe`` with ``basic_correct`` after ``standardize_format``:
     each channel's BaSiC fields fitted on the card within 1e-4 (flat) and
     1e-5 x the mean (dark) of the CPU's, every drawn bead found within
     1 px and no other mark, the marks within 1 px of the golden file's
     ``S_rows`` (the JAX package's); prints the fit's time per channel on
     the card and on the CPU and ``diagnostics.stage_report()`` of one warm
     frame (frame A's warm loop prints one too);
   * stacks read from disk (in a temporary directory, deleted at the end):
     ``beads`` and ``image`` on frame B written as
     ``b/(channel)/tile_(row)_(col).tif`` (8 files) must equal the
     in-memory runs in every variable (and the golden file); ``beads`` on
     frame A with a flat field given as a TIFF path must equal the same
     array; ``microfluidic_chip`` on frame C written as one 2-page TIFF must
     equal the in-memory frame C run in every variable; each prints its
     warm time beside the in-memory one;
   * out of core: 4 x 20 x 4096^2 uint16 pages (2.68 GB, 5.0 x
     ``components.find.MAX_RESIDENT_BYTES``) written as
     ``ooc/(channel)/s.ome.tif`` (4 OME-TIFFs of 20 pages), then, in a
     child process (``--out-of-core DIR``) so that its peak RSS is its
     own, ``beads`` (dense, the search planes one at a time through both
     dense kernels) -> ``quantify`` -> ``save`` (npz) -> ``load``: the
     loaded result must equal the saved one; 84 pages decoded (every page
     once, each search channel's t = 0 page once more); every intensity
     rising with t; peak RSS above the warm baseline below half the
     stack's bytes; the marks equal to the 4 search planes run in memory,
     every one of the 1,760 drawn beads within 1 px; prints the write
     time, each stage's wall time and RSS peak;
   * under device meshes (``magnify_tpu_torch.parallel``): a (2, 4) and a
     (1, 4) mesh of the first card (one card named 8 and 4 times) and,
     where there are several cards, a mesh over all of them. The sharded
     hysteresis against ``hysteresis_plain`` on frame A's masks, frame C's
     plane and a serpentine that crosses every band boundary (rounds and
     launches printed); then under each mesh ``beads`` A and B,
     ``mrbles`` M, ``microfluidic_chip`` C8 and C, RANSAC ``beads`` A at
     5,000,000 proposals and ``find_circles_stack`` over 8 planes, each
     equal to the single-device run of this call (and the golden file, or
     for C the drawn buttons), with warm ms beside one device's for A, C8
     and C; and the out-of-core stack under each mesh in a child
     (``--out-of-core DIR --mesh``), equal to the single-device child's
     saved result (marks, masks, ROI store);
   * the tuning UI, headless (without matplotlib or a GUI backend):
     ``beads(interactive=True)`` on A, ``microfluidic_chip(interactive=
     True)`` on C8 and ``ops.find_circles(gui=InteractiveUI())`` on A's
     plane, each equal to its call without the UI;
4. decode at device scale: ``identify_mrbles`` alone on 8,192 marks x 5
   channels x 32^2 ROIs over the 24-code panel; tags on ``cuda`` must equal
   tags on ``cpu``; prints the stage times on both;
5. prints one JSON line of kernel records (per kernel: ``launches`` over
   all main paths, ``launches_by_path`` and ``launches_per_call``,
   ``ms``/``plain_ms``/``bound_ms``/``bound_share``/``library_ms`` at frame
   A's shapes and the same keys with ``_frame_b`` at frame B's,
   ``bound_by``, ``max_abs_err``, for hysteresis and ring_corr also with
   ``_ooc`` at the out-of-core plane and ``_frame_s`` at frame S's stitched
   plane; the batched entries have the same keys
   with ``_rois_c8`` and ``_rois_c``; perimeter_score's record has them for
   each of its inputs above (``profiler_ms`` beside ``ms``; ``bound_share``
   over ``profiler_ms`` and ``bound_share_events`` over ``ms``; the lanes a
   circle of each under ``plan``; ``redesigned``), and its batched entry
   has frame C's chamber batch under the plain keys; normalize_u8's has
   ``ms``/``plain_ms``/``host_ms``/``bound_ms``/``bound_share`` with
   ``_chip`` and ``_beads``, and no batched entry, and bead_ownership's
   ``ms``/``profiler_ms``/``host_ms``/``bound_ms``/``bound_share`` with
   ``_frame_s`` (frame S's drawn beads) and ``_cell`` (the bead cell's
   1,764 marks on 3,688^2)) and,
   last, one JSON line
   ``{"ok": true, "device": {...}}``.

Any failed check raises: the script exits nonzero and prints no result.
Without a CUDA device it exits 2 at once. ``--kernels-only`` stops after
phase 2. ``--out-of-core DIR`` is the child of the out-of-core phase, and
``--out-of-core DIR --mesh`` the one of the mesh phase.

The frame functions (:func:`frame_a`, :func:`frame_b`, :func:`frame_m`,
:func:`frame_c8`, :func:`frame_c`, :func:`frame_s`, :func:`cell_marks`) need
numpy and the port's copy of the library rasterizer only, so the golden-file
script imports them from here.
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import io
import json
import os
import pathlib
import statistics
import subprocess
import sys
import tempfile
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


# Frame M: the MRBLE workload. Three lanthanides seen through four
# channels; four codes, the dy/eu and sm/eu ratios each 0 or 1.
MRBLES_CHANNELS = ["435", "474", "536", "620"]
MRBLES_LNS = ["eu", "dy", "sm"]
MRBLES_SPECTRA = np.array([
    [1.0, 0.2, 0.1, 0.9],
    [0.1, 1.0, 0.3, 0.0],
    [0.0, 0.1, 0.9, 0.1],
])
MRBLES_CODES = {"code_a": (0.0, 0.0), "code_b": (1.0, 0.0),
                "code_c": (0.0, 1.0), "code_d": (1.0, 1.0)}
FRAME_M_KW = dict(min_bead_diameter=16, max_bead_diameter=24, overlap=0,
                  min_roundness=0.3, search_channel="620")
# The card's f32 sums of the fg pixels differ from the host's in the last
# bits (magnify_tpu_torch.ops.reduce.MEAN_RTOL = 2e-6 of ~10^2 intensities),
# and the 3 x 4 least squares carries that into the volumes.
LN_VOL_RTOL = 1e-4


def frame_m(seed: int = 2, n_per_code: int = 27):
    """The MRBLE frame: 4 channels x 1024^2 float32, ``n_per_code`` beads of
    radius 10 for each of the four codes at random non-touching positions,
    eu volumes 80-120, over a clipped Gaussian background (the JAX
    package's bench workload). Returns (planes, n_beads)."""
    rng = np.random.default_rng(seed)
    planes = np.zeros((len(MRBLES_CHANNELS), TILE, TILE), np.float32)
    disk = filled_circle_points(10)
    centers = []
    for dy_r, sm_r in MRBLES_CODES.values():
        placed = 0
        while placed < n_per_code:
            pos = rng.integers(40, TILE - 40, 2)
            if any(abs(pos[0] - c[0]) < 34 and abs(pos[1] - c[1]) < 34
                   for c in centers):
                continue
            centers.append(pos)
            eu = rng.uniform(80, 120)
            intensity = np.array([eu, dy_r * eu, sm_r * eu]) @ MRBLES_SPECTRA
            pts = disk + pos
            for ci in range(len(MRBLES_CHANNELS)):
                planes[ci, pts[:, 0], pts[:, 1]] = intensity[ci]
            placed += 1
    planes = np.maximum(
        planes + rng.normal(10.0, 2.5, planes.shape).astype(np.float32), 0.0)
    return planes, len(centers)


def mrbles_csvs():
    """(spectra, codes) of frame M as CSV file-likes."""
    spectra = ["name," + ",".join(MRBLES_CHANNELS)]
    spectra += [f"{n}," + ",".join(map(str, row))
                for n, row in zip(MRBLES_LNS, MRBLES_SPECTRA)]
    codes = ["name,eu,dy,sm"]
    codes += [f"{n},1.0,{d},{s}" for n, (d, s) in MRBLES_CODES.items()]
    return io.StringIO("\n".join(spectra)), io.StringIO("\n".join(codes))


# Frame C8: the JAX package's chip bench workload, and a 2-channel,
# 2-timestep variant (C8V) whose first channel is empty.
C8_GRID = (8, 8)
FRAME_C8_KW = dict(shape=C8_GRID, min_button_diameter=16,
                   max_button_diameter=32, overlap=0, row_dist=100,
                   col_dist=100)


def frame_c8() -> np.ndarray:
    """8 x 8 buttons of radius 10 at pitch 100 on a black 900^2 uint16
    image."""
    img = np.zeros(((C8_GRID[0] + 1) * 100, (C8_GRID[1] + 1) * 100),
                   np.uint16)
    pts = filled_circle_points(10)
    for i in range(C8_GRID[0]):
        for j in range(C8_GRID[1]):
            img[pts[:, 0] + (i + 1) * 100, pts[:, 1] + (j + 1) * 100] = 1000
    return img


def frame_c8v(seed: int = 3) -> np.ndarray:
    """(channel, time, y, x): channel 0 is empty (zeros), channel 1 holds
    frame C8 on Gaussian noise at t = 0 and the same buttons moved by
    (3, 2) pixels at t = 1 (a copied timestep keeps t = 0's positions)."""
    rng = np.random.default_rng(seed)
    out = np.zeros((2, 2) + frame_c8().shape, np.uint16)
    out[1] = rng.normal(100, 4, out[1].shape).astype(np.uint16)
    buttons = frame_c8() > 0
    out[1, 0][buttons] = 1000
    out[1, 1][np.roll(buttons, (3, 2), axis=(0, 1))] = 1000
    return out


# Frame C: the README's deployment, a "pc" chip at full size.
C_GRID = (56, 28)
C_ROW_DIST, C_COL_DIST = 406 / 3.22, 750 / 3.22
C_BLANK_EVERY = 25  # every 25th chamber (4%) is blank
FRAME_C_KW = dict(chip_type="pc", overlap=0)


def _c_blank(i: int, j: int) -> bool:
    return (i * C_GRID[1] + j) % C_BLANK_EVERY == 7


@functools.lru_cache(maxsize=1)
def frame_c(seed: int = 4):
    """The full-size chip frame: a (time=2, y, x) uint16 stack, 56 x 28
    chambers at the "pc" pitches (126.09 x 232.92 px), buttons of radius
    5-14 (of the default diameters 8-30) and brightness 5,000-9,500 over a
    dim noisy background (100 +- 5, below one uint8 level of the normalized
    plane, as the dark field of a fluorescence image is), none in the blank
    chambers. The second
    timestep repeats the first. Returns (stack, centers (56, 28, 2) int of
    the drawn (y, x), blank (56, 28) bool)."""
    rng = np.random.default_rng(seed)
    rows, cols = C_GRID
    h = round((rows + 1) * C_ROW_DIST)
    w = round((cols + 1) * C_COL_DIST)
    img = rng.normal(100, 5, (h, w)).astype(np.float32).astype(np.uint16)
    centers = np.zeros((rows, cols, 2), np.int64)
    blank = np.zeros((rows, cols), bool)
    for i in range(rows):
        for j in range(cols):
            cy = round((i + 1) * C_ROW_DIST) + (i * 7 + j * 3) % 5 - 2
            cx = round((j + 1) * C_COL_DIST) + (i * 5 + j * 11) % 5 - 2
            centers[i, j] = cy, cx
            blank[i, j] = _c_blank(i, j)
            if blank[i, j]:
                continue
            pts = filled_circle_points(5 + (i * 3 + j) % 10)
            img[pts[:, 0] + cy, pts[:, 1] + cx] = 5000 + 500 * ((i + j) % 10)
    return np.stack([img, img]), centers, blank


def frame_c_pinlist() -> io.StringIO:
    """Frame C's layout as a pinlist CSV: "(col, row)" 1-indexed."""
    lines = ["Indices,MutantID"]
    for i in range(C_GRID[0]):
        for j in range(C_GRID[1]):
            name = "BLANK" if _c_blank(i, j) else f"m{i}_{j}"
            lines.append(f'"({j + 1}, {i + 1})",{name}')
    return io.StringIO("\n".join(lines) + "\n")


# Frame S: a 4 x 4 scan of 1024^2 tiles under a vignette and a dark-field
# gradient, for ``basic_correct``.
S_GRID = 4
S_CHANNELS = ["a", "b"]
# min_roundness 0.45: on the 13.6 M pixels of the stitched plane the
# background noise alone forms circles of radius 8 that score up to 0.37
# (five of them above 0.3), while every bead scores above 0.57.
FRAME_S_KW = dict(min_bead_diameter=16, max_bead_diameter=24,
                  overlap=OVERLAP_B, min_roundness=0.45, search_channel="a")


@functools.lru_cache(maxsize=1)
def s_shading():
    """Frame S's flat field (a vignette from 1 in the centre to 0.6 in the
    corners) and dark field (a gradient from 100 to 300 counts), each
    (TILE, TILE) float64."""
    yy, xx = np.mgrid[0:TILE, 0:TILE]
    rr = ((yy - (TILE - 1) / 2) ** 2 + (xx - (TILE - 1) / 2) ** 2) / (
        2 * ((TILE - 1) / 2) ** 2)
    return 1.0 - 0.4 * rr, 100.0 + 100.0 * (yy + xx) / (TILE - 1)


def frame_s(seed: int = 6, one_level: bool = False, per_side: int = S_GRID):
    """The scan frame: (channel 2, row 4, col 4, y, x) uint16 tiles of
    1024^2 that overlap by ``OVERLAP_B`` (stitched to 3,688^2).

    Every tile holds ``per_side`` x ``per_side`` beads (16 by default) of
    radius 8-11 on a jittered grid inside the part that stitching keeps,
    drawn from a seed of its own, at the same spots in both channels
    (+1,500 counts in "a", +1,000 in "b") over a background level of its
    own and Gaussian noise (sd 5). The levels of a channel's 16 tiles are
    100, 160, ..., 1,000 counts in an order drawn from the seed: the
    per-image baseline of BaSiC's model, which the fit needs to vary (with
    ``one_level`` every tile is at 550 and its dark field is not
    identifiable). Each tile is then shaded by :func:`s_shading`'s flat
    field and offset by its dark field. Returns (tiles, beads (n, 3) int of
    the drawn (y, x, radius) in the stitched image)."""
    step = TILE - OVERLAP_B
    clip = OVERLAP_B // 2
    flat, dark = s_shading()
    out = np.empty((len(S_CHANNELS), S_GRID, S_GRID, TILE, TILE), np.uint16)
    beads = []
    pitch = step // per_side
    levels = [np.full(S_GRID * S_GRID, 550.0) if one_level else
              100.0 + 60.0 * np.random.default_rng([seed, ci]).permutation(
                  S_GRID * S_GRID) for ci in range(len(S_CHANNELS))]
    for tr in range(S_GRID):
        for tc in range(S_GRID):
            rng = np.random.default_rng([seed, tr, tc])
            spots = [(clip + a * pitch + int(rng.integers(15, pitch - 15)),
                      clip + b * pitch + int(rng.integers(15, pitch - 15)),
                      int(rng.integers(8, 12)))
                     for a in range(per_side) for b in range(per_side)]
            beads += [(y - clip + tr * step, x - clip + tc * step, r)
                      for y, x, r in spots]
            for ci, bead in enumerate((1500.0, 1000.0)):
                img = levels[ci][tr * S_GRID + tc] + rng.normal(
                    0, 5, (TILE, TILE))
                for y, x, r in spots:
                    p = filled_circle_points(r) + np.array([y, x])
                    img[p[:, 0], p[:, 1]] += bead
                out[ci, tr, tc] = np.clip(np.round(img * flat + dark), 0,
                                          65535)
    return out, np.array(beads)


def frame_s_pipe(pkg, **kw):
    """``beads_pipe`` of package ``pkg`` for frame S with ``basic_correct``
    after ``standardize_format``; ``kw`` goes to ``beads_pipe``, and its
    ``device`` to ``basic_correct`` too."""
    pipe = pkg.beads_pipe(**FRAME_S_KW, **kw)
    pipe.add_pipe("basic_correct", after="standardize_format",
                  **{k: v for k, v in kw.items() if k == "device"})
    return pipe


def cell_marks(seed: int = 0, side: int = 3688, pitch: int = 88,
               jitter: int = 8) -> np.ndarray:
    """Bead marks (n, 3) int32 (row, col, radius) laid out as the bead
    cell's: a grid of ``pitch`` jittered by up to ``jitter`` on a
    ``side``^2 plane (1,764 marks at 3,688^2), radii 5-15."""
    rng = np.random.default_rng(seed)
    centres = np.arange(pitch // 2, side - pitch // 4, pitch)
    yy, xx = np.meshgrid(centres, centres, indexing="ij")
    n = yy.size
    return np.stack([yy.ravel() + rng.integers(-jitter, jitter + 1, n),
                     xx.ravel() + rng.integers(-jitter, jitter + 1, n),
                     rng.integers(5, 16, n)], 1).astype(np.int32)


def as_dataarray(pkg, case: str, seed=None):
    """Frame ``case`` ("A", "B", "M", "C8", "C8V", "C" or "S") as a
    DataArray of package ``pkg``."""
    if case == "S":
        return pkg.DataArray(frame_s()[0],
                             dims=("channel", "row", "col", "y", "x"),
                             coords={"channel": S_CHANNELS})
    if case == "C8":
        return pkg.DataArray(frame_c8(), dims=("y", "x"))
    if case == "C8V":
        return pkg.DataArray(frame_c8v(), dims=("channel", "time", "y", "x"),
                             coords={"channel": ["empty", "egfp"]})
    if case == "C":
        return pkg.DataArray(frame_c()[0], dims=("time", "y", "x"))
    if case == "A":
        return pkg.DataArray(frame_a()[0], dims=("y", "x"))
    if case == "M":
        planes, _n = frame_m(2 if seed is None else seed)
        return pkg.DataArray(planes, dims=("channel", "y", "x"),
                             coords={"channel": MRBLES_CHANNELS})
    return pkg.DataArray(frame_b(), dims=("channel", "row", "col", "y", "x"),
                         coords={"channel": ["red", "green"]})


def digest(a) -> str:
    a = np.ascontiguousarray(np.asarray(a))
    h = hashlib.sha256(f"{a.dtype.str}{a.shape}".encode())
    h.update(a.tobytes())
    return h.hexdigest()


def summarize(xp) -> dict:
    """What the golden file holds of one result: the bead rows (y, x) in
    mark order and digests of the fg/bg masks and ROI crops; of an
    ``mrbles`` result also the decoded tags (as unicode) and ``ln_vol``, of
    a chip result the chamber tags."""
    rows = np.stack([np.asarray(xp.y.values, float).ravel(),
                     np.asarray(xp.x.values, float).ravel()], axis=1)
    out = {"rows": rows, "fg": digest(xp.fg.values),
           "bg": digest(xp.bg.values), "roi": digest(xp["roi"].values)}
    if "tag" in xp.variables:
        out["tag"] = np.asarray(xp.tag.values).astype(str)
    if "ln_vol" in xp.variables:
        out["ln_vol"] = np.asarray(xp["ln_vol"].values, np.float64)
    return out


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


def _event_once_ms(fn) -> float:
    """Device time of ONE call of ``fn`` in ms, without a warm-up call: for
    the plain twins at the full chip's batch, which take seconds."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


# Published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W).
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15
F32_OPS_PER_S = 67e12  # float32 outside the tensor cores


def _bound(n_bytes: int, n_ops: int, ops_per_s: float = INT8_OPS_PER_S):
    """Least time (ms) for moving ``n_bytes`` once and doing ``n_ops``
    operations at ``ops_per_s`` (int8 unless said), and which of the two
    sets it."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
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


def _roi_stages(img, centers, roi_length, min_radius, max_radius, dev):
    """Canny masks (N, L, L) and padded int8 features (N, 8, Lp, Lp) of the
    chamber crops of one uint16 plane around ``centers`` (n, 2), on
    ``dev``, through the stages of
    ``magnify_tpu_torch.ops.detect.detect_rois_dense`` (the shapes and
    values the chip path's refinement sees)."""
    import torch
    import torch.nn.functional as F

    from magnify_tpu_torch.ops import detect, edge, geom, score

    h, w = img.shape
    L = roi_length
    plane = torch.as_tensor(detect.normalize_planes_u8(img[None])[0]).to(dev)
    cy = torch.as_tensor(centers[:, 0]).to(dev)
    cx = torch.as_tensor(centers[:, 1]).to(dev)
    rois = geom.extract_rois(plane, torch.clamp(cy - L // 2, 0, h - L),
                             torch.clamp(cx - L // 2, 0, w - L), L)
    u8 = edge.normalize_to_u8(rois)
    dx, dy = edge.scharr(edge.gaussian_blur5_u8(u8))
    grad = edge.sqrt_f32(dx * dx + dy * dy)
    high_q = np.float32(1 - np.pi * min_radius / L**2)
    lo, hi = edge.histogram_quantiles(grad, [np.float32(0.1), high_q],
                                      batched=True)
    strong, weak = edge.canny_nms(dx, dy, lo, hi)
    edges = edge.hysteresis(strong, weak)
    pad = 2 * max_radius
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


def _frame_s_planes() -> np.ndarray:
    """Both channels of frame S stitched (2 x 3,688^2 uint16), as the
    stitch component joins them: the bead scan's search planes."""
    clip = OVERLAP_B // 2
    tiles = frame_s()[0][:, :, :, clip:TILE - clip, clip:TILE - clip]
    c, n, m, th, tw = tiles.shape
    return np.ascontiguousarray(tiles.transpose(0, 1, 3, 2, 4)).reshape(
        c, n * th, m * tw)


def _frame_s_plane() -> np.ndarray:
    """Channel "a" of frame S stitched (3,688^2 uint16): the shape the main
    path's detector sees (after ``basic_correct``, which changes values,
    not shape)."""
    return np.ascontiguousarray(_frame_s_planes()[0])


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


def _hysteresis_record(dev, planes, rois) -> dict:
    import torch

    from magnify_tpu_torch.ops import hysteresis as hyst

    ((strong_a, weak_a), (strong_b, weak_b), (strong_o, weak_o),
     (strong_s, weak_s)) = planes
    rng = np.random.default_rng(7)
    cases = [("frame A masks", strong_a, weak_a, None),
             ("frame B masks", strong_b, weak_b, None),
             ("out-of-core plane masks", strong_o, weak_o, None),
             ("frame S stitched plane masks", strong_s, weak_s, None)]
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
    # Batches of planes: the chamber crops, widths that are no multiple of
    # 4 or of the 128-column tile, heights below the tile's rows, and planes
    # that would join across the plane border.
    for tag, (s, w) in rois.items():
        cases.append((f"ROI crops of frame {tag}", s, w, None))
    for shape, tr in (((37, 40, 17), None), ((64, 72, 72), None),
                      ((9, 33, 130), 8), ((300, 5, 72), None)):
        s = rng.random(shape) > 0.99
        w = s | (rng.random(shape) > 0.65)
        cases.append((f"random batch {shape} tile_rows={tr}",
                      torch.as_tensor(s).to(dev), torch.as_tensor(w).to(dev),
                      tr))
    s = np.zeros((6, 24, 72), bool)
    w = np.zeros_like(s)
    s[0::2, -1, :] = w[0::2, -1, :] = True  # plane k ends in a strong row
    w[1::2, 0:3, :] = True                  # plane k + 1 starts in weak rows
    cases.append(("planes that touch in memory", torch.as_tensor(s).to(dev),
                  torch.as_tensor(w).to(dev), None))
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
        if name.startswith("planes that touch") and bool(got[1::2].any()):
            raise AssertionError("hysteresis grew from one plane into the "
                                 "next")
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
    timed = [("", strong_a, weak_a), ("_frame_b", strong_b, weak_b),
             ("_ooc", strong_o, weak_o), ("_frame_s", strong_s, weak_s)]
    timed += [(f"_rois_{tag.lower()}", s, w) for tag, (s, w) in rois.items()]
    for tag, s, w in timed:
        k_ms = _event_ms(lambda: hyst.hysteresis(s, w), 100)
        p_ms = _event_ms(lambda: hyst.hysteresis_plain(s, w), 3)
        # Strong and weak masks read once, the result written once: 3 B/px.
        bound_ms, bound_by = _bound(3 * s.numel(), 0)
        rec.update({f"ms{tag}": k_ms, f"plain_ms{tag}": p_ms,
                    f"bound_ms{tag}": bound_ms, "bound_by": bound_by,
                    f"bound_share{tag}": bound_ms / k_ms})
        _say(f"hysteresis time at {tuple(s.shape)}: kernel {k_ms:.4f} ms, "
             f"plain {p_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by})")
    # The whole-plane and tiled forms of the TPU kernel are one kernel
    # here; the random 2048^2 and 4096^2 masks time it past the whole-plane
    # form's size.
    for name, s, w, _ in cases[4:6]:
        kn = _event_ms(lambda: hyst.hysteresis(s, w), 20)
        pn = _event_once_ms(lambda: hyst.hysteresis_plain(s, w))
        bn, _by = _bound(3 * s.numel(), 0)
        tag = "_" + name.replace(" ", "").replace("^2", "")
        rec.update({f"ms{tag}": kn, f"plain_ms{tag}": pn,
                    f"bound_ms{tag}": bn, f"bound_share{tag}": bn / kn})
        _say(f"hysteresis time on {name}: kernel {kn:.4f} ms, plain "
             f"{pn:.4f} ms (one call), bound {bn:.5f} ms (bytes)")
    rec["library_ms"] = None  # no single PyTorch call computes it
    return rec


def _ring_corr_record(dev, feats_ab, roi_feats) -> dict:
    """``roi_feats``: {frame: (features (N, 8, Lp, Lp), (min_radius,
    max_radius))} of the chamber crops."""
    import torch
    import torch.nn.functional as F

    from magnify_tpu_torch.ops import score

    # (key suffix, name, features, weights, plain twin timed with a warm-up)
    cases = [("", "frame A", feats_ab[0], (8, 12), True),
             ("_frame_b", "frame B", feats_ab[1], (8, 12), True),
             ("_ooc", "the out-of-core plane", feats_ab[2], (8, 12), False),
             ("_frame_s", "frame S's stitched plane", feats_ab[3], (8, 12),
              False)]
    for tag, (feats, radii) in roi_feats.items():
        cases.append((f"_rois_{tag.lower()}", f"ROI crops of frame {tag}",
                      feats, radii, feats.shape[0] <= 64))
    err, per_call, plain_ms = 0, set(), {}
    for sfx, name, feats, radii, _warm in cases:
        weights, _dq = score._cached_tables(*radii, str(dev))
        nnz = int((weights.dense != 0).sum())
        before = score.launches
        got = score.ring_corr(feats, weights)
        per_call.add(score.launches - before)
        want = []
        plain_ms[sfx] = _event_once_ms(
            lambda: want.append(score.ring_corr_plain(feats, weights)))
        e = int((got.to(torch.int64) - want[0].to(torch.int64)).abs().max())
        if e != 0 or got.shape != want[0].shape:
            raise AssertionError(f"ring_corr kernel != plain twin on {name}: "
                                 f"max |diff| {e}")
        err = max(err, e)
        _say(f"ring_corr == plain on {name} features {tuple(feats.shape)} "
             f"-> {tuple(got.shape)} int32, radii {radii}, "
             f"{int(weights.table.shape[0])} positions, {nnz} taps")
        del got, want
    if per_call != {1}:
        raise AssertionError(f"ring_corr launches per call {per_call}")
    per_call = 1

    tf32 = torch.backends.cudnn.allow_tf32
    bench = torch.backends.cudnn.benchmark
    rec = {"name": "ring_corr", "route": "cuda",
           "source": "magnify_tpu_torch/csrc/ring_corr.cu",
           "replaces": "magnify_tpu/ops/score.py:637",
           "launches_per_call": per_call, "max_abs_err": err,
           "library_call": "F.conv2d(feats.float()[None], "
                           "weights.dense.float(), padding=R)",
           "library_cudnn_allow_tf32": tf32,
           "library_cudnn_benchmark": bench}
    for tag, _name, feats, radii, warm in cases:
        weights, _dq = score._cached_tables(*radii, str(dev))
        dense_f = weights.dense.float()
        n_r, _c, k, _ = weights.dense.shape
        rad = k // 2
        nnz = int((weights.dense != 0).sum())
        h, w = feats.shape[-2:]
        px = feats.numel() // 8  # pixels of all planes
        k_ms = _event_ms(lambda: score.ring_corr(feats, weights), 50)
        # The full chip's batch takes seconds in float64: its one checked
        # call above is its time.
        p_ms = (_event_ms(lambda: score.ring_corr_plain(feats, weights), 3)
                if warm else plain_ms[tag])
        ff = feats.float().reshape(-1, 8, h, w)
        lib = F.conv2d(ff, dense_f, padding=rad)
        lib_err = float((lib.reshape(-1) - score.ring_corr(feats, weights)
                         .reshape(-1)).abs().max())
        del lib
        lib_ms = _event_ms(lambda: F.conv2d(ff, dense_f, padding=rad),
                           20 if warm else 3)
        # int8 features read once, int32 maps written once; one multiply
        # and one add per nonzero weight and pixel.
        bound_ms, bound_by = _bound((8 + 4 * n_r) * px, 2 * nnz * px)
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


@contextlib.contextmanager
def spy(module, name: str, wrap):
    """Within the block ``module.<name>`` is ``wrap(original)``. The
    scorer check takes its inputs from the main path's own calls this way,
    and ``scripts/torch_profile_frame.py`` times the RANSAC stages."""
    real = getattr(module, name)
    setattr(module, name, wrap(real))
    try:
        yield
    finally:
        setattr(module, name, real)


def _scorer_calls(run) -> list:
    """The arguments of every ``score_circles`` call that ``ops.detect``
    makes in ``run()``, in order, each a dict of its parameters."""
    import inspect

    from magnify_tpu_torch.ops import detect, score

    sig = inspect.signature(score.score_circles)
    calls = []

    def wrap(real):
        def call(*args, **kw):
            bound = sig.bind(*args, **kw)
            bound.apply_defaults()
            calls.append(dict(bound.arguments))
            return real(*args, **kw)
        return call

    with spy(detect, "score_circles", wrap):
        run()
    return calls


def _perimeter_work(grad_angles, edges, circles, valid, max_radius,
                    pad) -> tuple:
    """What the scorer must touch for these inputs: the valid circles, the
    edge pixels on their perimeters (where it does its float32 arithmetic),
    the distinct pixels on their perimeters (whose edge flag it reads) and
    the distinct edge pixels among them (whose angle it reads). Counted on
    the planes padded by ``pad``, where the reference reads them: the
    padding adds no edge pixels and its pixels are counted as the reference
    reads them."""
    import torch
    import torch.nn.functional as F

    from magnify_tpu_torch.ops import score

    offsets, lengths, _e = score._perimeter_tensors(max_radius,
                                                    str(circles.device))
    c = circles.reshape(-1, 3).to(torch.int64)
    r = torch.clamp(c[:, 2], 0, max_radius)
    padded = F.pad(edges, (pad,) * 4)
    hp, wp = padded.shape[-2:]
    base = 0
    if circles.ndim == 3:
        base = torch.arange(circles.shape[0], device=c.device
                            ).repeat_interleave(circles.shape[1]) * (hp * wp)
    flat = padded.reshape(-1)
    live = (torch.ones_like(r, dtype=torch.bool) if valid is None
            else valid.reshape(-1).to(torch.bool))
    seen = torch.zeros_like(flat)
    hits = torch.zeros(c.shape[0], dtype=torch.int64, device=c.device)
    for p in range(offsets.shape[1]):
        idx = base + score._pixel_index(c, offsets, r, p, hp, wp)
        on = live & (p < lengths[r])
        seen[idx[on]] = True
        hits += (flat[idx] & on).to(torch.int64)
    return (int(live.sum()), int(hits.sum()), int(seen.sum()),
            int((seen & flat).sum()))


# The scorer calls of each RANSAC main path, in the order it makes them.
SCORER_CALLS = {
    "A": (("", "frame A's whole plane"),),
    "C8": (("_plane_c8", "frame C8's whole plane"),
           ("_rois_c8", "frame C8's chamber batch"),
           ("_climb_c8", "frame C8's hill-climb")),
    "C": (("_plane_c", "frame C's whole plane"),
          ("_rois_c", "frame C's chamber batch"),
          ("_climb_c", "frame C's hill-climb")),
}


def _small_radius_calls(dev) -> list:
    """The scorer at ``max_radius`` 0, 1 and 2 (perimeters of 1, 8 and 12
    positions, whose sum forms differ from the larger radii's): random
    angles and edges (30% edges) on a 1024^2 plane padded by 2 * max_radius
    and 200,000 random circles, reaching 3 pixels past the padded plane,
    with radii -1 .. max_radius + 1 and 10% invalid."""
    import torch

    calls = []
    for max_r in (0, 1, 2):
        rng = np.random.default_rng(100 + max_r)
        h = w = TILE
        pad = 2 * max_r
        n = 200_000
        angles = rng.uniform(-np.pi, np.pi, (h, w)).astype(np.float32)
        circles = np.stack([rng.integers(-3, h + 2 * pad + 3, n),
                            rng.integers(-3, w + 2 * pad + 3, n),
                            rng.integers(-1, max_r + 2, n)],
                           axis=1).astype(np.int32)
        calls.append((f"_r{max_r}", f"random 1024^2 plane at max_radius "
                      f"{max_r}", dict(
                          grad_angles=torch.as_tensor(angles).to(dev),
                          edges=torch.as_tensor(rng.random((h, w)) < 0.3
                                                ).to(dev),
                          circles=torch.as_tensor(circles).to(dev),
                          valid=torch.as_tensor(rng.random(n) < 0.9).to(dev),
                          max_radius=max_r, pad=pad)))
    return calls


def _profiled_kernel_ms(fn, reps: int, kernel: str = "perimeter") -> tuple:
    """Device time of one launch of the kernel whose name holds ``kernel``
    (the scorer's by default), from
    ``torch.profiler`` over ``reps`` calls after one warm-up call (the
    mean over the launches it recorded; it may drop some when calls come
    this fast): (ms, launches recorded), or (None, 0) if it recorded no
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us, count = 0.0, 0
    for evt in prof.key_averages():
        if kernel not in evt.key:
            continue
        us += getattr(evt, "device_time_total", None) or getattr(
            evt, "cuda_time_total", 0.0)
        count += evt.count
    if us <= 0 or count == 0:
        return None, 0
    return us / 1e3 / count, count


def _perimeter_record(dev) -> dict:
    """perimeter_score against score_circles_plain on the card, bit for
    bit, on every input the RANSAC main paths give it (``beads`` on frame
    A and ``microfluidic_chip`` on frames C8 and C at the default
    ``num_iter``, their scorer calls taken from one run of each; its
    launches are not a main path's) and on three random planes at
    ``max_radius`` 0-2, one launch each in the plan
    :func:`magnify_tpu_torch.ops.score.perimeter_plan` gives. Each timed with
    CUDA events (50 back-to-back calls) and, kernels only, with
    ``torch.profiler`` (20 calls), beside the twin; its bound from the
    bytes it must move (valid flags and scores of every circle, the valid
    circles and their plane indices, the edge flag of each distinct
    perimeter pixel and the angle of each distinct edge pixel among them,
    each once) and its float32 operations (6 at each edge pixel of a
    perimeter, one division per valid circle)."""
    import torch

    import magnify_tpu_torch as mt
    from magnify_tpu_torch.ops import score

    kw = dict(detector="ransac", device=dev)
    runs = {
        "A": lambda: mt.beads(as_dataarray(mt, "A"), **kw, **FRAME_A_KW),
        "C8": lambda: mt.microfluidic_chip(as_dataarray(mt, "C8"), **kw,
                                           **FRAME_C8_KW),
        "C": lambda: mt.microfluidic_chip(as_dataarray(mt, "C"),
                                          pinlist=frame_c_pinlist(), **kw,
                                          **FRAME_C_KW),
    }
    rec = {"name": "perimeter_score", "route": "cuda",
           "source": "magnify_tpu_torch/csrc/perimeter_score.cu",
           "replaces": "magnify_tpu/ops/score.py:671", "redesigned": "PR 6",
           "launches_per_call": 1, "plan": {}, "library_ms": None}
    inputs = []
    for frame, run in runs.items():
        calls = _scorer_calls(run)
        if len(calls) != len(SCORER_CALLS[frame]):
            raise AssertionError(f"perimeter_score: frame {frame} made "
                                 f"{len(calls)} scorer calls")
        for (tag, name), args in zip(SCORER_CALLS[frame], calls):
            inputs.append((frame, tag, name, args))
    inputs += [(None, tag, name, args)
               for tag, name, args in _small_radius_calls(dev)]
    err = 0.0
    for frame, tag, name, args in inputs:
        circles, max_r, pad = args["circles"], args["max_radius"], args["pad"]
        n = int(np.prod(circles.shape[:-1]))
        n_pos = score._perimeter_tensors(max_r, str(dev))[0].shape[1]
        lanes = score.perimeter_plan(circles, max_radius=max_r)
        before = score.perimeter_launches
        got = score.score_circles(**args)
        if score.perimeter_launches != before + 1:
            raise AssertionError("perimeter_score: one launch per call "
                                 f"expected on {name}")
        want = score.score_circles_plain(**args)
        torch.cuda.synchronize()
        bits_got, bits_want = got.view(torch.int32), want.view(torch.int32)
        if not torch.equal(bits_got, bits_want):
            bad = int((bits_got != bits_want).sum())
            raise AssertionError(f"perimeter_score != plain twin on "
                                 f"{name}: {bad} of {n} scores differ")
        fin = torch.isfinite(want)
        if bool(fin.any()):
            err = max(err, float((got[fin] - want[fin]).abs().max()))
        k_ms = _event_ms(lambda: score.score_circles(**args), 50)
        prof_ms, prof_launches = _profiled_kernel_ms(
            lambda: score.score_circles(**args), 20)
        p_ms = _event_ms(lambda: score.score_circles_plain(**args), 3)
        angles, valid = args["grad_angles"], args["valid"]
        n_valid, hits, touched, touched_edges = _perimeter_work(
            angles, args["edges"], circles, valid, max_r, pad)
        n_bytes = (n * (4 + (valid is not None))
                   + n_valid * (12 + 4 * (circles.ndim == 3))
                   + touched + 4 * touched_edges)
        bound_ms, bound_by = _bound(n_bytes, 6 * hits + n_valid,
                                    F32_OPS_PER_S)
        key = tag or "_frame_a"
        rec["plan"][key] = lanes
        # The share of the bound over the kernel's device time (profiler);
        # over the CUDA-event time (which holds the wrapper's host work
        # between back-to-back calls) as well.
        rec.update({f"ms{tag}": k_ms, f"profiler_ms{tag}": prof_ms,
                    f"plain_ms{tag}": p_ms, f"bound_ms{tag}": bound_ms,
                    "bound_by": bound_by,
                    f"bound_share{tag}": (bound_ms / prof_ms
                                          if prof_ms else None),
                    f"bound_share_events{tag}": bound_ms / k_ms,
                    f"n_circles{tag}": n, f"L{tag}": n_pos})
        n_planes = angles.shape[0] if angles.ndim == 3 else 1
        _say(f"perimeter_score == plain on {name}: N = {n} circles "
             f"({n_valid} valid) on {n_planes} plane(s) of "
             f"{tuple(angles.shape[-2:])} (pad {pad} not stored), L = "
             f"{n_pos} positions, {hits} edge hits, {touched} perimeter "
             f"pixels ({touched_edges} edges); {lanes} lane(s) a circle; "
             f"kernel {k_ms:.4f} ms (CUDA "
             f"events), {prof_ms} ms on the device (profiler, the kernel "
             f"alone, mean of the {prof_launches} launches it recorded of "
             f"20), plain {p_ms:.4f} ms, bound {bound_ms:.5f} ms "
             f"({bound_by}), share {rec[f'bound_share{tag}']} of the "
             f"device time ({bound_ms / k_ms:.4f} of the event time); no "
             "single PyTorch call computes it")
        del got, want
    rec["max_abs_err"] = err
    return rec


def _normalize_record(dev) -> dict:
    """The uint8 normalization kernel at the dense finders' search planes:
    the chip's (frame C, 1 x 7,187 x 6,755) and the bead scan's (frame S's
    two channels, 2 x 3,688^2). Bit-equal to the host's
    ``normalize_planes_u8`` and to the plain twin on the card, then timed
    with CUDA events over 100 calls (the twin over 3, the host's numpy
    normalization, the work the kernel took over, by wall time over 3)
    against its bound: 5 bytes a pixel (2 read for the min/max, 2 read and
    1 written for the quantization)."""
    import torch

    from magnify_tpu_torch.ops import detect, edge

    rec = {"name": "normalize_u8", "route": "CUDA",
           "source": "magnify_tpu_torch/csrc/normalize_u8.cu",
           "replaces": "magnify_tpu/ops/detect.py:992 normalize_planes_u8 "
                       "(host twin of magnify_tpu/ops/edge.py:42 "
                       "normalize_to_u8), for whole planes",
           "launches_per_call": edge.NORMALIZE_U8_LAUNCHES_PER_CALL,
           "bound_by": "bytes", "max_abs_err": 0}
    for tag, raw in (("chip", frame_c()[0][:1]),
                     ("beads", _frame_s_planes())):
        raw = np.ascontiguousarray(raw)
        host = detect.normalize_planes_u8(raw)
        raw_dev = torch.from_numpy(raw).to(dev)
        before = edge.normalize_u8_launches
        got = edge.normalize_u8(raw_dev)
        torch.cuda.synchronize()
        if edge.normalize_u8_launches - before != rec["launches_per_call"]:
            raise AssertionError("normalize_u8 did not launch its kernels")
        if not np.array_equal(got.cpu().numpy(), host):
            raise AssertionError(f"normalize_u8 != normalize_planes_u8 at "
                                 f"{tag} {raw.shape}")
        plain = edge.normalize_to_u8(raw_dev).to(torch.uint8)
        if not torch.equal(got, plain):
            raise AssertionError(f"normalize_u8 != its plain twin at {tag}")
        del plain
        ms = _event_ms(lambda: edge.normalize_u8(raw_dev), 100)
        plain_ms = _event_ms(
            lambda: edge.normalize_to_u8(raw_dev).to(torch.uint8), 3)
        host_ms = _time_ms(lambda: detect.normalize_planes_u8(raw), 3)
        bound_ms, _by = _bound(5 * raw.size, 0)
        rec.update({f"ms_{tag}": round(ms, 4),
                    f"plain_ms_{tag}": round(plain_ms, 4),
                    f"host_ms_{tag}": round(host_ms, 2),
                    f"bound_ms_{tag}": round(bound_ms, 5),
                    f"bound_share_{tag}": round(bound_ms / ms, 4),
                    f"shape_{tag}": list(raw.shape)})
        _say(f"normalize_u8 at {tag} {raw.shape}: bit-equal; kernel "
             f"{ms:.4f} ms, bound {bound_ms:.5f} ms "
             f"({100 * bound_ms / ms:.1f}%), plain twin {plain_ms:.4f} ms, "
             f"host numpy {host_ms:.2f} ms")
        del raw_dev, got
    return rec


def _ownership_record(dev) -> dict:
    """The bead ownership kernel on frame S's 3,688^2 plane: at frame S's
    drawn beads (L = 48, radii to 12) and at the bead cell's layout
    (1,764 marks, L = 60, radii to 15). Bit-equal to the wrapper's CPU
    branch (the host's numpy pass, the work the kernel took over), then
    timed with CUDA events over 100 calls and the kernel alone by
    ``torch.profiler`` over 100 (the CPU branch by wall time over 3)
    against its bound (the share is of the profiler's time): the masks
    written once (2 L^2 bytes a mark) and the marks and corners read once
    (20 bytes a mark)."""
    import torch

    from magnify_tpu_torch.components import find
    from magnify_tpu_torch.ops import geom

    rec = {"name": "bead_ownership", "route": "CUDA",
           "source": "magnify_tpu_torch/csrc/bead_ownership.cu",
           "replaces": "no TPU kernel: the host's ownership masks, "
                       "magnify_tpu/components/find.py:298",
           "launches_per_call": 1, "bound_by": "bytes", "max_abs_err": 0}
    side = S_GRID * (TILE - OVERLAP_B)  # the stitched plane, 3,688
    for tag, marks, L, max_radius in (
            ("frame_s", frame_s()[1].astype(np.int32), 48, 12),
            ("cell", cell_marks(), 60, 15)):
        n = len(marks)
        tops, lefts = find._bead_windows(marks, side, side, L)
        host = [torch.from_numpy(np.ascontiguousarray(a, np.int32))
                for a in (marks, tops, lefts)]
        want = geom.bead_ownership(*host, L, max_radius)
        args = [a.to(dev) for a in host]
        before = geom.bead_ownership_launches
        got = geom.bead_ownership(*args, L, max_radius)
        torch.cuda.synchronize()
        if geom.bead_ownership_launches - before != 1:
            raise AssertionError("bead_ownership did not launch its kernel")
        if not torch.equal(got.cpu(), want):
            raise AssertionError(f"bead_ownership on the card != its CPU "
                                 f"branch at {tag} ({n} marks, L = {L})")
        ms = _event_ms(lambda: geom.bead_ownership(*args, L, max_radius), 100)
        kernel_ms, _count = _profiled_kernel_ms(
            lambda: geom.bead_ownership(*args, L, max_radius), 100,
            "bead_ownership")
        host_ms = _time_ms(lambda: geom.bead_ownership(*host, L, max_radius),
                           3)
        bound_ms, _by = _bound(2 * n * L * L + 20 * n, 0)
        share = bound_ms / (kernel_ms or ms)
        rec.update({f"ms_{tag}": round(ms, 4),
                    f"profiler_ms_{tag}": kernel_ms and round(kernel_ms, 4),
                    f"host_ms_{tag}": round(host_ms, 2),
                    f"bound_ms_{tag}": round(bound_ms, 5),
                    f"bound_share_{tag}": round(share, 4),
                    f"shape_{tag}": [n, L, max_radius]})
        _say(f"bead_ownership at {tag} ({n} marks, L = {L}, max radius "
             f"{max_radius}): bit-equal; a call {ms:.4f} ms (events), the "
             f"kernel {kernel_ms or float('nan'):.4f} ms (profiler), bound "
             f"{bound_ms:.5f} ms ({100 * share:.1f}%), the CPU branch "
             f"(host numpy) {host_ms:.2f} ms")
        del args, got
    return rec


def kernel_phase(dev) -> list:
    strong_a, weak_a, feats_a = _stages(frame_a()[0], dev)
    strong_b, weak_b, feats_b = _stages(_frame_b_plane(), dev)
    strong_o, weak_o, feats_o = _stages(ooc_base()[0], dev)
    strong_s, weak_s, feats_s = _stages(_frame_s_plane(), dev)
    # The chamber crops the chip path refines: around the drawn centers, at
    # the default ROI length 72 and each frame's radii.
    c8_centers = np.array([[(i + 1) * 100, (j + 1) * 100]
                           for i in range(C8_GRID[0])
                           for j in range(C8_GRID[1])])
    s8, w8, f8 = _roi_stages(frame_c8(), c8_centers, 72, 8, 16, dev)
    stack_c, centers_c, _blank = frame_c()
    sc, wc, fc = _roi_stages(stack_c[0], centers_c.reshape(-1, 2), 72, 4, 15,
                             dev)
    return [_hysteresis_record(dev, ((strong_a, weak_a), (strong_b, weak_b),
                                     (strong_o, weak_o), (strong_s, weak_s)),
                               {"C8": (s8, w8), "C": (sc, wc)}),
            _ring_corr_record(dev, (feats_a, feats_b, feats_o, feats_s),
                              {"C8": (f8, (8, 16)), "C": (fc, (4, 15))}),
            _perimeter_record(dev)]


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
    if "tag" not in got:
        return
    want_tag = golden[f"{case}_tag"]
    if not np.array_equal(got["tag"], want_tag):
        raise AssertionError(
            f"frame {case}: {int((got['tag'] != want_tag).sum())} of "
            f"{want_tag.size} tags differ from the golden file")
    if "ln_vol" not in got:
        _say(f"frame {case}: {want_tag.size} tags equal the golden file")
        return
    want_vol = golden[f"{case}_ln_vol"]
    scale = float(np.abs(want_vol).max())
    err = float(np.abs(got["ln_vol"] - want_vol).max())
    if not np.isfinite(got["ln_vol"]).all() or err > LN_VOL_RTOL * scale:
        raise AssertionError(f"frame {case}: ln_vol max |diff| {err} over "
                             f"{LN_VOL_RTOL} x {scale}")
    _say(f"frame {case}: {len(want_tag)} tags equal the golden file, ln_vol "
         f"max |diff| {err:.3e} (bound {LN_VOL_RTOL} x max |ln_vol| "
         f"{scale:.3f})")


def _assert_same_frame(what: str, out, ref) -> None:
    """A streamed frame against the single-frame call on the same input."""
    got, want = summarize(out), summarize(ref)
    for key, val in want.items():
        same = (np.array_equal(got[key], val) if isinstance(val, np.ndarray)
                else got[key] == val)
        if not same:
            raise AssertionError(f"{what}: {key} differs from the "
                                 "single-frame call")


DENSE = ("hysteresis", "ring_corr")
RANSAC = ("hysteresis", "perimeter_score")
CONV = ("hysteresis", "ring_corr")  # RANSAC with the conv scorer


#: Kernels with no batched-launch counter: one call normalizes a batch of
#: planes with the same launches as one plane, and one call makes every
#: window's ownership masks.
UNBATCHED = ("normalize_u8", "bead_ownership")


class _Launches:
    """The kernels' launch counts over one path: zeroed on entry, read and
    checked on exit: each kernel of ``kernels`` must have launched, the
    uint8 normalization exactly ``normalize`` calls' worth and the bead
    ownership kernel exactly ``beads`` times (once a bead frame)."""

    def __init__(self, by_path: dict, path: str, kernels=DENSE,
                 normalize: int = 0, beads: int = 0):
        from magnify_tpu_torch.ops import edge, geom, hysteresis, score

        # name: (module, its launch counter, its batched-launch counter)
        self.counters = {
            "hysteresis": (hysteresis, "launches", "batched_launches"),
            "ring_corr": (score, "launches", "batched_launches"),
            "perimeter_score": (score, "perimeter_launches",
                                "perimeter_batched_launches"),
            "normalize_u8": (edge, "normalize_u8_launches", None),
            "bead_ownership": (geom, "bead_ownership_launches", None)}
        self.by_path, self.path, self.kernels = by_path, path, kernels
        self.want = {
            "normalize_u8": normalize * edge.NORMALIZE_U8_LAUNCHES_PER_CALL,
            "bead_ownership": beads}

    def __enter__(self):
        for mod, total, batched in self.counters.values():
            setattr(mod, total, 0)
            if batched is not None:
                setattr(mod, batched, 0)
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            return False
        import torch

        torch.cuda.synchronize()
        counts = {name: getattr(mod, total)
                  for name, (mod, total, _b) in self.counters.items()}
        batched = {f"{name}_batched": getattr(mod, b)
                   for name, (mod, _t, b) in self.counters.items()
                   if b is not None}
        _say(f"kernel launches in {self.path}: {counts}, of them on a "
             f"batch of planes {batched}")
        for name in self.kernels:
            if counts[name] <= 0:
                raise AssertionError(f"{self.path} never launched {name}")
        for name, want in self.want.items():
            if counts[name] != want:
                raise AssertionError(f"{self.path} launched {name} "
                                     f"{counts[name]} times, its route "
                                     f"{want}")
        self.by_path[self.path] = counts
        self.by_path.setdefault("_batched", {})[self.path] = batched
        return False


def _mrbles(mt, data, dev, decode_device=None):
    """``mt.mrbles`` on frame-M data; with ``decode_device`` the decode
    component is rebuilt on that device (detection stays on ``dev``)."""
    spectra, codes = mrbles_csvs()
    if decode_device is None:
        return mt.mrbles(data, spectra=spectra, codes=codes, device=dev,
                         **FRAME_M_KW)
    pipe = mt.mrbles_pipe(spectra=spectra, codes=codes, device=dev,
                          **FRAME_M_KW)
    pipe.remove_pipe("identify_mrbles")
    pipe.add_pipe("identify_mrbles", after="find_beads", spectra=spectra,
                  codes=codes, reference="eu", device=decode_device)
    return pipe(data=data)


def main_path(records: list, dev) -> None:
    import magnify_tpu_torch as mt
    from magnify_tpu_torch import diagnostics
    from magnify_tpu_torch.components import identify

    golden = np.load(GOLDEN)
    by_path: dict = {}

    # --- beads, frames A and B ------------------------------------------
    data_a = as_dataarray(mt, "A")
    data_b = as_dataarray(mt, "B")
    with _Launches(by_path, "beads A", normalize=1, beads=1):
        xa = mt.beads(data_a, device=dev, **FRAME_A_KW)
    with _Launches(by_path, "beads B", normalize=1, beads=1):
        xb = mt.beads(data_b, device=dev, **FRAME_B_KW)
    n_true = frame_a()[1]
    n_a = xa["roi"].sizes["mark"]
    if n_a != n_true:
        raise AssertionError(f"frame A: found {n_a} of {n_true} beads")
    _say(f"frame A: found {n_a}/{n_true} beads, roi {xa['roi'].shape}")
    _check_case("A", xa, golden)
    _say(f"frame B: roi {xb['roi'].shape}")
    _check_case("B", xb, golden)

    diagnostics.reset_stages()
    ms_a = _time_ms(lambda: mt.beads(data_a, device=dev, **FRAME_A_KW), 5)
    _say(f"frame A warm beads(): {ms_a:.3f} ms per frame (median of 5); "
         f"stage_report() over the warm-up and the 5 timed frames "
         f"{json.dumps(diagnostics.stage_report())}")
    ms_b = _time_ms(lambda: mt.beads(data_b, device=dev, **FRAME_B_KW), 3)
    _say(f"frame B warm beads(): {ms_b:.3f} ms per frame (median of 3)")

    # --- mrbles, frame M ------------------------------------------------
    n_frames_m = 6
    frames_m = [as_dataarray(mt, "M", seed) for seed in range(n_frames_m)]
    data_m, n_true_m = frames_m[2], frame_m()[1]
    # Frame M is float32: its search plane is normalized on the host.
    with _Launches(by_path, "mrbles M", beads=1):
        xm = _mrbles(mt, data_m, dev)
    tags = np.asarray(xm.tag.values)
    found, outliers = len(tags), int((tags == "outlier").sum())
    _say(f"frame M: true {n_true_m}, found {found}, coded "
         f"{found - outliers}, outliers {outliers}, roi {xm['roi'].shape}")
    _check_case("M", xm, golden)
    for where, decode_device in (("card", None), ("cpu", "cpu")):
        _mrbles(mt, data_m, dev, decode_device)  # warm
        ms = _time_ms(lambda: _mrbles(mt, data_m, dev, decode_device), 3)
        _say(f"frame M warm mrbles(), decode on the {where}: {ms:.3f} ms per "
             f"frame (median of 3); decode stages (s) "
             f"{json.dumps(identify.last_decode_timings)}")
    x_cpu_decode = _mrbles(mt, data_m, dev, "cpu")
    if not np.array_equal(np.asarray(x_cpu_decode.tag.values), tags):
        raise AssertionError("frame M: tags differ between the decode on the "
                             "card and on the CPU")

    # --- streams ----------------------------------------------------------
    n_stream_a = 8
    with _Launches(by_path, f"beads_stream {n_stream_a} x A",
                   beads=n_stream_a):
        outs = list(mt.beads_stream([data_a] * n_stream_a, device=dev,
                                    **FRAME_A_KW))
    if len(outs) != n_stream_a:
        raise AssertionError(f"beads_stream yielded {len(outs)} frames")
    for k, out in enumerate(outs):
        _assert_same_frame(f"beads_stream frame {k}", out, xa)
    # The stream normalizes its frames on the host.
    want = dict({k: n_stream_a * v for k, v in by_path["beads A"].items()},
                normalize_u8=0)
    if by_path[f"beads_stream {n_stream_a} x A"] != want:
        raise AssertionError(f"beads_stream launches != {want}")
    _say(f"beads_stream: {n_stream_a} frames equal the single-frame call, "
         f"launches {n_stream_a} x the single frame's")

    def stream_a():
        return list(mt.beads_stream([data_a] * n_stream_a, device=dev,
                                    **FRAME_A_KW))

    ms_stream_a = _time_ms(stream_a, 3) / n_stream_a
    _say(f"frame A: {ms_stream_a:.3f} ms per frame streamed (8 frames, "
         f"depth 2, median of 3) vs {ms_a:.3f} ms serial")

    # The single-frame calls the stream is held to; their launches are the
    # stream's expected count and are not a path of their own.
    serial_m: dict = {}
    singles_path = f"{n_frames_m} single mrbles calls, seeds 0-5"
    with _Launches(serial_m, singles_path, beads=n_frames_m):
        singles_m = [_mrbles(mt, frame, dev) for frame in frames_m]
    per_frame_m = serial_m[singles_path]
    spectra, codes = mrbles_csvs()  # one pair of handles for every frame

    def stream_m():
        return list(mt.mrbles_stream(frames_m, spectra=spectra, codes=codes,
                                     device=dev, **FRAME_M_KW))

    with _Launches(by_path, f"mrbles_stream {n_frames_m} x M",
                   beads=n_frames_m):
        outs_m = stream_m()
    if len(outs_m) != n_frames_m:
        raise AssertionError(f"mrbles_stream yielded {len(outs_m)} frames")
    for k, (out, ref) in enumerate(zip(outs_m, singles_m)):
        _assert_same_frame(f"mrbles_stream frame {k}", out, ref)
    if by_path[f"mrbles_stream {n_frames_m} x M"] != per_frame_m:
        raise AssertionError(f"mrbles_stream launches != {per_frame_m}")
    coded = [int((np.asarray(o.tag.values) != "outlier").sum())
             for o in outs_m]
    _say(f"mrbles_stream: {n_frames_m} frames (seeds 0-5) equal the "
         f"single-frame calls, tags included; coded per frame {coded}; "
         "launches equal the single frames' sum")
    ms_serial_m = _time_ms(
        lambda: [_mrbles(mt, f, dev) for f in frames_m], 3) / n_frames_m
    ms_stream_m = _time_ms(stream_m, 3) / n_frames_m
    _say(f"frame M: {ms_stream_m:.3f} ms per frame streamed (6 frames, "
         f"depth 2, median of 3) vs {ms_serial_m:.3f} ms serial")

    results = {"A": xa, "B": xb, "M": xm}
    chip_ms = chip_paths(mt, dev, golden, by_path, results)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        disk_paths(mt, dev, golden, by_path, results,
                   {"B": ms_b, "C": chip_ms["C"]}, pathlib.Path(tmp))
        mesh_phase(mt, dev, golden, by_path, results, dict(chip_ms, A=ms_a),
                   pathlib.Path(tmp), records)
    interactive_phase(mt, dev, by_path, results)
    gather_ms = ransac_paths(mt, dev, golden, by_path, dict(chip_ms, A=ms_a))
    ransac_paths(mt, dev, golden, by_path, gather_ms, scorer="conv")
    ops_phase(mt, dev, by_path)
    basic_phase(mt, dev, golden, by_path)

    batched_by_path = by_path.pop("_batched")
    for rec in list(records):
        rec["launches_by_path"] = {path: counts[rec["name"]]
                                   for path, counts in by_path.items()}
        rec["launches"] = sum(rec["launches_by_path"].values())
        _say(f"{rec['name']}: {rec['launches_per_call']} launches per call, "
             f"{rec['launches']} in the main paths "
             f"{rec['launches_by_path']}")
        if rec["name"] in UNBATCHED:
            continue
        # The batched entry of the same kernel: its launches are those the
        # chip paths made on a batch of planes, its times those at frame
        # C's 1,568 chamber crops (frame C8's beside them).
        name = rec["name"] + "_batched"
        launches = {path: counts[name]
                    for path, counts in batched_by_path.items()
                    if counts[name]}
        # Batches of planes: the chip paths' chamber crops, and the bands
        # a mesh's paths give one card.
        if not launches or {p for p in launches
                            if not p.startswith("mesh ")} - {
                "chip_c8", "chip_c8_2ch2t", "chip_c", "chip_c from a TIFF",
                "chip_c8 ransac", "chip_c ransac", "chip_c8 ransac conv",
                "chip_c ransac conv", "chip_c8 interactive"}:
            raise AssertionError(f"{name}: launched in {sorted(launches)}")
        brec = {k: rec[k] for k in ("route", "source", "replaces",
                                    "launches_per_call", "max_abs_err",
                                    "bound_by")}
        brec.update(name=name, launches=sum(launches.values()),
                    launches_by_path=launches)
        for key in ("ms", "plain_ms", "bound_ms", "bound_share"):
            brec[key] = rec[f"{key}_rois_c"]
            brec[f"{key}_rois_c8"] = rec[f"{key}_rois_c8"]
        brec["library_ms"] = rec.get("library_ms_rois_c")
        brec["library_ms_rois_c8"] = rec.get("library_ms_rois_c8")
        records.append(brec)
        _say(f"{name}: {brec['launches']} launches in the chip paths "
             f"{launches}")


def chip_paths(mt, dev, golden, by_path: dict, results: dict) -> dict:
    """``microfluidic_chip`` on frames C8, C8V (golden, cuda == cpu) and C
    (truth). Returns the warm ms of frames C8 and C; frame C's result goes
    into ``results["C"]``."""
    import torch

    from magnify_tpu_torch.components import find
    from magnify_tpu_torch.ops import edge
    from magnify_tpu_torch.ops import hysteresis as hyst

    # --- C8 and its variant: the golden file and the CPU -----------------
    # A chip makes no bead ownership masks.
    per_channel = {"hysteresis": 2 * hyst.LAUNCHES_PER_CALL, "ring_corr": 2,
                   "perimeter_score": 0, "bead_ownership": 0}
    # One normalization of all search planes of the searched timestep.
    per_timestep = {"normalize_u8": edge.NORMALIZE_U8_LAUNCHES_PER_CALL}
    for case, path, n_search in (("C8", "chip_c8", 1),
                                 ("C8V", "chip_c8_2ch2t", 2)):
        data = as_dataarray(mt, case)
        with _Launches(by_path, path, normalize=1):
            xc = mt.microfluidic_chip(data, device=dev, **FRAME_C8_KW)
        # Per search channel: detection, and ONE call for all 64 crops.
        want = dict({k: n_search * v for k, v in per_channel.items()},
                    **per_timestep)
        if by_path[path] != want:
            raise AssertionError(f"{path} launches {by_path[path]} != {want}")
        n_marks = int(np.prod(C8_GRID))
        if xc["roi"].sizes["mark_row"] * xc["roi"].sizes["mark_col"] != \
                n_marks:
            raise AssertionError(f"frame {case}: roi {xc['roi'].shape}")
        yx = summarize(xc)["rows"].reshape(-1, *C8_GRID, 2)[0]
        truth = np.array([[((i + 1) * 100, (j + 1) * 100)
                           for j in range(C8_GRID[1])]
                          for i in range(C8_GRID[0])], float)
        found = int((np.abs(yx - truth).max(axis=-1) <= 1).sum())
        _say(f"frame {case}: found {found}/{n_marks} buttons within 1 px, "
             f"roi {xc['roi'].shape}")
        if found != n_marks:
            raise AssertionError(f"frame {case}: {found}/{n_marks} buttons")
        _check_case(case, xc, golden)
        if case == "C8":  # half a minute of float64 convolutions on the CPU
            results["C8"] = xc
            x_cpu = mt.microfluidic_chip(data, device="cpu", **FRAME_C8_KW)
            _assert_same_frame("frame C8 on cuda vs cpu", xc, x_cpu)
            _say("frame C8: device='cuda' equals device='cpu' row for row "
                 "(rows, digests, tags)")
    data_c8 = as_dataarray(mt, "C8")
    ms_c8 = _time_ms(lambda: mt.microfluidic_chip(data_c8, device=dev,
                                                  **FRAME_C8_KW), 5)
    _say(f"frame C8 warm microfluidic_chip(): {ms_c8:.3f} ms (median of 5); "
         f"last_chip_timings {json.dumps(find.last_chip_timings)}")

    # --- C: the full-size chip against where the buttons were drawn ----
    data_c = as_dataarray(mt, "C")

    def run_c():
        return mt.microfluidic_chip(data_c, pinlist=frame_c_pinlist(),
                                    device=dev, **FRAME_C_KW)

    torch.cuda.reset_peak_memory_stats()
    with _Launches(by_path, "chip_c", normalize=1):
        xc = run_c()
    if by_path["chip_c"] != dict(per_channel, **per_timestep):
        raise AssertionError(f"chip_c launches {by_path['chip_c']} != "
                             f"{dict(per_channel, **per_timestep)}")
    peak = torch.cuda.max_memory_allocated()
    _check_frame_c("frame C", xc)
    results["C"] = xc
    ms_c = _time_ms(run_c, 3)
    _say(f"frame C warm microfluidic_chip(): {ms_c:.3f} ms (median of 3, one "
         f"searched + one copied timestep); last_chip_timings "
         f"{json.dumps(find.last_chip_timings)}; peak device memory "
         f"allocated {peak / 2**30:.3f} GiB ({peak} bytes)")
    return {"C8": ms_c8, "C": ms_c}


def _check_frame_c(what: str, xc) -> None:
    """Frame C's result against where its buttons were drawn: every
    non-blank button within 1 px, tags and valid as the pinlist says, fg
    disks of the drawn radius (within 1.5 px)."""
    stack, centers, blank = frame_c()
    xc = xc.transpose("mark_row", "mark_col", ...)
    y, x = np.asarray(xc.y.values), np.asarray(xc.x.values)  # (56, 28, 2)
    tag = np.asarray(xc.tag.values)
    if y.shape != C_GRID + (2,) or not (np.isfinite(y).all()
                                        and np.isfinite(x).all()):
        raise AssertionError(f"{what}: x/y of shape {y.shape} or not finite")
    if not np.array_equal(tag == "", blank) or not bool(
            np.asarray(xc.valid.values).all()):
        raise AssertionError(f"{what}: tag/valid differ from the pinlist")
    err = np.maximum(np.abs(y - centers[..., :1]), np.abs(x - centers[..., 1:]))
    ok = (err <= 1).all(axis=-1)
    n_expected = int((~blank).sum())
    n_found = int(ok[~blank].sum())
    _say(f"{what}: image {stack.shape[1:]}, {n_found}/{n_expected} "
         f"non-blank buttons within 1 px of where they were drawn "
         f"(max error {err[~blank].max():.1f} px), {int(blank.sum())} blank "
         f"chambers, roi {xc['roi'].shape}")
    if n_found != n_expected:
        raise AssertionError(f"{what}: {n_found}/{n_expected} buttons")
    fg = np.asarray(xc.fg.values)
    radii = np.sqrt(fg.reshape(C_GRID + (2, -1))[..., 0, :].sum(-1) / np.pi)
    drawn = np.array([[5 + (i * 3 + j) % 10 for j in range(C_GRID[1])]
                      for i in range(C_GRID[0])], float)
    r_err = np.abs(radii - drawn)[~blank]
    _say(f"{what}: fg radius within {r_err.max():.2f} px of the drawn radius")
    if r_err.max() > 1.5:
        raise AssertionError(f"{what}: fg masks do not match the buttons")


@contextlib.contextmanager
def _scorer(mode: str):
    """``MAGNIFY_TPU_SCORER`` set to ``mode`` for a block, restored after."""
    saved = os.environ.get("MAGNIFY_TPU_SCORER")
    os.environ["MAGNIFY_TPU_SCORER"] = mode
    try:
        yield
    finally:
        if saved is None:
            del os.environ["MAGNIFY_TPU_SCORER"]
        else:
            os.environ["MAGNIFY_TPU_SCORER"] = saved


def ransac_paths(mt, dev, golden, by_path: dict, ref_ms: dict,
                 scorer: str = "gather") -> dict:
    """The main paths with ``detector="ransac"`` at the default
    ``num_iter``, with ``scorer`` ("gather": the perimeter scorer, or
    "conv": the int8 score maps read at each proposal): beads on frame A,
    with the gather scorer also its stream, and the chip on frames C8 and
    C. Prints each frame's warm ms beside ``ref_ms`` (the dense detector's
    for "gather", the gather scorer's for "conv"). Returns the warm ms of
    frames A, C8 and C."""
    import torch

    from magnify_tpu_torch.components import find
    from magnify_tpu_torch.ops import edge
    from magnify_tpu_torch.ops import hysteresis as hyst

    conv = scorer == "conv"
    tag = " conv" if conv else ""
    golden_tag = "conv" if conv else ""
    ref_name = "the gather scorer" if conv else "dense"
    kernels = CONV if conv else RANSAC
    hyst_call = hyst.LAUNCHES_PER_CALL

    def launches(calls: int, scorer_launches: int, normalize: int = 0,
                 beads: int = 0) -> dict:
        """One search channel: ``calls`` edge stacks (a whole plane, then
        for a chip ONE batch for all crops), each scored by one ring
        correlation (conv); or the perimeter scorer's launches (gather:
        for a chip the crops' proposals and their hill-climb);
        ``normalize`` uint8 normalizations on the card (the bead finder's;
        the RANSAC chip uploads its plane as f32); and ``beads`` bead
        frames' ownership masks."""
        return {"hysteresis": calls * hyst_call,
                "ring_corr": calls if conv else 0,
                "perimeter_score": 0 if conv else scorer_launches,
                "normalize_u8": normalize
                * edge.NORMALIZE_U8_LAUNCHES_PER_CALL,
                "bead_ownership": beads}

    kw = dict(detector="ransac", device=dev)
    out_ms = {}
    with _scorer(scorer):
        data_a = as_dataarray(mt, "A")
        path = f"beads A ransac{tag}"
        with _Launches(by_path, path, kernels, normalize=1, beads=1):
            xa = mt.beads(data_a, **kw, **FRAME_A_KW)
        if by_path[path] != launches(1, 1, 1, 1):
            raise AssertionError(f"{path} launches {by_path[path]} != "
                                 f"{launches(1, 1, 1, 1)}")
        n_true, n_a = frame_a()[1], xa["roi"].sizes["mark"]
        _say(f"frame A, RANSAC ({scorer}): found {n_a}/{n_true} beads, roi "
             f"{xa['roi'].shape}")
        if n_a != n_true:
            raise AssertionError(f"frame A, RANSAC ({scorer}): found {n_a} "
                                 f"of {n_true}")
        _check_case(f"RA{golden_tag}", xa, golden)
        out_ms["A"] = _time_ms(lambda: mt.beads(data_a, **kw, **FRAME_A_KW),
                               3)
        _say(f"frame A warm beads(detector='ransac', {scorer} scorer): "
             f"{out_ms['A']:.3f} ms per frame (median of 3) vs "
             f"{ref_name} {ref_ms['A']:.3f} ms")

        if not conv:
            n_stream = 3
            path = f"beads_stream {n_stream} x A ransac"
            # The RANSAC stream runs the single-frame call frame by frame.
            with _Launches(by_path, path, kernels, normalize=n_stream,
                           beads=n_stream):
                outs = list(mt.beads_stream([data_a] * n_stream, **kw,
                                            **FRAME_A_KW))
            if len(outs) != n_stream:
                raise AssertionError(f"beads_stream (ransac) yielded "
                                     f"{len(outs)}")
            for k, out in enumerate(outs):
                _assert_same_frame(f"beads_stream (ransac) frame {k}", out,
                                   xa)
            want = {k: n_stream * v
                    for k, v in by_path["beads A ransac"].items()}
            if by_path[path] != want:
                raise AssertionError(f"{path} launches != {want}")
            _say(f"beads_stream (ransac): {n_stream} frames equal the "
                 "single-frame call, run serially")

        data_c8 = as_dataarray(mt, "C8")
        path = f"chip_c8 ransac{tag}"
        want = launches(2, 3)
        with _Launches(by_path, path, kernels):
            xc = mt.microfluidic_chip(data_c8, **kw, **FRAME_C8_KW)
        if by_path[path] != want:
            raise AssertionError(f"{path} launches {by_path[path]} != "
                                 f"{want}")
        yx = summarize(xc)["rows"].reshape(-1, *C8_GRID, 2)[0]
        truth = np.array([[((i + 1) * 100, (j + 1) * 100)
                           for j in range(C8_GRID[1])]
                          for i in range(C8_GRID[0])], float)
        n_marks = int(np.prod(C8_GRID))
        found = int((np.abs(yx - truth).max(axis=-1) <= 1).sum())
        _say(f"frame C8, RANSAC ({scorer}): found {found}/{n_marks} buttons "
             f"within 1 px, roi {xc['roi'].shape}; unique proposals "
             f"{find.last_chip_timings.get('n_unique')}")
        if found != n_marks:
            raise AssertionError(f"frame C8, RANSAC ({scorer}): "
                                 f"{found}/{n_marks} buttons")
        _check_case(f"RC8{golden_tag}", xc, golden)
        out_ms["C8"] = _time_ms(lambda: mt.microfluidic_chip(
            data_c8, **kw, **FRAME_C8_KW), 3)
        _say(f"frame C8 warm microfluidic_chip(detector='ransac', {scorer} "
             f"scorer): {out_ms['C8']:.3f} ms (median of 3) vs {ref_name} "
             f"{ref_ms['C8']:.3f} ms; last_chip_timings "
             f"{json.dumps(find.last_chip_timings)}")

        data_c = as_dataarray(mt, "C")

        def run_c():
            return mt.microfluidic_chip(data_c, pinlist=frame_c_pinlist(),
                                        **kw, **FRAME_C_KW)

        path = f"chip_c ransac{tag}"
        torch.cuda.reset_peak_memory_stats()
        with _Launches(by_path, path, kernels):
            xc = run_c()
        if by_path[path] != want:
            raise AssertionError(f"{path} launches {by_path[path]} != "
                                 f"{want}")
        peak = torch.cuda.max_memory_allocated()
        _check_frame_c(f"frame C, RANSAC ({scorer})", xc)
        out_ms["C"] = _time_ms(run_c, 2)
        _say(f"frame C warm microfluidic_chip(detector='ransac', {scorer} "
             f"scorer): {out_ms['C']:.3f} ms (median of 2) vs {ref_name} "
             f"{ref_ms['C']:.3f} ms; last_chip_timings "
             f"{json.dumps(find.last_chip_timings)} (n_unique: unique "
             f"proposals of the whole-plane search); peak device memory "
             f"allocated {peak / 2**30:.3f} GiB ({peak} bytes)")
    return out_ms


#: find_circles arguments on frame A's plane, as ``beads`` derives them
#: from FRAME_A_KW: (low_q, high_q, grid_length, num_iter, min_radius,
#: max_radius, min_roundness, min_dist).
FIND_ARGS = (0.1, 0.9, 20, 5_000_000, 8, 12, 0.3, 8)


def ops_phase(mt, dev, by_path: dict) -> None:
    """The public ops layer: ``find_circles`` on frame A's plane, dense and
    RANSAC with each scorer, equal to the port's CPU result (the CPU side
    run once); ``find_circles_stack`` over 8 planes of frame A (seeds 0-7,
    ``batch=4``), each equal to its ``find_circles`` call."""
    img, n_true = frame_a()
    for path, detector, scorer, kernels in (
            ("find_circles dense", "dense", "auto", DENSE),
            ("find_circles ransac", "ransac", "gather", RANSAC),
            ("find_circles ransac conv", "ransac", "conv", CONV)):
        with _scorer(scorer):
            with _Launches(by_path, path, kernels):
                got = mt.ops.find_circles(img, *FIND_ARGS, detector=detector,
                                          device=dev)
            t0 = time.perf_counter()
            want = mt.ops.find_circles(img, *FIND_ARGS, detector=detector,
                                       device="cpu")
            cpu_s = time.perf_counter() - t0
            if not all(np.array_equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"{path}: cuda differs from cpu")
            if len(got[0]) != n_true:
                raise AssertionError(f"{path}: {len(got[0])} circles")
            ms = _time_ms(lambda: mt.ops.find_circles(
                img, *FIND_ARGS, detector=detector, device=dev), 3)
        _say(f"{path}: {len(got[0])} circles, cuda equals cpu row for row "
             f"(circles and scores); warm {ms:.3f} ms on the card (median "
             f"of 3), {cpu_s:.3f} s on the CPU")

    planes = np.stack([frame_a(seed)[0] for seed in range(8)])
    stack_kw = dict(low_edge_quantile=FIND_ARGS[0],
                    high_edge_quantile=FIND_ARGS[1],
                    min_radius=FIND_ARGS[4], max_radius=FIND_ARGS[5],
                    min_roundness=FIND_ARGS[6], min_dist=FIND_ARGS[7],
                    batch=4, device=dev)
    path = "find_circles_stack 8 x A"
    with _Launches(by_path, path):
        res = mt.ops.find_circles_stack(planes, **stack_kw)
    from magnify_tpu_torch.ops import hysteresis as hyst

    want = {"hysteresis": len(planes) * hyst.LAUNCHES_PER_CALL,
            "ring_corr": len(planes), "perimeter_score": 0,
            "normalize_u8": 0, "bead_ownership": 0}
    if by_path[path] != want:
        raise AssertionError(f"{path} launches {by_path[path]} != {want}")
    for k, (c, s) in enumerate(res):
        one = mt.ops.find_circles(planes[k], *FIND_ARGS, detector="dense",
                                  device=dev)
        if not (np.array_equal(c, one[0]) and np.array_equal(s, one[1])):
            raise AssertionError(f"{path}: plane {k} differs from its "
                                 "find_circles call")
    ms_stack = _time_ms(lambda: mt.ops.find_circles_stack(planes, **stack_kw),
                        3) / len(planes)
    _say(f"{path}: every plane equals its find_circles call "
         f"({[len(c) for c, _s in res]} circles); {ms_stack:.3f} ms per "
         "plane (median of 3)")


#: The BaSiC fit's tolerances, the card against the CPU (and the port
#: against the JAX package): flat field, and dark field over the mean of
#: the tiles fitted.
BASIC_FLAT_ATOL = 1e-4
BASIC_DARK_RTOL = 1e-5


def basic_phase(mt, dev, golden, by_path: dict) -> None:
    """Frame S through ``beads_pipe`` with ``basic_correct``: the fitted
    fields on the card against the CPU's, every drawn bead found within
    1 px, the marks against the golden file's ``S_rows`` (the JAX package's
    marks) within 1 px; the fit's time per channel on the card and on the
    CPU and the stage split of one warm frame."""
    from magnify_tpu_torch import diagnostics
    from magnify_tpu_torch.ops import basic

    tiles, beads = frame_s()
    for ci, ch in enumerate(S_CHANNELS):
        train = tiles[ci].reshape(-1, TILE, TILE)
        mean = float(train.astype(np.float32).mean())
        fields, secs = {}, {}
        for where, device in (("cuda", dev), ("cpu", "cpu")):
            basic.fit_basic(train, device=device)  # warm
            t0 = time.perf_counter()
            fields[where] = basic.fit_basic(train, device=device)
            secs[where] = time.perf_counter() - t0
        d_flat = float(np.abs(fields["cuda"][0] - fields["cpu"][0]).max())
        d_dark = float(np.abs(fields["cuda"][1] - fields["cpu"][1]).max())
        _say(f"frame S channel {ch}: fit_basic on 16 x {TILE}^2 tiles "
             f"{secs['cuda'] * 1e3:.3f} ms on the card, "
             f"{secs['cpu'] * 1e3:.3f} ms on the CPU; cuda vs cpu flat "
             f"max |diff| {d_flat:.3e} (bound {BASIC_FLAT_ATOL}), dark "
             f"{d_dark:.3e} (bound {BASIC_DARK_RTOL} x mean {mean:.1f})")
        if not (np.isfinite(fields["cuda"][0]).all()
                and d_flat <= BASIC_FLAT_ATOL
                and d_dark <= BASIC_DARK_RTOL * mean):
            raise AssertionError(f"frame S channel {ch}: the card's fields "
                                 "differ from the CPU's")

    data = as_dataarray(mt, "S")
    pipe = frame_s_pipe(mt, device=dev)
    with _Launches(by_path, "beads S basic_correct", normalize=1, beads=1):
        xs = pipe(data=data)
    yx = np.stack([np.asarray(xs.y.values, float),
                   np.asarray(xs.x.values, float)], axis=1)
    d = np.abs(yx[:, None, :] - beads[None, :, :2]).max(-1)
    found = int((d.min(axis=0) <= 1).sum())
    side = S_GRID * (TILE - OVERLAP_B)
    _say(f"frame S: {side}^2 stitched, {len(yx)} marks, {found}/"
         f"{len(beads)} drawn beads within 1 px, roi {xs['roi'].shape}")
    if found != len(beads) or len(yx) != len(beads):
        raise AssertionError(f"frame S: {len(yx)} marks, {found} of "
                             f"{len(beads)} drawn beads")
    want = golden["S_rows"]
    dg = np.abs(yx[:, None, :] - want[None, :, :]).max(-1)
    if len(want) != len(yx) or dg.min(axis=0).max() > 1 or \
            dg.min(axis=1).max() > 1:
        raise AssertionError(f"frame S: marks differ from the golden "
                             f"{len(want)} by more than 1 px")
    same = np.array_equal(yx, want)
    n_moved = int((dg.min(axis=1) > 0).sum())
    _say(f"frame S: the {len(want)} marks equal the golden file's within "
         f"1 px ({n_moved} not exactly equal; same order: {same})")

    import torch

    diagnostics.reset_stages()
    t0 = time.perf_counter()
    pipe(data=data)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    _say(f"frame S warm beads_pipe() with basic_correct: {ms:.3f} ms; "
         f"stage_report() of that frame "
         f"{json.dumps(diagnostics.stage_report())}")


# The 24-code, 4-lanthanide, 5-channel panel of the decode-scale check.
PANEL_CHANNELS = ["435", "474", "536", "620", "700"]
PANEL_LNS = ["eu", "dy", "sm", "tm"]
PANEL_SPECTRA = np.array([
    [1.0, 0.2, 0.1, 0.05, 0.02],
    [0.1, 1.0, 0.3, 0.0, 0.05],
    [0.0, 0.1, 0.9, 0.4, 0.1],
    [0.05, 0.0, 0.2, 0.9, 0.3],
])
PANEL_CODES = {f"code_{d}{s}{t}": (1.5 * d, 2.0 * s, 2.5 * t)
               for d in range(4) for s in range(3) for t in range(2)}


def decode_assay(pkg, n: int = 8192, side: int = 32, seed: int = 7):
    """``n`` synthetic marks over the 24-code panel: (mark, 5 channels, 1,
    side, side) float32 ROIs whose 8 x 8 centre holds the code's spectrum
    (ratio noise 0.04), fg the centre, bg the two top rows. Returns the
    Dataset of package ``pkg`` and the (spectra, codes) CSV file-likes."""
    rng = np.random.default_rng(seed)
    lo, hi = side // 2 - 4, side // 2 + 4
    roi = np.zeros((n, len(PANEL_CHANNELS), 1, side, side), np.float32)
    fg = np.zeros((n, 1, side, side), bool)
    bg = np.zeros((n, 1, side, side), bool)
    fg[:, :, lo:hi, lo:hi] = True
    bg[:, :, 0:2, :] = True
    code_list = np.asarray(list(PANEL_CODES.values()))
    codes_arr = code_list[rng.integers(0, len(code_list), n)]
    eu = rng.uniform(80, 120, n)
    vols = eu[:, None] * np.concatenate(
        [np.ones((n, 1)), codes_arr + rng.normal(0, 0.04, codes_arr.shape)],
        axis=1)
    roi[:, :, 0, lo:hi, lo:hi] = (vols @ PANEL_SPECTRA)[:, :, None, None]
    ds = pkg.Dataset(
        {"roi": (("mark", "channel", "time", "roi_y", "roi_x"), roi)},
        coords={"channel": PANEL_CHANNELS,
                "fg": (("mark", "time", "roi_y", "roi_x"), fg),
                "bg": (("mark", "time", "roi_y", "roi_x"), bg)})
    spectra = ["name," + ",".join(PANEL_CHANNELS)]
    spectra += [n_ + "," + ",".join(str(v) for v in row)
                for n_, row in zip(PANEL_LNS, PANEL_SPECTRA)]
    codes = ["name," + ",".join(PANEL_LNS)]
    codes += [f"{n_},1.0,{d},{s},{t}"
              for n_, (d, s, t) in PANEL_CODES.items()]
    return ds, io.StringIO("\n".join(spectra)), io.StringIO("\n".join(codes))


def decode_phase(dev) -> None:
    """``identify_mrbles`` alone at device scale: the card against the CPU."""
    import magnify_tpu_torch as mt
    from magnify_tpu_torch.components import identify

    ds, spectra, codes = decode_assay(mt)
    n = ds.sizes["mark"]
    out, timings, wall = {}, {}, {}
    for name, device in (("cuda", dev), ("cpu", "cpu")):
        identify.identify_mrbles(ds, spectra=spectra, codes=codes,
                                 device=device)  # warm
        t0 = time.perf_counter()
        out[name] = identify.identify_mrbles(ds, spectra=spectra, codes=codes,
                                             device=device)
        wall[name] = time.perf_counter() - t0
        timings[name] = dict(identify.last_decode_timings)
    tags = {k: np.asarray(v.tag.values) for k, v in out.items()}
    mismatches = int((tags["cuda"] != tags["cpu"]).sum())
    outlier_frac = float((tags["cuda"] == "outlier").mean())
    vol_err = float(np.abs(out["cuda"]["ln_vol"].values
                           - out["cpu"]["ln_vol"].values).max())
    _say(f"decode of {n} marks x {len(PANEL_CHANNELS)} channels x "
         f"{ds.sizes['roi_y']}^2: "
         f"{mismatches} tag mismatches cuda vs cpu, outlier fraction "
         f"{outlier_frac:.4f}, {len(np.unique(tags['cuda']))} distinct tags, "
         f"ln_vol max |diff| {vol_err:.3e}")
    for name in ("cuda", "cpu"):
        _say(f"decode on {name}: {wall[name]:.4f} s, "
             f"{n / wall[name]:.1f} marks/s; stages (s) "
             f"{json.dumps(timings[name])}")
    if mismatches:
        raise AssertionError(f"decode: {mismatches} of {n} tags differ "
                             "between cuda and cpu")
    if len(np.unique(tags["cuda"][tags["cuda"] != "outlier"])) != len(
            PANEL_CODES):
        raise AssertionError("decode: not every code of the panel decoded")


# --------------------------------------------------------------------------
# Stacks read from disk
# --------------------------------------------------------------------------

# The out-of-core stack: 4 channel directories, each one OME-TIFF of 20
# time pages of 4096^2 uint16 (2.68 GB on disk, 5.0 x the finder's 512 MiB
# MAX_RESIDENT_BYTES), read as ``ooc/(channel)/s.ome.tif``.
OOC_CHANNELS = ("ch0", "ch1", "ch2", "ch3")
OOC_TIMES = 20
OOC_SIDE = 4 * TILE
OOC_PATTERN = "ooc/(channel)/s.ome.tif"
OOC_KW = dict(min_bead_diameter=16, max_bead_diameter=24, overlap=0,
              detector="dense")


@functools.lru_cache(maxsize=1)
def ooc_base(seed: int = 5):
    """The out-of-core stack's base plane: frame A's layout and density
    tiled 4 x 4 over 4096^2 uint16 noise, 1,760 beads of radius 8-12.
    Every (channel, time) plane is this plane scaled by ``1 + 0.05 t``.
    Returns (plane, beads (n, 3) int of the drawn (y, x, radius))."""
    rng = np.random.default_rng(seed)
    img = rng.normal(100, 5, (OOC_SIDE, OOC_SIDE)).astype(np.uint16)
    beads = []
    for ti in range(OOC_SIDE // TILE):
        for tj in range(OOC_SIDE // TILE):
            for r in range(10):
                for c in range(11):
                    y, x = ti * TILE + r * 97 + 60, tj * TILE + c * 83 + 50
                    beads.append((y, x, 8 + (3 * r + c + ti + tj) % 5))
    for y, x, rad in beads:
        pts = filled_circle_points(rad) + np.array([y, x])
        img[pts[:, 0], pts[:, 1]] = 1000
    return img, np.array(beads)


def write_ooc_stack(root: pathlib.Path) -> float:
    """Write the out-of-core stack under ``root``; returns the seconds the
    writes took (the planes are made before the clock starts)."""
    from magnify_tpu_torch.io.tiff import write_tiff

    base = ooc_base()[0].astype(np.float32)
    stack = np.empty((OOC_TIMES, 1, OOC_SIDE, OOC_SIDE), np.uint16)
    for t in range(OOC_TIMES):
        stack[t, 0] = base * np.float32(1 + 0.05 * t)
    seconds = 0.0
    for name in OOC_CHANNELS:
        path = root / "ooc" / name / "s.ome.tif"
        path.parent.mkdir(parents=True)
        t0 = time.perf_counter()
        write_tiff(path, stack)
        seconds += time.perf_counter() - t0
    return seconds


class _RssSampler:
    """VmRSS of this process sampled every ``interval`` s on a thread, with
    the peak of each named stage (as ``scripts/measure_out_of_core.py``
    samples it)."""

    def __init__(self, interval: float = 0.02):
        import threading

        self.stage, self.interval = "setup", interval
        self.peaks: dict = {}
        self.ends: dict = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    @staticmethod
    def rss() -> int:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
        raise RuntimeError("no VmRSS in /proc/self/status")

    def _run(self):
        while not self._stop.is_set():
            self.mark()
            self._stop.wait(self.interval)

    def enter(self, stage: str):
        """Close the current stage with a sample and start ``stage``."""
        self.mark()
        self.ends[self.stage] = self.rss()
        self.stage = stage

    def mark(self):
        v = self.rss()
        if v > self.peaks.get(self.stage, 0):
            self.peaks[self.stage] = v

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.enter("done")
        return False


def out_of_core_child(root: pathlib.Path, mesh: bool = False) -> int:
    """``--out-of-core ROOT``: the out-of-core path alone, in a process of
    its own so that its peak RSS is its own (:func:`run_out_of_core` on the
    card). Prints one line ``OOC_RESULT {json}``. With ``--mesh``:
    :func:`out_of_core_mesh_child`, printed as ``OOC_MESH {json}``."""
    import torch

    from magnify_tpu_torch import _build

    if not torch.cuda.is_available():
        print("chip_smoke --out-of-core: no CUDA device", file=sys.stderr)
        return 2
    import magnify_tpu_torch as mt

    dev = torch.device("cuda")
    _build.load()
    if mesh:
        print("OOC_MESH " + json.dumps(out_of_core_mesh_child(root, dev)),
              flush=True)
        return 0
    # Warm the process before its baseline is read: one in-memory beads()
    # on the base plane loads the CUDA kernels the detection uses at this
    # plane size (their images count in RSS, once).
    mt.beads(mt.DataArray(ooc_base()[0], dims=("y", "x")), device=dev,
             **OOC_KW)
    print("OOC_RESULT " + json.dumps(run_out_of_core(root, dev)), flush=True)
    return 0


def run_out_of_core(root: pathlib.Path, dev) -> dict:
    """``beads`` -> ``quantify`` -> ``save`` -> ``load`` on
    ``ROOT/ooc/(channel)/s.ome.tif`` on ``dev``, with the kernels' launch
    counts zeroed before ``beads`` and read after it, VmRSS sampled against
    the warm baseline (taken once the caller has loaded what it needs; the
    peak of each stage, ``beads`` split at its ROI pass, and the RSS at each
    stage's end), and the pages the TIFF reader decoded counted. Returns
    what it measured."""
    import magnify_tpu_torch as mt
    from magnify_tpu_torch import native
    from magnify_tpu_torch.components import find
    from magnify_tpu_torch.core.lazy import is_memmap_backed
    from magnify_tpu_torch.io import tiff

    if not native.available():
        raise AssertionError(f"native IO library did not build: "
                             f"{native.build_error}")
    pattern = str(root / OOC_PATTERN)
    by_path: dict = {}
    seconds = {}
    tiff.page_reads.clear()
    def roi_pass(real):
        def call(*args, **kw):
            rss.enter("beads: ROI pass")
            seconds["beads: search planes"] = time.perf_counter() - t0
            return real(*args, **kw)
        return call

    with _RssSampler() as rss:
        baseline = rss.rss()
        rss.enter("beads: search planes")
        t0 = time.perf_counter()
        with _Launches(by_path, "beads OOC", beads=1), spy(
                find.BeadFinder, "_finish_streamed", roi_pass):
            xp = mt.beads(pattern, device=dev, **OOC_KW)
        seconds["beads"] = time.perf_counter() - t0
        seconds["beads: ROI pass"] = (seconds["beads"]
                                      - seconds["beads: search planes"])
        reads = dict(tiff.page_reads)
        rss.enter("quantify")
        t0 = time.perf_counter()
        xp = mt.quantify(xp, device=dev)
        seconds["quantify"] = time.perf_counter() - t0
        rss.enter("save")
        out = root / "ooc.npz"
        t0 = time.perf_counter()
        mt.save(out, xp.drop_vars("image"))
        seconds["save"] = time.perf_counter() - t0
        rss.enter("load")
        t0 = time.perf_counter()
        back = mt.load(out)
        seconds["load"] = time.perf_counter() - t0
    if not is_memmap_backed(xp["roi"].data):
        raise AssertionError("out-of-core ROI store is not disk-backed")
    inten = xp.intensity.transpose("mark", "channel", "time").values
    for name in ("x", "y", "intensity", "fg", "bg"):
        if not np.array_equal(np.asarray(back[name].values),
                              np.asarray(xp[name].values)):
            raise AssertionError(f"ooc: loaded {name} != saved {name}")
    if digest(back["roi"].values) != digest(xp["roi"].values):
        raise AssertionError("ooc: loaded roi != saved roi")
    # Every crop of the store against the plane it was cut from.
    roi = xp["roi"].transpose("mark", "channel", "time", "roi_y",
                              "roi_x").values
    length = roi.shape[-1]
    tops = np.clip(np.asarray(xp.y.values)[:, 0].astype(int) - length // 2,
                   0, OOC_SIDE - length)
    lefts = np.clip(np.asarray(xp.x.values)[:, 0].astype(int) - length // 2,
                    0, OOC_SIDE - length)
    base = ooc_base()[0].astype(np.float32)
    for t in range(OOC_TIMES):
        plane = (base * np.float32(1 + 0.05 * t)).astype(np.uint16)
        crops = np.stack([plane[a:a + length, b:b + length]
                          for a, b in zip(tops, lefts)])
        for ci in range(len(OOC_CHANNELS)):
            if not np.array_equal(roi[:, ci, t], crops):
                raise AssertionError(f"ooc: ROI crops of channel {ci}, time "
                                     f"{t} differ from the plane")
    counts = sorted(set(reads.values()))
    return {
        "n_marks": int(xp.sizes["mark"]), "roi_shape": list(xp.roi.shape),
        "seconds": seconds, "rss_baseline_bytes": baseline,
        "rss_peak_growth_bytes": {k: v - baseline
                                  for k, v in rss.peaks.items()
                                  if k != "setup"},
        "rss_end_growth_bytes": {k: v - baseline
                                 for k, v in rss.ends.items()
                                 if k != "setup"},
        "page_reads": sum(reads.values()),
        "page_reads_by_count": {str(k): sum(1 for v in reads.values()
                                            if v == k) for k in counts},
        "pages_read_twice": sorted(f"{pathlib.Path(p).parent.name}:{t}"
                                   for (p, t), v in reads.items() if v == 2),
        "launches": by_path["beads OOC"],
        "intensity_rises": bool((np.diff(inten, axis=-1) > 0).all()),
        "intensity_min": float(inten.min()),
    }


def _same_dataset(what: str, got, want) -> None:
    """Every variable of ``got`` equals ``want``'s: names, dims, values."""
    if sorted(got.variables) != sorted(want.variables):
        raise AssertionError(f"{what}: variables {sorted(got.variables)} != "
                             f"{sorted(want.variables)}")
    for name in want.variables:
        g, w = got[name], want[name]
        gv, wv = np.asarray(g.values), np.asarray(w.values)
        if g.dims != w.dims or gv.dtype != wv.dtype or not np.array_equal(
                gv, wv):
            raise AssertionError(f"{what}: {name} differs")


def disk_paths(mt, dev, golden, by_path: dict, in_memory: dict,
               ms_memory: dict, tmp: pathlib.Path) -> dict:
    """Frames B and C read from TIFF files, each against its in-memory
    run, and a flat field given as a TIFF path; then the out-of-core stack
    in a child process. Returns what the child measured."""
    from magnify_tpu_torch import native
    from magnify_tpu_torch.io.tiff import write_tiff

    # --- frame B as a 2 x 2 grid of tile files per channel ----------------
    tiles = frame_b()
    for ci, ch in enumerate(("red", "green")):
        for r in range(2):
            for c in range(2):
                path = tmp / "b" / ch / f"tile_{r}_{c}.tif"
                path.parent.mkdir(parents=True, exist_ok=True)
                write_tiff(path, tiles[ci, r, c], ome=False)
    path_b = str(tmp / "b" / "(channel)" / "tile_(row)_(col).tif")
    with _Launches(by_path, "beads B from files", normalize=1, beads=1):
        xf = mt.beads(path_b, device=dev, **FRAME_B_KW)
    if not native.available():
        raise AssertionError(f"native IO library did not build: "
                             f"{native.build_error}")
    names = list(np.asarray(xf.channel.values))
    if sorted(names) != ["green", "red"]:
        raise AssertionError(f"frame B from files: channels {names}")
    # The reader orders channel directories by name; the in-memory frame
    # lists red first.
    xf = xf.isel(channel=[names.index("red"), names.index("green")])
    _check_case("B", xf, golden)
    _same_dataset("frame B from files", xf, in_memory["B"])
    img_f = mt.image(path_b, overlap=OVERLAP_B, device=dev)
    img_m = mt.image(as_dataarray(mt, "B"), overlap=OVERLAP_B, device=dev)
    img_f = img_f.isel(channel=[names.index("red"), names.index("green")])
    _same_dataset("image() of frame B from files", img_f, img_m)
    ms_b = _time_ms(lambda: mt.beads(path_b, device=dev, **FRAME_B_KW), 3)
    _say(f"frame B from 8 tile files: beads() and image() equal the "
         f"in-memory runs (and the golden file); warm beads() {ms_b:.3f} ms "
         f"per frame (median of 3) vs {ms_memory['B']:.3f} ms in memory")

    # --- a flat field as a TIFF path ----------------------------------------
    yy, xx = np.mgrid[0:TILE, 0:TILE]
    flat = (1.0 + 0.3 * np.exp(-((yy - 512) ** 2 + (xx - 512) ** 2) / 2e5)
            ).astype(np.float32)
    write_tiff(tmp / "flat.tif", flat)
    data_a = as_dataarray(mt, "A")
    xa_path = mt.beads(data_a, flatfield=str(tmp / "flat.tif"), device=dev,
                       **FRAME_A_KW)
    xa_arr = mt.beads(data_a, flatfield=flat, device=dev, **FRAME_A_KW)
    _same_dataset("frame A with a flat field from a TIFF path", xa_path,
                  xa_arr)
    _say(f"frame A with a flat field from a TIFF path equals the same array "
         f"({xa_path.sizes['mark']} marks)")

    # --- frame C as one 2-page TIFF -----------------------------------------
    write_tiff(tmp / "c.tif", frame_c()[0], axes="TYX", ome=False)

    def run_c():
        return mt.microfluidic_chip(str(tmp / "c.tif"),
                                    pinlist=frame_c_pinlist(), device=dev,
                                    **FRAME_C_KW)

    with _Launches(by_path, "chip_c from a TIFF", normalize=1):
        xc = run_c()
    _same_dataset("frame C from a TIFF", xc, in_memory["C"])
    ms_c = _time_ms(run_c, 2)
    _say(f"frame C from a 2-page TIFF: every variable equals the in-memory "
         f"run; warm microfluidic_chip() {ms_c:.3f} ms (median of 2) vs "
         f"{ms_memory['C']:.3f} ms in memory")

    return out_of_core_phase(mt, dev, by_path, tmp)


def out_of_core_phase(mt, dev, by_path: dict, tmp: pathlib.Path) -> dict:
    """Write the out-of-core stack under ``tmp``, run
    :func:`out_of_core_child` on it in a child process, record its kernel
    launches as the path "beads OOC" and check what it measured."""
    write_s = write_ooc_stack(tmp)
    stack_bytes = len(OOC_CHANNELS) * OOC_TIMES * OOC_SIDE * OOC_SIDE * 2
    _say(f"out-of-core stack written: {len(OOC_CHANNELS)} x {OOC_TIMES} x "
         f"{OOC_SIDE}^2 uint16, {stack_bytes} bytes in {write_s:.3f} s "
         f"({stack_bytes / write_s / 1e9:.3f} GB/s)")
    t0 = time.perf_counter()
    child = subprocess.run([sys.executable, str(pathlib.Path(__file__)
                                                .resolve()),
                            "--out-of-core", str(tmp)],
                           capture_output=True, text=True, timeout=900)
    child_s = time.perf_counter() - t0
    for line in child.stdout.splitlines():
        if not line.startswith("OOC_RESULT "):
            _say("  [out-of-core child]", line)
    if child.returncode != 0:
        raise AssertionError(f"out-of-core child exited "
                             f"{child.returncode}:\n{child.stderr[-4000:]}")
    res = json.loads(next(line for line in child.stdout.splitlines()
                          if line.startswith("OOC_RESULT "))[11:])
    res.update(write_seconds=write_s, child_seconds=child_s,
               stack_bytes=stack_bytes)
    by_path["beads OOC"] = res["launches"]
    by_path.setdefault("_batched", {})["beads OOC"] = {
        f"{k}_batched": 0 for k in res["launches"]}
    check_out_of_core(mt, dev, tmp, res)
    return res


def check_out_of_core(mt, dev, tmp: pathlib.Path, res: dict) -> None:
    """What :func:`run_out_of_core` measured against what it must be: each
    page decoded once by the ROI pass and each search page once more, every
    intensity rising with t, peak RSS growth under half the stack, and the
    marks those of the search planes run in memory, every drawn bead
    among them."""
    _say("out-of-core result: " + json.dumps(res))
    stack_bytes = res["stack_bytes"]
    want_reads = len(OOC_CHANNELS) * OOC_TIMES + len(OOC_CHANNELS)
    if (res["page_reads"] != want_reads
            or res["page_reads_by_count"] != {
                "1": len(OOC_CHANNELS) * (OOC_TIMES - 1),
                "2": len(OOC_CHANNELS)}
            or res["pages_read_twice"] != sorted(f"{c}:0"
                                                 for c in OOC_CHANNELS)):
        raise AssertionError(f"ooc: {res['page_reads']} page reads "
                             f"{res['page_reads_by_count']}, want "
                             f"{want_reads}: each page once, and each "
                             "search page (t = 0) once more")
    if not res["intensity_rises"]:
        raise AssertionError("ooc: an intensity does not rise with t")
    growth = max(res["rss_peak_growth_bytes"].values())
    if growth >= stack_bytes / 2:
        raise AssertionError(f"ooc: peak RSS grew {growth} bytes, over half "
                             f"the stack's {stack_bytes}")
    # The marks against the same search planes run in memory.
    back = mt.load(tmp / "ooc.npz")
    base, drawn = ooc_base()
    planes = mt.DataArray(np.stack([base] * len(OOC_CHANNELS)),
                          dims=("channel", "y", "x"),
                          coords={"channel": list(OOC_CHANNELS)})
    mem = mt.beads(planes, device=dev, **OOC_KW)
    for name in ("x", "y", "fg", "bg"):
        got = np.asarray(back[name].transpose("mark", "time", ...).values)
        want = np.asarray(mem[name].values)
        if not np.array_equal(got[:, 0], want):
            raise AssertionError(f"ooc: {name} differs from the search "
                                 "planes run in memory")
    yx = np.stack([np.asarray(mem.y.values), np.asarray(mem.x.values)], 1)
    d = np.abs(yx[:, None, :] - drawn[None, :, :2]).max(-1)
    found = int((d.min(axis=0) <= 1).sum())
    _say(f"out-of-core: {res['n_marks']} marks equal the search planes run "
         f"in memory; {found}/{len(drawn)} drawn beads within 1 px; "
         f"peak RSS growth {growth} bytes ({growth / stack_bytes:.4f} of the "
         f"stack); page reads {res['page_reads']}; beads "
         f"{res['seconds']['beads']:.3f} s, quantify "
         f"{res['seconds']['quantify']:.3f} s, save "
         f"{res['seconds']['save']:.3f} s, load {res['seconds']['load']:.3f}"
         f" s")
    if found != len(drawn) or res["n_marks"] != len(drawn):
        raise AssertionError(f"ooc: {res['n_marks']} marks, {found} of "
                             f"{len(drawn)} drawn beads found")


# --------------------------------------------------------------------------
# Device meshes and the tuning UI
# --------------------------------------------------------------------------

#: The meshes of the mesh phase, on the first card: (batch, space).
MESH_SHAPES = ((2, 4), (1, 4))


def _mesh_names(n_cards: int) -> list:
    """(name, batch, space, devices) of every mesh the phase runs: the
    virtual meshes of :data:`MESH_SHAPES` on ``cuda:0`` and, with more
    than one card, one over the distinct cards."""
    out = [(f"{b}x{s}", b, s, ["cuda:0"] * (b * s)) for b, s in MESH_SHAPES]
    if n_cards > 1:
        out.append((f"1x{n_cards} cards", 1, n_cards,
                    [f"cuda:{i}" for i in range(n_cards)]))
    return out


def _vertical_serpentine(h: int = 256, w: int = 128, passes: int = 6):
    """One chain that runs down and up the plane ``passes`` times, so it
    crosses every boundary of a row split ``passes`` times."""
    chain = np.zeros((h, w), bool)
    cols = list(range(4, 4 + 20 * passes, 20))
    for k, c in enumerate(cols):
        chain[2:h - 2, c] = True
        if k + 1 < len(cols):
            chain[h - 3 if k % 2 == 0 else 2, c:cols[k + 1] + 1] = True
    strong = np.zeros_like(chain)
    strong[2, cols[0]] = True
    return strong, chain


class _KernelInputs:
    """The inputs of every ``hysteresis`` and ``ring_corr`` call made on
    the card within the block (:func:`spy` on each module that binds the
    wrapper), so that the kernels can be held against their plain twins at
    the shapes a mesh path gives them, after its counted run."""

    def __init__(self):
        self.calls = {"hysteresis": [], "ring_corr": []}
        self._stack = contextlib.ExitStack()

    def _recorder(self, name: str):
        def wrap(real):
            def call(*args, **kw):
                if args[0].device.type == "cuda":
                    self.calls[name].append(args[:2])
                return real(*args, **kw)
            return call
        return wrap

    def __enter__(self):
        from magnify_tpu_torch.ops import edge, score
        from magnify_tpu_torch.ops import hysteresis as hyst
        from magnify_tpu_torch.parallel import mesh

        for mod in (hyst, edge, mesh):
            self._stack.enter_context(
                spy(mod, "hysteresis", self._recorder("hysteresis")))
        self._stack.enter_context(
            spy(score, "ring_corr", self._recorder("ring_corr")))
        return self

    def __exit__(self, *exc):
        self._stack.close()
        return False


def _hold_recorded(what: str, seen: _KernelInputs, records=None,
                   tag: str | None = None) -> None:
    """Each recorded call's kernel result (launched again here, outside the
    counted run) against its plain twin on the same inputs, exactly. With
    ``tag`` the first call of each kernel (the mesh's bands: round 1 of
    the hysteresis, the banded score maps) is also timed against the
    plain twin, its bound and, for ``ring_corr``, the library convolution,
    into ``records`` under keys ending in ``tag``."""
    import torch
    import torch.nn.functional as F

    from magnify_tpu_torch.ops import hysteresis as hyst
    from magnify_tpu_torch.ops import score

    recs = {r["name"]: r for r in records or ()}
    shapes: dict = {}
    for k, (strong, weak) in enumerate(seen.calls["hysteresis"]):
        got = hyst.hysteresis(strong, weak)
        want = []
        p_ms = _event_once_ms(
            lambda: want.append(hyst.hysteresis_plain(strong, weak)))
        if not torch.equal(got, want[0]):
            raise AssertionError(
                f"{what}: hysteresis kernel != plain twin on call {k} "
                f"{tuple(strong.shape)}: {int((got != want[0]).sum())} "
                "pixels differ")
        shapes.setdefault("hysteresis", set()).add(tuple(strong.shape))
        if tag is not None and k == 0:
            k_ms = _event_ms(lambda: hyst.hysteresis(strong, weak), 20)
            bound_ms, _by = _bound(3 * strong.numel(), 0)
            recs["hysteresis"].update({
                f"ms{tag}": k_ms, f"plain_ms{tag}": p_ms,
                f"bound_ms{tag}": bound_ms,
                f"bound_share{tag}": bound_ms / k_ms,
                f"shape{tag}": list(strong.shape)})
            _say(f"{what}: hysteresis at the bands {tuple(strong.shape)}: "
                 f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms (one call), "
                 f"bound {bound_ms:.5f} ms (bytes)")
    for k, (feats, weights) in enumerate(seen.calls["ring_corr"]):
        got = score.ring_corr(feats, weights)
        want = []
        p_ms = _event_once_ms(
            lambda: want.append(score.ring_corr_plain(feats, weights)))
        if got.shape != want[0].shape or not torch.equal(got, want[0]):
            raise AssertionError(f"{what}: ring_corr kernel != plain twin "
                                 f"on call {k} {tuple(feats.shape)}")
        del got, want
        shapes.setdefault("ring_corr", set()).add(tuple(feats.shape))
        if tag is not None and k == 0:
            n_r, _c, ksz, _ = weights.dense.shape
            nnz = int((weights.dense != 0).sum())
            px = feats.numel() // 8
            k_ms = _event_ms(lambda: score.ring_corr(feats, weights), 10)
            ff = feats.float().reshape(-1, 8, *feats.shape[-2:])
            dense_f = weights.dense.float()
            lib_ms = _event_ms(
                lambda: F.conv2d(ff, dense_f, padding=ksz // 2), 3)
            del ff
            bound_ms, bound_by = _bound((8 + 4 * n_r) * px, 2 * nnz * px)
            recs["ring_corr"].update({
                f"ms{tag}": k_ms, f"plain_ms{tag}": p_ms,
                f"library_ms{tag}": lib_ms, f"bound_ms{tag}": bound_ms,
                f"bound_share{tag}": bound_ms / k_ms,
                f"shape{tag}": list(feats.shape)})
            _say(f"{what}: ring_corr at the bands {tuple(feats.shape)}: "
                 f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms (one call), "
                 f"library conv2d {lib_ms:.4f} ms, bound {bound_ms:.5f} ms "
                 f"({bound_by})")
    counts = {name: len(calls) for name, calls in seen.calls.items()}
    _say(f"{what}: kernels == plain twins on every call of the path "
         f"{counts}, shapes {dict((n, sorted(v)) for n, v in shapes.items())}")
    seen.calls = {name: [] for name in seen.calls}


def mesh_phase(mt, dev, golden, by_path: dict, singles: dict,
               ms_single: dict, tmp: pathlib.Path, records: list) -> None:
    """The main paths under ``use_mesh``: each mesh of :func:`_mesh_names`
    runs beads A and B, mrbles M, the chip on C8 and C, RANSAC beads A at
    5,000,000 proposals and find_circles_stack over 8 planes, each against
    the single-device run of this call (``singles``) and the golden file;
    first the sharded hysteresis against ``hysteresis_plain`` (frame A's
    masks, frame C's plane, a serpentine across every band boundary), its
    rounds printed; last the out-of-core stack under every mesh in a child
    (``--out-of-core DIR --mesh``) against the single-device child's saved
    result. Every kernel call of every mesh path is recorded and held
    against its plain twin after the path (:func:`_hold_recorded`); the
    bands of frames A and C are timed into ``records`` (keys ending in
    ``_mesh_<mesh>_a`` and ``_c``)."""
    import torch

    from magnify_tpu_torch.ops import hysteresis as hyst
    from magnify_tpu_torch.parallel import make_mesh, use_mesh
    from magnify_tpu_torch.parallel.mesh import sharded_hysteresis

    n_cards = torch.cuda.device_count()
    meshes = [(name, make_mesh(b, s, devices=devs))
              for name, b, s, devs in _mesh_names(n_cards)]
    _say(f"mesh phase: {n_cards} card(s) visible; meshes "
         f"{[name for name, _m in meshes]}")
    strong_a, weak_a, _f = _stages(frame_a()[0], dev)
    strong_c, weak_c, _f = _stages(frame_c()[0][0], dev)
    serp = [torch.as_tensor(m).to(dev) for m in _vertical_serpentine()]
    cases = (("frame A's masks", strong_a, weak_a),
             ("frame C's plane", strong_c, weak_c),
             ("a serpentine across every band boundary", *serp))
    want = [hyst.hysteresis_plain(s, w) for _name, s, w in cases]
    for name, mesh in meshes:
        for (what, s, w), ref in zip(cases, want):
            before = hyst.launches
            got, rounds = sharded_hysteresis(s, w, mesh)
            launches = hyst.launches - before
            if not torch.equal(got, ref):
                raise AssertionError(f"mesh {name}: sharded hysteresis on "
                                     f"{what} differs from hysteresis_plain")
            _say(f"mesh {name}: sharded hysteresis on {what} "
                 f"{tuple(s.shape)} equals hysteresis_plain; {rounds} "
                 f"rounds, {launches} kernel launches")
    del strong_c, weak_c

    data = {case: as_dataarray(mt, case) for case in ("A", "B", "C8", "C")}
    data["M"] = as_dataarray(mt, "M")
    planes = np.stack([frame_a(seed)[0] for seed in range(8)])
    stack_kw = dict(low_edge_quantile=FIND_ARGS[0],
                    high_edge_quantile=FIND_ARGS[1],
                    min_radius=FIND_ARGS[4], max_radius=FIND_ARGS[5],
                    min_roundness=FIND_ARGS[6], min_dist=FIND_ARGS[7],
                    batch=4, device=dev)
    stack_single = mt.ops.find_circles_stack(planes, **stack_kw)
    ransac_kw = dict(detector="ransac", device=dev)
    ransac_single = mt.beads(data["A"], **ransac_kw, **FRAME_A_KW)

    def run_c():
        return mt.microfluidic_chip(data["C"], pinlist=frame_c_pinlist(),
                                    device=dev, **FRAME_C_KW)

    # (path, case, kernels, run, bead frames)
    runs = (
        ("beads A", "A", DENSE,
         lambda: mt.beads(data["A"], device=dev, **FRAME_A_KW), 1),
        ("beads B", "B", DENSE,
         lambda: mt.beads(data["B"], device=dev, **FRAME_B_KW), 1),
        ("mrbles M", "M", DENSE, lambda: _mrbles(mt, data["M"], dev), 1),
        ("chip_c8", "C8", DENSE,
         lambda: mt.microfluidic_chip(data["C8"], device=dev,
                                      **FRAME_C8_KW), 0),
        ("chip_c", "C", DENSE, run_c, 0),
        ("beads A ransac", "RA", RANSAC,
         lambda: mt.beads(data["A"], **ransac_kw, **FRAME_A_KW), 1),
    )
    singles = dict(singles, RA=ransac_single)
    timed = {"A": "a", "C": "c"}
    for name, mesh in meshes:
        with use_mesh(mesh):
            for path, case, kernels, run, beads in runs:
                with _KernelInputs() as seen, \
                        _Launches(by_path, f"mesh {name} {path}", kernels,
                                  beads=beads):
                    out = run()
                _hold_recorded(
                    f"mesh {name} {path}", seen, records,
                    f"_mesh_{name}_{timed[case]}" if case in timed else None)
                _assert_same_frame(f"mesh {name} {path}", out, singles[case])
                if case == "C":
                    _check_frame_c(f"mesh {name} frame C", out)
                else:
                    _check_case(case, out, golden)
                _say(f"mesh {name} {path}: equals the single-device run "
                     "(rows, fg/bg/roi digests, tags)")
            path = f"mesh {name} find_circles_stack 8 x A"
            with _KernelInputs() as seen, _Launches(by_path, path):
                res = mt.ops.find_circles_stack(planes, **stack_kw)
            _hold_recorded(path, seen)
            for k, ((c, sc), (wc, ws)) in enumerate(zip(res, stack_single)):
                if not (np.array_equal(c, wc) and np.array_equal(sc, ws)):
                    raise AssertionError(f"{path}: plane {k} differs from "
                                         "the single-device stack")
            _say(f"{path}: every plane equals the single-device stack")
            for case, reps, run in (("A", 3, runs[0][3]),
                                    ("C8", 3, runs[3][3]),
                                    ("C", 2, run_c)):
                ms = _time_ms(run, reps)
                _say(f"mesh {name}: frame {case} warm {ms:.3f} ms (median "
                     f"of {reps}) vs one device {ms_single[case]:.3f} ms")
    mesh_out_of_core(mt, by_path, tmp)


def mesh_out_of_core(mt, by_path: dict, tmp: pathlib.Path) -> None:
    """The out-of-core stack under every mesh, in a child (``--out-of-core
    DIR --mesh``): its marks, masks and ROI store against what the
    single-device child saved (``DIR/ooc.npz``)."""
    t0 = time.perf_counter()
    child = subprocess.run([sys.executable, str(pathlib.Path(__file__)
                                                .resolve()),
                            "--out-of-core", str(tmp), "--mesh"],
                           capture_output=True, text=True, timeout=600)
    for line in child.stdout.splitlines():
        if not line.startswith("OOC_MESH "):
            _say("  [out-of-core mesh child]", line)
    if child.returncode != 0:
        raise AssertionError(f"out-of-core mesh child exited "
                             f"{child.returncode}:\n{child.stderr[-4000:]}")
    res = json.loads(next(line for line in child.stdout.splitlines()
                          if line.startswith("OOC_MESH "))[9:])
    single = mt.load(tmp / "ooc.npz")
    for name, got in res.items():
        by_path[f"mesh {name} beads OOC"] = got["launches"]
        by_path["_batched"][f"mesh {name} beads OOC"] = got["batched"]
        arrays = np.load(tmp / f"ooc_mesh_{name}.npz")
        for var in ("x", "y", "fg", "bg"):
            want = np.asarray(single[var].transpose("mark", "time",
                                                    ...).values)
            if not np.array_equal(arrays[var], want):
                raise AssertionError(f"mesh {name} beads OOC: {var} differs "
                                     "from the single-device child")
        if got["roi"] != digest(single["roi"].transpose(
                "mark", "channel", "time", ...).values):
            raise AssertionError(f"mesh {name} beads OOC: the ROI store "
                                 "differs from the single-device child")
        _say(f"mesh {name} beads OOC: {got['n_marks']} marks, masks and ROI "
             f"store equal the single-device child; beads "
             f"{got['seconds']:.3f} s")
    _say(f"out-of-core mesh child: {time.perf_counter() - t0:.3f} s")


def out_of_core_mesh_child(root: pathlib.Path, dev) -> dict:
    """``--out-of-core ROOT --mesh``: ``beads`` on the out-of-core stack
    under each mesh of :func:`_mesh_names`, every kernel call held against
    its plain twin after the run; saves each result's x, y, fg, bg to
    ``ROOT/ooc_mesh_NAME.npz`` and returns launches, seconds and the ROI
    store's digest per mesh."""
    import torch

    import magnify_tpu_torch as mt
    from magnify_tpu_torch.parallel import make_mesh, use_mesh

    out = {}
    for name, b, s, devs in _mesh_names(torch.cuda.device_count()):
        by_path: dict = {}
        t0 = time.perf_counter()
        with use_mesh(make_mesh(b, s, devices=devs)), \
                _KernelInputs() as seen, \
                _Launches(by_path, f"mesh {name} beads OOC", beads=1):
            xp = mt.beads(str(root / OOC_PATTERN), device=dev, **OOC_KW)
        seconds = time.perf_counter() - t0
        _hold_recorded(f"mesh {name} beads OOC", seen)
        np.savez(root / f"ooc_mesh_{name}.npz",
                 **{v: np.asarray(xp[v].transpose("mark", "time", ...).values)
                    for v in ("x", "y", "fg", "bg")})
        out[name] = {
            "launches": by_path[f"mesh {name} beads OOC"],
            "batched": by_path["_batched"][f"mesh {name} beads OOC"],
            "seconds": seconds, "n_marks": int(xp.sizes["mark"]),
            "roi": digest(xp["roi"].transpose("mark", "channel", "time",
                                              ...).values)}
    return out


def interactive_phase(mt, dev, by_path: dict, singles: dict) -> None:
    """The tuning UI, headless (no matplotlib or no GUI backend: each stage
    once with the defaults): ``beads(interactive=True)`` on frame A,
    ``microfluidic_chip(interactive=True)`` on frame C8 and
    ``ops.find_circles(gui=InteractiveUI())`` on frame A's plane, each equal
    to its call without the UI, the kernel launches counted."""
    from magnify_tpu_torch.plot.vis import InteractiveUI

    with _Launches(by_path, "beads A interactive", beads=1):
        xa = mt.beads(as_dataarray(mt, "A"), interactive=True, device=dev,
                      **FRAME_A_KW)
    _assert_same_frame("beads A interactive", xa, singles["A"])
    with _Launches(by_path, "chip_c8 interactive"):
        xc = mt.microfluidic_chip(as_dataarray(mt, "C8"), interactive=True,
                                  device=dev, **FRAME_C8_KW)
    _assert_same_frame("chip_c8 interactive", xc, singles["C8"])
    img = frame_a()[0]
    ui = InteractiveUI()
    with _Launches(by_path, "find_circles gui"):
        got = mt.ops.find_circles(img, *FIND_ARGS, gui=ui,
                                  detector="dense", device=dev)
    want = mt.ops.find_circles(img, *FIND_ARGS, detector="dense", device=dev)
    if not all(np.array_equal(g, w) for g, w in zip(got, want)):
        raise AssertionError("find_circles(gui=InteractiveUI()) differs from "
                             "gui=None")
    _say(f"interactive phase (InteractiveUI().interactive = "
         f"{ui.interactive}, {len(ui.sessions)} stages): beads A, chip C8 "
         "and find_circles equal their calls without the UI")


def main(argv) -> int:
    import torch

    if "--out-of-core" in argv:
        return out_of_core_child(
            pathlib.Path(argv[argv.index("--out-of-core") + 1]),
            "--mesh" in argv)
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
    records = kernel_phase(dev) + [_normalize_record(dev),
                                   _ownership_record(dev)]
    if "--kernels-only" in argv:
        _say(json.dumps({"kernels": records}))
        return 0
    main_path(records, dev)
    decode_phase(dev)
    _say(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
