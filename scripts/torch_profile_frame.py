#!/usr/bin/env python3
"""Device time of magnify_tpu_torch's hand kernels and of warm frames.

Run from the root of a checkout on a machine with one CUDA device:

    python3 scripts/torch_profile_frame.py

With ``torch.profiler`` (CUDA activity), at the shapes of ``chip_smoke.py``'s
frames A (1024^2) and B (1844^2 stitched plane, 1892^2 padded features):

1. each hand kernel's device time per call (the sum of its CUDA kernels'
   durations over 20 calls, divided by 20), kernel by kernel, beside the
   host wall time per call of the same loop, and for hysteresis at every
   tile height of 8, 16, 32, 64 and 128 rows;
2. for 3 warm ``beads()`` frames of A and then of B, 3 warm ``mrbles()``
   frames of M, 2 warm runs each of ``beads_stream`` over 8 frames A and
   ``mrbles_stream`` over 6 frames M (seeds 0-5), 3 warm
   ``microfluidic_chip()`` calls on frame C8 (8 x 8 chambers, 900^2) and 2
   on frame C ("pc", 56 x 28 chambers, 7,187 x 6,755, one searched and one
   copied timestep): the wall time per frame,
   the device busy time (the union of all kernel intervals, whatever thread
   or stream launched them), the idle share, and the ten kernels with the
   most device time; then the same for ``detector="ransac"`` (5,000,000
   proposals): 3 warm ``beads()`` frames of A, 3 warm chips C8 and 2 of C;
3. the RANSAC detector's stages as ``beads`` on frame A and
   ``microfluidic_chip`` on frames C8 and C reach them (CUDA events around
   each call ``ops.detect`` makes, 3 calls each after a warm-up, 2 for C):
   ``detect_ransac`` (the whole plane) and ``detect_rois_ransac`` (the
   chamber batch) and inside them the edge stack with the gradient angles,
   the sampler (threefry streams, gathers, circumcircles), the unique-triple
   dedupe, the perimeter scorer and the NMS, per input shape, with the
   number of unique proposals;
4. stacks read from disk: ``beads`` on frame B read from its 8 tile files,
   ``microfluidic_chip`` on frame C read from one 2-page TIFF (2 warm calls
   each), and the out-of-core stack of ``chip_smoke.py`` (4 channels x 20
   timesteps of 4096^2 uint16 OME-TIFF pages, 2.68 GB, written to a
   temporary directory first): ``beads`` and then ``quantify`` on it, one
   warm call each (the pages come from the page cache: the stack was just
   written);
5. the rest of the single-card API: ``detector="ransac"`` with the conv
   scorer (``MAGNIFY_TPU_SCORER=conv``): 3 warm ``beads()`` frames of A, 3
   chips C8 and 2 of C, and their RANSAC stages (the score maps and the
   map read-out in place of the perimeter scorer); ``fit_basic`` on each
   channel of frame S (16 tiles of 1024^2; device time per call over 3
   calls); 2 warm frames S through ``beads_pipe`` with ``basic_correct``.

``--disk-only`` runs part 4 alone, ``--api-only`` part 5 alone. It prints
the card's name and power limit first. It exits 2 without a CUDA device.
"""

from __future__ import annotations

import collections
import contextlib
import pathlib
import re
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def _kernels(prof):
    import torch

    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def _busy_us(events) -> float:
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e <= end:
            continue
        busy += e - max(s, end)
        end = e
    return busy


def _profile(fn, reps: int):
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return _kernels(prof), wall_ms


def kernel_times(label, fn, prefixes, reps=20) -> None:
    events, wall_ms = _profile(fn, reps)
    per = collections.Counter()
    for e in events:
        for p in prefixes:
            at = e.name.find(p)
            if at >= 0:
                key = re.split(r"[(<]", e.name[at:])[0]
                per[key] += e.time_range.elapsed_us()
    total = sum(per.values()) / reps
    detail = ", ".join(f"{k} {v / reps:.2f} us" for k, v in per.items())
    print(f"{label}: device {total:.2f} us per call ({detail}); host wall "
          f"{wall_ms / reps * 1e3:.2f} us per call", flush=True)


def frame_profile(label, fn, reps=3, frames=1) -> None:
    """``fn`` handles ``frames`` frames per call."""
    events, wall_ms = _profile(fn, reps)
    n = reps * frames
    busy_ms = _busy_us(events) / 1e3
    top = collections.Counter()
    for e in events:
        top[e.name[:60]] += e.time_range.elapsed_us()
    print(f"{label}: wall {wall_ms / n:.3f} ms per frame, device busy "
          f"{busy_ms / n:.3f} ms per frame, idle share "
          f"{1 - busy_ms / wall_ms:.4f}, {len(events) // n} kernels per "
          "frame", flush=True)
    for name, us in top.most_common(10):
        print(f"    {us / n / 1e3:8.4f} ms  {name}", flush=True)


# The functions of the RANSAC path, timed where ``ops.detect`` calls them.
RANSAC_STAGES = ("detect_ransac", "detect_rois_ransac", "edge_pipeline",
                 "candidate_circles", "dedupe_circles", "score_circles",
                 "_padded_maps", "gather_map_scores", "parallel_greedy_nms")


def ransac_stages(label, run, reps=3) -> None:
    """Device ms of each RANSAC stage as ``run()``, one entry-point call,
    reaches it through ``ops.detect``: CUDA events around every call of the
    functions in ``RANSAC_STAGES``, over ``reps`` calls after a warm-up, per
    function and input shape, with the unique proposals the dedupes kept."""
    import torch

    import chip_smoke as cs
    from magnify_tpu_torch.ops import detect

    log = []

    def timed(name):
        def wrap(real):
            def call(*args, **kw):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = real(*args, **kw)
                end.record()
                if name in ("score_circles", "gather_map_scores"):
                    circles = args[2 if name == "score_circles" else 1]
                    what = "x".join(map(str, circles.shape[:-1]))
                    what += " circles"
                elif name == "dedupe_circles":
                    what = str(tuple(args[0][0].shape))
                else:
                    what = str(tuple(args[0].shape))
                n_unique = out[-1] if name == "dedupe_circles" else None
                log.append((f"{name} {what}", start, end, n_unique))
                return out
            return call
        return wrap

    run()
    with contextlib.ExitStack() as stack:
        for name in RANSAC_STAGES:
            stack.enter_context(cs.spy(detect, name, timed(name)))
        for _ in range(reps):
            run()
    torch.cuda.synchronize()
    ms = collections.Counter()
    n_unique = 0
    for key, start, end, n_u in log:
        ms[key] += start.elapsed_time(end) / reps
        if n_u is not None:
            n_unique += int(torch.as_tensor(n_u).sum())
    detail = "; ".join(f"{k} {v:.3f} ms" for k, v in ms.items())
    print(f"RANSAC stages, {label} (per call): {detail}; n_unique "
          f"{n_unique // reps}", flush=True)


def disk_profile(dev) -> None:
    """Part 4: frames B and C read from TIFF files, and the out-of-core
    stack."""
    import chip_smoke as cs
    import magnify_tpu_torch as mt
    from magnify_tpu_torch.io.tiff import write_tiff

    with tempfile.TemporaryDirectory(prefix="profile_disk_") as tmp:
        tmp = pathlib.Path(tmp)
        tiles = cs.frame_b()
        for ci, ch in enumerate(("red", "green")):
            for r in range(2):
                for c in range(2):
                    path = tmp / "b" / ch / f"tile_{r}_{c}.tif"
                    path.parent.mkdir(parents=True, exist_ok=True)
                    write_tiff(path, tiles[ci, r, c], ome=False)
        path_b = str(tmp / "b" / "(channel)" / "tile_(row)_(col).tif")
        frame_profile("beads frame B from 8 tile files",
                      lambda: mt.beads(path_b, device=dev,
                                       **cs.FRAME_B_KW), reps=2)
        write_tiff(tmp / "c.tif", cs.frame_c()[0], axes="TYX", ome=False)
        frame_profile("microfluidic_chip frame C from a 2-page TIFF",
                      lambda: mt.microfluidic_chip(
                          str(tmp / "c.tif"), pinlist=cs.frame_c_pinlist(),
                          device=dev, **cs.FRAME_C_KW), reps=2)
        t0 = time.perf_counter()
        seconds = cs.write_ooc_stack(tmp)
        print(f"out-of-core stack written in {seconds:.3f} s of writes "
              f"({time.perf_counter() - t0:.3f} s with making the planes)",
              flush=True)
        pattern = str(tmp / cs.OOC_PATTERN)
        frame_profile("beads out-of-core 4 x 20 x 4096^2 from disk",
                      lambda: mt.beads(pattern, device=dev, **cs.OOC_KW),
                      reps=1)
        xp = mt.beads(pattern, device=dev, **cs.OOC_KW)
        frame_profile("quantify out-of-core (memmap ROI store)",
                      lambda: mt.quantify(xp, device=dev), reps=1)


def api_profile(dev) -> None:
    """Part 5: the conv scorer's RANSAC frames, the BaSiC fit and frame S
    through ``basic_correct``."""
    import chip_smoke as cs
    import magnify_tpu_torch as mt
    from magnify_tpu_torch.ops import basic

    ransac = dict(detector="ransac", device=dev)
    data_a = cs.as_dataarray(mt, "A")
    data_c8 = cs.as_dataarray(mt, "C8")
    data_c = cs.as_dataarray(mt, "C")
    runs = (("beads frame A",
             lambda: mt.beads(data_a, **ransac, **cs.FRAME_A_KW), 3),
            ("microfluidic_chip frame C8",
             lambda: mt.microfluidic_chip(data_c8, **ransac,
                                          **cs.FRAME_C8_KW), 3),
            ("microfluidic_chip frame C",
             lambda: mt.microfluidic_chip(
                 data_c, pinlist=cs.frame_c_pinlist(), **ransac,
                 **cs.FRAME_C_KW), 2))
    with cs._scorer("conv"):
        for label, fn, reps in runs:
            frame_profile(f"{label}, ransac, conv scorer", fn, reps=reps)
        for label, fn, reps in runs:
            ransac_stages(f"{label}, conv scorer", fn, reps=reps)
    tiles, _beads = cs.frame_s()
    for ci, ch in enumerate(cs.S_CHANNELS):
        train = tiles[ci].reshape(-1, cs.TILE, cs.TILE)
        frame_profile(f"fit_basic frame S channel {ch} (16 x 1024^2)",
                      lambda: basic.fit_basic(train, device=dev))
    data_s = cs.as_dataarray(mt, "S")
    pipe = cs.frame_s_pipe(mt, device=dev)
    frame_profile("beads_pipe + basic_correct frame S",
                  lambda: pipe(data=data_s), reps=2)


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    if "--disk-only" in argv:
        disk_profile(torch.device("cuda"))
        return 0
    if "--api-only" in argv:
        api_profile(torch.device("cuda"))
        return 0

    import chip_smoke as cs
    import magnify_tpu_torch as mt
    from magnify_tpu_torch.ops import hysteresis as hyst
    from magnify_tpu_torch.ops import score

    dev = torch.device("cuda")
    weights, _ = score._cached_tables(8, 12, str(dev))
    for name, img in (("frame A", cs.frame_a()[0]),
                      ("frame B", cs._frame_b_plane())):
        strong, weak, feats, _inputs = cs._stages(img, dev)
        for tile_rows in (8, 16, 32, 64, 128):
            kernel_times(f"hysteresis {name} {tuple(strong.shape)} "
                         f"tile_rows={tile_rows}",
                         lambda: hyst.hysteresis(strong, weak, tile_rows),
                         ("hyst_",))
        kernel_times(f"ring_corr {name} {tuple(feats.shape)}",
                     lambda: score.ring_corr(feats, weights),
                     ("ring_corr_kernel",))
    for case, kw in (("A", cs.FRAME_A_KW), ("B", cs.FRAME_B_KW)):
        data = cs.as_dataarray(mt, case)
        frame_profile(f"beads frame {case}",
                      lambda: mt.beads(data, device=dev, **kw))
    data_a = cs.as_dataarray(mt, "A")
    frames_m = [cs.as_dataarray(mt, "M", seed) for seed in range(6)]
    frame_profile("mrbles frame M",
                  lambda: cs._mrbles(mt, frames_m[2], dev))
    frame_profile(
        "beads_stream 8 x frame A",
        lambda: list(mt.beads_stream([data_a] * 8, device=dev,
                                     **cs.FRAME_A_KW)), reps=2, frames=8)
    spectra, codes = cs.mrbles_csvs()
    frame_profile(
        "mrbles_stream 6 x frame M",
        lambda: list(mt.mrbles_stream(frames_m, spectra=spectra, codes=codes,
                                      device=dev, **cs.FRAME_M_KW)),
        reps=2, frames=6)
    data_c8 = cs.as_dataarray(mt, "C8")
    frame_profile("microfluidic_chip frame C8",
                  lambda: mt.microfluidic_chip(data_c8, device=dev,
                                               **cs.FRAME_C8_KW))
    data_c = cs.as_dataarray(mt, "C")
    frame_profile("microfluidic_chip frame C",
                  lambda: mt.microfluidic_chip(
                      data_c, pinlist=cs.frame_c_pinlist(), device=dev,
                      **cs.FRAME_C_KW), reps=2)

    ransac = dict(detector="ransac", device=dev)
    frame_profile("beads frame A, ransac",
                  lambda: mt.beads(data_a, **ransac, **cs.FRAME_A_KW))
    frame_profile("microfluidic_chip frame C8, ransac",
                  lambda: mt.microfluidic_chip(data_c8, **ransac,
                                               **cs.FRAME_C8_KW))
    frame_profile("microfluidic_chip frame C, ransac",
                  lambda: mt.microfluidic_chip(
                      data_c, pinlist=cs.frame_c_pinlist(), **ransac,
                      **cs.FRAME_C_KW), reps=2)
    ransac_stages("beads frame A",
                  lambda: mt.beads(data_a, **ransac, **cs.FRAME_A_KW))
    ransac_stages("microfluidic_chip frame C8",
                  lambda: mt.microfluidic_chip(data_c8, **ransac,
                                               **cs.FRAME_C8_KW))
    ransac_stages("microfluidic_chip frame C",
                  lambda: mt.microfluidic_chip(
                      data_c, pinlist=cs.frame_c_pinlist(), **ransac,
                      **cs.FRAME_C_KW), reps=2)
    disk_profile(dev)
    api_profile(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
