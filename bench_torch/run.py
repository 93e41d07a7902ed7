#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once, on the GPU this process sees.

    python3 bench_torch/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

A cell names a configuration (``bench_torch/configs/<name>.json``, whose
``kind`` picks ``bench_torch/kinds/<kind>.py``) and a traffic mix
(``bench_torch/traffic/<name>.json``). The run:

1. draws the pool of distinct frames from ``--seed`` (on the card);
2. warms the program up on the cell's own frames (the kernels are built,
   or loaded, into ``.cache/magnify_tpu_torch/kernels/`` in the checkout);
3. measures a closed loop for ``--seconds``: one caller hands the program
   the pool's frames in turn, each after the last one's result came back;
   the window ends with the first frame that completes after
   ``--seconds``;
4. with ``--trace 1``, measures instead a window of whole passes over the
   pool (at least ``TRACE_SECONDS``) under ``torch.profiler``, with the
   per-layer metrics' spies installed, and reports those metrics;
5. holds a sample of the window's results, drawn from the seed, against
   the plain reference of its frame (the kind's ``expected``/``compare``)
   once the window has closed, and prints one JSON line.

End-to-end metrics are read by ``bench_torch/end_to_end/<name>.py``,
per-layer ones by ``bench_torch/metrics/<name>.py``. Without a CUDA
device, or with fewer than the cell asks for, it prints no result and
exits 2.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import random  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TRACE_SECONDS = 3.0  # least length of a traced window
SAMPLE_SIZE = 16     # results of a window held against the reference


@dataclasses.dataclass
class Window:
    setup_s: float
    seconds: float
    frames: int
    peak_bytes: int


def load_cell(root: pathlib.Path, name: str) -> tuple:
    """(benchmark, workload entry, configuration, traffic mix): the
    configuration's file as ``BENCHMARK.json`` gives it, the traffic
    mix's by its name."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = json.loads((root / configs[cell["config"]]["file"]).read_text())
    traffic = json.loads((root / "bench_torch" / "traffic"
                          / f"{cell['traffic']}.json").read_text())
    return bench, cell, cfg, traffic


def cell_metrics(entries: list, cell: str) -> list:
    """Names of the metrics of ``entries`` that ``cell`` reports."""
    return [m["name"] for m in entries
            if cell in m.get("workloads", [cell])]


class SerialLoop:
    """One caller: frame ``k % pool`` after frame ``k - 1`` returned."""

    def __init__(self, kind, cfg, traffic, frames, device):
        self.call = kind.make_call(cfg, traffic, device)
        self.frames = frames
        self.k = 0

    def next(self) -> tuple:
        idx = self.k % len(self.frames)
        out = self.call(self.frames[idx])
        self.k += 1
        return idx, out


def measure(loop, seconds: float, pool: int, whole_cycles: bool,
            sample: "Sample", on_frame=None, min_frames: int = 1) -> tuple:
    """Run ``loop`` until ``seconds`` have passed and ``min_frames``
    frames completed (and, with ``whole_cycles``, until the frames make
    whole passes over the pool), offering each result to ``sample``.
    Returns (frames, window seconds)."""
    import torch

    n = 0
    t0 = time.perf_counter()
    while True:
        with torch.profiler.record_function("frame"):
            idx, out = loop.next()
        sample.offer(idx, out)
        del out
        n += 1
        if on_frame is not None:
            on_frame(n)
        if time.perf_counter() - t0 >= seconds and n >= min_frames and (
                not whole_cycles or n % pool == 0):
            break
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return n, time.perf_counter() - t0


class Sample:
    """The results that ``correct`` checks: a uniform sample of at most
    ``size`` of the window's results, drawn from the run's seed (reservoir
    sampling), so that a long window holds no more than ``size`` results
    in memory."""

    def __init__(self, seed: int, size: int = SAMPLE_SIZE):
        self.rng = random.Random(seed)
        self.size = size
        self.seen = 0
        self.kept: list = []

    def offer(self, idx: int, out) -> None:
        if len(self.kept) < self.size:
            self.kept.append((idx, out))
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.size:
                self.kept[j] = (idx, out)
        self.seen += 1


def power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def check(kind, cfg, frames, results) -> tuple:
    """Hold every result of ``results`` [(frame index, result)] against the
    reference of its frame. Returns (failed results, {number: {"value":
    worst, "limit": limit}})."""
    want = {}
    worst = {name: 0 for name in kind.LIMITS}
    failed = 0
    for idx, out in results:
        if idx not in want:
            want[idx] = kind.expected(cfg, frames[idx])
        nums = kind.compare(cfg, frames[idx], want[idx],
                            kind.extract(cfg, out))
        bad = False
        for name, value in nums.items():
            worst[name] = max(worst[name], value)
            bad |= value > kind.LIMITS[name]
        failed += bad
    return failed, {name: {"value": worst[name], "limit": kind.LIMITS[name]}
                    for name in kind.LIMITS}


def run_cell(bench, cell, cfg, traffic, seed: int, seconds: float,
             traced: bool, device: str, t0: float = _T0,
             min_frames: int = 1) -> dict:
    """One run of ``cell``; returns its result line as a dict. ``device``
    is where the frames are drawn and the program runs; the window holds
    at least ``min_frames`` frames."""
    import torch

    from bench_torch import trace as tracing

    kind = importlib.import_module(f"bench_torch.kinds.{cfg['kind']}")
    os.environ["MAGNIFY_TPU_DETECTOR"] = traffic["detector"]
    os.environ["MAGNIFY_TPU_SCORER"] = traffic.get("scorer", "auto")
    if traffic["mode"] != "serial":
        raise ValueError(f"traffic mode {traffic['mode']!r}: the harness "
                         "runs serial loops only")
    pool = traffic["pool"]
    frames = kind.make_frames(cfg, seed, pool, device)
    loop = SerialLoop(kind, cfg, traffic, frames, device)
    on_card = torch.device(device).type == "cuda"
    for _ in range(cfg["warm_frames"]):
        loop.next()
    if on_card:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t0

    line: dict = {}
    sample = Sample(seed)
    if not traced:
        n, window_s = measure(loop, seconds, pool, False, sample,
                              min_frames=min_frames)
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        window = Window(setup_s, window_s, n, peak)
        metrics = {}
        units = {m["name"]: m["unit"] for m in bench["end_to_end"]}
        for name in cell_metrics(bench["end_to_end"], cell["name"]):
            value = importlib.import_module(
                f"bench_torch.end_to_end.{name}").read(window)
            if value is not None:
                metrics[name] = {"value": value, "unit": units[name]}
        device_info = {}
    else:
        names = cell_metrics(bench["per_layer"], cell["name"])
        mods = {n: importlib.import_module(f"bench_torch.metrics.{n}")
                for n in names}
        tr = tracing.Trace()
        diagnostics = importlib.import_module("magnify_tpu_torch.diagnostics")
        find = importlib.import_module("magnify_tpu_torch.components.find")

        def on_frame(n):
            tr.chip_timings.append(dict(find.last_chip_timings))
            if n >= pool:
                tr.first_cycle = False

        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if on_card:
            activities.append(ProfilerActivity.CUDA)
        with tracing.spies(mods, tr), tracing.stage_spans():
            diagnostics.reset_stages()
            find.last_chip_timings.clear()
            with profile(activities=activities) as prof:
                n, window_s = measure(
                    loop, min(seconds, TRACE_SECONDS), pool, True, sample,
                    on_frame, min_frames)
            tr.stages = diagnostics.stage_report()
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        tr.frames, tr.window_s = n, window_s
        tr.cycles = n // pool
        tr.read_profiler(prof)
        del prof
        units = {m["name"]: m["unit"] for m in bench["per_layer"]}
        metrics = {}
        for name, mod in mods.items():
            value = mod.read(tr, cfg)
            if value is not None:
                metrics[name] = {"value": value, "unit": units[name]}
        device_info = {"busy_s": tr.busy_s, "window_s": window_s}
        line["breakdown"] = tr.breakdown()
        tr.records.clear()
    del loop
    memory_peak = max(setup_peak, peak) if on_card else 0
    if on_card:
        torch.cuda.empty_cache()

    failed, checks = check(kind, cfg, frames, sample.kept)
    line.update({
        "correct": failed == 0 and n > 0,
        "attempted": n, "failed": failed, "metrics": metrics,
        "device": dict({
            "platform": "gpu" if on_card else "cpu",
            "kind": (torch.cuda.get_device_name(torch.device(device))
                     if on_card else "cpu"),
            "count": 1, "memory_peak_bytes": memory_peak,
            "power_limit": power_limit() if on_card else None},
            **device_info),
    })
    line["checks"] = checks  # last: each compared number and its limit
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench, cell, cfg, traffic = load_cell(ROOT, args.workload)
    cache = ROOT / ".cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")

    import torch

    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell["chips"]):
        print(f"run.py: the cell needs {cell['chips']} CUDA device(s); "
              f"this process sees {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    line = run_cell(bench, cell, cfg, traffic, args.seed, args.seconds,
                    bool(args.trace), "cuda")
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
