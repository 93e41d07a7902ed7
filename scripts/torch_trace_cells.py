#!/usr/bin/env python3
"""Where a benchmark cell's frames spend their host time, by program span,
and what tracing costs.

Run from anywhere on a machine with one CUDA device; ``ROOT`` is the
checkout to measure (its ``bench_torch/`` and ``magnify_tpu_torch/``):

    python3 scripts/torch_trace_cells.py spans ROOT CELL SEED OUT.json
    python3 scripts/torch_trace_cells.py cost ROOT CELL SEED PAIRS [--aa]

``spans`` makes one traced run of the cell (``bench_torch.run.run_cell``
with ``--trace 1``, a 30 s budget) and writes the result line's metrics,
the whole ``breakdown`` (``Trace.breakdown(top=1000)``: device time by
kernel and idle gaps by name), the share of the
named idle time whose gaps have no operator and no program span at their
middle (operator slot ``-``), the device's launches by kernel name,
``diagnostics.span_report()`` and ``counter_report()`` to ``OUT.json``;
it prints a summary line and the self time of each span a frame. A
checkout without the program's span store (before it had one) gives the
breakdown alone.

``cost`` draws the cell's frames, warms up, then runs ``PAIRS`` pairs of
calls in one process, each pair one frame of the pool twice, with tracing
off and with ``MAGNIFY_TPU_TRACE=1`` (ABBA order), each call timed on the
host clock to its result; with ``--aa`` both calls of a pair run with
tracing off (the control). It then times one span with tracing off, on, under a running
``torch.profiler``, and one ``device=True`` span with tracing on, and
prints one JSON line.
"""

from __future__ import annotations

import collections
import importlib
import json
import os
import statistics
import sys
import time

DEVICE = "cuda"


def _checkout(root: str):
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    return importlib.import_module("bench_torch.run")


def spans(root, cell_name, seed, out_path) -> None:
    out_path = os.path.abspath(out_path)
    run = _checkout(root)
    trace = importlib.import_module("bench_torch.trace")
    kept = {}
    breakdown = trace.Trace.breakdown

    def keep(self, top=10):
        kept["full"] = breakdown(self, top=1000)
        kept["magnify_kernels"] = sum(n.startswith("magnify/")
                                      for n, _s, _e in self.kernels)
        kept["kernel_calls"] = dict(collections.Counter(
            n for n, _s, _e in self.kernels))
        return breakdown(self, top)

    trace.Trace.breakdown = keep
    bench, cell, cfg, traffic = run.load_cell(run.ROOT, cell_name)
    line = run.run_cell(bench, cell, cfg, traffic, seed, 30.0, True, DEVICE)
    gaps = kept["full"]["idle_gaps"]
    named = sum(v for n, v in gaps if n != "(shorter gaps)")
    unnamed = sum(v for n, v in gaps if n.endswith(" > -"))
    out = {"cell": cell_name, "seed": seed, "correct": line["correct"],
           "frames": line["attempted"],
           "metrics": {k: v["value"] for k, v in line["metrics"].items()},
           "device": line["device"], "idle_gaps": gaps,
           "device_ops": kept["full"]["device_ops"],
           "named_idle_s": named, "unnamed_idle_s": unnamed,
           "unnamed_share": unnamed / named if named else None,
           "magnify_kernels": kept["magnify_kernels"],
           "kernel_calls": kept["kernel_calls"]}
    diagnostics = importlib.import_module("magnify_tpu_torch.diagnostics")
    if hasattr(diagnostics, "span_report"):
        out["spans"] = diagnostics.span_report()
        out["counters"] = diagnostics.counter_report()
        out["dropped"] = diagnostics.dropped_spans()
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: out[k] for k in (
        "cell", "seed", "correct", "frames", "metrics", "named_idle_s",
        "unnamed_idle_s", "unnamed_share", "magnify_kernels")}))
    for name, e in sorted(out.get("spans", {}).items(),
                          key=lambda kv: -kv[1]["self_seconds"]):
        dev = e["device_seconds"]
        print(f"{name:28s} calls {e['calls']:5d}  self "
              f"{1e3 * e['self_seconds'] / out['frames']:9.3f} ms/frame"
              + (f"  device {1e3 * dev / out['frames']:9.3f}"
                 if dev is not None else ""))


def _per_span(diagnostics, n: int, device: bool = False) -> float:
    t0 = time.perf_counter_ns()
    for _ in range(n):
        with diagnostics.span("cost.probe", device=device):
            pass
    return (time.perf_counter_ns() - t0) / n / 1e3


def cost(root, cell_name, seed, pairs, aa) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    run = _checkout(root)
    diagnostics = importlib.import_module("magnify_tpu_torch.diagnostics")
    bench, cell, cfg, traffic = run.load_cell(run.ROOT, cell_name)
    kind = importlib.import_module(f"bench_torch.kinds.{cfg['kind']}")
    os.environ["MAGNIFY_TPU_DETECTOR"] = traffic["detector"]
    os.environ["MAGNIFY_TPU_SCORER"] = traffic.get("scorer", "auto")
    os.environ.pop("MAGNIFY_TPU_TRACE", None)
    frames = kind.make_frames(cfg, seed, traffic["pool"], DEVICE)
    call = kind.make_call(cfg, traffic, DEVICE)
    sync = torch.cuda.synchronize if DEVICE == "cuda" else (lambda: None)
    for frame in frames:
        call(frame)
    sync()
    diagnostics.reset_stages()
    times = {"off": [], "on": []}
    with open(os.devnull, "w") as devnull:
        for i in range(pairs):
            for mode in ("off", "on") if i % 2 == 0 else ("on", "off"):
                if mode == "on" and not aa:
                    os.environ["MAGNIFY_TPU_TRACE"] = "1"
                stdout, sys.stdout = sys.stdout, devnull  # the stage lines
                try:
                    t0 = time.perf_counter()
                    call(frames[i % len(frames)])
                    sync()
                    times[mode].append(time.perf_counter() - t0)
                finally:
                    sys.stdout = stdout
                    os.environ.pop("MAGNIFY_TPU_TRACE", None)
    diffs = [b - a for a, b in zip(times["off"], times["on"])]
    rec = {"cell": cell_name, "seed": seed, "pairs": pairs, "aa": aa,
           "off_median_s": statistics.median(times["off"]),
           "on_median_s": statistics.median(times["on"]),
           "paired_diff_median_s": statistics.median(diffs),
           "spans_per_frame": len(diagnostics.spans()) / pairs,
           "off_s": times["off"], "on_s": times["on"]}
    diagnostics.reset_stages()
    rec["span_us_off"] = _per_span(diagnostics, 20000)
    os.environ["MAGNIFY_TPU_TRACE"] = "1"
    rec["span_us_on"] = _per_span(diagnostics, 20000)
    rec["device_span_us_on"] = _per_span(diagnostics, 5000, device=True)
    os.environ.pop("MAGNIFY_TPU_TRACE", None)
    diagnostics.reset_stages()
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if DEVICE == "cuda" else [])
    with profile(activities=activities):
        rec["span_us_profiled"] = _per_span(diagnostics, 5000)
    diagnostics.reset_stages()
    print(json.dumps(rec))


def main(argv) -> int:
    if len(argv) >= 5 and argv[0] == "spans":
        spans(argv[1], argv[2], int(argv[3]), argv[4])
    elif len(argv) >= 5 and argv[0] == "cost":
        cost(argv[1], argv[2], int(argv[3]), int(argv[4]), "--aa" in argv)
    else:
        print(__doc__, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
