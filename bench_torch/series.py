#!/usr/bin/env python3
"""Run cells of the benchmark several times in one process tree and sum
up the spread: the tool for setting bounds and for a look at noise.

    python3 bench_torch/series.py --seconds 10 --trace 0 \
        --out .cache/series.jsonl chip_pc.dense:11,12,13 ...

Each ``cell:seed,seed,...`` is one set: ``bench_torch/run.py`` once per
seed, one after another; a cell named twice has two sets. Every result
line is appended to ``--out`` with the cell, seed, exit code and wall
seconds; a summary line per run goes to standard output, and at the end,
per cell and metric, each set's median and spread (the distance between
the first and third quartiles of ``statistics.quantiles(values, n=4)``,
as a share of the median), the spread of each set without its run
farthest from the median, their mean (what a bound has to stay above
twice), the spread of all runs (what it has to stay under eight times)
and the second set's median against the first's.
"""

from __future__ import annotations

import argparse
import collections
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent


def spread(values: list) -> float | None:
    if len(values) < 2:
        return None
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def trimmed(values: list) -> list:
    """``values`` without the one farthest from their median."""
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return values[:far] + values[far + 1:]


def summary(cell: str, metric: str, runs: list) -> str:
    """One line on the spread of ``runs`` [(set number, value)]."""
    sets = collections.defaultdict(list)
    for set_no, v in runs:
        sets[set_no].append(v)
    sets = [sets[i] for i in sorted(sets)]
    fmt = lambda x: "-" if x is None else f"{x:.4%}"  # noqa: E731
    parts = [f"set {i}: n {len(v)} median {statistics.median(v):.6g} "
             f"spread {fmt(spread(v))} trimmed "
             f"{fmt(spread(trimmed(v)) if len(v) > 2 else None)}"
             for i, v in enumerate(sets)]
    trims = [spread(trimmed(v)) for v in sets if len(v) > 2]
    every = [v for _s, v in runs]
    line = (f"SPREAD {cell} {metric}: " + "; ".join(parts)
            + f"; mean trimmed {fmt(statistics.mean(trims) if trims else None)}"
            f"; all runs {fmt(spread(every))}")
    if len(sets) >= 2:
        line += (f"; second median / first "
                 f"{statistics.median(sets[1]) / statistics.median(sets[0]):.4f}")
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", required=True)
    ap.add_argument("--timeout", type=float, default=1200)
    ap.add_argument("runs", nargs="+", help="cell:seed,seed,...")
    args = ap.parse_args(argv)
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    values = collections.defaultdict(list)
    for set_no, spec in enumerate(args.runs):
        cell, seeds = spec.split(":")
        for seed in seeds.split(","):
            cmd = [sys.executable, str(ROOT / "bench_torch" / "run.py"),
                   "--workload", cell, "--seed", seed, "--seconds",
                   str(args.seconds), "--trace", str(args.trace)]
            t0 = time.perf_counter()
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=args.timeout, cwd=ROOT)
                rc, stdout, stderr = proc.returncode, proc.stdout, proc.stderr
            except subprocess.TimeoutExpired as e:
                rc, stdout, stderr = 124, e.stdout or "", e.stderr or ""
                stdout = stdout if isinstance(stdout, str) else stdout.decode()
                stderr = stderr if isinstance(stderr, str) else stderr.decode()
            wall = time.perf_counter() - t0
            lines = stdout.strip().splitlines()
            try:
                line = json.loads(lines[-1]) if lines else None
            except json.JSONDecodeError:
                line = None
            rec = {"cell": cell, "seed": int(seed), "trace": args.trace,
                   "seconds": args.seconds, "rc": rc, "wall_s": wall,
                   "line": line}
            if line is None or rc != 0:
                rec["stderr_tail"] = stderr[-3000:]
            with out.open("a") as f:
                f.write(json.dumps(rec) + "\n")
            if line is None:
                print(f"{cell} seed {seed}: rc {rc}, no result; "
                      f"{stderr[-1500:]}", flush=True)
                continue
            ms = {k: round(v["value"], 4) for k, v in line["metrics"].items()}
            for k, v in line["metrics"].items():
                values[(cell, k)].append((set_no, v["value"]))
            bad = {k: c["value"] for k, c in line["checks"].items()
                   if c["value"]}
            print(f"{cell} seed {seed}: rc {rc} wall {wall:.1f}s correct "
                  f"{line['correct']} attempted {line['attempted']} failed "
                  f"{line['failed']} {ms} nonzero checks {bad} peak "
                  f"{line['device']['memory_peak_bytes']} "
                  f"{line['device'].get('power_limit')}", flush=True)
    for (cell, k), runs in values.items():
        print(summary(cell, k, runs), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
