#!/usr/bin/env python3
"""The control of ``correct`` at a cell's own size: for each seed, the
configuration's frames are drawn as a run draws them (on the card), and
the plain reference's own answer at half resolution (every centre moved
to the even pixel below it, its masks and crops there) is held against
the reference's answer. Every compared number is printed with its limit;
a control that passes every limit would make the limits worthless, and
the script then exits 1.

    python3 bench_torch/control.py --config chip_pc --seeds 1 2 3
"""

from __future__ import annotations

import argparse
import importlib
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--pool", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from bench_torch.test_correct import control_answer

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = {c["name"]: c for c in bench["configs"]}[args.config]
    cfg = json.loads((ROOT / entry["file"]).read_text())
    kind = importlib.import_module(f"bench_torch.kinds.{cfg['kind']}")
    caught = True
    for seed in args.seeds:
        worst = {k: 0 for k in kind.LIMITS}
        for frame in kind.make_frames(cfg, seed, args.pool, args.device):
            nums = kind.compare(cfg, frame, kind.expected(cfg, frame),
                                control_answer(kind, cfg, frame))
            worst = {k: max(worst[k], v) for k, v in nums.items()}
        failed = [k for k, v in worst.items() if v > kind.LIMITS[k]]
        caught &= bool(failed)
        print(json.dumps({"config": args.config, "seed": seed,
                          "control": worst, "limits": kind.LIMITS,
                          "fails": failed}), flush=True)
    return 0 if caught else 1


if __name__ == "__main__":
    sys.exit(main())
