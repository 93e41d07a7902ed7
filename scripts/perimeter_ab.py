#!/usr/bin/env python3
"""Time the RANSAC perimeter scorer of several checkouts on one card.

    python3 scripts/perimeter_ab.py ROOT [ROOT ...]

For each ROOT, in the order given (give a parent and a change as ``parent
change change parent`` to see the spread), one subprocess imports that
checkout's ``magnify_tpu_torch`` and ``chip_smoke.py``, builds its kernels,
takes the scorer's inputs from one ``detector="ransac"`` run of ``beads``
on frame A and of ``microfluidic_chip`` on frames C8 and C (5,000,000
proposals each; each checkout's own calls, so each in its own interface),
and times every input with CUDA events (50 back-to-back calls) and with
``torch.profiler`` (20 calls, the scorer's kernels alone: device time and
launches per call). Prints the card's name and power limit, then one JSON
line per ROOT.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent.parent


def _this_smoke():
    """This checkout's chip_smoke.py (its timing helpers), under another
    module name so that ROOT's own ``chip_smoke`` stays importable."""
    spec = importlib.util.spec_from_file_location("ab_chip_smoke",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def one(root: str) -> dict:
    sys.path.insert(0, str(pathlib.Path(root).resolve()))
    import chip_smoke as cs  # ROOT's
    import torch

    import magnify_tpu_torch as mt
    from magnify_tpu_torch.ops import score

    timing = _this_smoke()
    dev = torch.device("cuda")
    kw = dict(detector="ransac", device=dev)
    runs = {
        "A": lambda: mt.beads(cs.as_dataarray(mt, "A"), **kw,
                              **cs.FRAME_A_KW),
        "C8": lambda: mt.microfluidic_chip(cs.as_dataarray(mt, "C8"), **kw,
                                           **cs.FRAME_C8_KW),
        "C": lambda: mt.microfluidic_chip(cs.as_dataarray(mt, "C"),
                                          pinlist=cs.frame_c_pinlist(), **kw,
                                          **cs.FRAME_C_KW),
    }
    out = {"root": root, "inputs": {}}
    for frame, run in runs.items():
        for (tag, _name), args in zip(cs.SCORER_CALLS[frame],
                                      cs._scorer_calls(run)):
            def call():
                return score.score_circles(**args)
            ev = timing._event_ms(call, 50)
            prof, recorded = timing._profiled_kernel_ms(call, 20)
            out["inputs"][tag or "_frame_a"] = {
                "event_ms": ev, "profiler_ms": prof,
                "profiler_launches_recorded": recorded}
    return out


def main(argv) -> int:
    if argv[:1] == ["--one"]:
        print(json.dumps(one(argv[1])), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    for root in argv:
        res = subprocess.run([sys.executable, __file__, "--one", root],
                             capture_output=True, text=True)
        lines = res.stdout.strip().splitlines()
        if res.returncode != 0 or not lines:
            print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
            return 1
        print(lines[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
