#!/usr/bin/env python3
"""Time the RANSAC perimeter scorer under each of its launch plans, for
this checkout's kernel source and for variants of it.

    python3 scripts/perimeter_variants.py [NAME=SOURCE[@FLAG,FLAG...] ...]

With no argument, times this checkout's ``csrc/perimeter_score.cu``. Each
NAME=SOURCE builds the kernels of ``csrc/`` with SOURCE (a path, or ``.``
for this checkout's source) in place of ``perimeter_score.cu`` and the
given extra ``nvcc`` flags (for example ``lineinfo=.@-lineinfo``); a
SOURCE must export this checkout's C interface. All builds run at once.

Takes the scorer's inputs from one ``detector="ransac"`` run of ``beads``
on frame A and of ``microfluidic_chip`` on frames C8 and C (5,000,000
proposals each, as ``chip_smoke.py`` drives them) and, on every input, for
every build and every plan (one lane a circle, and the lanes
``ops.score.spread_lanes`` gives), checks the scores against the twin bit
for bit and takes the kernel's device time with ``torch.profiler`` (20
calls).
Prints the card's name and power limit, then one JSON line per input
with the plan ``ops.score.perimeter_plan`` picks and every time.
"""

from __future__ import annotations

import concurrent.futures as cf
import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
OUT = ROOT / ".cache" / "perimeter_variants"


def _build_variant(name: str, spec: str):
    from magnify_tpu_torch import _build

    source, _, flags = spec.partition("@")
    source = _build.CSRC / "perimeter_score.cu" if source == "." else \
        pathlib.Path(source).resolve()
    out = OUT / name
    out.mkdir(parents=True, exist_ok=True)
    sources = [s for s in sorted(_build.CSRC.glob("*.cu"))
               if s.name != "perimeter_score.cu"] + [source]
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS[:-2],
           *[f for f in flags.split(",") if f], "-shared", "-o",
           str(out / "lib.so"), *map(str, sources)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{res.stderr[-4000:]}")
    return name, out / "lib.so"


def _load(path):
    from magnify_tpu_torch import _build

    lib = ctypes.CDLL(str(path))
    for fn, (argtypes, restype) in _build._SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def main(argv) -> int:
    import torch

    import chip_smoke as cs
    import magnify_tpu_torch as mt
    from magnify_tpu_torch import _build
    from magnify_tpu_torch.ops import score

    if not torch.cuda.is_available():
        print("perimeter_variants: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    specs = dict(a.split("=", 1) for a in argv) or {"tree": "."}
    with cf.ThreadPoolExecutor(len(specs)) as ex:
        libs = {name: _load(path) for name, path in
                ex.map(lambda kv: _build_variant(*kv), specs.items())}
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
    tree_load = _build.load
    ok = True
    for frame, run in runs.items():
        for (tag, name), args in zip(cs.SCORER_CALLS[frame],
                                     cs._scorer_calls(run)):
            circles = args["circles"]
            max_r = args["max_radius"]
            n_pos = score._perimeter_tensors(max_r, "cpu")[0].shape[1]
            want = score.score_circles_plain(**args).view(torch.int32)
            plans = sorted({1, score.spread_lanes(n_pos)})
            times = {}
            for vname, lib in libs.items():
                _build.load = lambda lib=lib: lib
                for plan in plans:
                    def call(plan=plan):
                        return score.perimeter_score(**args, plan=plan)
                    key = f"{vname}:{plan}"
                    if not torch.equal(call().view(torch.int32), want):
                        print(f"{name}: {key} differs from the twin",
                              file=sys.stderr)
                        ok = False
                    times[key] = cs._profiled_kernel_ms(call, 20)[0]
            _build.load = tree_load
            print(json.dumps({
                "input": tag or "_frame_a", "name": name,
                "circles": int(circles[..., 0].numel()), "L": n_pos,
                "plan": score.perimeter_plan(circles, max_radius=max_r),
                "profiler_ms": times}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
