#!/usr/bin/env python3
"""Checks of the benchmark's own arithmetic and files, on the CPU.

    python3 bench_torch/selftest.py     (or python3 -m pytest on it)

It checks the interval union and the idle gaps of a trace, the
nearest-rank 95th percentile over all frames, the byte and operation
counts and the roofline bound of each kernel on hand-made inputs, the
Bresenham disks against their closed form, the seeding of frames, and
that every configuration, traffic mix and metric that ``BENCHMARK.json``
names loads and has what the harness reads from it. Run it before a chip
call that follows a change here.
"""

from __future__ import annotations

import importlib
import json
import math
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_torch import geometry, roofline, seeding, trace  # noqa: E402


def test_interval_union_and_gaps():
    spans = [(0, 10), (5, 12), (20, 25), (21, 22), (30, 30)]
    assert trace.busy_us(spans) == 17
    assert trace.busy_us([]) == 0
    assert trace.idle_gaps(spans, 0, 40) == [(12, 20), (25, 30), (30, 40)]
    assert trace.idle_gaps([(5, 50)], 0, 40) == [(0, 5)]


def test_kernel_work_counts():
    assert roofline.hysteresis_work(1024 * 1024) == (
        3 * 1024 * 1024, 0, roofline.INT8_OPS_PER_S)
    b, ops, peak = roofline.ring_corr_work(1000, 5, 700)
    assert (b, ops, peak) == ((8 + 20) * 1000, 2 * 700 * 1000,
                              roofline.INT8_OPS_PER_S)
    b, ops, peak = roofline.perimeter_work(10, True, 7, True, 50, 100, 30)
    assert b == 10 * 5 + 7 * 16 + 100 + 4 * 30
    assert ops == 6 * 50 + 7 and peak == roofline.F32_OPS_PER_S
    b, _ops, _p = roofline.perimeter_work(10, False, 10, False, 0, 0, 0)
    assert b == 10 * 4 + 10 * 12


def test_roofline_bound():
    # 3.35 GB at 3.35 TB/s is 1 ms; 1.979e12 int8 ops at 1,979 TOP/s 1 ms.
    assert math.isclose(roofline.bound_s(3.35e9, 0, 1.979e15), 1e-3)
    assert math.isclose(roofline.bound_s(0, 1.979e12, 1.979e15), 1e-3)
    assert math.isclose(roofline.bound_s(3.35e9, 3.958e12, 1.979e15), 2e-3)

    tr = trace.Trace()
    tr.kernels = [("hyst_local", 0.0, 100.0),
                  ("void (anonymous namespace)::hyst_mark(int)", 100, 150),
                  ("void (anonymous namespace)::ring_corr_kernel<16>(int)",
                   150, 400), ("void at::native::vectorized_elementwise_"
                               "kernel<2, hyst_local>(int)", 400, 900)]
    assert math.isclose(roofline.share_pct(tr, 75e-6, "hyst_"), 50.0)
    assert math.isclose(roofline.share_pct(tr, 25e-6, "ring_corr_kernel"),
                        10.0)
    assert roofline.share_pct(tr, 1e-6, "perimeter_score") is None


def test_perimeter_counts_by_hand():
    import torch

    edges = torch.zeros((9, 9), dtype=torch.bool)
    edges[4, 6] = edges[2, 4] = True  # two pixels of the radius-2 circle
    circles = torch.tensor([[4 + 2, 4 + 2, 2], [0, 0, 0]], dtype=torch.int32)
    valid = torch.tensor([True, False])
    n_valid, hits, touched, touched_edges = roofline.perimeter_counts(
        edges, circles, valid, max_radius=2, pad=2)
    assert n_valid == 1
    assert touched == len(geometry.perimeter(2)) == 12
    assert hits == touched_edges == 2


def test_disks():
    for r in range(0, 30):
        d = geometry.disk(r)
        assert len({tuple(p) for p in d.tolist()}) == len(d)
        assert (np.abs(d) <= r).all()
        # The scanline fill holds every pixel within r - 0.5 of the centre
        # and none beyond r + 0.5 along the axes.
        inside = {tuple(p) for p in d.tolist()}
        for dy in range(-r, r + 1):
            for dx in range(-r, r + 1):
                if dy * dy + dx * dx <= (r - 0.5) ** 2:
                    assert (dy, dx) in inside, (r, dy, dx)
        assert (0, r) in inside and (0, r + 1) not in inside
    m = geometry.disk_mask(9, np.array([4]), np.array([4]), np.array([2]))
    assert m[0].sum() == len(geometry.disk(2))
    img = np.zeros((5, 5), np.uint16)
    geometry.paint(img, [0], [0], [1], 7)  # clipped at the corner
    assert img.sum() == 7 * 4  # the radius-1 disk is a 3 x 3 square


def test_seeds():
    assert seeding.frame_seed(1, 0) != seeding.frame_seed(1, 1)
    assert seeding.frame_seed(2**31 + 5, 3) == seeding.frame_seed(
        2**31 + 5, 3)
    assert 0 <= seeding.frame_seed(-7, 0) < 2**63


def test_benchmark_files_load():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    configs = {c["name"]: c for c in bench["configs"]}
    for cell in cells.values():
        cfg = json.loads((ROOT / configs[cell["config"]]["file"]).read_text())
        kind = importlib.import_module(f"bench_torch.kinds.{cfg['kind']}")
        for fn in ("make_frames", "make_call", "extract", "expected",
                   "compare", "to_input"):
            assert callable(getattr(kind, fn)), (cfg["kind"], fn)
        assert kind.LIMITS
        for key in configs[cell["config"]]["reduced"]:
            assert key in cfg, key
        traffic = json.loads((ROOT / "bench_torch" / "traffic"
                              / f"{cell['traffic']}.json").read_text())
        assert traffic["mode"] == "serial"
        assert traffic["pool"] >= 1 and cfg["warm_frames"] >= 1
    for m in bench["end_to_end"]:
        mod = importlib.import_module(f"bench_torch.end_to_end.{m['name']}")
        assert callable(mod.read)
    for m in bench["per_layer"]:
        mod = importlib.import_module(f"bench_torch.metrics.{m['name']}")
        assert callable(mod.read)
        for module, attr, record in getattr(mod, "SPIES", ()):
            assert hasattr(importlib.import_module(module), attr)
            assert callable(record)
        for w in m.get("workloads", []):
            assert w in cells, w


def test_profiler_reading_and_breakdown():
    import types

    import torch

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(name, s, e, dev, annotation=False):
        return types.SimpleNamespace(
            name=name, device_type=dev, is_user_annotation=annotation,
            time_range=types.SimpleNamespace(start=s, end=e))

    events = [ev("frame", 0, 100, cpu), ev("stage/find_beads", 10, 90, cpu),
              ev("span/_assemble", 60, 90, cpu), ev("aten::copy_", 75, 85, cpu),
              ev("frame", 0, 100, cuda, True),
              ev("stage/find_beads", 10, 90, cuda),
              ev("k1", 20, 50, cuda), ev("Memcpy HtoD", 45, 60, cuda)]
    tr = trace.Trace()
    tr.read_profiler(types.SimpleNamespace(events=lambda: events))
    assert [n for n, _s, _e in tr.kernels] == ["k1", "Memcpy HtoD"]
    assert math.isclose(tr.busy_s, 40e-6)
    assert (tr.lo_us, tr.hi_us) == (0, 100)
    gaps = dict(tr.breakdown()["idle_gaps"])
    assert math.isclose(gaps["span/_assemble > aten::copy_"], 40e-6)
    assert math.isclose(gaps["stage/find_beads > -"], 20e-6)
    assert len(gaps) == 2


if __name__ == "__main__":
    failed = 0
    for name, fn in sorted(globals().items()):
        if name.startswith("test_") and callable(fn):
            try:
                fn()
                print(f"ok   {name}")
            except Exception as e:  # report every check, then fail
                failed += 1
                print(f"FAIL {name}: {type(e).__name__}: {e}")
    sys.exit(1 if failed else 0)
