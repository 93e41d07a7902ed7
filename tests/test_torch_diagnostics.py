"""The port's tracing system (``magnify_tpu_torch.diagnostics``): spans,
counters and the stage timers in one store, on the CPU.

Tracing off, a span records nothing and opens no profiler range; with
``MAGNIFY_TPU_TRACE`` set, spans carry their parent, thread and pipeline
call, also on the chip finder's prefetch thread; under ``torch.profiler``
the main thread's spans are ``magnify/<name>`` host events. A small chip
and a small bead field show the finders' spans and the ``upload_bytes``
counter, and the benchmark's metrics of spans read the store.
"""

import importlib
import os
import sys
import threading

import numpy as np
import pytest
import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from magnify_tpu_torch import diagnostics  # noqa: E402

torch.set_num_threads(1)

#: The chip: 2 x 2 buttons on 240^2, 3 timesteps (t=0 searched).
CHIP_T = 3


def _draw(img, centers, radius, value):
    from magnify_tpu_torch.utils import filled_circle_points

    pts = filled_circle_points(radius)
    for y, x in centers:
        img[..., pts[:, 0] + y, pts[:, 1] + x] = value


@pytest.fixture
def traced(monkeypatch):
    monkeypatch.setenv("MAGNIFY_TPU_TRACE", "1")
    diagnostics.reset_stages()
    yield
    diagnostics.reset_stages()


@pytest.fixture(scope="module")
def chip_spans():
    """The span records and counters of one traced chip call."""
    import magnify_tpu_torch as mt

    rng = np.random.default_rng(3)
    img = rng.normal(100, 4, (CHIP_T, 240, 240)).astype(np.uint16)
    _draw(img, [(80, 80), (80, 160), (160, 80), (160, 160)], 7, 1000)
    os.environ["MAGNIFY_TPU_TRACE"] = "1"
    try:
        diagnostics.reset_stages()
        mt.microfluidic_chip(
            mt.DataArray(img, dims=("time", "y", "x")), shape=(2, 2),
            row_dist=80, col_dist=80, min_button_diameter=10,
            max_button_diameter=18, chamber_diameter=40, overlap=0,
            device="cpu")
        out = diagnostics.spans(), diagnostics.counter_report()
    finally:
        del os.environ["MAGNIFY_TPU_TRACE"]
        diagnostics.reset_stages()
    return out


def test_tracing_off_records_nothing(monkeypatch):
    monkeypatch.delenv("MAGNIFY_TPU_TRACE", raising=False)

    def forbidden(*args, **kwargs):
        raise AssertionError("record_function with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", forbidden)
    diagnostics.reset_stages()
    with diagnostics.span("demo.outer") as outer:
        with diagnostics.span("demo.inner", device=True):
            diagnostics.count("upload_bytes", 5)
    with diagnostics.stage_timer("demo"):
        pass
    assert outer.seconds > 0
    assert diagnostics.spans() == []
    assert diagnostics.counter_report() == {}
    assert diagnostics.span_report() == {}
    assert diagnostics.stage_report()["demo"]["calls"] == 1
    diagnostics.reset_stages()


def test_nested_spans_carry_parent_thread_and_call(traced):
    with diagnostics.pipeline_call():
        with diagnostics.span("demo.outer") as outer:
            with diagnostics.span("demo.inner") as inner:
                pass
    with diagnostics.span("demo.alone"):
        pass
    recs = {r.name: r for r in diagnostics.spans()}
    assert recs["demo.inner"].parent == recs["demo.outer"].id
    assert recs["demo.outer"].parent is None
    assert recs["demo.inner"].call == recs["demo.outer"].call is not None
    assert recs["demo.alone"].call is None
    assert recs["demo.inner"].thread == threading.current_thread().name
    assert (recs["demo.outer"].end_ns - recs["demo.outer"].start_ns
            == outer.end_ns - outer.start_ns)
    report = diagnostics.span_report()
    assert report["demo.outer"]["calls"] == 1
    assert report["demo.outer"]["self_seconds"] == pytest.approx(
        outer.seconds - inner.seconds)
    assert report["demo.inner"]["device_seconds"] is None


def test_span_decorates_a_function(traced):
    @diagnostics.span("demo.decorated", device=True)
    def twice(x, k=2):
        """Doubles."""
        with diagnostics.span("demo.inside"):
            return x * k

    assert twice(torch.ones(3)).tolist() == [2.0, 2.0, 2.0]
    assert twice(3, k=3) == 9
    assert twice.__name__ == "twice" and twice.__doc__ == "Doubles."
    recs = diagnostics.spans()
    assert [r.name for r in recs] == ["demo.inside", "demo.decorated"] * 2
    assert recs[0].parent == recs[1].id and recs[1].events is None
    report = diagnostics.span_report()
    assert report["demo.decorated"]["calls"] == 2


class _Event:
    def __init__(self, done, ms=0.0):
        self.done, self.ms = done, ms

    def query(self):
        return self.done

    def elapsed_time(self, end):
        return end.ms - self.ms


@pytest.mark.parametrize("done", [(True, True), (True, False)])
def test_span_report_keeps_host_totals_while_device_work_runs(traced, done):
    """A device span whose work has not finished leaves its name's device
    seconds None (a partial sum would read as the total) and every host
    total as it is."""
    for i, end_done in enumerate(done):
        diagnostics._records.append(diagnostics.SpanRecord(
            "demo.device", 0, 2_000_000, 100 + i, None, "main", None,
            (_Event(True, 1.0), _Event(end_done, 4.0))))
    entry = diagnostics.span_report()["demo.device"]
    assert entry["calls"] == 2 and entry["seconds"] == pytest.approx(0.004)
    assert entry["device_seconds"] == (pytest.approx(0.006) if all(done)
                                       else None)


def test_store_counts_what_it_drops(traced, monkeypatch):
    monkeypatch.setattr(diagnostics, "MAX_SPANS", 2)
    for _ in range(5):
        with diagnostics.span("demo.many"):
            pass
    assert len(diagnostics.spans()) == 2
    assert diagnostics.dropped_spans() == 3
    diagnostics.reset_stages()
    assert diagnostics.dropped_spans() == 0


def test_threads_lose_no_span_or_count(traced):
    """More threads than cores, a short switch interval: every span and
    every count of every thread lands in the store."""
    n_threads, n_each = 2 * (os.cpu_count() or 1) + 2, 200
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n_each):
                with diagnostics.span("demo.thread"):
                    diagnostics.count("demo", 1)

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    assert len(diagnostics.spans()) == n_threads * n_each
    assert diagnostics.counter_report() == {"demo": n_threads * n_each}


def test_profiler_sees_main_thread_spans(monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    monkeypatch.delenv("MAGNIFY_TPU_TRACE", raising=False)
    diagnostics.reset_stages()

    def worker():
        with diagnostics.span("demo.worker"):
            pass

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with diagnostics.span("demo.main"):
            torch.ones(8) + 1
        thread = threading.Thread(target=worker)
        thread.start()
        thread.join()
    names = {e.name for e in prof.events()}
    assert "magnify/demo.main" in names
    assert {r.name for r in diagnostics.spans()} == {"demo.main",
                                                    "demo.worker"}
    diagnostics.reset_stages()


def test_reset_clears_and_stage_report_keeps_its_form(traced):
    with diagnostics.stage_timer("read"):
        pass
    with diagnostics.stage_timer("find_beads"):
        diagnostics.count("upload_bytes", 7)
    with diagnostics.stage_timer("read"):
        pass
    report = diagnostics.stage_report()
    assert list(report) == ["read", "find_beads"]
    assert report["read"]["calls"] == 2
    assert set(report["read"]) == {"seconds", "calls"}
    assert report["read"]["seconds"] == round(report["read"]["seconds"], 4)
    assert [r.name for r in diagnostics.spans()] == [
        "stage.read", "stage.find_beads", "stage.read"]
    assert diagnostics.counter_report() == {"upload_bytes": 7}
    diagnostics.reset_stages()
    assert diagnostics.stage_report() == {}
    assert diagnostics.spans() == [] and diagnostics.counter_report() == {}


def test_chip_records_one_copy_crop_per_copied_timestep(chip_spans):
    records, counters = chip_spans
    by_name = {}
    for r in records:
        by_name.setdefault(r.name, []).append(r)
    assert len(by_name["chip.copy_crop"]) == CHIP_T - 1
    assert len(by_name["chip.load_wait"]) == CHIP_T - 1
    assert len(by_name["chip.load_timestep"]) == CHIP_T
    for name in ("chip.alloc", "chip.copy_timesteps", "chip.assemble",
                 "chip.normalize_upload", "chip.dispatch",
                 "chip.crops_masks", "detect.normalize_u8"):
        assert len(by_name[name]) == 1, name
    ids = {r.id: r for r in records}
    copies = by_name["chip.copy_timesteps"][0]
    stage = ids[copies.parent]
    assert stage.name == "stage.find_buttons"
    assert all(ids[r.parent].name == "chip.copy_timesteps"
               for r in by_name["chip.copy_crop"])
    # The prefetch thread's reads belong to the main thread's call.
    main = threading.main_thread().name
    loads = [r for r in by_name["chip.load_timestep"] if r.thread != main]
    assert len(loads) == CHIP_T - 1
    assert all(r.call == stage.call is not None for r in loads)


def test_upload_bytes_counts_the_uploaded_planes(chip_spans, traced):
    import magnify_tpu_torch as mt

    _records, counters = chip_spans
    # One raw uint16 search plane (normalized on the device) and the grid
    # fit's f32 points per row and column (2 + 2).
    assert counters["upload_bytes"] == 2 * 240 * 240 + 4 * 4
    assert counters["normalize_u8_device_planes"] == 1

    rng = np.random.default_rng(5)
    img = rng.normal(100, 4, (2, 96, 96)).astype(np.uint16)
    _draw(img[0], [(30, 30), (60, 64)], 6, 2000)
    _draw(img[1], [(30, 62)], 6, 2000)
    mt.beads(mt.DataArray(img, dims=("channel", "y", "x"),
                          coords={"channel": ["a", "b"]}),
             min_bead_diameter=10, max_bead_diameter=14, overlap=0,
             device="cpu")
    # A CPU finder makes its 3 marks' ownership masks on the host, and the
    # int8 features of its two search planes, padded by 2 * max_radius
    # (7), with the torch chain.
    assert diagnostics.counter_report() == {
        "upload_bytes": 2 * 2 * 96 * 96, "normalize_u8_device_planes": 2,
        "ownership_host_windows": 3,
        "features_q8_host_px": 2 * (96 + 4 * 7) ** 2}
    names = {r.name for r in diagnostics.spans()}
    assert {"beads.upload", "beads.detect", "beads.finalize_host",
            "beads.ownership", "beads.assemble", "detect.normalize_u8",
            "score.features_q8"} <= names


METRICS = {
    "copy_timesteps_ms": ("chip.copy_timesteps", "seconds", 0.6, 150.0),
    "load_wait_ms": ("chip.load_wait", "seconds", 0.2, 50.0),
    "normalize_u8_ms": ("detect.normalize_u8", "seconds", 1.0, 250.0),
    "ownership_ms": ("beads.ownership", "seconds", 0.02, 5.0),
    "features_q8_ms": ("score.features_q8", "device_seconds", 0.004, 1.0),
    "sampler_device_ms": ("ransac.sampler", "device_seconds", 0.08, 20.0),
}


@pytest.mark.parametrize("name", sorted(METRICS) + ["upload_mb"])
def test_span_metrics_read_a_hand_made_trace(name, monkeypatch):
    from bench_torch import trace as tracing

    metric = importlib.import_module(f"bench_torch.metrics.{name}")
    tr = tracing.Trace()
    tr.frames = 4
    report = {}
    if name in METRICS:
        span_name, key, total, want = METRICS[name]
        report[span_name] = {"seconds": 1.0, "calls": 4, "self_seconds": 1.0,
                             "device_seconds": None}
        report[span_name][key] = total
    else:
        want = 48.548185
    monkeypatch.setattr(diagnostics, "span_report", lambda: report)
    monkeypatch.setattr(diagnostics, "counter_report",
                        lambda: {"upload_bytes": 4 * 48_548_185})
    assert metric.read(tr, {}) == pytest.approx(want)
    monkeypatch.setattr(diagnostics, "dropped_spans", lambda: 1)
    assert metric.read(tr, {}) is None
