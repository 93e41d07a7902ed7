"""Observability: spans, counters, stage timers, the package's logger and a
device profiler.

The port's own copy of ``magnify_tpu.diagnostics``, grown into one tracing
system:

* :class:`span` times a named block of work on the host clock
  (``time.perf_counter_ns``, read once at entry and once at exit; the
  yielded handle's ``seconds``). While tracing is on, each span also
  appends one record to a bounded in-memory store (:func:`spans`,
  :func:`span_report`): its name, start and end, the span it opened in,
  its thread and the :func:`pipeline_call` it belongs to. While a
  ``torch.profiler`` records, a span on the main thread also opens
  ``record_function("magnify/<name>")``, so it lies on the profiler's clock
  beside the kernels. ``span(name, device=True)`` records two CUDA timing
  events on the current stream besides (``device=<a torch.device>``: on
  that card's current stream), so the device interval of the work
  launched inside it is known once the caller has waited for it. A span
  also decorates a function: each call runs in a fresh span of that name,
  and ``device=True`` then means the card of the first tensor argument.
* :func:`count` adds to a named counter (:func:`counter_report`).
* Tracing is on while a ``torch.profiler`` records or while
  ``MAGNIFY_TPU_TRACE`` is set. Off, a span or a counter costs one check of
  those two switches: nothing is stored, no ``record_function`` is opened
  and no CUDA call is made. No span synchronizes a card.
* :func:`stage_timer` is a span (``stage.<name>`` in the store; kept out of
  the profiler, where the pipeline's caller marks stages itself) that
  accumulates host wall time and a call count per named stage;
  :class:`~magnify_tpu_torch.core.pipeline.Pipeline` times its reader
  (``"read"``) and every component by name through it, and
  :func:`stage_report` returns the totals. With ``MAGNIFY_TPU_TRACE`` set
  each stage also logs and prints ``[magnify_tpu_torch] <stage>: <ms> ms``.
  Device work still in flight when a stage ends is counted in the stage
  that waits for it (the detector's components wait for their marks, so a
  component's time includes its own device work).
* :func:`profile` records ``torch.profiler`` activity (the CPU, and CUDA
  when a card is present) around a block and writes a Chrome trace.
* ``log``: one stdlib logger, ``magnify_tpu_torch``, so a host program can
  route the package's messages (the chip grid's sparse-edge warnings, for
  one).

The finders' spans (README lists them): ``chip.alloc``,
``chip.load_timestep``, ``chip.load_wait``, ``chip.copy_crop``,
``chip.copy_timesteps``, ``chip.assemble``, ``chip.normalize_upload``,
``chip.dispatch``, ``chip.crops_masks``, ``chip.upload``,
``chip.find_centers``, ``chip.find_rois``, ``detect.normalize_u8``,
``ransac.sampler``, ``beads.upload``, ``beads.detect``,
``beads.finalize_host``, ``beads.ownership``, ``beads.assemble`` and the
decode's ``identify.<stage>``. The counter ``upload_bytes`` sums the bytes
of the host arrays a finder copies to a card: its search planes (once,
where a mesh then cuts them into bands) and the tables it hands to the
card (the grid fit's points per row and column, the chambers' centres or
ROI corners, the beads' marks and ROI corners); the 0-d scalars and PRNG
keys the kernels take are not counted. ``ownership_device_windows`` and
``ownership_host_windows`` count the bead windows whose ownership masks
were made on a card and on the host.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import functools
import itertools
import logging
import os
import pathlib
import threading
import time
from collections import defaultdict

import torch
import torch.autograd.profiler as _profiler

__all__ = ["MAX_SPANS", "SpanRecord", "count", "counter_report",
           "dropped_spans", "log", "pipeline_call", "profile",
           "reset_stages", "span", "span_report", "spans", "stage_report",
           "stage_timer"]

log = logging.getLogger("magnify_tpu_torch")

#: Most span records the store holds; the spans past it are counted by
#: :func:`dropped_spans` instead.
MAX_SPANS = 1 << 16

_stage_totals: dict[str, float] = defaultdict(float)
_stage_counts: dict[str, int] = defaultdict(int)

#: One span of the store. ``parent``: the id of the span open where this
#: one started (on its thread, or on the thread that handed it the work);
#: ``call``: the id of its :func:`pipeline_call`, None outside one;
#: ``events``: the (start, end) CUDA events of a device span, else None.
SpanRecord = collections.namedtuple(
    "SpanRecord", "name start_ns end_ns id parent thread call events")

_records: list[SpanRecord] = []
_counters: dict[str, int] = defaultdict(int)
_dropped = 0
_lock = threading.Lock()
_ids = itertools.count(1)
_calls = itertools.count(1)
_open_span: contextvars.ContextVar = contextvars.ContextVar(
    "magnify_tpu_torch_span", default=None)
_call_id: contextvars.ContextVar = contextvars.ContextVar(
    "magnify_tpu_torch_call", default=None)


def _tracing() -> bool:
    return bool(os.environ.get("MAGNIFY_TPU_TRACE"))


def _recording() -> bool:
    return _profiler._is_profiler_enabled or _tracing()


class span:
    """``with span(name[, device=True]) as s:`` times the block; ``s.seconds``
    is its host wall time once the block has ended. ``@span(name, ...)``
    times each call of a function. See the module's docstring for what is
    recorded while tracing is on."""

    __slots__ = ("name", "device", "start_ns", "end_ns", "_annotate", "_id",
                 "_token", "_function", "_events", "_stream")

    def __init__(self, name: str, device=False, *, _annotate: bool = True):
        self.name = name
        self.device = device
        self._annotate = _annotate
        self._id = None
        self.start_ns = self.end_ns = 0

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def __call__(self, fn):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            if not _recording():
                return fn(*args, **kwargs)
            device = self.device
            if device is True:
                device = next((a.device for a in args
                               if isinstance(a, torch.Tensor)), True)
            with span(self.name, device, _annotate=self._annotate):
                return fn(*args, **kwargs)

        return spanned

    def __enter__(self) -> span:
        if _recording():
            self._open()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.perf_counter_ns()
        if self._id is not None:
            self._close()
        return False

    def _open(self) -> None:
        self._id = next(_ids)
        self._token = _open_span.set(self._id)
        self._function = self._events = None
        if (self._annotate and _profiler._is_profiler_enabled
                and threading.current_thread() is threading.main_thread()):
            self._function = torch.profiler.record_function(
                "magnify/" + self.name)
            self._function.__enter__()
        if self.device is not False and torch.cuda.is_initialized():
            device = None if self.device is True else torch.device(
                self.device)
            if device is None or device.type == "cuda":
                self._stream = torch.cuda.current_stream(device)
                self._events = (torch.cuda.Event(enable_timing=True),
                                torch.cuda.Event(enable_timing=True))
                self._events[0].record(self._stream)

    def _close(self) -> None:
        global _dropped
        if self._events is not None:
            self._events[1].record(self._stream)
        if self._function is not None:
            self._function.__exit__(None, None, None)
        _open_span.reset(self._token)
        record = SpanRecord(self.name, self.start_ns, self.end_ns, self._id,
                            _open_span.get(), threading.current_thread().name,
                            _call_id.get(), self._events)
        self._id = None
        with _lock:
            if len(_records) < MAX_SPANS:
                _records.append(record)
            else:
                _dropped += 1


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while tracing is on."""
    if _recording():
        with _lock:
            _counters[name] += int(n)


@contextlib.contextmanager
def pipeline_call():
    """Give the spans of the block (and of the work it hands to threads
    through ``contextvars.copy_context()``) a fresh pipeline-call id."""
    token = _call_id.set(next(_calls))
    try:
        yield
    finally:
        _call_id.reset(token)


def spans() -> list[SpanRecord]:
    """The store's span records, in the order they ended."""
    with _lock:
        return list(_records)


def dropped_spans() -> int:
    """Spans the store had no room for since the last :func:`reset_stages`."""
    return _dropped


def span_report() -> dict:
    """Totals by span name: {name: {"seconds", "calls", "self_seconds",
    "device_seconds"}}. ``self_seconds`` leaves out the spans opened inside
    it on its own thread; ``device_seconds`` sums the device intervals of
    its ``device=True`` spans once the caller has waited for their work
    (``torch.cuda.synchronize()``), and is None for host spans and while
    any of that name's device work is still running."""
    records = spans()
    child = defaultdict(int)
    thread = {r.id: r.thread for r in records}
    for r in records:
        if r.parent is not None and thread.get(r.parent) == r.thread:
            child[r.parent] += r.end_ns - r.start_ns
    out: dict = {}
    running = set()
    for r in records:
        e = out.setdefault(r.name, {"seconds": 0.0, "calls": 0,
                                    "self_seconds": 0.0,
                                    "device_seconds": None})
        ns = r.end_ns - r.start_ns
        e["seconds"] += ns / 1e9
        e["calls"] += 1
        e["self_seconds"] += (ns - child[r.id]) / 1e9
        if r.events is None:
            continue
        if not r.events[1].query():
            running.add(r.name)
            continue
        e["device_seconds"] = ((e["device_seconds"] or 0.0)
                               + r.events[0].elapsed_time(r.events[1]) / 1e3)
    for name in running:
        out[name]["device_seconds"] = None
    return out


def counter_report() -> dict:
    """The counters: {name: total}."""
    with _lock:
        return dict(_counters)


@contextlib.contextmanager
def stage_timer(name: str):
    """Accumulate the host wall time of a named stage (a span
    ``stage.<name>``); logs and prints it when ``MAGNIFY_TPU_TRACE`` is
    set."""
    timed = span("stage." + name, _annotate=False)
    try:
        with timed:
            yield
    finally:
        dt = timed.seconds
        _stage_totals[name] += dt
        _stage_counts[name] += 1
        if _tracing():
            log.info("stage %s: %.1f ms", name, dt * 1000)
            print(f"[magnify_tpu_torch] {name}: {dt * 1000:.1f} ms",
                  flush=True)


def stage_report() -> dict:
    """Accumulated per-stage totals: {name: {"seconds", "calls"}}."""
    return {
        name: {"seconds": round(_stage_totals[name], 4),
               "calls": _stage_counts[name]}
        for name in _stage_totals
    }


def reset_stages() -> None:
    """Clear the stage totals, the span store and the counters."""
    global _dropped
    _stage_totals.clear()
    _stage_counts.clear()
    with _lock:
        _records.clear()
        _counters.clear()
        _dropped = 0


@contextlib.contextmanager
def profile(log_dir: str = "magnify_tpu_torch_profile"):
    """Record a ``torch.profiler`` trace of the CPU and, when a card is
    present, of CUDA around a block of work; the Chrome trace is written
    to ``log_dir/trace.json`` when the block ends. Yields the profiler
    (``key_averages()`` gives the per-operator totals)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = pathlib.Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with torch_profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))
    log.info("profiler trace written to %s", out / "trace.json")
