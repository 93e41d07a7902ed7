"""What a traced window leaves for the per-layer metrics.

The window runs under ``torch.profiler`` (CPU and CUDA activity). From
its events this module keeps the device's kernel intervals (busy time is
their union, whatever thread or stream launched them), the host's
intervals (the program's stage spans, which the benchmark marks with
``record_function``, and the operators), and what each metric's spy
recorded around the program's calls.
"""

from __future__ import annotations

import collections
import contextlib
import importlib

import numpy as np

STAGE = "stage/"  # prefix of the host spans around the pipeline's stages
SPAN = "span/"    # prefix of the benchmark's host spans around program calls
FRAME = "frame"   # the host span around one frame of the loop

# The program's calls that the traced window wraps in a span of the
# benchmark's own, (module, attribute): the finders' host stages and their
# device entry points, so that an idle gap names the host work around it.
SPANS = (
    ("magnify_tpu_torch.ops.detect", "normalize_planes_u8"),
    ("magnify_tpu_torch.ops.detect", "detect_dense"),
    ("magnify_tpu_torch.ops.detect", "ransac_plane"),
    ("magnify_tpu_torch.components.find", "chip_fused"),
    ("magnify_tpu_torch.components.find", "_crop_rois_np"),
    ("magnify_tpu_torch.components.find", "_bead_finalize_host"),
    ("magnify_tpu_torch.components.find.ButtonFinder", "_place_chambers"),
    ("magnify_tpu_torch.components.find.ButtonFinder", "find_centers"),
    ("magnify_tpu_torch.components.find.ButtonFinder", "find_rois"),
    ("magnify_tpu_torch.components.find.BeadFinder", "_host_planes"),
    ("magnify_tpu_torch.components.find.BeadFinder", "detect_planes"),
    ("magnify_tpu_torch.components.find.BeadFinder", "_assemble"),
)


def busy_us(spans) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e <= end:
            continue
        busy += e - max(s, end)
        end = e
    return busy


def idle_gaps(spans, lo: float, hi: float) -> list:
    """(start, end) of the gaps in [lo, hi] that no interval covers."""
    gaps, end = [], lo
    for s, e in sorted(spans):
        if s > end:
            gaps.append((end, min(s, hi)))
        end = max(end, e)
        if end >= hi:
            break
    if end < hi:
        gaps.append((end, hi))
    return [(s, e) for s, e in gaps if e > s]


class Trace:
    """Filled by the run: ``frames`` and ``window_s`` of the traced
    window, ``cycles`` (passes over the frame pool in it), the per-frame
    ``chip_timings`` and the ``stages`` report, ``records`` by metric
    (what its spy recorded; ``cache`` is the spies' to keep what they
    worked out once), and from the profiler ``kernels`` [(name,
    start_us, end_us)], ``host`` [(name, start_us, end_us)] and the
    window's bounds in the profiler's clock."""

    def __init__(self):
        self.frames = 0
        self.cycles = 0
        self.window_s = 0.0
        self.first_cycle = True
        self.chip_timings: list = []
        self.stages: dict = {}
        self.records: dict = collections.defaultdict(list)
        self.kernels: list = []
        self.host: list = []
        self.lo_us = 0.0
        self.hi_us = 0.0
        self.cache: dict = {}

    @property
    def busy_s(self) -> float:
        return busy_us([(s, e) for _n, s, e in self.kernels]) / 1e6

    def kernel_s(self, match) -> float:
        """Summed device seconds of the kernels whose name ``match``
        accepts."""
        return sum(e - s for n, s, e in self.kernels if match(n)) / 1e6

    def read_profiler(self, prof) -> None:
        """Kernels, copies and sets on the device (not the device-side
        copies of the host's annotations), and every host event."""
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        for ev in prof.events():
            span = (ev.name, ev.time_range.start, ev.time_range.end)
            if ev.device_type != cuda:
                self.host.append(span)
            elif not (getattr(ev, "is_user_annotation", False)
                      or _annotation(ev.name)):
                self.kernels.append(span)
        frames = [(s, e) for n, s, e in self.host if n == FRAME]
        if frames:
            self.lo_us = min(s for s, _e in frames)
            self.hi_us = max(e for _s, e in frames)

    def breakdown(self, top: int = 10) -> dict:
        """The device operations with the most time, and the idle gaps
        summed by what the host was doing (the innermost span, a stage's
        or the benchmark's, and the innermost operator that cover the
        gap's middle, "-" where none does; the longest 200 gaps are
        named, the rest summed as one)."""
        per = collections.Counter()
        for n, s, e in self.kernels:
            per[n[:120]] += (e - s) / 1e6
        gaps = idle_gaps([(s, e) for _n, s, e in self.kernels],
                         self.lo_us, self.hi_us)
        gaps.sort(key=lambda g: g[0] - g[1])
        named = collections.Counter()
        if self.host:
            names = [n for n, _s, _e in self.host]
            starts = np.array([s for _n, s, _e in self.host])
            ends = np.array([e for _n, _s, e in self.host])
            span = np.array([_annotation(n) for n in names])
            op = ~span
            for s, e in gaps[:200]:
                mid = (s + e) / 2
                inside = (starts <= mid) & (ends >= mid)
                label = []
                for sel in (inside & span, inside & op):
                    idx = np.nonzero(sel)[0]
                    label.append(names[idx[np.argmax(starts[idx])]]
                                 if len(idx) else "-")
                named[" > ".join(label)] += (e - s) / 1e6
        rest = sum(e - s for s, e in gaps[200:]) / 1e6
        if rest:
            named["(shorter gaps)"] += rest
        return {"device_ops": [[n, v] for n, v in per.most_common(top)],
                "idle_gaps": [[n, v] for n, v in named.most_common(top)]}


def _annotation(name: str) -> bool:
    return name == FRAME or name.startswith((STAGE, SPAN))


def _owner(path: str):
    """The module or class that ``path`` (dotted, a module path with an
    optional class name after it) names."""
    try:
        return importlib.import_module(path)
    except ModuleNotFoundError:
        module, _, cls = path.rpartition(".")
        return getattr(importlib.import_module(module), cls)


@contextlib.contextmanager
def stage_spans():
    """The pipeline's stage timers also open a profiler range
    ``stage/<name>`` (``Pipeline.__call__`` imports
    ``diagnostics.stage_timer`` at each call), and each call of
    :data:`SPANS` one ``span/<name>``."""
    import torch

    diagnostics = importlib.import_module("magnify_tpu_torch.diagnostics")
    real = diagnostics.stage_timer

    @contextlib.contextmanager
    def timer(name):
        with torch.profiler.record_function(STAGE + name), real(name):
            yield

    diagnostics.stage_timer = timer
    with contextlib.ExitStack() as stack:
        stack.callback(setattr, diagnostics, "stage_timer", real)
        for path, attr in SPANS:
            owner = _owner(path)
            fn = owner.__dict__[attr] if isinstance(owner, type) else getattr(
                owner, attr)

            def spanned(*args, _fn=fn, _name=SPAN + attr, **kwargs):
                with torch.profiler.record_function(_name):
                    return _fn(*args, **kwargs)

            setattr(owner, attr, spanned)
            stack.callback(setattr, owner, attr, fn)
        yield


@contextlib.contextmanager
def spies(metrics: dict, trace: Trace):
    """Install each metric's spies: ``SPIES`` is a sequence of (module,
    attribute, record), and while the block runs ``module.attribute`` is
    the original wrapped so that ``record(trace, records, args, kwargs,
    call)`` makes the call (``call()``) and returns its result."""
    with contextlib.ExitStack() as stack:
        for name, mod in metrics.items():
            for module_name, attr, record in getattr(mod, "SPIES", ()):
                module = _owner(module_name)
                real = getattr(module, attr)
                rec = trace.records[name]

                def wrapped(*args, _real=real, _record=record, _rec=rec,
                            **kwargs):
                    return _record(trace, _rec, args, kwargs,
                                   lambda: _real(*args, **kwargs))

                setattr(module, attr, wrapped)
                stack.callback(setattr, module, attr, real)
        yield
