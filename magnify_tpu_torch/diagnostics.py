"""Observability: stage timers, the package's logger and a device profiler.

The port's own copy of ``magnify_tpu.diagnostics``:

* :func:`stage_timer` accumulates host wall time and a call count per named
  stage; :class:`~magnify_tpu_torch.core.pipeline.Pipeline` times its
  reader (``"read"``) and every component by name through it, and
  :func:`stage_report` returns the totals. With ``MAGNIFY_TPU_TRACE`` set
  each stage also logs and prints ``[magnify_tpu_torch] <stage>: <ms> ms``.
  The timers never synchronize a card: device work still in flight when a
  stage ends is counted in the stage that waits for it (the detector's
  components wait for their marks, so a component's time includes its own
  device work).
* :func:`profile` records ``torch.profiler`` activity (the CPU, and CUDA
  when a card is present) around a block and writes a Chrome trace.
* ``log``: one stdlib logger, ``magnify_tpu_torch``, so a host program can
  route the package's messages (the chip grid's sparse-edge warnings, for
  one).
"""

from __future__ import annotations

import contextlib
import logging
import os
import pathlib
import time
from collections import defaultdict

__all__ = ["log", "profile", "reset_stages", "stage_report", "stage_timer"]

log = logging.getLogger("magnify_tpu_torch")

_stage_totals: dict[str, float] = defaultdict(float)
_stage_counts: dict[str, int] = defaultdict(int)


def _tracing() -> bool:
    return bool(os.environ.get("MAGNIFY_TPU_TRACE"))


@contextlib.contextmanager
def stage_timer(name: str):
    """Accumulate the host wall time of a named stage; logs and prints it
    when ``MAGNIFY_TPU_TRACE`` is set."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
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
    _stage_totals.clear()
    _stage_counts.clear()


@contextlib.contextmanager
def profile(log_dir: str = "magnify_tpu_torch_profile"):
    """Record a ``torch.profiler`` trace of the CPU and, when a card is
    present, of CUDA around a block of work; the Chrome trace is written
    to ``log_dir/trace.json`` when the block ends. Yields the profiler
    (``key_averages()`` gives the per-operator totals)."""
    import torch
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
