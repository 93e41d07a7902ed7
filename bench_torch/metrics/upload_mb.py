"""Bytes the finders copy from the host to the device a frame (MB, 10^6
B): the program's counter ``upload_bytes`` (``diagnostics
.counter_report()``), over the frames of the window: the search planes
and the tables a finder hands to the card (the dense chip's points per
row and column, the RANSAC chip's chamber corners), not the 0-d scalars
and keys the kernels take. Layer: host to device.

Also the reader of the program's span store for the other metrics of
spans: each returns None where the program keeps no such store, the
window recorded no such span, or the store dropped records."""

import importlib


def _store():
    """The program's ``diagnostics`` module if it keeps a span store whose
    every record of the window is there, else None."""
    diagnostics = importlib.import_module("magnify_tpu_torch.diagnostics")
    if not hasattr(diagnostics, "span_report") or (
            diagnostics.dropped_spans()):
        return None
    return diagnostics


def span_ms(trace, name, key):
    """``key`` ("seconds" or "device_seconds") of the spans ``name`` a
    frame, ms."""
    diagnostics = _store()
    if diagnostics is None or not trace.frames:
        return None
    entry = diagnostics.span_report().get(name)
    if entry is None or entry[key] is None:
        return None
    return 1e3 * entry[key] / trace.frames


def read(trace, cfg):
    diagnostics = _store()
    if diagnostics is None or not trace.frames:
        return None
    n = diagnostics.counter_report().get("upload_bytes")
    return None if n is None else n / 1e6 / trace.frames
