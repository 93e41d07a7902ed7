"""The RANSAC sampler a frame (ms): CUDA events around every call of
``ops.ransac.candidate_circles`` that ``ops.detect`` makes, summed (the
host clock where the program runs on the CPU). Layer: RANSAC sampler
(``ops/prng.py``, ``ops/ransac.py``)."""

import time


def _record(trace, records, args, kwargs, call):
    import torch

    if not torch.cuda.is_available():
        t0 = time.perf_counter()
        out = call()
        records.append(1e3 * (time.perf_counter() - t0))
        return out
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = call()
    end.record()
    records.append((start, end))
    return out


SPIES = (("magnify_tpu_torch.ops.detect", "candidate_circles", _record),)


def read(trace, cfg):
    records = trace.records.get("sampler_ms")
    if not records or not trace.frames:
        return None
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return sum(r if isinstance(r, float) else r[0].elapsed_time(r[1])
               for r in records) / trace.frames
