"""The RANSAC sampler's device time a frame (ms): the device interval of
the program's span ``ransac.sampler`` (two CUDA events around each call of
``ops.ransac.candidate_circles``), over the frames of the window. Layer:
RANSAC sampler (``ops/prng.py``, ``ops/ransac.py``)."""

from bench_torch.metrics import upload_mb


def read(trace, cfg):
    return upload_mb.span_ms(trace, "ransac.sampler", "device_seconds")
