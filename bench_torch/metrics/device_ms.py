"""Device busy time a frame (ms): the union of every kernel's interval in
the profiler's trace of the window, over the frames completed in it.
Layer: device path (``ops/edge.py``, ``ops/score.py``, ``ops/detect.py``,
``ops/nms.py``, the RANSAC sampler)."""


def read(trace, cfg):
    if not trace.frames or not trace.kernels:
        return None
    return 1e3 * trace.busy_s / trace.frames
