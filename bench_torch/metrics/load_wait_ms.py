"""The chip finder's main thread waiting for the next copied timestep's
read a frame (ms): the program's span ``chip.load_wait``, over the frames
of the window. Layer: chip finder host (``components/find.py``
``ButtonFinder``)."""

from bench_torch.metrics import upload_mb


def read(trace, cfg):
    return upload_mb.span_ms(trace, "chip.load_wait", "seconds")
