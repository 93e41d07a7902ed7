"""The host's min-max uint8 normalization of the search planes a frame
(ms): the program's span ``detect.normalize_u8``, over the frames of the
window. Layer: host normalization (``ops/detect.py``
``normalize_planes_u8``)."""

from bench_torch.metrics import upload_mb


def read(trace, cfg):
    return upload_mb.span_ms(trace, "detect.normalize_u8", "seconds")
