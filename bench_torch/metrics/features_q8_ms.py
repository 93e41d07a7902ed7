"""The dense detector's int8 alignment features a frame (ms): the device
interval of the program's span ``score.features_q8`` (two CUDA events
around each call of ``ops.score.alignment_features_q8`` on a card: the
kernel ``csrc/features_q8.cu``), over the frames of the window. None where
the program has no such span or ran no call on a card. Layer: device path
(``ops/score.py``)."""

from bench_torch.metrics import upload_mb


def read(trace, cfg):
    return upload_mb.span_ms(trace, "score.features_q8", "device_seconds")
