"""The bead ownership masks a frame (ms): the program's span
``beads.ownership``, host wall time, over the frames of the window. On a
card that is the uploads, the kernel and the copy of the masks back; on
the host the numpy pass. Layer: bead finder (``components/find.py``
``_bead_ownership``)."""

from bench_torch.metrics import upload_mb


def read(trace, cfg):
    return upload_mb.span_ms(trace, "beads.ownership", "seconds")
