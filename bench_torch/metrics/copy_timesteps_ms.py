"""The chip finder's copied timesteps a frame (ms): the program's span
``chip.copy_timesteps`` (``diagnostics.span_report()``), the loop that
reads each timestep that is not searched and crops it at the copied
positions, over the frames of the window. Layer: chip finder host
(``components/find.py`` ``ButtonFinder``)."""

from bench_torch.metrics import upload_mb


def read(trace, cfg):
    return upload_mb.span_ms(trace, "chip.copy_timesteps", "seconds")
