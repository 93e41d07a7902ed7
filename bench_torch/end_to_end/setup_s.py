"""Seconds from the start of the process to the first timed frame: imports,
CUDA start-up, building or loading the kernels, drawing the frames and
the warm-up calls."""


def read(window):
    return window.setup_s
