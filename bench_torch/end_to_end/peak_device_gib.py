"""Peak device memory allocated in the window (GiB):
``torch.cuda.max_memory_allocated()`` after ``reset_peak_memory_stats()``
at the window's start."""


def read(window):
    return window.peak_bytes / 2**30
