"""One module per end-to-end metric, named as the metric in
``BENCHMARK.json``. Each has ``read(window)``, which returns the metric's
value from the measured :class:`bench_torch.run.Window` (host clock and
the device's peak memory), or None where the cell has nothing to read."""
