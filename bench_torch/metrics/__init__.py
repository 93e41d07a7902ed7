"""One module per per-layer metric, named as the metric in
``BENCHMARK.json``. Each has ``read(trace, cfg)``, which returns the
metric's value from a :class:`bench_torch.trace.Trace` after the traced
window, or None where it finds nothing to read (the run then leaves the
metric out). A metric that needs to see the program's calls lists
``SPIES``: (module, attribute, record) triples (see
:func:`bench_torch.trace.spies`)."""
