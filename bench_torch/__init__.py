"""The benchmark of ``magnify_tpu_torch`` on one NVIDIA GPU.

``python3 bench_torch/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Everything that measures lives here: the frame generators, the
plain reference that decides ``correct``, the profiler reduction, the
roofline arithmetic and one reader per per-layer metric. It imports the
program under test (``magnify_tpu_torch``) and never the JAX package.
"""
