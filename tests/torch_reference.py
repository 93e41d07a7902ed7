"""The JAX references of the port's tests, each run in one subprocess.

The JAX package reads ``MAGNIFY_TPU_SCORE_QUANT`` once at import, and its
CPU default (bf16 score maps) is another program than the port's; it reads
``MAGNIFY_TPU_DETECTOR`` and ``MAGNIFY_TPU_SCORER`` per call, where they
override a ``detector`` argument. So the subprocess gets its own
environment, and a reference that needs a scorer sets it itself.
"""

import os
import subprocess
import sys

import numpy as np

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
CACHE = os.path.join(ROOT, ".cache", "test_xla")
# Seconds for one reference: about three times the longest of them with a
# cold compilation cache, so a hung reference fails its own tests instead
# of running into the suite's limit.
TIMEOUT = 380


def run(test_file, *args, detector="dense"):
    """Run ``python test_file *args`` and load the ``.npz`` it writes.

    The last argument is the path the script writes its arrays to. The
    reference sees one CPU device: the suite's ``XLA_FLAGS`` are left out.
    """
    env = dict(os.environ, MAGNIFY_TPU_SCORE_QUANT="int8",
               JAX_PLATFORMS="cpu", MAGNIFY_TPU_CACHE_DIR=CACHE)
    env.pop("MAGNIFY_TPU_SCORER", None)
    env.pop("XLA_FLAGS", None)
    if detector is None:
        env.pop("MAGNIFY_TPU_DETECTOR", None)
    else:
        env["MAGNIFY_TPU_DETECTOR"] = detector
    subprocess.run([sys.executable, os.path.abspath(test_file),
                    *map(str, args)],
                   env=env, cwd=ROOT, check=True, timeout=TIMEOUT)
    return dict(np.load(args[-1]))


def check_env(detector="dense"):
    """Assert the environment :func:`run` gives the reference subprocess."""
    assert os.environ.get("MAGNIFY_TPU_SCORE_QUANT") == "int8"
    assert os.environ.get("JAX_PLATFORMS") == "cpu"
    assert os.environ.get("MAGNIFY_TPU_DETECTOR") == detector
    assert "MAGNIFY_TPU_SCORER" not in os.environ
