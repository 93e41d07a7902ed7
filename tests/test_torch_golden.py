"""The port on the CPU reproduces the golden file of the smoke frame A.

``tests/data/torch_port_golden.npz`` holds the JAX package's ``beads``
result (dense, int8) on frame A of ``chip_smoke.py`` (1024^2, 110 beads):
the bead rows in mark order and digests of fg, bg and roi. ``chip_smoke``
holds the port on the card to it; this test holds the port's CPU path to
it, so a drift between the golden file and the port shows up here too.
"""

import os
import sys

import numpy as np

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
import torch  # noqa: E402

# One intra-op thread per test process: the suite runs several pytest
# workers at once, and oversubscribed torch thread pools spin for the cores
# the others need.
torch.set_num_threads(1)


def test_frame_a_matches_golden():
    import magnify_tpu_torch as mt

    golden = np.load(chip_smoke.GOLDEN)
    xp = mt.beads(chip_smoke.as_dataarray(mt, "A"), device="cpu",
                  **chip_smoke.FRAME_A_KW)
    got = chip_smoke.summarize(xp)
    assert got["rows"].shape == (110, 2)
    np.testing.assert_array_equal(got["rows"], golden["A_rows"])
    for key in ("fg", "bg", "roi"):
        assert got[key] == str(golden[f"A_{key}"]), key
