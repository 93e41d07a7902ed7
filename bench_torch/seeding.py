"""Seeds of the frames: one ``torch.Generator`` per frame, from the run's
``--seed`` (any whole number) and the frame's index in the pool."""

from __future__ import annotations

import numpy as np


def frame_seed(seed: int, index: int) -> int:
    """A 63-bit seed for frame ``index`` of the pool drawn from ``seed``."""
    seq = np.random.SeedSequence([int(seed) % 2**64, int(index)])
    return int(seq.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, index: int, device):
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(frame_seed(seed, index))
    return g
