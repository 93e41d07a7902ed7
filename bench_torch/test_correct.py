"""The comparison that decides ``correct``, held to fail where it must.

On the CPU, at sizes a test run holds (a 6 x 4 chip at the "pc" pitches,
a 2 x 2 scan of 256^2 tiles), with the program on ``device="cpu"``:

* every cell's run, without the look for a chip, is correct;
* the control (the reference's own answer at half resolution, put in the
  program's place) is not;
* each fault that a cell can have, planted in the program under the timed
  path, makes the run not correct: a step that returns its state unchanged
  (the last frame's detection again), half of the batch left out (one of
  the two search channels; half of the chambers' refinement), an answer
  altered where it is produced (one mark moved by a pixel).

Run with ``python3 -m pytest bench_torch/test_correct.py`` (about a
minute), or ``python3 bench_torch/test_correct.py``. The chip-size
control is ``python3 bench_torch/control.py`` on the card.
"""

from __future__ import annotations

import importlib
import pathlib
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_torch import run  # noqa: E402

# Sizes a CPU test holds (the plain CPU ring correlation costs seconds a
# frame past these).
TINY = {
    "chip_pc": {"grid": [6, 4]},
    "beads_4x4": {"tiles": [2, 2], "tile_px": 256},
}
TINY_TRAFFIC = {"num_iter": 20000, "pool": 2}
# One seed for the sound runs and the faulted ones, so that each fault is
# held against a run that is correct without it.
SEED = 2**31 + 7
CELLS = ("chip_pc.dense", "beads_4x4.serial", "chip_pc.ransac")


def tiny_cell(name: str) -> tuple:
    bench, cell, cfg, traffic = run.load_cell(ROOT, name)
    cfg = dict(cfg, **TINY[cell["config"]], warm_frames=1)
    traffic = dict(traffic, **{k: v for k, v in TINY_TRAFFIC.items()
                               if k in traffic or k == "pool"})
    return bench, cell, cfg, traffic


def run_tiny(name: str, seed: int = SEED, traced: bool = False) -> dict:
    bench, cell, cfg, traffic = tiny_cell(name)
    return run.run_cell(bench, cell, cfg, traffic, seed, 0.0, traced, "cpu",
                        min_frames=3)


@pytest.fixture(autouse=True)
def _detector_env(monkeypatch):
    # run_cell pins the detector and scorer in the environment; leave the
    # process as it was.
    monkeypatch.setenv("MAGNIFY_TPU_DETECTOR", "auto")
    monkeypatch.setenv("MAGNIFY_TPU_SCORER", "auto")


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    line = run_tiny(name)
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 3 and line["failed"] == 0
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("config", ("chip_pc", "beads_4x4"))
def test_control_is_not_correct(config):
    _bench, _cell, cfg, _traffic = tiny_cell(f"{config}.dense"
                                             if config == "chip_pc"
                                             else f"{config}.serial")
    kind = importlib.import_module(f"bench_torch.kinds.{cfg['kind']}")
    for seed in (1, 2, 3):
        frame = kind.make_frames(cfg, seed, 1, "cpu")[0]
        nums = kind.compare(cfg, frame, kind.expected(cfg, frame),
                            control_answer(kind, cfg, frame))
        assert any(v > kind.LIMITS[k] for k, v in nums.items()), nums


def control_answer(kind, cfg, frame) -> dict:
    """The reference's answer at half resolution, in the shape of the
    kind's ``extract``."""
    half = kind.expected(cfg, frame, quantum=2)
    if cfg["kind"] == "chip":
        n_t = frame["stack"].shape[0]
        rows, cols = frame["cy"].shape
        rep = np.ones(n_t)
        return {"y": half["cy"][..., None] * rep,
                "x": half["cx"][..., None] * rep,
                "valid": np.ones((rows, cols, n_t), bool), "tag": half["tag"],
                "fg": np.repeat(half["fg"][:, :, None], n_t, axis=2),
                "bg": np.repeat(half["bg"][:, :, None], n_t, axis=2),
                "roi": half["roi"]}
    return {"y": half["y"].astype(float), "x": half["x"].astype(float),
            "valid": np.ones(len(half["y"]), bool), "fg": half["fg"],
            "bg": half["bg"], "roi": half["roi"]}


# --- faults planted under the timed path ------------------------------------

def _stale(real):
    last = []

    def call(*args, **kw):
        if not last:
            last.append(real(*args, **kw))
        return last[0]
    return call


def _bead_faults(fault):
    def wrap(real):
        if fault == "stale":
            return _stale(real)
        if fault == "half_batch":
            return lambda self, planes: real(self, planes[:1])

        def altered(self, planes):
            out = real(self, planes).copy()
            out[0, 1] += 1
            return out
        return altered
    return wrap


def _chip_dense_faults(fault):
    def wrap(real):
        if fault == "stale":
            return _stale(real)

        def call(*args, **kw):
            out = dict(real(*args, **kw))
            if fault == "half_batch":
                score = out["score"].clone()
                score[len(score) // 2:] = float("nan")
                out["score"] = score
            else:
                circle = out["circle"].clone()
                circle[0, 1] += 1
                out["circle"] = circle
            return out
        return call
    return wrap


def _chip_ransac_faults(fault):
    def wrap(real):
        if fault == "stale":
            return _stale(real)

        def call(self, images_np, images_dev, tag, x, y, valid, idxs):
            x, y = np.array(x), np.array(y)
            out = list(real(self, images_np, images_dev, tag, x, y, valid,
                            idxs))
            if fault == "half_batch":
                n = x.shape[0] // 2
                out[3], out[4] = out[3].copy(), out[4].copy()
                out[3][n:], out[4][n:] = x[n:], y[n:]
            else:
                out[3] = out[3].copy()
                out[3][0, 0] += 1
            return tuple(out)
        return call
    return wrap


FAULT_SITES = {
    "chip_pc.dense": ("chip_fused", _chip_dense_faults),
    "chip_pc.ransac": ("ButtonFinder.find_rois", _chip_ransac_faults),
    "beads_4x4.serial": ("BeadFinder.detect_planes", _bead_faults),
}


@pytest.mark.parametrize("fault", ("stale", "half_batch", "altered"))
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault, monkeypatch):
    from magnify_tpu_torch.components import find

    site, faults = FAULT_SITES[name]
    owner, attr = ((getattr(find, site.split(".")[0]), site.split(".")[1])
                   if "." in site else (find, site))
    monkeypatch.setattr(owner, attr, faults(fault)(getattr(owner, attr)))
    line = run_tiny(name)
    assert not line["correct"], line["checks"]


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-q"]))
