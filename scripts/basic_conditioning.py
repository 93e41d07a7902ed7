"""How well conditioned the JAX package's BaSiC solver is on a stack of
tiles, and how closely the port's solver follows it.

    JAX_PLATFORMS=cpu python scripts/basic_conditioning.py

For each stack it prints:

* ``spread``: how far the jitted JAX solver's flat field (max |diff|) and
  dark field (max |diff| over the stack's mean) move when its
  working-resolution stack is multiplied by ``1 + 1e-7 * noise``, a change
  below float32 resolution;
* ``port``: the same two distances between the port's ``fit_basic`` on the
  CPU and the JAX ``fit_basic``;
* ``flat_err``: how far the JAX flat field is from the drawn one (max
  relative error, both at unit mean).

The stacks: those of ``tests/test_torch_basic.py``; frame S's two channels
(``chip_smoke.frame_s``: 16 tiles of 1024^2, background levels 100-1,000,
16 beads a tile); and channel "a" of frame S with every tile at one
background level, with 64 beads a tile, and both. Runs on the CPU; needs
JAX and the JAX package.
"""

from __future__ import annotations

import json
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import chip_smoke  # noqa: E402
from magnify_tpu.ops import basic as jbasic  # noqa: E402
from magnify_tpu_torch.ops import basic as tbasic  # noqa: E402
from test_torch_basic import reference_spread, shading_tiles  # noqa: E402

TILE = chip_smoke.TILE


def measure(name: str, tiles, flat) -> dict:
    mean = float(tiles.astype(np.float32).mean())
    f_j, d_j = (np.asarray(v) for v in jbasic.fit_basic(tiles))
    f_t, d_t = tbasic.fit_basic(tiles, device="cpu")
    spread_flat, spread_dark = reference_spread(tiles)
    rec = {
        "stack": name, "shape": list(tiles.shape),
        "spread_flat": spread_flat, "spread_dark_over_mean":
            spread_dark / mean,
        "port_flat": float(np.abs(f_t - f_j).max()),
        "port_dark_over_mean": float(np.abs(d_t - d_j).max()) / mean,
        "flat_err": float(np.abs(f_j / (flat / flat.mean()) - 1).max()),
    }
    print(f"{name} {tiles.shape}: spread flat {rec['spread_flat']:.3e} "
          f"dark/mean {rec['spread_dark_over_mean']:.3e}; port flat "
          f"{rec['port_flat']:.3e} dark/mean "
          f"{rec['port_dark_over_mean']:.3e}; JAX flat off the drawn one "
          f"by {rec['flat_err']:.4f}", flush=True)
    return rec


def main() -> None:
    out = []
    for shape, seed in (((8, 256, 256), 0), ((8, 256, 256), 1),
                        ((8, 192, 320), 2)):
        out.append(measure(f"tests seed {seed}", *shading_tiles(*shape,
                                                                 seed)))
    flat_s, _dark = chip_smoke.s_shading()
    tiles_s, _beads = chip_smoke.frame_s()
    for ci, ch in enumerate(chip_smoke.S_CHANNELS):
        out.append(measure(f"frame S channel {ch}",
                           tiles_s[ci].reshape(-1, TILE, TILE), flat_s))
    for one_level, per_side in ((True, 4), (False, 8), (True, 8)):
        tiles, _beads = chip_smoke.frame_s(one_level=one_level,
                                           per_side=per_side)
        name = (f"frame S channel a, "
                f"{'one level' if one_level else 'levels 100-1000'}, "
                f"{per_side ** 2} beads a tile")
        out.append(measure(name, tiles[0].reshape(-1, TILE, TILE), flat_s))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
