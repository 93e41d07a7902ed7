"""Write tests/data/torch_port_golden.npz: the JAX package's beads results
on the port's two smoke frames, for checking the port where JAX is absent.

    JAX_PLATFORMS=cpu python scripts/make_torch_port_golden.py

Runs ``magnify_tpu.beads(detector="dense")`` with int8 score maps on the CPU
for frame A (1024^2, 110 beads) and frame B (2 channels, 2 x 2 tiles of
1024^2, overlap 102) as ``chip_smoke.py`` builds them, and stores for each
the bead rows (y, x) in mark order and sha256 digests of fg, bg and roi.
The score-quantization mode is read once when magnify_tpu is imported, so
this script sets it (and the detector) before that import, in its own
process.
"""

from __future__ import annotations

import os
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
os.environ["MAGNIFY_TPU_SCORE_QUANT"] = "int8"
os.environ["MAGNIFY_TPU_DETECTOR"] = "dense"
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("MAGNIFY_TPU_CACHE_DIR",
                      str(ROOT / ".cache" / "golden_xla"))
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402
import magnify_tpu as mg  # noqa: E402


def main() -> None:
    out = {}
    cases = (("A", chip_smoke.FRAME_A_KW), ("B", chip_smoke.FRAME_B_KW))
    for case, kw in cases:
        xp = mg.beads(chip_smoke.as_dataarray(mg, case), detector="dense",
                      **kw)
        summary = chip_smoke.summarize(xp)
        out[f"{case}_rows"] = summary["rows"]
        for key in ("fg", "bg", "roi"):
            out[f"{case}_{key}"] = np.array(summary[key])
        print(f"frame {case}: {len(summary['rows'])} marks, "
              f"roi {xp['roi'].shape}")
    path = ROOT / "tests" / "data" / "torch_port_golden.npz"
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **out)
    print(f"wrote {path.relative_to(ROOT)}")


if __name__ == "__main__":
    main()
