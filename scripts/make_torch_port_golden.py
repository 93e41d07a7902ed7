"""Write tests/data/torch_port_golden.npz: the JAX package's results on the
port's smoke frames, for checking the port where JAX is absent.

    JAX_PLATFORMS=cpu python scripts/make_torch_port_golden.py

Runs ``magnify_tpu.beads(detector="dense")`` with int8 score maps on the CPU
for frame A (1024^2, 110 beads) and frame B (2 channels, 2 x 2 tiles of
1024^2, overlap 102) and ``magnify_tpu.mrbles`` the same way for frame M
(4 channels x 1024^2, 108 beads of 4 codes) and
``magnify_tpu.microfluidic_chip`` for frame C8 (8 x 8 chambers on 900^2) and
its 2-channel, 2-timestep variant C8V, as ``chip_smoke.py`` builds them;
then frames A and C8 again with ``detector="ransac"`` at the default
``num_iter`` (5,000,000 proposals, seed 0), with the exact perimeter scorer
(``MAGNIFY_TPU_SCORER=gather``) under the keys ``RA_*`` and ``RC8_*`` and
with the conv scorer (``MAGNIFY_TPU_SCORER=conv``, each proposal's score
read out of the int8 score maps) under ``RAconv_*`` and ``RC8conv_*``; and
frame S (2 channels x 4 x 4 tiles of 1024^2, stitched to 3,688^2) through
``beads_pipe`` with ``basic_correct`` after ``standardize_format`` and the
dense detector, under ``S_*``. It stores for each the mark rows (y, x) in
mark order and sha256 digests of fg, bg and roi; for frame M also the
decoded tags and ``ln_vol``, for the chip frames the chamber tags.
The score-quantization mode is read once when magnify_tpu is imported, so
this script sets it (and the detector) before that import, in its own
process; the detector and the scorer are read per call and switch for the
RANSAC frames.
Keys that the file already holds must come out unchanged: the script
refuses to overwrite a file whose frames A, B, M, C8 or C8V would change.
"""

from __future__ import annotations

import os
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
os.environ["MAGNIFY_TPU_SCORE_QUANT"] = "int8"
os.environ["MAGNIFY_TPU_DETECTOR"] = "dense"
os.environ["MAGNIFY_TPU_SCORER"] = "gather"
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("MAGNIFY_TPU_CACHE_DIR",
                      str(ROOT / ".cache" / "golden_xla"))
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402
import magnify_tpu as mg  # noqa: E402


def main() -> None:
    out = {}
    cases = (("A", chip_smoke.FRAME_A_KW), ("B", chip_smoke.FRAME_B_KW),
             ("M", chip_smoke.FRAME_M_KW), ("C8", chip_smoke.FRAME_C8_KW),
             ("C8V", chip_smoke.FRAME_C8_KW))
    for case, kw in cases:
        data = chip_smoke.as_dataarray(mg, case)
        if case == "M":
            spectra, codes = chip_smoke.mrbles_csvs()
            xp = mg.mrbles(data, spectra=spectra, codes=codes,
                           detector="dense", **kw)
        elif case.startswith("C8"):
            xp = mg.microfluidic_chip(data, detector="dense", **kw)
        else:
            xp = mg.beads(data, detector="dense", **kw)
        for key, val in chip_smoke.summarize(xp).items():
            out[f"{case}_{key}"] = np.asarray(val)
        print(f"frame {case}: {len(out[f'{case}_rows'])} marks, "
              f"roi {xp['roi'].shape}")
    xp = chip_smoke.frame_s_pipe(mg, detector="dense")(
        data=chip_smoke.as_dataarray(mg, "S"))
    for key, val in chip_smoke.summarize(xp).items():
        out[f"S_{key}"] = np.asarray(val)
    print(f"frame S: {len(out['S_rows'])} marks, roi {xp['roi'].shape}")
    os.environ["MAGNIFY_TPU_DETECTOR"] = "ransac"
    for scorer, suffix in (("gather", ""), ("conv", "conv")):
        os.environ["MAGNIFY_TPU_SCORER"] = scorer
        for case, kw in (("A", chip_smoke.FRAME_A_KW),
                         ("C8", chip_smoke.FRAME_C8_KW)):
            data = chip_smoke.as_dataarray(mg, case)
            if case == "C8":
                xp = mg.microfluidic_chip(data, detector="ransac", **kw)
            else:
                xp = mg.beads(data, detector="ransac", **kw)
            name = f"R{case}{suffix}"
            for key, val in chip_smoke.summarize(xp).items():
                out[f"{name}_{key}"] = np.asarray(val)
            print(f"frame {case}, RANSAC ({scorer}): "
                  f"{len(out[f'{name}_rows'])} marks, roi {xp['roi'].shape}")
    tags = out["M_tag"]
    print(f"frame M: true {chip_smoke.frame_m()[1]}, found {len(tags)}, "
          f"coded {int((tags != 'outlier').sum())}, outliers "
          f"{int((tags == 'outlier').sum())}")
    path = ROOT / "tests" / "data" / "torch_port_golden.npz"
    path.parent.mkdir(parents=True, exist_ok=True)
    if path.exists():
        old = np.load(path)
        for key in old.files:
            if key.split("_")[0] not in ("A", "B", "M", "C8", "C8V"):
                continue
            if not np.array_equal(old[key], out[key]):
                raise SystemExit(f"{key} would change; the golden file was "
                                 "not written")
    np.savez_compressed(path, **out)
    print(f"wrote {path.relative_to(ROOT)}")


if __name__ == "__main__":
    main()
