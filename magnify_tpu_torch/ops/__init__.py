"""Device compute in torch: the port's ops layer.

Submodules:

- :mod:`~magnify_tpu_torch.ops.edge` — normalize/blur/Scharr/Canny stack,
  exact quantiles
- :mod:`~magnify_tpu_torch.ops.hysteresis` — Canny hysteresis (CUDA kernel
  ``csrc/hysteresis.cu`` and its plain twin)
- :mod:`~magnify_tpu_torch.ops.ransac`, :mod:`~magnify_tpu_torch.ops.prng`
  — RANSAC circumcircle proposals from threefry streams
- :mod:`~magnify_tpu_torch.ops.score` — int8 ring-correlation score maps
  (``csrc/ring_corr.cu``), unique-triple dedupe, the perimeter scorer
  (``csrc/perimeter_score.cu``) and the map read-out of the conv scorer
- :mod:`~magnify_tpu_torch.ops.nms` — exact greedy neighbour suppression
- :mod:`~magnify_tpu_torch.ops.detect` — the detectors (one plane, a stack
  of planes, a batch of ROIs) and ``find_circles``
- :mod:`~magnify_tpu_torch.ops.geom`, :mod:`~magnify_tpu_torch.ops.gridfit`
  — disks and annuli, ROI gathers, rotation; the chip grid fit
- :mod:`~magnify_tpu_torch.ops.reduce` — masked per-mark statistics
- :mod:`~magnify_tpu_torch.ops.basic` — the BaSiC flat/dark-field solver

The names exported here are those of ``magnify_tpu.ops`` but one:
``prefer_host_reduction``, whose link-rate probe serves the JAX package's
relay to a remote TPU and has no counterpart on a local card.
"""

from magnify_tpu_torch.ops.detect import (  # noqa: F401
    detect_best_in_rois,
    find_circles,
    find_circles_stack,
    resolve_detector,
)
from magnify_tpu_torch.ops.edge import (  # noqa: F401
    edge_pipeline,
    histogram_quantile,
)
from magnify_tpu_torch.ops.reduce import (  # noqa: F401
    fg_mean_bg_median,
    masked_mean,
    masked_median,
)

__all__ = [
    "detect_best_in_rois",
    "edge_pipeline",
    "fg_mean_bg_median",
    "find_circles",
    "find_circles_stack",
    "histogram_quantile",
    "masked_mean",
    "masked_median",
    "resolve_detector",
]
