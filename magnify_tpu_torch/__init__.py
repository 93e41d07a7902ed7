"""magnify_tpu_torch: the bead and chip pipelines of magnify_tpu in PyTorch
and CUDA.

A port of ``magnify_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100. It
runs ``beads``, ``mrbles`` and ``microfluidic_chip`` on in-memory frames end
to end with the dense detector: host layout, flat-field correction and stitching in numpy; the
edge stack, int8 score maps, survivor sort and greedy NMS in torch on an
explicit ``device``; masks and ROI crops back on the host; for ``mrbles``
the spectral decode (masked ROI reductions, lattice fit, Gaussian-mixture
EM) on the same device. ``beads_stream`` and ``mrbles_stream`` run a
sequence of frames with the host work, the pinned uploads and the device
work of consecutive frames overlapped (``parallel``). ``microfluidic_chip``
runs a whole timestep on the device: detection, the grid fit and one
batched re-detection over every chamber's crop. Two hand-written CUDA
kernels (``csrc/``) carry the device path, each over one plane or a batch
of planes: Canny hysteresis and the exact int8 ring correlation. Each has a
plain torch twin that CPU tensors take.

The package imports torch, numpy and scipy, and never jax, magnify_tpu or
pandas.
It has no learned weights: the constant state it shares with the JAX
package is numpy tables (Bresenham rings, the disk-extent LUT, the float
and int8 ring kernels and their scales), built by numpy code copied from
the JAX package and array-equal to its tables — no conversion step exists.
"""

__version__ = "0.1.0"

__all__ = [
    "DataArray",
    "Dataset",
    "Pipeline",
    "beads",
    "beads_pipe",
    "beads_stream",
    "component",
    "microfluidic_chip",
    "microfluidic_chip_pipe",
    "mrbles",
    "mrbles_pipe",
    "mrbles_stream",
    "parallel",
]

from magnify_tpu_torch import components  # noqa: F401  (registers components)
from magnify_tpu_torch import parallel
from magnify_tpu_torch.core import DataArray, Dataset
from magnify_tpu_torch.core.pipeline import Pipeline
from magnify_tpu_torch.core.registry import component
from magnify_tpu_torch.io import reader  # noqa: F401  (registers "read")
from magnify_tpu_torch.registry import (
    beads,
    beads_pipe,
    beads_stream,
    microfluidic_chip,
    microfluidic_chip_pipe,
    mrbles,
    mrbles_pipe,
    mrbles_stream,
)
