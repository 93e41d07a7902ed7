"""magnify_tpu_torch: the bead and chip pipelines of magnify_tpu in PyTorch
and CUDA.

A port of ``magnify_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100. It
runs ``beads``, ``mrbles``, ``microfluidic_chip`` and ``image`` end to end,
with the dense or the RANSAC detector, on in-memory frames or on stacks
read from disk (TIFF/OME-TIFF path patterns, store directories; ``io``):
host layout, flat-field correction and stitching in numpy; the edge stack,
score maps, survivor sort and greedy NMS in torch on an explicit
``device``; masks and ROI crops back on the host; for ``mrbles`` the
spectral decode on the same device. A bead stack larger than
``components.find.MAX_RESIDENT_BYTES`` is processed out of core: one search
plane at a time through the detector, the ROI crops streamed plane by plane
into a disk-backed store. ``quantify`` reduces the ROI stack to
per-(mark, channel, time) intensities; ``save``/``load`` write and read
npz and netCDF. ``beads_stream`` and ``mrbles_stream`` run a sequence of
frames with the host work, the pinned uploads and the device work of
consecutive frames overlapped (``parallel``). ``basic_correct`` fits BaSiC
flat and dark fields per channel on the device (``ops.basic``);
``ops.find_circles``/``find_circles_stack`` are the upstream single-image
contract, and ``diagnostics`` times every pipeline stage and wraps
``torch.profiler``. ``microfluidic_chip`` runs a
whole timestep on the device: detection, the grid fit and one batched
re-detection over every chamber's crop. Three hand-written CUDA kernels
(``csrc/``) carry the device path: Canny hysteresis, the exact int8 ring
correlation and the RANSAC perimeter scorer. Each has a plain torch twin
that CPU tensors take.

The package imports torch, numpy and scipy, and never jax, magnify_tpu or
pandas. h5py (netCDF4), zstandard (zstd stores) and PIL (LZW or tiled
TIFF pages) are optional and imported only where such a file is read.
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
    "accessor",
    "beads",
    "beads_pipe",
    "beads_stream",
    "component",
    "components",
    "diagnostics",
    "filter",
    "find",
    "identify",
    "image",
    "image_pipe",
    "io",
    "load",
    "microfluidic_chip",
    "microfluidic_chip_pipe",
    "mrbles",
    "mrbles_pipe",
    "mrbles_stream",
    "ops",
    "parallel",
    "postprocess",
    "preprocess",
    "quantify",
    "readers",
    "save",
    "stitch",
    "utils",
]

from magnify_tpu_torch import (  # noqa: F401
    accessor,
    diagnostics,
    io,
    ops,
    parallel,
    utils,
)
from magnify_tpu_torch.components import (  # noqa: F401
    filter,
    find,
    identify,
    postprocess,
    preprocess,
    stitch,
)
from magnify_tpu_torch.components.quantify import quantify
from magnify_tpu_torch.core import DataArray, Dataset
from magnify_tpu_torch.core.pipeline import Pipeline
from magnify_tpu_torch.io import reader  # noqa: F401  (registers "read")
from magnify_tpu_torch.io.file import load, save
from magnify_tpu_torch.registry import (
    beads,
    beads_pipe,
    beads_stream,
    component,
    components,
    image,
    image_pipe,
    microfluidic_chip,
    microfluidic_chip_pipe,
    mrbles,
    mrbles_pipe,
    mrbles_stream,
    readers,
)
