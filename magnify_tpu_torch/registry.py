"""User-facing pipeline factories: ``beads`` and ``beads_pipe``.

The same parameters and defaults as ``magnify_tpu.registry``'s, plus
``device`` (default ``"cuda"``): the device the detector runs on. The CPU
runs the kernels' plain twins; a device that is missing raises.
"""

from __future__ import annotations

from magnify_tpu_torch.core.pipeline import Pipeline

__all__ = ["beads", "beads_pipe"]


def beads_pipe(
    flatfield=1.0,
    darkfield=0.0,
    overlap: int = 102,
    min_bead_diameter: int = 5,
    max_bead_diameter: int = 25,
    low_edge_quantile: float = 0.1,
    high_edge_quantile: float = 0.9,
    num_iter: int = 5000000,
    min_roundness: float = 0.3,
    roi_length=None,
    search_channel=None,
    roi_only: bool = False,
    drop_tiles: bool = True,
    interactive: bool = False,
    detector: str = "auto",
    device="cuda",
) -> Pipeline:
    """Build the bead-finding pipeline: read -> standardize_format ->
    flatfield_correct -> stitch -> find_beads -> drop -> restore_format."""
    pipe = Pipeline("read")
    pipe.add_pipe("standardize_format")
    pipe.add_pipe("flatfield_correct", flatfield=flatfield, darkfield=darkfield)
    pipe.add_pipe("stitch", overlap=overlap)
    pipe.add_pipe(
        "find_beads",
        min_bead_diameter=min_bead_diameter,
        max_bead_diameter=max_bead_diameter,
        low_edge_quantile=low_edge_quantile,
        high_edge_quantile=high_edge_quantile,
        num_iter=num_iter,
        min_roundness=min_roundness,
        roi_length=roi_length,
        search_channel=search_channel,
        interactive=interactive,
        detector=detector,
        device=device,
    )
    pipe.add_pipe("drop", roi_only=roi_only, drop_tiles=drop_tiles)
    pipe.add_pipe("restore_format")
    return pipe


def beads(
    data,
    flatfield=1.0,
    darkfield=0.0,
    overlap: int = 102,
    min_bead_diameter: int = 10,
    max_bead_diameter: int = 50,
    low_edge_quantile: float = 0.1,
    high_edge_quantile: float = 0.9,
    num_iter: int = 5000000,
    min_roundness: float = 0.3,
    roi_length=None,
    search_channel=None,
    roi_only: bool = False,
    drop_tiles: bool = True,
    interactive: bool = False,
    detector: str = "auto",
    device="cuda",
):
    """Find beads in images and return the standardized dataset.

    Parameters
    ----------
    data :
        DataArray/Dataset, or a sequence of them (paths are not ported yet).
    flatfield, darkfield :
        Scalar or array factors for illumination correction.
    overlap :
        Pixels to crop between adjacent tiles while stitching.
    min_bead_diameter, max_bead_diameter :
        Detection diameter bounds in pixels.
    low_edge_quantile, high_edge_quantile :
        Gradient-magnitude quantiles for the Canny thresholds (0..1).
    num_iter :
        Accepted for parity with ``magnify_tpu.beads``; the dense detector
        scores every candidate and ignores it.
    min_roundness :
        Minimum perimeter-alignment score for accepted beads (0..1).
    roi_length :
        ROI window edge length (default ``2 * max_bead_diameter``).
    search_channel :
        Channel(s) used for detection (default: all); beads found in later
        channels within ``2 * min_radius`` of an earlier find are dropped
        as duplicates.
    roi_only :
        Return only the roi DataArray.
    drop_tiles :
        Remove the tile variable after stitching.
    interactive :
        Not ported yet; True raises.
    detector :
        "auto" or "dense" (both the dense detector); "ransac" raises.
    device :
        Torch device of the detector ("cuda", "cuda:1", "cpu", ...).

    Returns
    -------
    Dataset with a ``roi`` (mark, channel, time, roi_y, roi_x) variable and
    ``fg``/``bg``/``x``/``y``/``valid`` coordinates over marks.
    """
    return beads_pipe(
        flatfield=flatfield,
        darkfield=darkfield,
        overlap=overlap,
        min_bead_diameter=min_bead_diameter,
        max_bead_diameter=max_bead_diameter,
        low_edge_quantile=low_edge_quantile,
        high_edge_quantile=high_edge_quantile,
        num_iter=num_iter,
        min_roundness=min_roundness,
        roi_length=roi_length,
        search_channel=search_channel,
        roi_only=roi_only,
        drop_tiles=drop_tiles,
        interactive=interactive,
        detector=detector,
        device=device,
    )(data=data)
