"""User-facing pipeline factories: ``beads``, ``mrbles``,
``microfluidic_chip``, ``image``, their ``*_pipe`` forms and the
``*_stream`` generators of the bead pipelines.

The same parameters and defaults as ``magnify_tpu.registry``'s, plus
``device`` (default ``"cuda"``): the device the detector and the decoder run
on. The CPU runs the kernels' plain twins; a device that is missing raises.
"""

from __future__ import annotations

from magnify_tpu_torch.core.pipeline import Pipeline
from magnify_tpu_torch.core.registry import (  # noqa: F401
    component,
    components,
    readers,
)

__all__ = ["CHIP_PRESETS", "beads", "beads_pipe", "beads_stream",
           "component", "components", "image", "image_pipe",
           "microfluidic_chip", "microfluidic_chip_pipe", "mrbles",
           "mrbles_pipe", "mrbles_stream", "readers"]

# Chip-type presets: (row, column) pitch in pixels.
CHIP_PRESETS = {
    "minichip": (375 / 1.61, 400 / 1.61),
    "pc": (406 / 3.22, 750 / 3.22),
    "ps": (375 / 3.22, 655 / 3.22),
}

def microfluidic_chip_pipe(
    shape=(8, 8),
    pinlist=None,
    blank=None,
    overlap: int = 102,
    rotation: int = 0,
    row_dist: float = 375 / 1.61,
    col_dist: float = 400 / 1.61,
    chip_type=None,
    min_button_diameter: int = 8,
    max_button_diameter: int = 30,
    chamber_diameter: int = 60,
    top_chamber=None,
    left_chamber=None,
    low_edge_quantile: float = 0.1,
    high_edge_quantile: float = 0.9,
    num_iter: int = 5000000,
    min_roundness: float = 0.2,
    cluster_penalty: float = 50,
    roi_length=None,
    progress_bar: bool = False,
    search_timestep=0,
    search_channel=None,
    roi_only: bool = False,
    drop_tiles: bool = True,
    interactive: bool = False,
    detector: str = "auto",
    device="cuda",
) -> Pipeline:
    """Build the button-finding pipeline for microfluidic chip images:
    read -> standardize_format -> identify_buttons -> stitch -> rotate ->
    find_buttons -> drop -> restore_format. ``rotate`` and ``find_buttons``
    run on ``device``."""
    if chip_type is not None:
        if chip_type not in CHIP_PRESETS:
            raise ValueError(
                f"Invalid chip type: {chip_type}. Must be one of "
                f"['pc', 'ps', 'minichip']"
            )
        row_dist, col_dist = CHIP_PRESETS[chip_type]

    pipe = Pipeline("read")
    pipe.add_pipe("standardize_format")
    pipe.add_pipe("identify_buttons", shape=shape, pinlist=pinlist, blank=blank)
    pipe.add_pipe("stitch", overlap=overlap)
    pipe.add_pipe("rotate", rotation=rotation, device=device)
    pipe.add_pipe(
        "find_buttons",
        row_dist=row_dist,
        col_dist=col_dist,
        min_button_diameter=min_button_diameter,
        max_button_diameter=max_button_diameter,
        chamber_diameter=chamber_diameter,
        top_chamber=top_chamber,
        left_chamber=left_chamber,
        low_edge_quantile=low_edge_quantile,
        high_edge_quantile=high_edge_quantile,
        num_iter=num_iter,
        min_roundness=min_roundness,
        cluster_penalty=cluster_penalty,
        roi_length=roi_length,
        progress_bar=progress_bar,
        search_timestep=search_timestep,
        search_channel=search_channel,
        interactive=interactive,
        detector=detector,
        device=device,
    )
    pipe.add_pipe("drop", roi_only=roi_only, drop_tiles=drop_tiles)
    pipe.add_pipe("restore_format")
    return pipe


def microfluidic_chip(
    data,
    shape=(8, 8),
    pinlist=None,
    blank=None,
    overlap: int = 102,
    rotation: int = 0,
    row_dist: float = 375 / 1.61,
    col_dist: float = 400 / 1.61,
    chip_type=None,
    min_button_diameter: int = 8,
    max_button_diameter: int = 30,
    chamber_diameter: int = 60,
    top_chamber=None,
    left_chamber=None,
    low_edge_quantile: float = 0.1,
    high_edge_quantile: float = 0.9,
    num_iter: int = 5000000,
    min_roundness: float = 0.2,
    cluster_penalty: float = 50,
    roi_length=None,
    progress_bar: bool = False,
    search_timestep=0,
    search_channel=None,
    roi_only: bool = False,
    drop_tiles: bool = True,
    interactive: bool = False,
    detector: str = "auto",
    device="cuda",
):
    """Find buttons in microfluidic-chip images and return the standardized
    dataset.

    Parameters
    ----------
    data :
        DataArray/Dataset, or a sequence of them (paths are not ported yet).
    shape :
        (rows, cols) of the button grid; every chamber is tagged
        "default". Either ``shape`` or ``pinlist`` must be given.
    pinlist :
        CSV with an ``Indices`` column of 1-indexed "(col, row)" pairs and a
        ``MutantID`` column of chamber names; ``blank`` values (default
        ["", "blank", "BLANK"]) become the empty tag.
    overlap :
        Pixels to crop between adjacent tiles while stitching.
    rotation :
        Degrees to rotate the stitched image about its center.
    row_dist, col_dist :
        Pitch between button rows/columns in pixels.
    chip_type :
        Preset pitch: "minichip", "pc", or "ps" (overrides
        row_dist/col_dist).
    min_button_diameter, max_button_diameter :
        Detection diameter bounds in pixels.
    chamber_diameter :
        Chamber diameter in pixels (sets the background annulus and the
        center-clustering distance).
    top_chamber, left_chamber :
        Known pixel offset of the first chamber edge; when given, row/col
        clustering uses the fixed geometry instead of the offset sweep.
    low_edge_quantile, high_edge_quantile :
        Gradient-magnitude quantiles for the Canny thresholds (0..1).
    num_iter :
        RANSAC proposals for the whole-plane search (``detector="ransac"``;
        each chamber's refinement gets ``num_iter // n_chambers``). The
        dense detector scores every candidate and ignores it.
    min_roundness :
        Minimum perimeter-alignment score for accepted buttons (0..1).
    cluster_penalty :
        Weight of the count-mismatch term in the row/col clustering cost.
    roi_length :
        ROI window edge length (default ``1.2 * chamber_diameter``).
    progress_bar :
        Show progress over timesteps.
    search_timestep :
        Timestep(s) to run detection on; others copy positions from the
        nearest searched timestep before them (or the first after).
    search_channel :
        Channel(s) used for detection (default: all).
    roi_only :
        Return only the roi DataArray.
    drop_tiles :
        Remove the tile variable after stitching.
    interactive :
        Not ported yet; True raises.
    detector :
        "auto" or "dense" (both the dense detector), or "ransac": the JAX
        package's unfused grid search, with Monte-Carlo circumcircle
        proposals from seed 0 scored by the exact perimeter ("gather")
        scorer, or with ``MAGNIFY_TPU_SCORER=conv`` read out of the int8
        score maps. ``MAGNIFY_TPU_DETECTOR``, read per call, overrides
        it.
    device :
        Torch device of the rotation and the button finder.

    Returns
    -------
    Dataset (or list of Datasets, one per assay) with ``roi`` plus
    ``fg``/``bg``/``x``/``y``/``tag``/``valid`` coordinates over
    ``mark = (mark_row, mark_col)``.
    """
    return microfluidic_chip_pipe(
        shape=shape,
        pinlist=pinlist,
        blank=blank,
        overlap=overlap,
        rotation=rotation,
        row_dist=row_dist,
        col_dist=col_dist,
        chip_type=chip_type,
        min_button_diameter=min_button_diameter,
        max_button_diameter=max_button_diameter,
        chamber_diameter=chamber_diameter,
        top_chamber=top_chamber,
        left_chamber=left_chamber,
        low_edge_quantile=low_edge_quantile,
        high_edge_quantile=high_edge_quantile,
        num_iter=num_iter,
        min_roundness=min_roundness,
        cluster_penalty=cluster_penalty,
        roi_length=roi_length,
        progress_bar=progress_bar,
        search_timestep=search_timestep,
        search_channel=search_channel,
        roi_only=roi_only,
        drop_tiles=drop_tiles,
        interactive=interactive,
        detector=detector,
        device=device,
    )(data=data)


def mrbles_pipe(
    spectra,
    codes,
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
    reference: str = "eu",
    roi_only: bool = False,
    drop_tiles: bool = True,
    interactive: bool = False,
    detector: str = "auto",
    device="cuda",
) -> Pipeline:
    """Build the MRBLEs pipeline: bead detection + spectral decoding, both
    on ``device``."""
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
    pipe.add_pipe("identify_mrbles", spectra=spectra, codes=codes,
                  reference=reference, device=device)
    pipe.add_pipe("drop", roi_only=roi_only, drop_tiles=drop_tiles)
    pipe.add_pipe("restore_format")
    return pipe


def mrbles(
    data,
    spectra,
    codes,
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
    reference: str = "eu",
    roi_only: bool = False,
    drop_tiles: bool = True,
    interactive: bool = False,
    detector: str = "auto",
    device="cuda",
):
    """Find and spectrally decode MRBLEs beads.

    Parameters
    ----------
    data :
        DataArray/Dataset, or a sequence of them (paths are not ported yet).
    spectra :
        CSV (path or file-like) of per-lanthanide emission across channels:
        a ``name`` column plus one column per imaging channel.
    codes :
        CSV of code compositions: a ``name`` column plus one column per
        lanthanide (ratios relative to the reference lanthanide).
    reference :
        The normalizing lanthanide name (default "eu").
    device :
        Torch device of the detector and the decoder.

    The other parameters are those of :func:`beads`.

    Returns
    -------
    Dataset with ``roi``, ``ln_vol``/``ln_ratio`` (mark, ln) variables, and
    a decoded per-bead ``tag`` coordinate ("outlier" for unassigned beads).
    """
    return mrbles_pipe(
        spectra=spectra,
        codes=codes,
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
        reference=reference,
        roi_only=roi_only,
        drop_tiles=drop_tiles,
        interactive=interactive,
        detector=detector,
        device=device,
    )(data=data)


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
        RANSAC proposals per search channel (``detector="ransac"``); the
        dense detector scores every candidate and ignores it.
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
        "auto" or "dense" (both the dense detector), or "ransac":
        Monte-Carlo circumcircle proposals from seed 0 scored by the exact
        perimeter ("gather") scorer, the JAX package's detector off the
        TPU (``MAGNIFY_TPU_SCORER=conv``: read out of the int8 score maps,
        its scorer on the TPU). ``MAGNIFY_TPU_DETECTOR``, read per call,
        overrides it.
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


def beads_stream(frames, *, stream_depth: int = 2, stream_pull_batch: int = 4,
                 **kwargs):
    """Pipelined multi-frame bead pipeline (generator).

    ``frames`` is an iterable of per-frame inputs (each anything
    :func:`beads` accepts); ``kwargs`` are the :func:`beads` parameters,
    ``device`` included. Yields one finished Dataset per frame,
    bit-identical to ``beads(frame, **kwargs)`` run alone and in input
    order, with consecutive frames' stages overlapped: the host pre-stages
    and the pinned uint8 upload of frames up to ``stream_depth`` ahead, the
    detection of frame k+1 and the host ROI/mask assembly of frame k run
    concurrently (``BeadFinder.stream``).

    ``stream_pull_batch`` is accepted for the JAX package's signature and
    validated, and has no effect yet: the port's detector waits for the
    device inside every frame, so there is no packed result to pull for
    several frames with one sync.
    """
    return _stream_from_pipe(beads_pipe(**kwargs), frames, stream_depth,
                             stream_pull_batch)


def mrbles_stream(frames, *, spectra, codes, stream_depth: int = 2,
                  stream_pull_batch: int = 4, **kwargs):
    """Pipelined multi-frame MRBLEs pipeline (generator).

    The :func:`beads_stream` overlap applied to the full MRBLEs chain: each
    frame's spectral decoding (``identify_mrbles``) runs on the assembly
    worker, overlapping the next frames' uploads and detection. Yields one
    decoded Dataset per frame, bit-identical to ``mrbles(frame, ...)`` run
    alone. ``spectra``/``codes`` file-likes are rewound per frame and read
    by the assembly worker only.
    """
    return _stream_from_pipe(
        mrbles_pipe(spectra=spectra, codes=codes, **kwargs), frames,
        stream_depth, stream_pull_batch,
    )


def _stream_from_pipe(pipe, frames, depth, pull_batch):
    """Split a bead-finding pipeline at find_beads and run its streaming
    executor (BeadFinder.stream): pre components feed the producer thread,
    post components (drop/restore, and identify_mrbles for the mrbles
    pipe) run per frame on the assembly worker."""
    split = pipe.component_names.index("find_beads")
    finder = pipe.components[split][1]
    return finder.stream(
        frames,
        reader=pipe.reader,
        pre=pipe.components[:split],
        post=pipe.components[split + 1:],
        depth=depth,
        pull_batch=pull_batch,
    )


def image_pipe(
    overlap: int = 102,
    rotation: float = 0,
    roi_only: bool = False,
    drop_tiles: bool = True,
    device="cuda",
) -> Pipeline:
    """Build the plain image-standardization pipeline (magnify
    registry.py:672-693): read -> standardize_format -> stitch -> rotate ->
    drop -> restore_format. ``rotate`` runs on ``device`` (a non-zero
    ``rotation`` only)."""
    pipe = Pipeline("read")
    pipe.add_pipe("standardize_format")
    pipe.add_pipe("stitch", overlap=overlap)
    pipe.add_pipe("rotate", rotation=rotation, device=device)
    pipe.add_pipe("drop", roi_only=roi_only, drop_tiles=drop_tiles)
    pipe.add_pipe("restore_format")
    return pipe


def image(data, overlap: int = 102, rotation: float = 0,
          roi_only: bool = False, drop_tiles: bool = True, device="cuda"):
    """Read and standardize images, stitching included (magnify
    registry.py:615-669)."""
    return image_pipe(overlap=overlap, rotation=rotation, roi_only=roi_only,
                      drop_tiles=drop_tiles, device=device)(data=data)
