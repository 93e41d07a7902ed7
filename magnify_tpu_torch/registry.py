"""User-facing pipeline factories: ``beads``, ``mrbles``, their ``*_pipe``
forms and their ``*_stream`` generators.

The same parameters and defaults as ``magnify_tpu.registry``'s, plus
``device`` (default ``"cuda"``): the device the detector and the decoder run
on. The CPU runs the kernels' plain twins; a device that is missing raises.
"""

from __future__ import annotations

from magnify_tpu_torch.core.pipeline import Pipeline

__all__ = ["beads", "beads_pipe", "beads_stream", "mrbles", "mrbles_pipe",
           "mrbles_stream"]


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
