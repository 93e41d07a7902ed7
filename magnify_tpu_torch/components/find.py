"""Bead finding (``find_beads``) and chip-button finding (``find_buttons``)
on one device, with the dense or the RANSAC detector.

:class:`BeadFinder` is the torch port of the in-memory dense path of
``magnify_tpu.components.find.BeadFinder`` (``_fused_dense``):

* uint8 normalization of the search planes (t = 0): uint16 planes go to
  the device raw and are normalized there
  (:func:`magnify_tpu_torch.ops.detect.upload_planes_u8`, the same
  bits); planes of other dtypes, and every plane under a mesh, in the
  tuning UI, the stream and out of core, on the host;
* device: per-channel dense detection + greedy NMS
  (:func:`magnify_tpu_torch.ops.detect.detect_dense`), then the
  cross-channel dedupe (a circle within ``2 * min_radius`` of a surviving
  circle of an earlier search channel drops);
* ownership fg/bg masks on the finder's device
  (:func:`magnify_tpu_torch.ops.geom.bead_ownership`: on a card its CUDA
  kernel, on the CPU the JAX package's numpy code; the same bits), host
  ROI crops and the output coordinates.

Marks come out channel-major and, within a channel, best score first — the
JAX package's order. With ``detector="ransac"`` each search channel goes
through :func:`magnify_tpu_torch.ops.detect.detect_ransac` (the JAX
package's unfused ``BeadFinder.__call__``: ``num_iter`` threefry proposals
from seed 0, the exact perimeter scorer or, with ``MAGNIFY_TPU_SCORER=conv``,
the int8 score maps) and the channels are deduped on
the host by KD-tree; the masks and crops are the same code. The
interactive UI raises.

A stack larger than :data:`MAX_RESIDENT_BYTES` is processed out of core,
as the JAX package's unfused ``BeadFinder.__call__`` does it: each search
plane (t = 0) is read alone, normalized to uint8 on the host and detected
on the device, the channels are deduped on the host by KD-tree, and
:meth:`BeadFinder._finish_streamed` fills a disk-backed ROI store one
(channel, time) plane at a time with the next plane read ahead. Peak host
memory is then a few planes, whatever the stack's size. The marks are
those of the in-memory path.

:meth:`BeadFinder.stream` runs the same three phases for a sequence of
frames with consecutive frames overlapped: a producer thread does the host
phase and a pinned, asynchronous upload up to ``depth`` frames ahead, the
calling thread detects in input order, and one worker thread assembles
masks and crops (and runs the pipeline's later components) behind it.

:class:`ButtonFinder` is the port of ``ButtonFinder``'s fused dense timestep
(``_fused_timestep`` and ``_chip_fused_packed``). :func:`chip_fused` runs a
whole timestep on the device: per-channel dense detection + NMS +
cross-channel dedupe at the chamber radius, the 1-D grid-offset sweeps,
per-cluster regression and grid-line intersection
(:mod:`magnify_tpu_torch.ops.gridfit`), then one batched re-detection over
every chamber's crop (:func:`magnify_tpu_torch.ops.detect.detect_rois_dense`:
one hysteresis call and one ring correlation for all chambers of a search
channel). The host then crops the ROIs at the refined centers and
rasterizes the fg disk and the bg annulus. With ``detector="ransac"`` a
searched timestep takes the JAX package's unfused path instead:
:meth:`ButtonFinder.find_centers` (RANSAC per search channel on the raw
planes, a distance dedupe, and the numpy grid fit of this module:
:func:`cluster_1d`, :func:`label_clusters`, :func:`regress_clusters`) and
:meth:`ButtonFinder.find_rois` (one RANSAC + hill-climb batch over every
chamber crop per search channel,
:func:`magnify_tpu_torch.ops.detect.detect_best_in_rois`). The tuning UI
is not ported.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import contextvars
import math
import os
import threading
import warnings

import numpy as np
import scipy.spatial
import torch

from magnify_tpu_torch import diagnostics, utils
from magnify_tpu_torch.core import Variable
from magnify_tpu_torch.core.lazy import alloc_output
from magnify_tpu_torch.core.registry import components
from magnify_tpu_torch.ops import detect as ops_detect
from magnify_tpu_torch.ops import geom as ops_geom
from magnify_tpu_torch.ops import gridfit
from magnify_tpu_torch.parallel.streaming import DevicePrefetcher, PinnedUploader

__all__ = ["BeadFinder", "ButtonFinder", "MAX_RESIDENT_BYTES", "chip_fused",
           "cluster_1d", "label_clusters", "last_chip_timings",
           "regress_clusters"]

#: Bead stacks above this many bytes are processed out of core (per-plane
#: host reads, ROI crops streamed into a disk-backed store) instead of being
#: read into memory whole. Module-level, so tests can lower it.
MAX_RESIDENT_BYTES = 512 * 1024 * 1024

#: What the last chip timestep spent where (seconds, host clock). Dense:
#: ``upload_bytes``, ``upload_precision``, ``normalize_upload_s`` (host
#: quantization and the copy to the device), ``dispatch_pull_s`` (the device
#: timestep of :func:`chip_fused` up to its results on the host) and
#: ``host_crops_masks_s``, the JAX package's keys. RANSAC:
#: ``find_centers_s``, ``find_rois_s`` and ``n_unique`` (the unique
#: proposals of each search channel's whole-plane detection).
last_chip_timings: dict = {}

#: The sampler's grid cell, in pixels (the JAX package's finders pass 20).
GRID_LENGTH = 20

def _progress(iterable, enabled):
    if not enabled:
        return iterable
    try:
        import tqdm

        return tqdm.tqdm(iterable)
    except ImportError:
        return iterable


def _check_detector(detector: str) -> None:
    if detector not in ("auto", "dense", "ransac"):
        raise ValueError(f"unknown detector {detector!r}")


def _tuning_ui(interactive: bool):
    """The finder's tuning UI (``interactive=True``), else None."""
    if not interactive:
        return None
    from magnify_tpu_torch.plot.vis import InteractiveUI

    return InteractiveUI()


def _ransac_kw(finder) -> dict:
    """A finder's arguments of ``ops.detect.ransac_plane`` but the radii,
    the NMS distance and ``normalized`` (the JAX package's finders draw
    with seed 0)."""
    return dict(low_q=float(finder.low_edge_quantile),
                high_q=float(finder.high_edge_quantile),
                min_roundness=float(finder.min_roundness),
                grid_length=GRID_LENGTH, num_iter=int(finder.num_iter),
                seed=0)


def _channel_values(assay):
    if "channel" in assay.coords:
        return list(assay["channel"].values.tolist())
    return list(range(assay.sizes["channel"]))


def _channel_index(assay, channel):
    return _channel_values(assay).index(channel)


def _stack_bytes(assay) -> int:
    var = assay["image"]
    return int(np.prod(var.shape)) * np.dtype(var.dtype).itemsize


def _dedupe_host(beads, found, dedupe_dist):
    """The JAX package's unfused cross-channel dedupe: drop a ``found``
    circle within ``dedupe_dist`` of an earlier channel's kept circle."""
    if len(beads) > 0 and len(found) > 0:
        tree = scipy.spatial.KDTree(beads[:, :2])
        neighbors = tree.query_ball_point(found[:, :2], dedupe_dist)
        found = found[~np.array([len(nb) > 0 for nb in neighbors])]
    return np.concatenate([beads, found])


def _cross_channel_dedupe(blocks, dedupe_dist):
    """Drop a channel-k circle within ``dedupe_dist`` of a SURVIVING circle
    of an earlier channel (earlier channel wins). ``blocks``: per-channel
    (n_k, 3) accepted circles in search order. Returns their channel-major
    concatenation after the dedupe."""
    d2max = np.float32(dedupe_dist) ** 2
    kept = []
    for ck in blocks:
        if kept and len(ck):
            prev = torch.cat(kept)
            diff = (ck[:, None, :2] - prev[None, :, :2]).to(torch.int64)
            d2 = (diff * diff).sum(-1).to(torch.float32)
            ck = ck[~(d2 <= float(d2max)).any(dim=1)]
        kept.append(ck)
    return torch.cat(kept)


def _bead_windows(beads, h, w, roi_length):
    """The ROI windows' corners (tops, lefts) of ``beads``: L x L around
    each mark, clamped into the (h, w) image."""
    L = roi_length
    return (np.clip(beads[:, 0] - L // 2, 0, h - L),
            np.clip(beads[:, 1] - L // 2, 0, w - L))


def _bead_ownership(beads, h, w, roi_length, max_radius, device=None):
    """Ownership masks and ROI windows of the (n, 3) int marks ``beads``,
    ``(fg (n, L, L), bg, tops, lefts)``, under the span
    ``beads.ownership``: the windows' corners from :func:`_bead_windows`,
    the masks from :func:`magnify_tpu_torch.ops.geom.bead_ownership` on
    ``device`` (the finder's), which picks the route (the CUDA kernel on a
    card, the host's numpy pass on the CPU), then one copy back. The marks
    and corners copied to a card are counted in ``upload_bytes``; the span
    is then a device span and its host time includes the copy back."""
    device = torch.device("cpu" if device is None else device)
    tops, lefts = _bead_windows(beads, h, w, roi_length)
    host = [np.ascontiguousarray(a, np.int32) for a in (beads, tops, lefts)]
    with diagnostics.span("beads.ownership", device=device):
        masks = ops_geom.bead_ownership(
            *(torch.from_numpy(a).to(device) for a in host), roi_length,
            max_radius).cpu().numpy().view(bool)
    if device.type != "cpu":
        diagnostics.count("upload_bytes", sum(a.nbytes for a in host))
    return masks[0], masks[1], tops, lefts


def _bead_finalize_host(image, beads, roi_length, max_radius, *,
                        device=None):
    """Masks + ROI crops: ``image`` (C, T, H, W) numpy; the masks where
    :func:`_bead_ownership` puts them for ``device``, the crops on the
    host. Returns (fg (n, L, L), bg, rois (n, C, T, L, L), tops, lefts)."""
    h, w = image.shape[-2:]
    L = roi_length
    fg, bg, tops, lefts = _bead_ownership(beads, h, w, L, max_radius, device)
    rois = np.empty((len(beads),) + image.shape[:-2] + (L, L), image.dtype)
    for i in range(len(beads)):
        rois[i] = image[..., tops[i]:tops[i] + L, lefts[i]:lefts[i] + L]
    return fg, bg, rois, tops, lefts


class BeadFinder:
    """Find beads in a stitched image.

    ``detector``: "auto"/"dense" scores every (center, radius) and ignores
    ``num_iter``; "ransac" scores ``num_iter`` Monte-Carlo proposals per
    search channel with the exact perimeter scorer (with
    ``MAGNIFY_TPU_SCORER=conv``, out of the int8 score maps).
    ``MAGNIFY_TPU_DETECTOR`` overrides ``detector`` at each call."""

    def __init__(
        self,
        min_bead_diameter: int,
        max_bead_diameter: int,
        low_edge_quantile: float,
        high_edge_quantile: float,
        num_iter: int,
        min_roundness: float,
        roi_length: int | None,
        search_channel,
        interactive: bool,
        detector: str = "auto",
        device="cuda",
    ):
        if min_bead_diameter > max_bead_diameter:
            raise ValueError("min_bead_diameter must be <= max_bead_diameter.")
        _check_detector(detector)
        self.min_bead_radius = math.floor(min_bead_diameter / 2)
        self.max_bead_radius = math.ceil(max_bead_diameter / 2)
        self.low_edge_quantile = low_edge_quantile
        self.high_edge_quantile = high_edge_quantile
        self.num_iter = num_iter
        self.min_roundness = min_roundness
        self.detector = detector
        self.roi_length = (roi_length if roi_length is not None
                           else 2 * max_bead_diameter)
        self.search_channels = utils.to_list(search_channel)
        self.device = torch.device(device)
        self.gui = _tuning_ui(interactive)

    def __call__(self, assay):
        if _stack_bytes(assay) > MAX_RESIDENT_BYTES:
            return self._out_of_core(assay)
        image_np, planes = self._host_planes(assay)
        if self.gui is not None:
            beads = self._detect_each(ops_detect.normalize_planes_u8(planes))
        else:
            beads = self.detect(planes)
        return self._assemble(assay, image_np, beads)

    def _search_idxs(self, assay) -> list:
        search_channels = self.search_channels or _channel_values(assay)
        return [_channel_index(assay, c) if not isinstance(c, int) else c
                for c in search_channels]

    def _host_planes(self, assay):
        """Host phase of one frame: the image stack in memory and its raw
        search planes (S, H, W) at t = 0."""
        image_np = np.ascontiguousarray(assay.image.to_numpy())
        return image_np, image_np[self._search_idxs(assay), 0]

    def _out_of_core(self, assay):
        """A stack above :data:`MAX_RESIDENT_BYTES`: each search plane read
        and normalized alone and detected alone (the JAX package's
        ``magnify_tpu/components/find.py:767-801``) or, under a mesh with
        the dense detector, the normalized search planes streamed onto the
        mesh's bands (``parallel.streaming.DevicePrefetcher`` with the
        mesh) and detected as one batch over it (``find.py:737-765``); then
        the ROI store streamed by :meth:`_finish_streamed`."""
        from magnify_tpu_torch.parallel import mesh as mesh_mod

        def plane(ci):
            return ops_detect.normalize_planes_u8(
                assay.image.isel(time=0, channel=ci).to_numpy()[None])[0]

        idxs = self._search_idxs(assay)
        mesh = mesh_mod.sharded_mesh()
        if (self.gui is None and mesh is not None
                and ops_detect.resolve_detector(self.detector) == "dense"):
            beads = self.detect_planes([bands for _ci, bands in
                                        DevicePrefetcher(idxs, plane,
                                                         mesh=mesh)])
        else:
            beads = self._detect_each(plane(ci) for ci in idxs)
        return self._finish_streamed(assay, beads.astype(float))

    def _detect_each(self, planes) -> np.ndarray:
        """The JAX package's unfused detection: ``ops.detect.find_circles``
        on each uint8 search plane (with the tuning UI where there is one),
        a plane's circle within ``2 * min_radius`` of an earlier plane's
        kept circle dropped on the host. Returns the (n, 3) int32 marks."""
        beads = np.empty((0, 3))
        for plane in planes:
            found = ops_detect.find_circles(
                plane, float(self.low_edge_quantile),
                float(self.high_edge_quantile), GRID_LENGTH,
                int(self.num_iter), self.min_bead_radius,
                self.max_bead_radius, float(self.min_roundness),
                self.min_bead_radius, gui=self.gui, detector=self.detector,
                device=self.device)[0]
            beads = _dedupe_host(beads, found.astype(float),
                                 2 * self.min_bead_radius)
        return np.round(beads).astype(np.int32).reshape(-1, 3)

    def _finish_streamed(self, assay, beads):
        """Output allocation, ownership masks and ROI crops of an
        out-of-core stack: the crops stream in one (channel, time) plane at
        a time, the next plane read on a thread meanwhile, so peak host
        memory stays at a few planes whatever the stack's size.

        A disk-backed ROI store (``alloc_output`` makes one above
        ``core.lazy.RESIDENT_BYTES_LIMIT``) is filled through its file, one
        ``pwrite`` a crop, not through its mapping: a mapping's touched
        pages count in RSS until evicted, and one plane's crops touch the
        whole store, which spans every mark (the JAX package writes
        through the mapping and evicts it every 32 planes). The mapping
        sees the writes: it is the same file."""
        num_beads = len(beads)
        sizes = assay.sizes
        n_ch, n_t = sizes["channel"], sizes["time"]
        L = self.roi_length

        roi = alloc_output("roi", (num_beads, n_ch, n_t, L, L),
                           assay["image"].dtype)
        fg = alloc_output("fg", (num_beads, n_t, L, L), bool)
        bg = alloc_output("bg", (num_beads, n_t, L, L), bool)
        assay["roi"] = Variable(("mark", "channel", "time", "roi_y", "roi_x"),
                                roi)
        assay = assay.assign_coords(
            fg=(("mark", "time", "roi_y", "roi_x"), fg),
            bg=(("mark", "time", "roi_y", "roi_x"), bg),
            x=(("mark", "time"), np.repeat(beads[:, 1:2], n_t, axis=1)),
            y=(("mark", "time"), np.repeat(beads[:, 0:1], n_t, axis=1)),
            valid=(("mark", "time"), np.ones((num_beads, n_t), bool)),
        )
        if num_beads == 0:
            return assay

        ints = np.round(beads).astype(np.int32)
        fg1, bg1, tops, lefts = _bead_ownership(
            ints, sizes["im_y"], sizes["im_x"], L, self.max_bead_radius,
            self.device)
        fg[:] = fg1[:, None]
        bg[:] = bg1[:, None]

        planes = [(ci, t) for ci in range(n_ch) for t in range(n_t)]

        def read(idx):
            ci, t = idx
            return assay.image.isel(channel=ci, time=t).to_numpy()

        with contextlib.ExitStack() as stack:
            ex = stack.enter_context(
                concurrent.futures.ThreadPoolExecutor(max_workers=1))
            write = self._crop_writer(roi, stack)
            pending = ex.submit(read, planes[0])
            for k, (ci, t) in enumerate(planes):
                plane = pending.result()
                if k + 1 < len(planes):
                    pending = ex.submit(read, planes[k + 1])
                for i in range(num_beads):
                    write(i, ci, t, plane[tops[i]:tops[i] + L,
                                          lefts[i]:lefts[i] + L])
        assay.cache(["roi", "fg", "bg"])
        return assay

    @staticmethod
    def _crop_writer(roi, stack):
        """``write(i, ci, t, crop)`` into ``roi`` (mark, channel, time, L,
        L): an assignment for an array in memory, a ``pwrite`` into the
        file of a C-ordered memmap (the file is closed with ``stack``)."""
        if not isinstance(roi, np.memmap):
            def assign(i, ci, t, crop):
                roi[i, ci, t] = crop
            return assign
        fd = os.open(roi.filename, os.O_WRONLY)
        stack.callback(os.close, fd)
        dtype = roi.dtype
        crop_bytes = roi.shape[-2] * roi.shape[-1] * dtype.itemsize
        n_ch, n_t = roi.shape[1:3]

        def pwrite(i, ci, t, crop):
            at = roi.offset + ((i * n_ch + ci) * n_t + t) * crop_bytes
            os.pwrite(fd, np.ascontiguousarray(crop, dtype=dtype).data, at)
        return pwrite

    def _prepare_frame(self, assay, uploader):
        """Producer-thread half of one streamed frame: materialize the
        image, normalize the search planes on the host and start their
        asynchronous upload. Returns (assay, image_np, planes_dev, event),
        or (assay, None, None, None) for a stack above
        :data:`MAX_RESIDENT_BYTES`, which runs out of core."""
        if _stack_bytes(assay) > MAX_RESIDENT_BYTES:
            return (assay, None, None, None)
        image_np, planes = self._host_planes(assay)
        planes = ops_detect.normalize_planes_u8(planes)
        diagnostics.count("upload_bytes", planes.nbytes)
        return (assay, image_np) + uploader.upload(planes)

    def detect(self, planes: np.ndarray) -> np.ndarray:
        """Detection on raw search planes (S, H, W), normalized to uint8
        where :func:`magnify_tpu_torch.ops.detect.upload_planes_u8` decides:
        the (n, 3) int32 (row, col, radius) marks, channel-major, best
        first."""
        from magnify_tpu_torch.parallel import mesh as mesh_mod

        if mesh_mod.sharded_mesh() is not None:
            # The mesh cuts the host's planes into its bands.
            planes, _n = ops_detect.upload_planes_u8(planes, None)
        else:
            with diagnostics.span("beads.upload"):
                planes, _n = ops_detect.upload_planes_u8(planes, self.device)
        return self.detect_planes(planes)

    @diagnostics.span("beads.detect", device=True)
    def detect_planes(self, planes_dev) -> np.ndarray:
        """:meth:`detect` on planes that already lie on ``self.device`` (or,
        under a mesh, anywhere: they are cut into the mesh's bands, unless
        the stream has cut them, a list of ``parallel.mesh.PlaneBands``).
        Launches on the calling thread's current stream and waits for the
        marks. Dense detection under an active mesh of more than one device
        runs over its (batch = channels, space = rows) bands (the JAX
        package's ``_bead_detect_packed_mesh``); the cross-channel dedupe
        then runs on ``self.device``."""
        from magnify_tpu_torch.parallel import mesh as mesh_mod

        if ops_detect.resolve_detector(self.detector) == "ransac":
            return self._detect_ransac(torch.as_tensor(planes_dev))
        args = (float(self.low_edge_quantile), float(self.high_edge_quantile),
                float(self.min_roundness))
        kw = dict(min_radius=self.min_bead_radius,
                  max_radius=self.max_bead_radius,
                  min_dist=self.min_bead_radius)
        mesh = mesh_mod.sharded_mesh()
        if mesh is not None:
            blocks = [c.to(self.device) for c, _s in
                      mesh_mod.sharded_find_circles_batch(
                          planes_dev, mesh, *args, normalized=True, **kw)]
        else:
            blocks = [ops_detect.detect_dense(plane, *args, **kw)[0]
                      for plane in planes_dev]
        beads = _cross_channel_dedupe(blocks, 2.0 * self.min_bead_radius)
        return beads.cpu().numpy().astype(np.int32).reshape(-1, 3)

    def _detect_ransac(self, planes_dev: torch.Tensor) -> np.ndarray:
        """RANSAC per search channel (over the active mesh where it
        applies), then the JAX package's unfused cross-channel dedupe on
        the host (:func:`_dedupe_host`)."""
        beads = np.empty((0, 3))
        for plane in planes_dev:
            circles, _scores, _n = ops_detect.ransac_plane(
                plane.to(self.device), **_ransac_kw(self),
                min_radius=self.min_bead_radius,
                max_radius=self.max_bead_radius,
                min_dist=self.min_bead_radius, normalized=True)
            beads = _dedupe_host(beads, circles.cpu().numpy().astype(float),
                                 2 * self.min_bead_radius)
        return np.round(beads).astype(np.int32).reshape(-1, 3)

    @diagnostics.span("beads.assemble")
    def _assemble(self, assay, image_np, beads_i):
        """Ownership masks, ROI crops and coordinates from the marks."""
        sizes = assay.sizes
        n_ch, n_t = sizes["channel"], sizes["time"]
        L = self.roi_length
        n = len(beads_i)
        beads = beads_i.astype(float)

        with diagnostics.span("beads.finalize_host"):
            fg1, bg1, rois, _tops, _lefts = _bead_finalize_host(
                image_np, beads_i, L, self.max_bead_radius,
                device=self.device)
        roi = alloc_output("roi", (n, n_ch, n_t, L, L), assay["image"].dtype)
        fg = alloc_output("fg", (n, n_t, L, L), bool)
        bg = alloc_output("bg", (n, n_t, L, L), bool)
        roi[:] = rois
        fg[:] = fg1[:, None]
        bg[:] = bg1[:, None]

        assay["roi"] = Variable(("mark", "channel", "time", "roi_y", "roi_x"),
                                roi)
        assay = assay.assign_coords(
            fg=(("mark", "time", "roi_y", "roi_x"), fg),
            bg=(("mark", "time", "roi_y", "roi_x"), bg),
            x=(("mark", "time"), np.repeat(beads[:, 1:2], n_t, axis=1)),
            y=(("mark", "time"), np.repeat(beads[:, 0:1], n_t, axis=1)),
            valid=(("mark", "time"), np.ones((n, n_t), bool)),
        )
        if n > 0:
            assay.cache(["roi", "fg", "bg"])
        return assay

    def stream(self, inputs, *, reader, pre, post, depth: int = 2,
               pull_batch: int = 4):
        """Pipelined multi-frame bead pipeline (generator).

        Yields one finished Dataset per input frame, each bit-identical to
        running the single-frame pipeline on that frame alone, in input
        order, with the per-frame stages overlapped across frames:

        * the host pre-stages (``reader``, the ``pre`` components), the
          uint8 normalization and a pinned asynchronous upload run up to
          ``depth`` frames ahead on a producer thread;
        * detection runs on the calling thread, one frame at a time in
          input order (its hand kernels launch on the calling thread's
          stream, and their launch counters are plain module integers);
        * frame k's masks, ROI crops and ``post`` components run on one
          worker thread (with a CUDA stream of its own on a card, where
          the masks' kernel launches), while the calling thread already
          detects frame k+1. That kernel's launch counter is also a plain
          integer, and only one thread at a time adds to it: the worker
          alone while frames are pending, and the calling thread only
          once they are drained (the out-of-core frame below).

        A frame above :data:`MAX_RESIDENT_BYTES` is not read ahead: the
        frames before it are finished and yielded, then it runs the
        single-frame (out-of-core) path on the calling thread, as the JAX
        package's stream runs it.

        The detector waits for the device inside each frame (its survivor
        compaction and every NMS round read a count back), so there is no
        packed result to pull for several frames at once: ``pull_batch`` is
        validated and has no effect yet. What overlaps is host work (numpy
        releases the interpreter lock) with the calling thread's launches.
        With the RANSAC detector the frames run the single-frame path one
        after another on the calling thread, in order, as the JAX package's
        stream runs them.

        A producer failure is re-raised here after the frames before it;
        abandoning the generator releases the producer and the worker.
        """
        depth, pull_batch = int(depth), int(pull_batch)
        if depth < 1 or pull_batch < 1:
            raise ValueError("stream_depth and stream_pull_batch must be "
                             f">= 1 (got {depth}, {pull_batch})")
        if (self.gui is not None
                or ops_detect.resolve_detector(self.detector) == "ransac"):
            yield from self._serial_stream(inputs, reader, pre, post)
            return
        on_card = self.device.type == "cuda"
        # One frame being filled, ``depth`` + 1 queued, one in detection.
        uploader = PinnedUploader(self.device, slots=depth + 3)
        worker_stream = torch.cuda.Stream(self.device) if on_card else None

        queue: collections.deque = collections.deque()
        cv = threading.Condition()
        done = object()
        failure: list = []
        cancelled = threading.Event()

        def produce():
            try:
                for data in inputs:
                    for assay in reader(data=data):
                        if cancelled.is_set():
                            return
                        for _name, comp in pre:
                            assay = comp(assay)
                        item = self._prepare_frame(assay, uploader)
                        with cv:
                            while len(queue) > depth:
                                if cancelled.is_set():
                                    return
                                cv.wait()
                            queue.append(item)
                            cv.notify_all()
            except BaseException as e:  # re-raised in the consumer below
                failure.append(e)
            finally:
                with cv:
                    queue.append(done)
                    cv.notify_all()

        def assemble(assay, image_np, beads_i):
            side = (torch.cuda.stream(worker_stream) if on_card
                    else contextlib.nullcontext())
            with side:
                out = self._assemble(assay, image_np, beads_i)
                for _name, comp in post:
                    out = comp(out)
            return out

        thread = threading.Thread(target=produce, daemon=True,
                                  name="magnify-stream-producer")
        thread.start()
        # One worker keeps the yield order; the calling thread's steady
        # state is detection only.
        assembler = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="magnify-stream-assembly")
        pending: collections.deque = collections.deque()
        try:
            while True:
                with cv:
                    while not queue:
                        cv.wait()
                    item = queue.popleft()
                    cv.notify_all()
                if item is done:
                    break
                assay, image_np, planes_dev, event = item
                if planes_dev is None:
                    while pending:
                        yield pending.popleft().result()
                    out = self(assay)
                    for _name, comp in post:
                        out = comp(out)
                    yield out
                    continue
                beads_i = self.detect_planes(
                    uploader.receive(planes_dev, event))
                pending.append(
                    assembler.submit(assemble, assay, image_np, beads_i))
                while len(pending) > 1:
                    yield pending.popleft().result()
            while pending:
                yield pending.popleft().result()
            thread.join()
            if failure:
                raise failure[0]
        finally:
            # The consumer may abandon the generator mid-stream: release
            # the producer so it does not block forever holding buffers.
            cancelled.set()
            with cv:
                queue.clear()
                cv.notify_all()
            assembler.shutdown(wait=False, cancel_futures=True)

    def _serial_stream(self, inputs, reader, pre, post):
        """The stream without overlap: each frame through the pre-stages,
        :meth:`__call__` and the post-stages before the next is read."""
        for data in inputs:
            for assay in reader(data=data):
                for _name, comp in pre:
                    assay = comp(assay)
                out = self(assay)
                for _name, comp in post:
                    out = comp(out)
                yield out

    @components.register("find_beads")
    def make(
        min_bead_diameter: int,
        max_bead_diameter: int,
        low_edge_quantile: float,
        high_edge_quantile: float,
        num_iter: int,
        min_roundness: float,
        roi_length: int,
        search_channel,
        interactive: bool,
        detector: str = "auto",
        device="cuda",
    ):
        return BeadFinder(
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


# ---------------------------------------------------------------------------
# ButtonFinder
# ---------------------------------------------------------------------------

def _roi_corners(ys: torch.Tensor, xs: torch.Tensor, roi_length: int, h: int,
                 w: int):
    """(tops, lefts) int64 of the slid-not-shrunk ROI windows around f32
    centers, rounded half to even. A center that is not finite (a grid
    that could not be fitted) is taken as 0, on every device."""
    def corner(v, size):
        v = torch.nan_to_num(torch.round(v), nan=0.0, posinf=0.0, neginf=0.0)
        return torch.clamp(v.to(torch.int64) - roi_length // 2, 0,
                           size - roi_length)

    return corner(ys, h), corner(xs, w)


def _refine_chambers(planes, xs, ys, low_q, high_q, min_roundness, *,
                     roi_length, min_radius, max_radius):
    """Per-chamber re-detection: crop every chamber from every search plane
    (``planes`` (S, H, W)) and keep, per chamber, the best circle over the
    search channels (a later channel wins only with a strictly better
    score). Returns (circles (n, 3) int32 relative to the crop, scores (n,)
    f32, ``-inf`` where no channel found a circle)."""
    s, h, w = planes.shape
    tops, lefts = _roi_corners(ys, xs, roi_length, h, w)
    crops = ops_geom.extract_rois(planes, tops, lefts, roi_length)
    best_score = torch.full(xs.shape, -torch.inf, dtype=torch.float32,
                            device=planes.device)
    best_circle = torch.zeros((xs.shape[0], 3), dtype=torch.int32,
                              device=planes.device)
    for ci in range(s):
        circles, scores = ops_detect.detect_rois_dense(
            crops[:, ci], low_q, high_q, min_roundness,
            min_radius=min_radius, max_radius=max_radius)
        better = torch.isfinite(scores) & (scores > best_score)
        best_score = torch.where(better, scores, best_score)
        best_circle = torch.where(better[:, None], circles, best_circle)
    return best_circle, best_score


def _grid_stage(circles, penalty, ppr, ppc, *, h, w, num_rows, num_cols,
                row_dist, col_dist, top_chamber, left_chamber,
                chamber_radius):
    """Grid geometry from the detected centers (``circles`` (n, 3)): 1-D
    cluster sweeps (or fixed labelling where the first chamber's offset is
    given), robust per-cluster regression, and the intersection of the row
    and column lines. Returns (mark_x (R, C), mark_y, row_slope, col_slope,
    row_counts (R,), col_counts (C,)), f32."""
    ys = circles[:, 0].to(torch.float32)
    xs = circles[:, 1].to(torch.float32)
    valid = torch.ones(ys.shape, dtype=torch.bool, device=ys.device)

    def labels(points, chamber, total, count, dist, ideal):
        if chamber is None:
            return gridfit.cluster_1d_dev(
                points, valid, total_length=total, num_clusters=count,
                cluster_length=dist, ideal_num_points=ideal, penalty=penalty)
        return gridfit.label_clusters_dev(
            points, valid, offset=chamber, num_clusters=count,
            cluster_length=2 * chamber_radius,
            cluster_gap=dist - 2 * chamber_radius)

    row_labels = labels(ys, top_chamber, h, num_rows, row_dist, ppr)
    col_labels = labels(xs, left_chamber, w, num_cols, col_dist, ppc)
    in_cluster = (row_labels >= 0) & (col_labels >= 0)
    row_labels = torch.where(in_cluster, row_labels, -1)
    col_labels = torch.where(in_cluster, col_labels, -1)
    row_slope, row_intercepts, row_counts = gridfit.regress_clusters_dev(
        xs, ys, row_labels, num_clusters=num_rows, ideal_num_points=ppr)
    # Columns regress with the axes swapped to avoid near-vertical slopes.
    col_slope, col_intercepts, col_counts = gridfit.regress_clusters_dev(
        ys, xs, col_labels, num_clusters=num_cols, ideal_num_points=ppc)
    mark_y = (row_slope * col_intercepts[None, :] + row_intercepts[:, None]
              ) / (1 - row_slope * col_slope)
    mark_x = mark_y * col_slope + col_intercepts[None, :]
    return mark_x, mark_y, row_slope, col_slope, row_counts, col_counts


def _refine_on_mesh(planes, xs, ys, low_q, high_q, min_roundness, mesh, *,
                    roi_length, min_radius, max_radius):
    """:func:`_refine_chambers` with the chambers split over every device
    of ``mesh`` (the JAX package's ``_chip_mesh_finisher``): contiguous
    chunks, one a mesh device
    (:func:`magnify_tpu_torch.parallel.mesh.chunks_by_device`); the chunks
    of one device refined in one batch on a copy of the planes there.
    Results on the planes' device."""
    from magnify_tpu_torch.parallel import mesh as mesh_mod

    n = xs.shape[0]
    circle = torch.zeros((n, 3), dtype=torch.int32, device=planes.device)
    score = torch.zeros(n, dtype=torch.float32, device=planes.device)
    for dev, idx in mesh_mod.chunks_by_device(mesh, n):
        c, sc = _refine_chambers(
            planes.to(dev), xs[idx].to(dev), ys[idx].to(dev), low_q, high_q,
            min_roundness, roi_length=roi_length, min_radius=min_radius,
            max_radius=max_radius)
        circle[idx.to(planes.device)] = c.to(planes.device)
        score[idx.to(planes.device)] = sc.to(planes.device)
    return circle, score


def chip_fused(planes, low_q, high_q, high_q_roi, min_roundness, penalty,
               ppr, ppc, *, num_rows, num_cols, row_dist, col_dist,
               top_chamber, left_chamber, chamber_radius, min_radius,
               max_radius, roi_length, normalized=True, mesh=None):
    """A whole chip timestep on the device of ``planes``.

    ``planes`` (S, H, W) holds the search channels only, quantized on the
    host to uint8 values (``normalized``) or to uint16 values (then every
    plane and crop is normalized on the device). Detection + NMS per
    channel and the cross-channel dedupe at ``chamber_radius``, the grid
    stage, and the batched per-chamber re-detection at the intersected
    centers with ``high_q_roi`` as the upper Canny quantile. Returns a dict
    of tensors on that device: ``circle`` (R*C, 3) int32 relative to each
    chamber's crop, ``score`` (R*C,), ``mark_x``/``mark_y`` (R*C,) the grid
    intersections, ``n_centers``, ``row_slope``, ``col_slope``,
    ``row_counts`` (R,), ``col_counts`` (C,).

    With a ``mesh`` (the JAX package's ``_chip_fused_packed_mesh``) the
    detection runs over its (batch = channels, space = rows) bands and the
    chamber refinement over all its devices (:func:`_refine_on_mesh`); the
    dedupe and the grid stage stay on the device of ``planes``.
    """
    h, w = planes.shape[-2:]
    kw = dict(min_radius=min_radius, max_radius=max_radius,
              min_dist=int(chamber_radius))
    if mesh is not None:
        from magnify_tpu_torch.parallel import mesh as mesh_mod

        blocks = [c.to(planes.device) for c, _s in
                  mesh_mod.sharded_find_circles_batch(
                      planes, mesh, low_q, high_q, min_roundness,
                      normalized=normalized, **kw)]
    else:
        blocks = [ops_detect.detect_dense(plane, low_q, high_q, min_roundness,
                                          normalized=normalized, **kw)[0]
                  for plane in planes]
    centers = _cross_channel_dedupe(blocks, float(chamber_radius))
    mark_x, mark_y, row_slope, col_slope, row_counts, col_counts = \
        _grid_stage(centers, penalty, ppr, ppc, h=h, w=w, num_rows=num_rows,
                    num_cols=num_cols, row_dist=row_dist, col_dist=col_dist,
                    top_chamber=top_chamber, left_chamber=left_chamber,
                    chamber_radius=chamber_radius)
    args = (planes, mark_x.reshape(-1), mark_y.reshape(-1), low_q,
            high_q_roi, min_roundness)
    kw = dict(roi_length=roi_length, min_radius=min_radius,
              max_radius=max_radius)
    circle, score = (_refine_chambers(*args, **kw) if mesh is None
                     else _refine_on_mesh(*args, mesh, **kw))
    return dict(circle=circle, score=score, mark_x=mark_x.reshape(-1),
                mark_y=mark_y.reshape(-1), n_centers=centers.shape[0],
                row_slope=row_slope, col_slope=col_slope,
                row_counts=row_counts, col_counts=col_counts)


def _roi_windows(xs, ys, roi_length, h, w):
    """(tops, lefts) int32 of the windows around float64 centers, rounded
    half to even and slid (not shrunk) into the image: the JAX package's
    ``_extract_rois_host``."""
    tops = np.empty(len(xs), np.int32)
    lefts = np.empty(len(xs), np.int32)
    for i, (px, py) in enumerate(zip(xs, ys)):
        top, _, left, _ = utils.bounding_box(
            int(round(float(px))), int(round(float(py))), roi_length, w, h)
        tops[i], lefts[i] = top, left
    return tops, lefts


def _crop_rois_np(images, xs, ys, roi_length):
    """Host ROI crops at clamped windows: images (..., H, W) numpy, returns
    (n, ..., L, L)."""
    tops, lefts = _roi_windows(xs, ys, roi_length, *images.shape[-2:])
    out = np.empty((len(xs),) + images.shape[:-2]
                   + (roi_length, roi_length), images.dtype)
    for i, (top, left) in enumerate(zip(tops, lefts)):
        out[i] = images[..., top:top + roi_length, left:left + roi_length]
    return out


class ButtonFinder:
    """Find chip buttons on a grid.

    ``detector``: "auto"/"dense" runs the fused dense timestep and ignores
    ``num_iter``; "ransac" runs :meth:`find_centers` and :meth:`find_rois`
    with ``num_iter`` proposals for the whole plane and ``num_iter //
    n_chambers`` per chamber, scored by the exact perimeter scorer (with
    ``MAGNIFY_TPU_SCORER=conv``, out of the int8 score maps).
    ``MAGNIFY_TPU_DETECTOR`` overrides ``detector`` at each call."""

    def __init__(
        self,
        row_dist: float,
        col_dist: float,
        min_button_diameter: int,
        max_button_diameter: int,
        chamber_diameter: int,
        top_chamber,
        left_chamber,
        low_edge_quantile: float,
        high_edge_quantile: float,
        num_iter: int,
        min_roundness: float,
        cluster_penalty: float,
        roi_length: int | None,
        progress_bar: bool,
        search_timestep,
        search_channel,
        interactive: bool,
        detector: str = "auto",
        device="cuda",
    ):
        if min_button_diameter > max_button_diameter:
            raise ValueError("min_button_diameter must be <= max_button_diameter.")
        _check_detector(detector)
        self.row_dist = row_dist
        self.col_dist = col_dist
        self.min_button_radius = math.floor(min_button_diameter / 2)
        self.max_button_radius = math.ceil(max_button_diameter / 2)
        self.chamber_radius = round(chamber_diameter / 2)
        self.top_chamber = top_chamber
        self.left_chamber = left_chamber
        self.low_edge_quantile = low_edge_quantile
        self.high_edge_quantile = high_edge_quantile
        self.num_iter = num_iter
        self.min_roundness = min_roundness
        self.detector = detector
        self.cluster_penalty = cluster_penalty
        self.roi_length = (roi_length if roi_length is not None
                           else round(1.2 * chamber_diameter))
        self.progress_bar = progress_bar
        self.search_timesteps = sorted(utils.to_list(search_timestep))
        self.search_channels = utils.to_list(search_channel)
        self.device = torch.device(device)
        self.gui = _tuning_ui(interactive)

    def __call__(self, assay):
        search_channels = self.search_channels or _channel_values(assay)
        num_rows, num_cols = assay["tag"].shape
        sizes = assay.sizes
        n_ch, n_t = sizes["channel"], sizes["time"]
        L = self.roi_length

        with diagnostics.span("chip.alloc"):
            roi = alloc_output("roi", (num_rows, num_cols, n_ch, n_t, L, L),
                               assay["image"].dtype)
            fg = alloc_output("fg", (num_rows, num_cols, n_t, L, L), bool)
            bg = alloc_output("bg", (num_rows, num_cols, n_t, L, L), bool)
        x = np.zeros((num_rows, num_cols, n_t))
        y = np.zeros((num_rows, num_cols, n_t))
        valid = assay["valid"].transpose(
            "mark_row", "mark_col", "time").to_numpy().copy()
        tag = assay["tag"].to_numpy()

        search_idxs = [_channel_index(assay, c) for c in search_channels]
        # The fused timestep runs the dense detector without the tuning UI;
        # with it (or RANSAC) find_centers and find_rois run, as in the JAX
        # package.
        fused = (self.gui is None
                 and ops_detect.resolve_detector(self.detector) != "ransac")

        def load(t):
            with diagnostics.span("chip.load_timestep"):
                return assay.image.isel(time=int(t)).to_numpy()  # (C, H, W)

        for t in _progress(self.search_timesteps, self.progress_bar):
            images = load(t)
            if fused:
                (roi[:, :, :, t], fg[:, :, t], bg[:, :, t], x[..., t],
                 y[..., t], valid[..., t]) = self._fused_timestep(
                    images, tag, valid[..., t], search_idxs)
                continue
            # One upload per searched timestep, as f32 (uint16 values are
            # exact; torch indexes no uint16 tensors).
            with diagnostics.span("chip.upload"):
                images_dev = torch.as_tensor(np.ascontiguousarray(
                    images, dtype=np.float32)).to(self.device)
            diagnostics.count("upload_bytes", images_dev.nbytes)
            with diagnostics.span("chip.find_centers") as centers:
                x[..., t], y[..., t] = self.find_centers(
                    images_dev, search_idxs, tag)
            with diagnostics.span("chip.find_rois") as rois:
                (roi[:, :, :, t], fg[:, :, t], bg[:, :, t], x[..., t],
                 y[..., t], valid[..., t]) = self.find_rois(
                    images, images_dev, tag, x[..., t], y[..., t],
                    valid[..., t], search_idxs)
            last_chip_timings.update(find_centers_s=round(centers.seconds, 6),
                                     find_rois_s=round(rois.seconds, 6))

        # Timesteps that are not searched copy the positions and need ROI
        # crops only: host slicing, with the next plane's read prefetched
        # on a background thread.
        copy_ts = [t for t in range(n_t) if t not in self.search_timesteps]
        if copy_ts:
            with (diagnostics.span("chip.copy_timesteps"),
                  concurrent.futures.ThreadPoolExecutor(max_workers=1)
                  as pool):
                def submit(t):
                    # The read's span belongs to this call, on any thread.
                    return pool.submit(contextvars.copy_context().run, load,
                                       t)

                pending = submit(copy_ts[0])
                for i, t in enumerate(_progress(copy_ts, self.progress_bar)):
                    with diagnostics.span("chip.load_wait"):
                        images = pending.result()
                    if i + 1 < len(copy_ts):
                        pending = submit(copy_ts[i + 1])
                    with diagnostics.span("chip.copy_crop"):
                        copy_t = (self.search_timesteps[0]
                                  if t < self.search_timesteps[0] else t - 1)
                        xs = x[..., copy_t].reshape(-1)
                        ys = y[..., copy_t].reshape(-1)
                        crops = _crop_rois_np(images, xs, ys, L)
                        roi[:, :, :, t] = crops.reshape(num_rows, num_cols,
                                                        n_ch, L, L)
                        fg[:, :, t] = fg[:, :, copy_t]
                        bg[:, :, t] = bg[:, :, copy_t]
                        x[..., t] = x[..., copy_t]
                        y[..., t] = y[..., copy_t]
                        valid[..., t] = valid[..., copy_t]

        with diagnostics.span("chip.assemble"):
            assay["roi"] = Variable(
                ("mark_row", "mark_col", "channel", "time", "roi_y", "roi_x"),
                roi)
            assay = assay.assign_coords(
                fg=(("mark_row", "mark_col", "time", "roi_y", "roi_x"), fg),
                bg=(("mark_row", "mark_col", "time", "roi_y", "roi_x"), bg),
                x=(("mark_row", "mark_col", "time"), x),
                y=(("mark_row", "mark_col", "time"), y),
                valid=(("mark_row", "mark_col", "time"), valid),
            )
            assay = assay.stack(mark=("mark_row", "mark_col")).transpose(
                "mark", ...)
            assay.cache(["roi", "fg", "bg"])
        return assay

    def _fused_timestep(self, images_np, tag, valid_t, search_idxs):
        """One chip timestep: :func:`chip_fused` on ``self.device`` (over
        the active mesh, if it has more than one device), then host crops at
        the refined centers plus the fg/bg rasters. Only the search planes
        go to the device, quantized to uint8 (exactly the device's own
        normalization) or, where rare outliers compress the useful range,
        on the host to uint16
        (:func:`magnify_tpu_torch.ops.detect.choose_upload_precision`); the
        other channels' ROI crops are host slices. The uint8 planes are made
        where :func:`magnify_tpu_torch.ops.detect.upload_planes_u8`
        decides."""
        from magnify_tpu_torch.parallel import mesh as mesh_mod

        num_rows, num_cols = tag.shape
        L = self.roi_length
        h, w = images_np.shape[-2:]

        mesh = mesh_mod.sharded_mesh()
        with diagnostics.span("chip.normalize_upload") as upload:
            raw_planes = np.ascontiguousarray(images_np[list(search_idxs)])
            precision = ops_detect.choose_upload_precision(raw_planes)
            normalized = precision == "u8"
            if normalized:
                planes_dev, upload_bytes = ops_detect.upload_planes_u8(
                    raw_planes, self.device, mesh)
            else:
                # uint16 values, carried as f32 (exact): torch indexes no
                # uint16 tensors.
                planes_q = ops_detect.normalize_planes_u16(raw_planes)
                planes_dev = torch.as_tensor(
                    planes_q.astype(np.float32)).to(self.device)
                diagnostics.count("upload_bytes", planes_dev.nbytes)
                upload_bytes = planes_q.nbytes

        with diagnostics.span("chip.dispatch", self.device) as dispatch:
            for chamber, total, count, dist in (
                (self.top_chamber, h, num_rows, self.row_dist),
                (self.left_chamber, w, num_cols, self.col_dist),
            ):
                if chamber is None and gridfit.num_offsets(
                        total, count, dist) <= 0:
                    raise ValueError(
                        "cluster_1d: num_clusters * cluster_length exceeds "
                        "total_length."
                    )

            ppr = (tag != "").sum(axis=1).astype(np.float32)
            ppc = (tag != "").sum(axis=0).astype(np.float32)
            diagnostics.count("upload_bytes", ppr.nbytes + ppc.nbytes)
            high_q_roi = 1 - np.pi * self.min_button_radius / L**2
            out = chip_fused(
                planes_dev, float(self.low_edge_quantile),
                float(self.high_edge_quantile), float(high_q_roi),
                float(self.min_roundness), float(self.cluster_penalty),
                torch.as_tensor(ppr).to(self.device),
                torch.as_tensor(ppc).to(self.device), num_rows=num_rows,
                num_cols=num_cols,
                row_dist=float(self.row_dist), col_dist=float(self.col_dist),
                top_chamber=self.top_chamber, left_chamber=self.left_chamber,
                chamber_radius=int(self.chamber_radius),
                min_radius=self.min_button_radius,
                max_radius=self.max_button_radius, roi_length=L,
                normalized=normalized, mesh=mesh)
            circle = out["circle"].cpu().numpy()
            score = out["score"].cpu().numpy()
            mark_x = out["mark_x"].cpu().numpy()
            mark_y = out["mark_y"].cpu().numpy()
            row_counts = out["row_counts"].cpu().numpy()
            col_counts = out["col_counts"].cpu().numpy()

        with diagnostics.span("chip.crops_masks") as crops_masks:
            for cnt, ideal, edge in (
                (row_counts[0], ppr, 0), (row_counts[-1], ppr, num_rows - 1),
                (col_counts[0], ppc, 0), (col_counts[-1], ppc, num_cols - 1),
            ):
                if cnt < 2 and ideal[edge] >= 2:
                    diagnostics.log.warning(
                        "edge cluster %d has %d point(s); the chip grid is "
                        "unlikely to be segmented correctly", edge, int(cnt),
                    )

            placed = self._place_chambers(images_np, tag, circle, score,
                                          mark_x, mark_y, mark_x, mark_y)
        last_chip_timings.clear()
        last_chip_timings.update(
            upload_bytes=int(upload_bytes),
            upload_precision=precision,
            normalize_upload_s=round(upload.seconds, 6),
            dispatch_pull_s=round(dispatch.seconds, 6),
            host_crops_masks_s=round(crops_masks.seconds, 6),
        )
        return placed + (valid_t,)

    def _place_chambers(self, images_np, tag, circle, score, crop_x, crop_y,
                        mark_x, mark_y):
        """The chambers' outputs from the refinement's ``circle`` (n, 3)
        (relative to the crops cut at ``crop_y``/``crop_x``, as the device
        rounded those f32 centers) and ``score`` (n,): a refined chamber
        moves to its circle, the others keep ``mark_x``/``mark_y``; the ROIs
        are cropped from ``images_np`` at the final centers and the fg disk
        and bg annulus rasterized. Returns (roi, fg, bg, x, y) by (row,
        col)."""
        num_rows, num_cols = tag.shape
        L = self.roi_length
        n_ch, h, w = images_np.shape[0], *images_np.shape[-2:]
        tops, lefts = (a.numpy().astype(np.int32) for a in _roi_corners(
            torch.as_tensor(crop_y), torch.as_tensor(crop_x), L, h, w))
        with np.errstate(invalid="ignore"):
            refined = np.isfinite(score) & (tag.reshape(-1) != "")
            new_y = np.where(refined, circle[:, 0] + tops, mark_y)
            new_x = np.where(refined, circle[:, 1] + lefts, mark_x)
            radius = np.where(refined, circle[:, 2],
                              self.max_button_radius).astype(int)
        tops2, lefts2 = (a.numpy().astype(np.int32) for a in _roi_corners(
            torch.as_tensor(new_y), torch.as_tensor(new_x), L, h, w))
        crops = np.stack([
            images_np[..., t:t + L, le:le + L]
            for t, le in zip(tops2, lefts2)
        ])
        with np.errstate(invalid="ignore"):
            y_rel = np.round(new_y).astype(np.int32) - tops2
            x_rel = np.round(new_x).astype(np.int32) - lefts2
        centers_rel = np.stack([y_rel, x_rel], axis=1)
        fg_h = utils.disk_masks((L, L), centers_rel, radius)
        bg_h = utils.annulus_masks((L, L), centers_rel, self.chamber_radius,
                                   self.max_button_radius)
        return (
            crops.reshape(num_rows, num_cols, n_ch, L, L),
            fg_h.reshape(num_rows, num_cols, L, L),
            bg_h.reshape(num_rows, num_cols, L, L),
            new_x.astype(float).reshape(num_rows, num_cols),
            new_y.astype(float).reshape(num_rows, num_cols),
        )

    def find_centers(self, images_dev, search_idxs, tag):
        """Grid-constrained chamber centers (``ButtonFinder.find_centers``,
        its unfused branch): RANSAC (over the active mesh where it applies),
        or with the tuning UI ``ops.detect.find_circles`` with it, with
        either detector.

        Each search plane of ``images_dev`` (C, H, W) (raw values, f32) is
        normalized and searched on the device; a channel's circle within
        ``chamber_radius`` of an earlier channel's kept circle drops. The
        centers are clustered into rows and columns, each cluster's line
        fitted and the lines intersected, in numpy (float64). Returns
        (mark_x, mark_y) (R, C) float64.
        """
        min_button_dist = self.chamber_radius
        h, w = images_dev.shape[-2:]
        points = np.empty((0, 2))
        n_unique = []
        for ci in search_idxs:
            if self.gui is not None:
                found = ops_detect.find_circles(
                    images_dev[ci], float(self.low_edge_quantile),
                    float(self.high_edge_quantile), GRID_LENGTH,
                    int(self.num_iter), self.min_button_radius,
                    self.max_button_radius, float(self.min_roundness),
                    int(min_button_dist), gui=self.gui,
                    detector=self.detector,
                    device=images_dev.device)[0][:, :2].astype(float)
            else:
                circles, _scores, n_u = ops_detect.ransac_plane(
                    images_dev[ci], **_ransac_kw(self),
                    min_radius=self.min_button_radius,
                    max_radius=self.max_button_radius,
                    min_dist=int(min_button_dist), normalized=False)
                n_unique.append(n_u)
                found = circles[:, :2].cpu().numpy().astype(float)
            if len(points) > 0 and len(found) > 0:
                dists = np.linalg.norm(points[None] - found[:, None], axis=2)
                found = found[np.min(dists, axis=1) > min_button_dist]
            points = np.concatenate([points, found])
        last_chip_timings.clear()
        last_chip_timings["n_unique"] = n_unique

        xs, ys = points[:, 1], points[:, 0]
        points_per_row = (tag != "").sum(axis=1)
        points_per_col = (tag != "").sum(axis=0)
        num_rows, num_cols = tag.shape
        if self.top_chamber is None:
            row_labels = cluster_1d(
                ys, total_length=h, num_clusters=num_rows,
                cluster_length=self.row_dist,
                ideal_num_points=points_per_row, penalty=self.cluster_penalty)
        else:
            row_labels = label_clusters(
                ys, offset=self.top_chamber, num_clusters=num_rows,
                cluster_length=2 * self.chamber_radius,
                cluster_gap=self.row_dist - 2 * self.chamber_radius)
        if self.left_chamber is None:
            col_labels = cluster_1d(
                xs, total_length=w, num_clusters=num_cols,
                cluster_length=self.col_dist,
                ideal_num_points=points_per_col, penalty=self.cluster_penalty)
        else:
            col_labels = label_clusters(
                xs, offset=self.left_chamber, num_clusters=num_cols,
                cluster_length=2 * self.chamber_radius,
                cluster_gap=self.col_dist - 2 * self.chamber_radius)

        in_cluster = (row_labels >= 0) & (col_labels >= 0)
        xs, ys = xs[in_cluster], ys[in_cluster]
        col_labels = col_labels[in_cluster]
        row_labels = row_labels[in_cluster]
        row_slope, row_intercepts = regress_clusters(
            xs, ys, labels=row_labels, num_clusters=num_rows,
            ideal_num_points=points_per_row)
        # Columns regress with the axes swapped to avoid near-vertical slopes.
        col_slope, col_intercepts = regress_clusters(
            ys, xs, labels=col_labels, num_clusters=num_cols,
            ideal_num_points=points_per_col)
        mark_y = (row_slope * col_intercepts[None] + row_intercepts[:, None]
                  ) / (1 - row_slope * col_slope)
        mark_x = mark_y * col_slope + col_intercepts[None]
        return mark_x, mark_y

    def find_rois(self, images_np, images_dev, tag, x, y, valid,
                  search_idxs):
        """Per-chamber refinement (``ButtonFinder.find_rois``): with the
        dense detector (the tuning UI's path) one dense re-detection batch
        over every chamber, as in the fused timestep; otherwise by RANSAC,
        as follows.

        Every chamber is cropped at its grid center (``images_dev``, the
        timestep's (C, H, W) f32 planes) and each search channel's crops go
        through one :func:`~magnify_tpu_torch.ops.detect.detect_best_in_rois`
        batch with ``num_iter // n_chambers`` proposals per crop; a later
        channel wins a chamber only with a strictly better score. Refined
        chambers move to the detected center, the others keep their grid
        intersection. The ROIs are then cropped from ``images_np`` at the
        final centers and the fg disk / bg annulus rasterized on the host.
        """
        num_rows, num_cols = tag.shape
        n = num_rows * num_cols
        n_ch = images_np.shape[0]
        L = self.roi_length
        h, w = images_np.shape[-2:]
        xs = x.reshape(-1)
        ys = y.reshape(-1)
        high_q = 1 - np.pi * self.min_button_radius / L**2
        if ops_detect.resolve_detector(self.detector) == "dense":
            # The JAX package's _chip_detect_dense: every chamber cropped
            # from the raw search planes at its f32 center and refined.
            dev = images_dev.device
            xs32 = torch.as_tensor(xs.astype(np.float32))
            ys32 = torch.as_tensor(ys.astype(np.float32))
            diagnostics.count("upload_bytes", xs32.nbytes + ys32.nbytes)
            circle, score = _refine_chambers(
                images_dev[search_idxs], xs32.to(dev), ys32.to(dev),
                float(self.low_edge_quantile), float(high_q),
                float(self.min_roundness), roi_length=L,
                min_radius=self.min_button_radius,
                max_radius=self.max_button_radius)
            return self._place_chambers(
                images_np, tag, circle.cpu().numpy(), score.cpu().numpy(),
                xs32, ys32, xs, ys) + (valid,)

        tops, lefts = _roi_windows(xs, ys, L, h, w)
        diagnostics.count("upload_bytes", tops.nbytes + lefts.nbytes)
        crops_dev = ops_geom.extract_rois(
            images_dev, torch.as_tensor(tops, device=images_dev.device),
            torch.as_tensor(lefts, device=images_dev.device), L)
        roi_iter = max(int(self.num_iter) // n, 1)
        best_score = np.full(n, -np.inf)
        best_circle = np.zeros((n, 3), np.int32)
        for ci in search_idxs:
            circles, scores, found = ops_detect.detect_best_in_rois(
                crops_dev[:, ci], self.low_edge_quantile, high_q,
                self.min_button_radius, self.max_button_radius,
                self.min_roundness, device=images_dev.device,
                detector="ransac", grid_length=GRID_LENGTH,
                num_iter=roi_iter)
            better = found & (scores > best_score)
            best_score = np.where(better, scores, best_score)
            best_circle = np.where(better[:, None], circles, best_circle)

        refined = np.isfinite(best_score) & (tag.reshape(-1) != "")
        new_y = np.where(refined, best_circle[:, 0] + tops, np.round(ys))
        new_x = np.where(refined, best_circle[:, 1] + lefts, np.round(xs))
        radius = np.where(refined, best_circle[:, 2], self.max_button_radius)
        out_x = np.where(refined, new_x.astype(float), xs)
        out_y = np.where(refined, new_y.astype(float), ys)

        # Re-crop at the refined centers so the button is centered.
        tops, lefts = _roi_windows(out_x, out_y, L, h, w)
        crops = _crop_rois_np(images_np, out_x, out_y, L)
        centers_rel = np.stack([np.round(out_y).astype(np.int32) - tops,
                                np.round(out_x).astype(np.int32) - lefts],
                               axis=1)
        fg = utils.disk_masks((L, L), centers_rel, radius)
        bg = utils.annulus_masks((L, L), centers_rel, self.chamber_radius,
                                 self.max_button_radius)
        return (
            crops.reshape(num_rows, num_cols, n_ch, L, L),
            fg.reshape(num_rows, num_cols, L, L),
            bg.reshape(num_rows, num_cols, L, L),
            out_x.reshape(num_rows, num_cols),
            out_y.reshape(num_rows, num_cols),
            valid,
        )

    @components.register("find_buttons")
    def make(
        row_dist: float,
        col_dist: float,
        min_button_diameter: int,
        max_button_diameter: int,
        chamber_diameter: int,
        top_chamber,
        left_chamber,
        low_edge_quantile: float,
        high_edge_quantile: float,
        num_iter: int,
        min_roundness: float,
        cluster_penalty: float,
        roi_length: int | None,
        progress_bar: bool,
        search_timestep,
        search_channel,
        interactive: bool,
        detector: str = "auto",
        device="cuda",
    ):
        return ButtonFinder(
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


# ---------------------------------------------------------------------------
# 1-D clustering + regression (host geometry of the RANSAC grid search)
# ---------------------------------------------------------------------------
# Numpy code copied from magnify_tpu.components.find: the RANSAC branch of
# find_centers fits the grid on the host in float64, and the device twins
# of ops/gridfit.py reduce in another order.

def cluster_1d(points: np.ndarray, total_length: int, num_clusters: int,
               cluster_length: float, ideal_num_points: np.ndarray,
               penalty: float) -> np.ndarray:
    """Exhaustive 1-D grid-offset sweep, vectorized over all offsets.

    Per-cluster point variance scaled by sqrt(ideal count) plus a quadratic
    count-mismatch penalty; empty clusters cost the per-offset maximum.
    Labels outliers -1.
    """
    n_offsets = total_length - round(num_clusters * cluster_length)
    if n_offsets <= 0:
        raise ValueError(
            "cluster_1d: num_clusters * cluster_length exceeds total_length."
        )
    permutation = np.argsort(points)
    pts = points[permutation]
    ideal = np.asarray(ideal_num_points, dtype=float)

    offsets = np.arange(n_offsets)[:, None]
    edges = np.arange(num_clusters + 1) * cluster_length + offsets  # (O, C+1)
    centers = (edges[:, 1:] + edges[:, :-1]) / 2

    spans = np.searchsorted(pts, edges)  # (O, C+1)
    s, e = spans[:, :-1], spans[:, 1:]
    counts = e - s

    p1 = np.concatenate([[0.0], np.cumsum(pts)])
    p2 = np.concatenate([[0.0], np.cumsum(pts**2)])
    sum1 = p1[e] - p1[s]
    sum2 = p2[e] - p2[s]
    sq_dev = sum2 - 2 * centers * sum1 + counts * centers**2

    with np.errstate(invalid="ignore", divide="ignore"):
        var = np.where(counts > 0, sq_dev / np.maximum(counts, 1), 0.0)
    row_max = var.max(axis=1, keepdims=True)
    var = np.where(counts == 0, row_max, var)
    cost = var * np.sqrt(ideal) + penalty * (ideal - counts) ** 2
    totals = cost.sum(axis=1)
    best = int(np.argmin(totals))
    best_spans = spans[best]

    labels = -np.ones(len(pts), dtype=int)
    labels[best_spans[0]: best_spans[-1]] = np.repeat(
        np.arange(num_clusters), best_spans[1:] - best_spans[:-1]
    )
    return labels[np.argsort(permutation)]


def label_clusters(points, offset, num_clusters, cluster_length,
                   cluster_gap):
    """Fixed-geometry cluster labelling when the chip boundary is known:
    cluster ``i`` is ``[offset + i*(length+gap), ... + length)``; points
    outside every interval get -1."""
    points = np.asarray(points)
    pitch = cluster_length + cluster_gap
    starts = offset + np.arange(num_clusters) * pitch
    slot = np.searchsorted(starts, points, side="right") - 1
    clipped = np.clip(slot, 0, num_clusters - 1)
    inside = (slot >= 0) & (points < starts[clipped] + cluster_length)
    return np.where(inside, clipped, -1).astype(int)


def _linregress(x, y):
    x = np.asarray(x, float)
    y = np.asarray(y, float)
    xm, ym = x.mean(), y.mean()
    denom = ((x - xm) ** 2).sum()
    if denom == 0:
        return np.nan, ym
    slope = ((x - xm) * (y - ym)).sum() / denom
    return slope, ym - slope * xm


def _grouped_slopes(x, y, labels, num_clusters):
    """Least-squares slope per label via grouped sums; NaN where a cluster
    has fewer than 2 points (or zero x-variance)."""
    ok = labels >= 0
    lbl, xs, ys = labels[ok], x[ok], y[ok]
    n = np.bincount(lbl, minlength=num_clusters).astype(float)
    sx = np.bincount(lbl, weights=xs, minlength=num_clusters)
    sy = np.bincount(lbl, weights=ys, minlength=num_clusters)
    sxx = np.bincount(lbl, weights=xs * xs, minlength=num_clusters)
    sxy = np.bincount(lbl, weights=xs * ys, minlength=num_clusters)
    denom = n * sxx - sx**2
    with np.errstate(invalid="ignore", divide="ignore"):
        slopes = np.where((n >= 2) & (denom != 0),
                          (n * sxy - sx * sy) / np.where(denom == 0, 1, denom),
                          np.nan)
    return slopes, n.astype(int)


def regress_clusters(x: np.ndarray, y: np.ndarray, labels: np.ndarray,
                     num_clusters: int, ideal_num_points: np.ndarray) -> tuple:
    """Robust per-cluster line fits: the median of the per-cluster
    least-squares slopes, per-cluster median intercepts under that slope,
    blended with an evenly spaced intercept lattice by how full each
    cluster is. Returns (slope, intercepts (num_clusters,))."""
    x = np.asarray(x, float)
    y = np.asarray(y, float)
    labels = np.asarray(labels)
    ideal = np.asarray(ideal_num_points)
    if num_clusters == 1:
        if len(x) == 1:
            return 0, y
        slope, intercept = _linregress(x, y)
        return slope, np.atleast_1d(intercept)

    slopes, counts = _grouped_slopes(x, y, labels, num_clusters)
    for edge in (0, num_clusters - 1):
        if counts[edge] < 2 and ideal[edge] >= 2:
            diagnostics.log.warning(
                "edge cluster %d has %d point(s); the chip grid is unlikely "
                "to be segmented correctly", edge, counts[edge],
            )

    with np.errstate(invalid="ignore"), warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        slope = np.nanmedian(slopes)
    if np.isnan(slope):
        # Every cluster has <= 1 point: take the grid lines as axis-aligned.
        slope = 0.0
    residuals = y - slope * x
    intercepts = np.full(num_clusters, np.nan)
    for i in np.flatnonzero(counts):
        intercepts[i] = np.median(residuals[labels == i])

    observed = ~np.isnan(intercepts)
    lattice_m, lattice_b = _linregress(np.flatnonzero(observed),
                                       intercepts[observed])
    lattice = lattice_m * np.arange(num_clusters) + lattice_b
    with np.errstate(invalid="ignore", divide="ignore"):
        weight = np.minimum(counts, ideal) / np.where(ideal == 0, 1, ideal)
    use_local = observed & (ideal != 0)
    blended = np.where(
        use_local,
        weight * np.where(observed, intercepts, 0.0) + (1 - weight) * lattice,
        lattice,
    )
    return slope, blended
