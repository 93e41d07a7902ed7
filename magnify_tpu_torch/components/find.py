"""Bead finding (``find_beads``) with the dense detector on one device.

Torch port of the in-memory dense path of
``magnify_tpu.components.find.BeadFinder`` (``_fused_dense``):

* host: uint8 normalization of the search planes (t = 0);
* device: per-channel dense detection + greedy NMS
  (:func:`magnify_tpu_torch.ops.detect.detect_dense`), then the
  cross-channel dedupe (a circle within ``2 * min_radius`` of a surviving
  circle of an earlier search channel drops);
* host: ownership fg/bg masks and ROI crops (numpy, copied from the JAX
  package), and the output coordinates.

Marks come out channel-major and, within a channel, best score first — the
JAX package's order. Only the dense detector exists here: ``"ransac"``
and the interactive UI raise, and a lazy stack is read into memory whole
(the out-of-core path is not ported yet; ROADMAP, queue 1).

:meth:`BeadFinder.stream` runs the same three phases for a sequence of
frames with consecutive frames overlapped: a producer thread does the host
phase and a pinned, asynchronous upload up to ``depth`` frames ahead, the
calling thread detects in input order, and one worker thread assembles
masks and crops (and runs the pipeline's later components) behind it.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import math
import threading

import numpy as np
import scipy.spatial
import torch

from magnify_tpu_torch import utils
from magnify_tpu_torch.core import Variable
from magnify_tpu_torch.core.lazy import alloc_output
from magnify_tpu_torch.core.registry import components
from magnify_tpu_torch.ops import detect as ops_detect
from magnify_tpu_torch.ops import geom as ops_geom
from magnify_tpu_torch.parallel.streaming import PinnedUploader

__all__ = ["BeadFinder"]

# Budget for the (pairs, L, L) ownership temporaries.
_PAIR_CHUNK_BYTES = 32 << 20


def _channel_values(assay):
    if "channel" in assay.coords:
        return list(assay["channel"].values.tolist())
    return list(range(assay.sizes["channel"]))


def _channel_index(assay, channel):
    return _channel_values(assay).index(channel)


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


def _bead_ownership_host(beads, h, w, roi_length, max_radius):
    """Host fg/bg ownership masks + ROI windows (numpy).

    fg = pixels covered by this bead's disk only, bg = pixels covered by
    none; disks rasterized from the shared Bresenham extent LUT. Returns
    (fg (n, L, L), bg, tops, lefts).
    """
    n = len(beads)
    L = roi_length
    lut = ops_geom.extent_lut(max_radius)
    tops = np.clip(beads[:, 0] - L // 2, 0, h - L)
    lefts = np.clip(beads[:, 1] - L // 2, 0, w - L)

    fg = np.zeros((n, L, L), bool)
    count = np.zeros((n, L, L), np.int16)
    if n == 0:
        return fg, count == 0, tops, lefts

    # Neighbor lists: beads whose disks can reach a window (Chebyshev
    # distance from bead center to window center <= L/2 + max_radius).
    tree = scipy.spatial.KDTree(beads[:, :2])
    win_centers = np.stack([tops + L // 2, lefts + L // 2], axis=1)
    neighbor_lists = tree.query_ball_point(
        win_centers, L / 2 + max_radius + 1, p=np.inf)

    arange_l = np.arange(L)
    pairs_i = np.concatenate(
        [np.full(len(nb), i, np.int64) for i, nb in enumerate(neighbor_lists)]
    )
    pairs_j = np.concatenate(
        [np.asarray(nb, np.int64) for nb in neighbor_lists]
    )
    chunk = max(1, _PAIR_CHUNK_BYTES // max(L * L, 1))
    for s in range(0, len(pairs_i), chunk):
        pi = pairs_i[s:s + chunk]
        pj = pairs_j[s:s + chunk]
        r = np.clip(beads[pj, 2].astype(np.int64), 0, max_radius)
        dr = np.abs(tops[pi, None] + arange_l[None, :] - beads[pj, 0][:, None])
        width = np.where(dr <= r[:, None],
                         lut[r[:, None], np.minimum(dr, max_radius)], -1)
        dc = np.abs(lefts[pi, None] + arange_l[None, :]
                    - beads[pj, 1][:, None])
        cover = dc[:, None, :] <= width[:, :, None]  # (P, L, L)
        # pairs_i ascends, so each window's pairs form a contiguous run.
        ui, starts = np.unique(pi, return_index=True)
        count[ui] += np.add.reduceat(cover.astype(np.int16), starts, axis=0)
        self_rows = pi == pj
        fg[pi[self_rows]] = cover[self_rows]

    fg &= count == 1
    return fg, count == 0, tops, lefts


def _bead_finalize_host(image, beads, roi_length, max_radius):
    """Host masks + ROI crops: ``image`` (C, T, H, W) numpy. Returns
    (fg (n, L, L), bg, rois (n, C, T, L, L), tops, lefts)."""
    h, w = image.shape[-2:]
    L = roi_length
    fg, bg, tops, lefts = _bead_ownership_host(beads, h, w, L, max_radius)
    rois = np.empty((len(beads),) + image.shape[:-2] + (L, L), image.dtype)
    for i in range(len(beads)):
        rois[i] = image[..., tops[i]:tops[i] + L, lefts[i]:lefts[i] + L]
    return fg, bg, rois, tops, lefts


class BeadFinder:
    """Find beads in a stitched image with the dense detector.

    ``num_iter`` is accepted for parity with the JAX package and ignored:
    the dense detector scores every (center, radius)."""

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
        if detector not in ("auto", "dense", "ransac"):
            raise ValueError(f"unknown detector {detector!r}")
        if detector == "ransac":
            raise NotImplementedError(
                "the RANSAC detector is not ported yet (ROADMAP queue 1: "
                "RANSAC parity mode); use detector='dense' or 'auto'")
        if interactive:
            raise NotImplementedError(
                "the interactive tuning UI is not ported yet (ROADMAP "
                "queue 1: plot)")
        self.min_bead_radius = math.floor(min_bead_diameter / 2)
        self.max_bead_radius = math.ceil(max_bead_diameter / 2)
        self.low_edge_quantile = low_edge_quantile
        self.high_edge_quantile = high_edge_quantile
        self.min_roundness = min_roundness
        self.roi_length = (roi_length if roi_length is not None
                           else 2 * max_bead_diameter)
        self.search_channels = utils.to_list(search_channel)
        self.device = torch.device(device)

    def __call__(self, assay):
        image_np, planes = self._host_planes(assay)
        beads = self.detect(planes)
        return self._assemble(assay, image_np, beads)

    def _host_planes(self, assay):
        """Host phase of one frame: the image stack in memory and its uint8
        search planes (S, H, W) at t = 0."""
        search_channels = self.search_channels or _channel_values(assay)
        search_idxs = [
            _channel_index(assay, c) if not isinstance(c, int) else c
            for c in search_channels
        ]
        image_np = np.ascontiguousarray(assay.image.to_numpy())
        planes = ops_detect.normalize_planes_u8(image_np[search_idxs, 0])
        return image_np, planes

    def _prepare_frame(self, assay, uploader):
        """Producer-thread half of one streamed frame: materialize the
        image, normalize the search planes on the host and start their
        asynchronous upload. Returns (assay, image_np, planes_dev, event)."""
        image_np, planes = self._host_planes(assay)
        return (assay, image_np) + uploader.upload(planes)

    def detect(self, planes: np.ndarray) -> np.ndarray:
        """Dense detection on uint8 search planes (S, H, W): the (n, 3)
        int32 (row, col, radius) marks, channel-major, best first."""
        return self.detect_planes(torch.as_tensor(planes).to(self.device))

    def detect_planes(self, planes_dev: torch.Tensor) -> np.ndarray:
        """:meth:`detect` on planes that already lie on ``self.device``.
        Launches on the calling thread's current stream and waits for the
        marks."""
        blocks = []
        for plane in planes_dev:
            circles, _scores = ops_detect.detect_dense(
                plane, float(self.low_edge_quantile),
                float(self.high_edge_quantile), float(self.min_roundness),
                min_radius=self.min_bead_radius,
                max_radius=self.max_bead_radius,
                min_dist=self.min_bead_radius)
            blocks.append(circles)
        beads = _cross_channel_dedupe(blocks, 2.0 * self.min_bead_radius)
        return beads.cpu().numpy().astype(np.int32).reshape(-1, 3)

    def _assemble(self, assay, image_np, beads_i):
        """Ownership masks, ROI crops and coordinates from the marks."""
        sizes = assay.sizes
        n_ch, n_t = sizes["channel"], sizes["time"]
        L = self.roi_length
        n = len(beads_i)
        beads = beads_i.astype(float)

        fg1, bg1, rois, _tops, _lefts = _bead_finalize_host(
            image_np, beads_i, L, self.max_bead_radius
        )
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
          input order (the hand kernels launch on the calling thread's
          stream, and their launch counters are plain module integers);
        * frame k's masks, ROI crops and ``post`` components run on one
          worker thread (with a CUDA stream of its own on a card), while
          the calling thread already detects frame k+1.

        The detector waits for the device inside each frame (its survivor
        compaction and every NMS round read a count back), so there is no
        packed result to pull for several frames at once: ``pull_batch`` is
        validated and has no effect yet. What overlaps is host work (numpy
        releases the interpreter lock) with the calling thread's launches.

        A producer failure is re-raised here after the frames before it;
        abandoning the generator releases the producer and the worker.
        """
        depth, pull_batch = int(depth), int(pull_batch)
        if depth < 1 or pull_batch < 1:
            raise ValueError("stream_depth and stream_pull_batch must be "
                             f">= 1 (got {depth}, {pull_batch})")
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
