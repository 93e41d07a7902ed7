"""Double-buffered host -> device streaming.

Torch port of ``magnify_tpu.parallel.streaming``: while the card works on
block t, a loader thread is already decoding block t+1 into a pinned host
buffer and copying it over on a side CUDA stream. The copy is asynchronous
(``non_blocking=True`` from pinned memory); an event recorded behind it
orders the consumer's stream after it. On ``device="cpu"`` the same thread
and queue run with no copy.
"""

from __future__ import annotations

import collections
import threading
from collections.abc import Callable, Iterable, Iterator

import numpy as np
import torch

from magnify_tpu_torch.parallel.mesh import PlaneBands, row_pad

__all__ = ["DevicePrefetcher", "MeshUploader", "PinnedUploader",
           "stream_planes"]


class PinnedUploader:
    """Asynchronous uploads of numpy blocks through a ring of pinned buffers.

    :meth:`upload` (loader thread) copies a block into the next pinned
    buffer and starts its transfer on a side stream; :meth:`receive`
    (consumer thread) makes the consumer's current stream wait for that
    transfer. A pinned buffer is refilled only after the transfer that read
    it has finished (one event per buffer), so any number of uploads may be
    in flight. On a CPU device both calls pass the block through as a
    tensor that shares the array's memory.
    """

    def __init__(self, device, slots: int = 3):
        self.device = torch.device(device)
        self._on_card = self.device.type == "cuda"
        self._slots = [None] * max(1, slots)   # (pinned tensor, copy event)
        self._next = 0
        self._stream = torch.cuda.Stream(self.device) if self._on_card else None

    def upload(self, block: np.ndarray):
        """Start moving ``block`` to the device; returns (tensor, event)."""
        src = torch.from_numpy(np.ascontiguousarray(block))
        if not self._on_card:
            return src, None
        slot = self._next
        self._next = (slot + 1) % len(self._slots)
        held = self._slots[slot]
        if held is not None:
            held[1].synchronize()
        if (held is None or held[0].shape != src.shape
                or held[0].dtype != src.dtype):
            pinned = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        else:
            pinned = held[0]
        pinned.copy_(src)
        with torch.cuda.stream(self._stream):
            out = pinned.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
        self._slots[slot] = (pinned, event)
        return out, event

    def receive(self, tensor: torch.Tensor, event) -> torch.Tensor:
        """Order the calling thread's current stream behind the upload of
        ``tensor`` and tell the allocator that this stream uses it."""
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            tensor.record_stream(stream)
        return tensor


class MeshUploader:
    """:class:`PinnedUploader` for a mesh: each uploaded plane (H, W) is
    REFLECT_101-padded to the mesh's row bands and cut into them, band
    ``s`` to the space device ``s`` of one batch row (the rows take the
    planes in turn), each through the pinned ring of its device.
    :meth:`receive` gives the plane as a
    :class:`~magnify_tpu_torch.parallel.mesh.PlaneBands`, which
    ``sharded_find_circles_batch`` takes as it is."""

    def __init__(self, mesh, slots: int = 3):
        self.mesh = mesh
        self._uploaders = {d: PinnedUploader(d, slots)
                           for d in dict.fromkeys(mesh.devices.flat)}
        self._row = 0

    def upload(self, block: np.ndarray):
        rows = self.mesh.devices[self._row % self.mesh.devices.shape[0]]
        self._row += 1
        h = block.shape[-2]
        pad_h = row_pad(h, len(rows))
        if pad_h >= h:
            raise ValueError(f"cannot reflect-pad {h} rows by {pad_h}; use "
                             "fewer 'space' shards for this image.")
        if pad_h:
            block = np.concatenate([block, block[h - 1 - pad_h:h - 1][::-1]])
        out = [self._uploaders[d].upload(b)
               for d, b in zip(rows, np.split(block, len(rows)))]
        return PlaneBands([t for t, _e in out], h), [e for _t, e in out]

    def receive(self, plane, events):
        return PlaneBands([self._uploaders[b.device].receive(b, e)
                           for b, e in zip(plane.bands, events)],
                          plane.height)


class DevicePrefetcher:
    """Iterate (key, device_tensor) with IO + transfer overlapped.

    ``loader(key) -> np.ndarray`` runs on a background thread (decoding,
    memmap reads); the block goes straight into a pinned buffer and its
    asynchronous copy, up to ``depth`` blocks ahead, so consumers receive
    tensors that are usually already resident when they are needed. With a
    ``mesh`` each block, a plane (H, W), arrives as its row bands on the
    mesh's devices (:class:`MeshUploader`).
    """

    def __init__(self, keys: Iterable, loader: Callable, depth: int = 2,
                 device="cuda", mesh=None):
        self.keys = list(keys)
        self.loader = loader
        self.depth = max(1, depth)
        self.device = torch.device(device)
        self.mesh = mesh

    def __iter__(self) -> Iterator:
        queue: collections.deque = collections.deque()
        cv = threading.Condition()
        done = object()
        failure: list = []
        cancelled = threading.Event()
        # One block being filled, ``depth`` queued, one with the consumer.
        uploader = (PinnedUploader(self.device, slots=self.depth + 2)
                    if self.mesh is None else
                    MeshUploader(self.mesh, slots=self.depth + 2))

        def produce():
            try:
                for key in self.keys:
                    if cancelled.is_set():
                        return
                    item = uploader.upload(self.loader(key))
                    with cv:
                        while len(queue) >= self.depth:
                            if cancelled.is_set():
                                return
                            cv.wait()
                        queue.append((key,) + item)
                        cv.notify_all()
            except BaseException as e:  # re-raised in the consumer below
                failure.append(e)
            finally:
                with cv:
                    queue.append(done)
                    cv.notify_all()

        thread = threading.Thread(target=produce, daemon=True,
                                  name="magnify-prefetch")
        thread.start()
        try:
            while True:
                with cv:
                    while not queue:
                        cv.wait()
                    item = queue.popleft()
                    cv.notify_all()
                if item is done:
                    break
                key, tensor, event = item
                yield key, uploader.receive(tensor, event)
            thread.join()
            if failure:
                raise failure[0]
        finally:
            # The consumer may abandon the iterator mid-stream (exception in
            # the for-body, generator GC): release the producer so it does
            # not block in cv.wait() forever holding device buffers.
            cancelled.set()
            with cv:
                queue.clear()
                cv.notify_all()


def stream_planes(dataset, var: str = "image", dims=("channel", "time"),
                  depth: int = 2, device="cuda", mesh=None):
    """Stream (index, device_plane) pairs from a dataset variable.

    Iterates the cartesian product of ``dims`` (e.g. every channel x time
    plane of the stitched image), loading each plane from its (possibly
    lazy / memmapped) backing store on a background thread.

    With a ``mesh`` (:func:`magnify_tpu_torch.parallel.mesh.make_mesh`)
    each plane arrives as its row bands on the space devices of one batch
    row (a :class:`~magnify_tpu_torch.parallel.mesh.PlaneBands`), the rows
    taking the planes in turn (the counterpart of the JAX package's
    ``sharding=``): a list of them is a batch that
    ``sharded_find_circles_batch`` detects without a stop on one device.
    """
    da = dataset[var]
    used = [d for d in dims if d in da.dims]
    sizes = [dataset.sizes[d] for d in used]
    keys = list(np.ndindex(*sizes)) if sizes else [()]

    def loader(key):
        sub = da
        for d, i in zip(used, key):
            sub = sub.isel(**{d: int(i)})
        return sub.to_numpy()

    return DevicePrefetcher(keys, loader, depth=depth, device=device,
                            mesh=mesh)
