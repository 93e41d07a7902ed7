"""Overlap of host work, host-to-device copies and device work."""

from magnify_tpu_torch.parallel import streaming  # noqa: F401
from magnify_tpu_torch.parallel.streaming import DevicePrefetcher, stream_planes

__all__ = ["DevicePrefetcher", "stream_planes", "streaming"]
