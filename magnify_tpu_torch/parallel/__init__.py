"""Multi-device execution: device meshes (one process drives every device
of its mesh; several processes through ``torch.distributed``) and the
overlap of host work, host-to-device copies and device work."""

from magnify_tpu_torch.parallel import streaming  # noqa: F401
from magnify_tpu_torch.parallel.mesh import (
    active_mesh,
    make_mesh,
    sharded_detect_step,
    sharded_find_circles,
    sharded_find_circles_batch,
    sharded_find_circles_batch_packed,
    use_mesh,
)
from magnify_tpu_torch.parallel.multihost import (
    host_shard_keys,
    make_global_stack,
    multihost_mesh,
)
from magnify_tpu_torch.parallel.streaming import DevicePrefetcher, stream_planes

__all__ = ["DevicePrefetcher", "active_mesh", "host_shard_keys",
           "make_global_stack", "make_mesh", "multihost_mesh",
           "sharded_detect_step", "sharded_find_circles",
           "sharded_find_circles_batch", "sharded_find_circles_batch_packed",
           "stream_planes", "streaming", "use_mesh"]
