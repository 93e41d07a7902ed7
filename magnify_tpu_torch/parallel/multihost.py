"""Meshes over several processes (hosts), with ``torch.distributed``.

Torch port of ``magnify_tpu.parallel.multihost``. Every process runs the
same program, joined by ``torch.distributed.init_process_group`` (gloo
between CPU processes, NCCL between cards):

* the load keys (tiff pages, zarr chunks, (channel, time) planes) are cut
  into equal contiguous blocks, one a process (:func:`host_shard_keys`), so
  each process reads only its own files and process ``p`` owns global
  batch rows ``[p * B, (p + 1) * B)``;
* :func:`multihost_mesh` lays the processes outer on the batch axis: each
  builds its own batch rows over its own cards, so the space axis (halo
  copies, the quantile gather, hysteresis rounds) stays inside a process;
* :func:`make_global_stack` names this process's block within the global
  batch. No image bytes cross processes: detection on a multihost mesh
  runs each process's batch rows locally
  (:func:`magnify_tpu_torch.parallel.mesh.sharded_find_circles_batch` of
  its block), and only small results cross, such as counts or RANSAC's
  unique proposals where its iterations split over the processes
  (:func:`magnify_tpu_torch.parallel.mesh.sharded_ransac_find_circles`).
  A finder under such a mesh is given every search plane on every
  process: each detects them all on its own devices (the same result on
  every process), and only RANSAC's proposals split over the processes.

With one process (``torch.distributed`` not initialized) every function
degenerates to the single-process behaviour.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from magnify_tpu_torch.parallel.mesh import Mesh, visible_cards

__all__ = ["GlobalStack", "host_shard_keys", "make_global_stack",
           "multihost_mesh"]


def _process() -> tuple[int, int]:
    """(rank, world size) of the initialized process group, else (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def host_shard_keys(keys, process_index: int | None = None,
                    process_count: int | None = None) -> list:
    """Deterministic contiguous-block partition of load keys across hosts.

    Host ``p`` loads ``keys[p*B : (p+1)*B]`` with ``B = len(keys) //
    process_count``: the layout :func:`make_global_stack` names (host ``p``
    owns global batch rows ``[p*B, (p+1)*B)``), so global batch index ``i``
    always holds the plane of ``keys[i]``. The defaults are this process's
    rank and the world size of ``torch.distributed`` (0 and 1 when it is
    not initialized). ``len(keys)`` must divide evenly by the host count:
    pad the key list (e.g. repeat trailing keys) or drop the remainder.
    """
    keys = list(keys)
    rank, world = _process()
    pi = rank if process_index is None else int(process_index)
    pc = world if process_count is None else int(process_count)
    if not 0 <= pi < pc:
        raise ValueError(f"process_index {pi} out of range for {pc} hosts")
    if len(keys) % pc:
        raise ValueError(
            f"len(keys) ({len(keys)}) must be a multiple of the host count "
            f"({pc}): make_global_stack names equal contiguous per-host "
            "blocks; pad the key list or drop the remainder.")
    block = len(keys) // pc
    return keys[pi * block:(pi + 1) * block]


def multihost_mesh(batch: int | None = None, space: int | None = None,
                   devices=None) -> Mesh:
    """(batch, space) mesh with hosts OUTER on the batch axis.

    Each process builds its ``batch // process_count`` rows over its own
    ``devices`` (default: every visible card; with none, it raises), so the
    space axis stays inside a process and only the small batch-axis results
    cross processes. Defaults: one batch row a process, its devices on the
    space axis. The batch axis must divide by the process count, and each
    process must hold ``batch // process_count * space`` devices.
    """
    rank, world = _process()
    if devices is None:
        devices = visible_cards("multihost_mesh")
    devs = list(np.asarray(devices, dtype=object).reshape(-1))
    if batch is None and space is None:
        batch, space = world, len(devs)
    elif batch is None:
        batch = world * (len(devs) // space)
    elif space is None:
        space = len(devs) // max(batch // world, 1)
    if batch % world:
        raise ValueError(
            f"batch axis ({batch}) must be divisible by the host count "
            f"({world}) so space collectives stay inside a host.")
    rows = batch // world
    if rows * space != len(devs):
        raise ValueError(f"batch*space must equal device count "
                         f"({len(devs) * world}).")
    return Mesh(np.asarray(devs, dtype=object).reshape(rows, space),
                process_index=rank, process_count=world)


class GlobalStack(NamedTuple):
    """This process's contiguous block ``planes`` of a global (B, H, W)
    plane batch: global rows ``offset .. offset + len(planes) - 1`` of
    ``global_batch``."""

    planes: np.ndarray
    global_batch: int
    offset: int


def make_global_stack(local_planes: np.ndarray, mesh: Mesh,
                      global_batch: int | None = None) -> GlobalStack:
    """Name ``local_planes``, this host's contiguous block of the global
    batch (host ``p`` owns planes ``[p*B/n, (p+1)*B/n)``), within it. The
    mesh's detectors take the result and detect this block on this
    process's devices; no image bytes cross processes."""
    local_planes = np.ascontiguousarray(local_planes)
    b_local = local_planes.shape[0]
    n_proc = mesh.process_count
    b_global = b_local * n_proc if global_batch is None else int(global_batch)
    if b_global != b_local * n_proc:
        raise ValueError(f"a global batch of {b_global} planes is not "
                         f"{n_proc} blocks of {b_local}")
    return GlobalStack(local_planes, b_global,
                       mesh.process_index * b_local)
