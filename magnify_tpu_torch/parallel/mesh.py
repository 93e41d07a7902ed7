"""Device meshes: detection sharded over several devices by one process.

Torch port of ``magnify_tpu.parallel.mesh``. The JAX package runs each
sharded step as one ``shard_map`` program over a (batch, space) mesh; here
one process drives every device of its mesh, as that single-controller
program does:

* ``batch`` axis: data parallelism over (time x channel) image planes;
* ``space`` axis: each plane is cut into row bands, one a device. The
  stencils read halo rows copied from the neighbouring bands
  (:func:`_exchange_halo`, non-blocking where the devices differ), the
  gradient quantiles are taken over the gathered gradients of the whole
  plane, and Canny hysteresis runs through the hand kernel on every band
  with one row of each neighbour's edges as seeds, round after round until
  no band changes (:func:`sharded_hysteresis`).

A mesh may name one device several times (``devices=["cuda:0"] * 8``, the
counterpart of the JAX package's ``--xla_force_host_platform_device_count``):
bands that share a device go through each kernel in ONE batched call, so a
virtual mesh on one card launches what one device would. Every sharded
result is bit-identical to the single-device detection of
:mod:`magnify_tpu_torch.ops.detect`.

Detection under ``with use_mesh(mesh):`` runs on the mesh's devices; host
work and a finder's other device work stay on the device its caller named.
A sharded path runs only when the mesh has more than one device, as in the
JAX package. A mesh built by :func:`magnify_tpu_torch.parallel.multihost.
multihost_mesh` spans several processes: each holds its own batch rows and
detects them locally (see that module).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from magnify_tpu_torch.ops import edge as edge_ops
from magnify_tpu_torch.ops import prng
from magnify_tpu_torch.ops import score as score_ops
from magnify_tpu_torch.ops.hysteresis import hysteresis
from magnify_tpu_torch.ops.nms import parallel_greedy_nms
from magnify_tpu_torch.ops.ransac import candidate_circles

__all__ = [
    "Mesh",
    "PlaneBands",
    "active_mesh",
    "make_mesh",
    "sharded_detect_step",
    "sharded_edge_pipeline",
    "sharded_find_circles",
    "sharded_find_circles_batch",
    "sharded_find_circles_batch_packed",
    "sharded_hysteresis",
    "sharded_ransac_find_circles",
    "use_mesh",
]

HALO = 4  # rows each side: 2 (5-tap blur) + 1 (Scharr) + 1 (Canny NMS)

# The mesh the components consult (set with use_mesh).
_ACTIVE_MESH = None


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """A (batch, space) grid of torch devices.

    ``devices`` (b, s) holds this process's devices: all of them for a mesh
    of one process, its own batch rows for a mesh over several processes
    (``process_count`` > 1, hosts outer on the batch axis). ``shape`` and
    ``size`` count the whole mesh, as the JAX package's ``Mesh`` does.
    """

    def __init__(self, devices, *, process_index: int = 0,
                 process_count: int = 1):
        grid = np.asarray(devices, dtype=object)
        if grid.ndim != 2 or grid.size == 0:
            raise ValueError("a mesh needs a non-empty (batch, space) grid "
                             "of devices")
        self.devices = np.empty(grid.shape, dtype=object)
        for idx, d in np.ndenumerate(grid):
            self.devices[idx] = _device(d)
        self.process_index = int(process_index)
        self.process_count = int(process_count)

    @property
    def shape(self) -> dict:
        b, s = self.devices.shape
        return {"batch": b * self.process_count, "space": s}

    @property
    def size(self) -> int:
        return self.devices.size * self.process_count

    def __repr__(self):
        devs = [str(d) for d in self.devices.flat]
        return (f"Mesh({self.shape}, devices={devs}, process "
                f"{self.process_index} of {self.process_count})")


class use_mesh:
    """Context manager activating a device mesh for pipeline components.

    with mt.parallel.use_mesh(mesh):
        xp = mt.beads(data=...)   # detection shards over the mesh
    """

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self._prev = None

    def __enter__(self):
        global _ACTIVE_MESH
        self._prev = _ACTIVE_MESH
        _ACTIVE_MESH = self.mesh
        return self.mesh

    def __exit__(self, *exc):
        global _ACTIVE_MESH
        _ACTIVE_MESH = self._prev
        return False


def active_mesh() -> Mesh | None:
    return _ACTIVE_MESH


def sharded_mesh() -> Mesh | None:
    """The active mesh where detection shards over it (more than one
    device), else None."""
    mesh = _ACTIVE_MESH
    return mesh if mesh is not None and mesh.size > 1 else None


def visible_cards(caller: str) -> list:
    """``cuda:0`` .. ``cuda:n-1``, every card this process sees; with none
    it raises (a mesh never falls back to the CPU unless named)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
        raise RuntimeError(f"{caller}: no CUDA device is visible; name the "
                           "mesh's devices with devices=")
    return [f"cuda:{i}" for i in range(torch.cuda.device_count())]


def make_mesh(batch: int | None = None, space: int | None = None,
              devices=None) -> Mesh:
    """Build a (batch, space) mesh over ``devices``: every visible card by
    default (:func:`visible_cards`). A device may be named several times.
    Space is favoured when neither axis is given; ``batch * space`` must
    equal the number of devices."""
    if devices is None:
        devices = visible_cards("make_mesh")
    devs = list(np.asarray(devices, dtype=object).reshape(-1))
    n = len(devs)
    if batch is None and space is None:
        batch, space = 1, n
    elif batch is None:
        batch = n // space
    elif space is None:
        space = n // batch
    if batch * space != n:
        raise ValueError(f"batch*space must equal device count ({n}).")
    return Mesh(np.asarray(devs, dtype=object).reshape(batch, space))


# ---------------------------------------------------------------------------
# Bands: a plane batch cut over the mesh
# ---------------------------------------------------------------------------
# A sharded batch is a flat list of tensors in (batch row, space) order, one
# band (planes of the batch row, rows of the band, W) on each mesh device.

def _by_device(devs) -> dict:
    groups: dict = {}
    for i, d in enumerate(devs):
        groups.setdefault(d, []).append(i)
    return groups


def _per_device(fn, devs, *bands):
    """``fn`` once per distinct device, on the dim-0 concatenation of the
    bands that lie on it; its output(s) are split back into bands."""
    out = None
    single = False
    for idx in _by_device(devs).values():
        args = [torch.cat([b[i] for i in idx]) if len(idx) > 1 else b[idx[0]]
                for b in bands]
        res = fn(*args)
        single = not isinstance(res, tuple)
        res = (res,) if single else res
        if out is None:
            out = [[None] * len(devs) for _ in res]
        sizes = [bands[0][i].shape[0] for i in idx]
        for k, r in enumerate(res):
            for i, piece in zip(idx, torch.split(r, sizes)):
                out[k][i] = piece
    return out[0] if single else tuple(out)


def chunks_by_device(mesh: Mesh, n: int) -> list:
    """``n`` items split over this process's mesh devices as the JAX
    package splits a chip's chambers: one contiguous chunk of ``ceil(n /
    devices)`` items a device, the last ones shorter (the JAX package pads
    them with item 0). Returns (device, int64 indices of its chunks) per
    distinct device that holds any."""
    devs = list(mesh.devices.flat)
    chunk = -(-n // len(devs))
    out = []
    for dev, idx in _by_device(devs).items():
        sel = torch.cat([torch.arange(min(i * chunk, n),
                                      min((i + 1) * chunk, n))
                         for i in idx])
        if sel.numel():
            out.append((dev, sel))
    return out


def _rows(flat: list, n_space: int) -> list:
    return [flat[i:i + n_space] for i in range(0, len(flat), n_space)]


def _exchange_halo(bands: list, halo: int, boundary: str = "zero") -> list:
    """Each band of one batch row with ``halo`` rows of its neighbours.

    ``bands``: the row bands of a plane batch in space order, tensors
    (..., rows, W), each on its own device. The previous band's last rows go
    above, the next band's first rows below, copied non-blocking where the
    devices differ. ``boundary`` picks the fill at the global image edge:
    "zero" is the single-device zero padding of Canny NMS, hysteresis and
    the scorer; "reflect" is BORDER_REFLECT_101 (row -k := row k), the
    border of the blur and Scharr stencils, so the edge bands reproduce
    the single-device stencils bit for bit.
    """
    if halo == 0:
        return list(bands)
    out = []
    last = len(bands) - 1
    for s, local in enumerate(bands):
        rows = local.shape[-2]
        if halo > rows or (boundary == "reflect" and halo >= rows):
            raise ValueError(f"a halo of {halo} rows does not fit bands of "
                             f"{rows}")
        if s > 0:
            prev = bands[s - 1][..., -halo:, :].to(local.device,
                                                   non_blocking=True)
        elif boundary == "reflect":
            prev = local[..., 1:halo + 1, :].flip(-2)
        else:
            prev = torch.zeros_like(local[..., :halo, :])
        if s < last:
            nxt = bands[s + 1][..., :halo, :].to(local.device,
                                                 non_blocking=True)
        elif boundary == "reflect":
            nxt = local[..., rows - halo - 1:rows - 1, :].flip(-2)
        else:
            nxt = torch.zeros_like(local[..., :halo, :])
        out.append(torch.cat([prev, local, nxt], dim=-2))
    return out


def _exchange(flat: list, n_space: int, halo: int, boundary="zero") -> list:
    return [b for row in _rows(flat, n_space)
            for b in _exchange_halo(row, halo, boundary)]


def _valid_rows(s: int, local: int, valid_h: int) -> int:
    return max(0, min(local, valid_h - s * local))


def _gather_rows(flat: list, n_space: int, home) -> torch.Tensor:
    """The whole (planes, H, W) batch of banded tensors on ``home``."""
    return torch.cat([torch.cat([b.to(home) for b in row], dim=-2)
                      for row in _rows(flat, n_space)])


def _any_changed(new: list, old: list, devs) -> bool:
    """Whether any band's first or last row differs (one sync a device)."""
    flags: dict = {}
    for a, b, d in zip(new, old, devs):
        flags.setdefault(d, []).append(
            (a[..., :1, :] != b[..., :1, :]).any()
            | (a[..., -1:, :] != b[..., -1:, :]).any())
    return any(bool(torch.stack(f).any()) for f in flags.values())


def _hysteresis_rounds(strong: list, weak: list, devs, n_space: int):
    """Canny hysteresis of banded masks through the hand kernel.

    Each round runs every band, with one row of each neighbour above and
    below, through :func:`~magnify_tpu_torch.ops.hysteresis.hysteresis`
    (one call for all bands of a device): the weak mask of the block, and
    as seeds the band's current edges with the neighbours' current edge
    rows. A round can only add pixels connected to an edge, and it carries
    an edge one band boundary further, so the rounds stop when no band's
    first or last row changed: then no seed changes, and the bands hold the
    whole plane's fixpoint. A chain that crosses k band boundaries in turn
    takes up to k + 1 rounds to grow, and one more finds nothing changed.
    Returns (edges, rounds)."""
    weak_ext = _exchange(weak, n_space, 1)
    cur = strong
    rounds = 0
    while True:
        rounds += 1
        seeds = _exchange(cur, n_space, 1)
        new = _per_device(lambda s, w: hysteresis(s, w)[..., 1:-1, :], devs,
                          seeds, weak_ext)
        changed = _any_changed(new, cur, devs)
        cur = new
        if not changed:
            return cur, rounds


def _edges(bands: list, devs, n_space: int, low_q: float, high_q: float,
           valid_h: int, normalized: bool):
    """The edge stack of banded planes (rows at or past ``valid_h`` are
    padding): ``ops.edge.edge_pipeline`` of each whole plane, cut into the
    same bands. Returns (edges, dx, dy) banded; dx and dy are zero on the
    padding rows, which then present the single-device zero border."""
    local = bands[0].shape[-2]
    vr = [_valid_rows(i % n_space, local, valid_h) for i in range(len(bands))]
    x = [b.to(torch.float32) for b in bands]
    if not normalized:
        x = _normalize(x, vr, n_space)
    blurred = _per_device(
        lambda t: edge_ops.gaussian_blur5_u8(t)[..., 2:-2, :], devs,
        _exchange(x, n_space, 2, "reflect"))
    dx, dy = _per_device(
        lambda t: tuple(g[..., 1:-1, :] for g in edge_ops.scharr(t)), devs,
        _exchange(blurred, n_space, 1, "reflect"))
    grad = _per_device(lambda a, b: edge_ops.sqrt_f32(a * a + b * b), devs,
                       dx, dy)
    thresholds = _quantiles(grad, vr, n_space, low_q, high_q)
    live = [torch.arange(local, device=d)[:, None] < v
            for d, v in zip(devs, vr)]
    dx = [torch.where(m, t, 0.0) for m, t in zip(live, dx)]
    dy = [torch.where(m, t, 0.0) for m, t in zip(live, dy)]
    strong, weak = _per_device(
        lambda a, b, t: tuple(m[..., 1:-1, :] for m in edge_ops.canny_nms(
            a, b, t[:, 0], t[:, 1])),
        devs, _exchange(dx, n_space, 1), _exchange(dy, n_space, 1),
        thresholds)
    edges, _rounds = _hysteresis_rounds(strong, weak, devs, n_space)
    return edges, dx, dy


def _normalize(x: list, vr: list, n_space: int) -> list:
    """Per-plane min-max normalization to uint8 values over the valid rows
    of every band (``ops.edge.normalize_to_u8`` of the whole plane)."""
    out = []
    for row, v in zip(_rows(x, n_space), _rows(vr, n_space)):
        home = row[0].device
        lo = torch.stack([b[..., :n, :].amin(dim=(-2, -1)).to(home)
                          for b, n in zip(row, v) if n]).amin(0)
        peak = torch.stack([
            (b[..., :n, :] - lo.to(b.device)[:, None, None]).amax(
                dim=(-2, -1)).to(home)
            for b, n in zip(row, v) if n]).amax(0)
        for b in row:
            shifted = b - lo.to(b.device)[:, None, None]
            pk = peak.to(b.device)[:, None, None]
            out.append(torch.trunc(torch.where(pk > 0, 255.0 * shifted / pk,
                                               shifted)))
    return out


def _quantiles(grad: list, vr: list, n_space: int, low_q, high_q) -> list:
    """The exact Canny thresholds of every plane, (planes, 2) on each
    band's device: the valid gradients of the bands gathered on the batch
    row's first device and ``ops.edge.histogram_quantiles`` of them."""
    qs = [np.float32(low_q), np.float32(high_q)]
    out = []
    for row, v in zip(_rows(grad, n_space), _rows(vr, n_space)):
        home = row[0].device
        vals = torch.cat([g[..., :n, :].to(home, non_blocking=True)
                          for g, n in zip(row, v) if n], dim=-2)
        q = edge_ops.histogram_quantiles(vals, qs, batched=True).T
        out += [q.to(g.device, non_blocking=True) for g in row]
    return out


def row_pad(h: int, n_space: int) -> int:
    """Rows a plane of ``h`` rows is REFLECT_101-padded by so that the
    space axis divides it: none where it does, else at least :data:`HALO`
    (the stencil halo must stay inside the padded rows, so that the border
    reflects at the true image edge, not the padded one)."""
    pad_h = (-h) % n_space
    if pad_h and pad_h < HALO:
        pad_h += ((HALO - pad_h + n_space - 1) // n_space) * n_space
    return pad_h


def _check_bands(h: int, pad_h: int, local: int, max_radius: int) -> None:
    """Raises where bands of ``local`` rows (``h`` rows padded by
    ``pad_h``) are too thin for the detector."""
    if local < max(2 * max_radius, HALO):
        raise ValueError(
            f"image rows per shard ({local}) must cover the scoring halo "
            f"({2 * max_radius}); use fewer 'space' shards for this image.")
    if pad_h >= h:
        raise ValueError(f"cannot reflect-pad {h} rows by {pad_h}; use "
                         "fewer 'space' shards for this image.")


class PlaneBands(NamedTuple):
    """One plane already cut into a mesh's row bands, as ``stream_planes(
    ..., mesh=)`` yields it: ``bands`` (rows, W) on the space devices of
    one batch row, REFLECT_101-padded (:func:`row_pad`) below the plane's
    ``height`` rows."""
    bands: list
    height: int


def _stack_bands(planes: list, mesh: Mesh) -> tuple:
    """Planes given as :class:`PlaneBands` (plane k on batch row k % b, as
    the stream hands them out) as the flat band list of one batch: each
    row's planes stacked, every row cyclically padded to as many planes
    (a band that lies elsewhere is copied to its row's device). Returns
    (bands, place, height): ``place[k]`` is plane k's index in the
    batch."""
    b_rows, n_space = mesh.devices.shape
    n = len(planes)
    if {p.height for p in planes} != {planes[0].height}:
        raise ValueError("the planes of one batch need one height")
    per_row = -(-n // b_rows)
    flat = [torch.stack([planes[(r + j * b_rows) % n].bands[s]
                         .to(mesh.devices[r, s]) for j in range(per_row)])
            for r in range(b_rows) for s in range(n_space)]
    place = [(k % b_rows) * per_row + k // b_rows for k in range(n)]
    return flat, place, planes[0].height


def _as_tensor(images):
    """A host stack as a tensor, uint8 kept (1 byte a pixel to upload),
    other types as float32 (uint16 is exact; torch indexes no uint16)."""
    if isinstance(images, torch.Tensor):
        return images
    images = np.asarray(images)
    if images.dtype != np.uint8:
        images = images.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(images))


def _scatter(imgs: torch.Tensor, mesh: Mesh, local: int,
             dtype=torch.float32) -> list:
    """Bands of a (B, H, W) stack (B a multiple of this process's batch
    rows, H of the space axis) on the mesh's devices, cast to ``dtype``
    there."""
    b_rows, n_space = mesh.devices.shape
    per_row = imgs.shape[0] // b_rows
    return [imgs[r * per_row:(r + 1) * per_row, s * local:(s + 1) * local]
            .to(mesh.devices[r, s], non_blocking=True).to(dtype)
            for r in range(b_rows) for s in range(n_space)]


def _pad_stack(imgs: torch.Tensor, pad_h: int, n_batch: int) -> torch.Tensor:
    """Rows REFLECT_101-padded by ``pad_h``, planes cyclically to a multiple
    of ``n_batch``."""
    b, h = imgs.shape[:2]
    if pad_h:
        imgs = torch.cat([imgs, imgs[:, h - 1 - pad_h:h - 1].flip(1)], dim=1)
    pad_b = (-b) % n_batch
    if pad_b:  # pad_b may exceed b
        imgs = torch.cat([imgs, imgs[torch.arange(pad_b) % b]])
    return imgs


def _local_block(images):
    """This process's planes: a :class:`~magnify_tpu_torch.parallel.
    multihost.GlobalStack`'s local block, or ``images`` itself."""
    return getattr(images, "planes", images)


# ---------------------------------------------------------------------------
# The edge stack and hysteresis
# ---------------------------------------------------------------------------

def sharded_edge_pipeline(images, mesh: Mesh, low_q: float, high_q: float,
                          valid_h: int | None = None,
                          normalized: bool = False):
    """Edge detection for a batch of planes over a (batch, space) mesh.

    ``images`` (B, H, W) with B a multiple of the batch axis and H of the
    space axis (pad them and pass the true height as ``valid_h``; rows past
    it are left out of every statistic and of the edges). ``normalized``
    marks uint8-valued planes; otherwise each plane is min-max normalized
    over its valid rows. Returns (edges bool, dx, dy), each (B, H, W) on the
    mesh's first device, equal to ``ops.edge.edge_pipeline`` of each plane
    on its valid rows (``arctan2(dy, dx)`` gives the angles).
    """
    imgs = _as_tensor(_local_block(images))
    n_space = mesh.devices.shape[1]
    valid = int(valid_h) if valid_h is not None else imgs.shape[1]
    bands = _scatter(imgs, mesh, imgs.shape[1] // n_space)
    devs = list(mesh.devices.flat)
    edges, dx, dy = _edges(bands, devs, n_space, low_q, high_q, valid,
                           normalized)
    home = devs[0]
    return tuple(_gather_rows(t, n_space, home) for t in (edges, dx, dy))


def sharded_hysteresis(strong: torch.Tensor, weak: torch.Tensor,
                       mesh: Mesh):
    """Canny hysteresis of (H, W) or (N, H, W) masks with the planes split
    over the batch axis and their rows over the space axis, through the
    hand kernel on every band (see :func:`_hysteresis_rounds`). Returns
    (edges on ``strong``'s device, the rounds taken); the edges equal
    ``ops.hysteresis.hysteresis`` of the whole planes."""
    squeeze = strong.ndim == 2
    s3, w3 = (strong[None], weak[None]) if squeeze else (strong, weak)
    n, h, w = s3.shape
    b_rows, n_space = mesh.devices.shape
    pad_h, pad_n = (-h) % n_space, (-n) % b_rows
    # Planes and rows of no pixel: they connect nothing.
    s3 = F.pad(s3, (0, 0, 0, pad_h, 0, 0)).to(torch.bool)
    w3 = F.pad(w3, (0, 0, 0, pad_h, 0, 0)).to(torch.bool)
    if pad_n:
        s3 = torch.cat([s3, torch.zeros_like(s3[:1]).expand(pad_n, -1, -1)])
        w3 = torch.cat([w3, torch.zeros_like(w3[:1]).expand(pad_n, -1, -1)])
    local = (h + pad_h) // n_space
    edges, rounds = _hysteresis_rounds(
        _scatter(s3, mesh, local, torch.bool),
        _scatter(w3, mesh, local, torch.bool), list(mesh.devices.flat),
        n_space)
    out = _gather_rows(edges, n_space, strong.device)[:n, :h]
    return (out[0] if squeeze else out), rounds


# ---------------------------------------------------------------------------
# Best circle per plane (sharded_detect_step)
# ---------------------------------------------------------------------------

def _halo_maps(edges, dx, dy, devs, n_space, min_radius, max_radius):
    """Score maps of every band with ``2 * max_radius`` halo rows of its
    neighbours (zero at the global edge) and columns: one ring correlation
    per device. Maps are (planes, n_radii, rows + 2 halo, W + 2 halo)."""
    halo = 2 * max_radius
    p = (halo, halo)
    return _per_device(
        lambda e, a, b: score_ops.score_maps(
            F.pad(e, p), F.pad(a, p), F.pad(b, p), min_radius=min_radius,
            max_radius=max_radius),
        devs, _exchange(edges, n_space, halo), _exchange(dx, n_space, halo),
        _exchange(dy, n_space, halo))


def sharded_detect_step(images, mesh: Mesh, low_q: float = 0.1,
                        high_q: float = 0.9, min_radius: int = 4,
                        max_radius: int = 8, min_roundness: float = 0.2):
    """One sharded step over a plane batch (B, H, W), B a multiple of the
    batch axis and H of the space axis: the sharded edge stack, score maps
    per band, and per plane the edge count, the sum of |gradient angle| over
    the edges and the best circle (the first maximum of each band's maps
    over its own rows; the best band wins, tied bands give the elementwise
    largest circle, as the JAX package's ``pmax``). Returns a dict of
    tensors on the mesh's first device: ``edges`` (B, H, W),
    ``edge_count``, ``edge_energy``, ``best_circle`` (B, 3) (-1 where no
    circle reaches ``min_roundness``), ``best_score`` (B,)."""
    imgs = _as_tensor(_local_block(images))
    w = imgs.shape[2]
    b_rows, n_space = mesh.devices.shape
    local = imgs.shape[1] // n_space
    devs = list(mesh.devices.flat)
    edges, dx, dy = _edges(_scatter(imgs, mesh, local), devs, n_space, low_q,
                           high_q, imgs.shape[1], False)
    maps = _halo_maps(edges, dx, dy, devs, n_space, min_radius, max_radius)
    halo = 2 * max_radius
    home = devs[0]
    best_s, best_c, count, energy = [], [], [], []
    for i, (m, e, gx, gy) in enumerate(zip(maps, edges, dx, dy)):
        s = i % n_space
        dev = m.device
        m = m[:, :, halo:halo + local]
        n_r, wp = m.shape[1], m.shape[-1]
        rows = torch.arange(local, device=dev) + s * local
        cols = torch.arange(wp, device=dev) - halo
        rads = torch.arange(min_radius, max_radius + 1, device=dev)[:, None]
        ok_r = (rows + rads >= 0) & (rows - rads < local * n_space)
        ok_c = (cols + rads >= 0) & (cols - rads < w)
        ok = ok_r[:, :, None] & ok_c[:, None, :] & (
            m >= torch.tensor(np.float32(min_roundness), device=dev))
        flat = torch.where(ok, m, -torch.inf).reshape(m.shape[0], -1)
        best = torch.argmax(flat, dim=1)
        r_idx, rem = best // (local * wp), best % (local * wp)
        best_s.append(torch.gather(flat, 1, best[:, None])[:, 0].to(home))
        best_c.append(torch.stack([rem // wp + s * local, rem % wp - halo,
                                   r_idx + min_radius], 1).to(home))
        count.append(e.sum(dim=(1, 2)).to(home))
        energy.append(torch.where(e, edge_ops.atan2_f32(gy, gx).abs(), 0.0)
                      .sum(dim=(1, 2)).to(home))
    out = {"best_circle": [], "best_score": [], "edge_count": [],
           "edge_energy": []}
    for r in range(b_rows):
        sl = slice(r * n_space, (r + 1) * n_space)
        scores = torch.stack(best_s[sl])          # (space, planes)
        top = scores.amax(0)
        win = (scores == top) & torch.isfinite(top)
        circles = torch.where(win[..., None], torch.stack(best_c[sl]), -1)
        out["best_circle"].append(circles.amax(0).to(torch.int32))
        out["best_score"].append(top)
        out["edge_count"].append(torch.stack(count[sl]).sum(0))
        out["edge_energy"].append(torch.stack(energy[sl]).sum(0))
    out = {k: torch.cat(v) for k, v in out.items()}
    out["edges"] = _gather_rows(edges, n_space, home)
    return out


# ---------------------------------------------------------------------------
# Dense detection over the mesh
# ---------------------------------------------------------------------------

def _survivors(maps, s, local, n_space, thresh, *, valid_h, width,
               min_radius, max_radius):
    """One band's map entries at or above ``thresh`` that pass the bound
    filters in global coordinates, among the map rows the band owns (its
    own rows; the first and last bands also the out-of-image halo rows).
    Returns (plane, single-device padded flat index, score, circle)."""
    halo = 2 * max_radius
    n_planes, n_r, lh, wp = maps.shape
    dev = maps.device
    rows = torch.arange(lh, device=dev) - halo + s * local
    cols = torch.arange(wp, device=dev) - halo
    rads = torch.arange(min_radius, max_radius + 1, device=dev)[:, None]
    own = (rows >= s * local) & (rows < (s + 1) * local)
    if s == 0:
        own |= rows < 0
    if s == n_space - 1:
        own |= rows >= n_space * local
    ok_r = own & (rows + rads >= 0) & (rows - rads < valid_h)
    ok_c = (cols + rads >= 0) & (cols - rads < width)
    keep = (maps >= thresh) & ok_r[:, :, None] & ok_c[:, None, :]
    plane, lin = torch.nonzero(keep.reshape(n_planes, -1)).unbind(1)
    scores = maps.reshape(n_planes, -1)[plane, lin]
    r_idx, rem = lin // (lh * wp), lin % (lh * wp)
    row = rem // wp - halo + s * local
    col_p = rem % wp
    # The single-device map's flat index: its (-score, index) tie-break.
    lin_single = (r_idx * (valid_h + 2 * halo) + row + halo) * wp + col_p
    circles = torch.stack([row, col_p - halo, r_idx + min_radius], 1)
    return plane, lin_single, scores, circles.to(torch.int32)


def _detect_bands(edges, dx, dy, devs, n_space, min_roundness, *, valid_h,
                  width, min_radius, max_radius, min_dist):
    """Dense detection of banded edge stacks: score maps per band, the
    survivors of each band merged on the batch row's first device in
    (-score, single-device flat index) order, then greedy NMS per plane.
    Returns, per plane of every batch row, (circles (n, 3) int32, scores)
    on that device, best first: ``ops.detect.detect_dense`` of the plane.
    """
    maps = _halo_maps(edges, dx, dy, devs, n_space, min_radius, max_radius)
    local = edges[0].shape[-2]
    out = []
    for r, row in enumerate(_rows(maps, n_space)):
        home = row[0].device
        parts = []
        for s, m in enumerate(row):
            thresh = torch.tensor(np.float32(min_roundness), device=m.device)
            parts.append([t.to(home, non_blocking=True) for t in _survivors(
                m, s, local, n_space, thresh, valid_h=valid_h, width=width,
                min_radius=min_radius, max_radius=max_radius)])
        plane, lin, scores, circles = (torch.cat(t) for t in zip(*parts))
        order = torch.argsort(lin, stable=True)
        order = order[torch.sort(-scores[order], stable=True).indices]
        plane, scores, circles = plane[order], scores[order], circles[order]
        for p in range(row[0].shape[0]):
            sel = plane == p
            c, sc = circles[sel], scores[sel]
            accepted = parallel_greedy_nms(
                c, torch.isfinite(sc), min_dist=min_dist, height=valid_h,
                width=width, max_radius=max_radius)
            out.append((c[accepted], sc[accepted]))
    return out


def sharded_find_circles_batch(images, mesh: Mesh, low_q: float,
                               high_q: float, min_roundness: float, *,
                               min_radius: int, max_radius: int,
                               min_dist: int, normalized: bool = False):
    """Dense detection of a plane batch (B, H, W) over a (batch, space)
    mesh.

    Any B and H: rows are REFLECT_101-padded to the space axis (the padding
    is left out of every statistic) and planes cyclically to the batch
    axis. ``images`` (numpy or a tensor; uint8 when ``normalized``, which
    marks host-normalized planes, 1 byte a pixel to upload) is cut into
    bands on the mesh's devices and cast to float32 there; or it is a list
    of :class:`PlaneBands`, planes the stream has already cut and put
    there. Returns one (circles (n, 3) int32, scores (n,)) pair of tensors
    per plane, best first after greedy NMS at ``min_dist``, each on the
    first device of its batch row and equal to ``ops.detect.detect_dense``
    of the plane. On a mesh over several processes ``images`` is this
    process's block (or its :class:`~magnify_tpu_torch.parallel.multihost.
    GlobalStack`) and the pairs are its planes'.
    """
    n_space = mesh.devices.shape[1]
    if isinstance(images, (list, tuple)) and images and isinstance(
            images[0], PlaneBands):
        bands, place, h = _stack_bands(list(images), mesh)
        local, w = bands[0].shape[-2:]
        _check_bands(h, local * n_space - h, local, max_radius)
    else:
        imgs = _as_tensor(_local_block(images))
        b, h, w = imgs.shape
        pad_h = row_pad(h, n_space)
        local = (h + pad_h) // n_space
        _check_bands(h, pad_h, local, max_radius)
        bands = _scatter(_pad_stack(imgs, pad_h, mesh.devices.shape[0]),
                         mesh, local)
        place = range(b)
    devs = list(mesh.devices.flat)
    edges, dx, dy = _edges(bands, devs, n_space, low_q, high_q, h,
                           normalized)
    found = _detect_bands(edges, dx, dy, devs, n_space, min_roundness,
                          valid_h=h, width=w, min_radius=min_radius,
                          max_radius=max_radius, min_dist=min_dist)
    return [found[i] for i in place]


def sharded_find_circles_batch_packed(
        images_u8, mesh: Mesh, low_q: float, high_q: float,
        min_roundness: float, *, min_radius: int, max_radius: int,
        min_dist: int) -> list:
    """:func:`sharded_find_circles_batch` of host-normalized uint8 planes
    with the results on the host: a list of (circles int32, scores) numpy
    pairs per plane, the return of ``ops.detect.find_circles_stack``."""
    found = sharded_find_circles_batch(
        images_u8, mesh, low_q, high_q, min_roundness, min_radius=min_radius,
        max_radius=max_radius, min_dist=min_dist, normalized=True)
    return [(c.cpu().numpy().astype(np.int32), s.cpu().numpy())
            for c, s in found]


def sharded_find_circles(image, mesh: Mesh, low_edge_quantile: float,
                         high_edge_quantile: float, min_radius: int,
                         max_radius: int, min_roundness: float,
                         min_dist: int):
    """The dense branch of ``ops.detect.find_circles`` over a mesh: the
    (H, W) plane (numpy or a tensor, anywhere) cut into the mesh's bands,
    normalized there and detected by :func:`sharded_find_circles_batch`;
    host (circles, scores)."""
    (circles, scores), = sharded_find_circles_batch(
        _as_tensor(image)[None], mesh, float(low_edge_quantile),
        float(high_edge_quantile), float(min_roundness),
        min_radius=int(min_radius), max_radius=int(max_radius),
        min_dist=int(min_dist))
    return circles.cpu().numpy().astype(np.int32), scores.cpu().numpy()


# ---------------------------------------------------------------------------
# RANSAC over the mesh
# ---------------------------------------------------------------------------

def _all_gather_keys(keys: torch.Tensor) -> torch.Tensor:
    """Every process's dedupe keys, concatenated (``torch.distributed``:
    gloo on CPU tensors, NCCL on the process's card)."""
    import torch.distributed as dist

    x = keys if dist.get_backend() == "nccl" else keys.cpu()
    world = dist.get_world_size()
    size = torch.tensor([x.numel()], dtype=torch.int64, device=x.device)
    sizes = [torch.zeros_like(size) for _ in range(world)]
    dist.all_gather(sizes, size)
    sizes = [int(n) for n in sizes]
    buf = torch.zeros(max(sizes), dtype=x.dtype, device=x.device)
    buf[:x.numel()] = x
    bufs = [torch.empty_like(buf) for _ in range(world)]
    dist.all_gather(bufs, buf)
    return torch.cat([b[:n] for b, n in zip(bufs, sizes)]).to(keys.device)


def ransac_fits_mesh(h: int, w: int, min_radius: int,
                     max_radius: int) -> bool:
    """Whether RANSAC on an (h, w) plane may split its proposals over a
    mesh: its dedupe raster has at most ``RASTER_KEY_LIMIT`` keys (the JAX
    package ORs per-device presence bitmaps of the raster; beyond it,
    ``ops.detect.ransac_plane`` runs on one device)."""
    return score_ops.raster_key_space(
        h, w, min_radius, max_radius) <= score_ops.RASTER_KEY_LIMIT


def ransac_on_mesh(image: torch.Tensor, mesh: Mesh, low_q: float,
                   high_q: float, min_roundness: float, *, grid_length: int,
                   num_iter: int, min_radius: int, max_radius: int,
                   min_dist: int, seed: int, normalized: bool):
    """RANSAC detection of one plane with the proposals split over the
    mesh (see :func:`sharded_ransac_find_circles`). ``image`` (H, W), raw
    or (``normalized``) uint8-valued. Returns (circles (n, 3) int32, scores
    (n,), n_unique) on the mesh's first device, equal to
    ``ops.detect.detect_ransac`` with the key of ``seed``."""
    from magnify_tpu_torch.ops import detect as ops_detect

    if int(num_iter) < 1:
        raise ValueError("RANSAC needs num_iter >= 1")
    h, w = image.shape
    if not ransac_fits_mesh(h, w, min_radius, max_radius):
        raise ValueError(
            "sharded RANSAC requires the raster dedupe (key space "
            f"{score_ops.raster_key_space(h, w, min_radius, max_radius)} > "
            f"{score_ops.RASTER_KEY_LIMIT}); use the dense detector or a "
            "single chip for planes this large.")
    devs = list(mesh.devices.flat)
    home = devs[0]
    conv = ops_detect.use_conv_scorer()
    edges, dx, dy, *angles = edge_ops.edge_pipeline(
        image.to(home).to(torch.float32), low_q, high_q, normalized,
        angles=not conv)
    # Slot d of the whole mesh owns proposals d*chunk .. (d+1)*chunk - 1;
    # its slice starts at most at num_iter - chunk (the tail slot's overlap
    # with its neighbour is masked out), as the JAX package's static slices.
    n_dev = mesh.size
    chunk = -(-num_iter // n_dev)
    first = mesh.process_index * len(devs)
    bounds = dict(height=h, width=w, min_radius=min_radius,
                  max_radius=max_radius)
    key = prng.prng_key(seed)
    local = []
    for dev, idx in _by_device(devs).items():
        slots = torch.tensor([first + i for i in idx], dtype=torch.int64)
        starts = torch.clamp(slots * chunk, max=num_iter - chunk)
        cands, any_edges = candidate_circles(
            edges.to(dev), grid_length, num_iter, key.to(dev), start=starts,
            count=chunk)
        gi = (starts[:, None] + torch.arange(chunk)).to(dev)
        lo_own = (slots * chunk)[:, None].to(dev)
        own = (gi >= lo_own) & (gi < torch.clamp(lo_own + chunk,
                                                 max=num_iter))
        local.append(score_ops.circle_keys(
            cands, own.reshape(-1) & any_edges, **bounds).to(home))
    keys = torch.unique(torch.cat(local))
    if mesh.process_count > 1:
        keys = torch.unique(_all_gather_keys(keys))
    uniq = score_ops.decode_keys(keys, width=w, min_radius=min_radius,
                                 max_radius=max_radius)
    circles, scores = ops_detect.select_ransac(
        edges, dx, dy, angles[0] if angles else None, uniq, min_roundness,
        min_radius=min_radius, max_radius=max_radius, min_dist=min_dist)
    return circles, scores, int(keys.numel())


def sharded_ransac_find_circles(
    image,
    mesh: Mesh,
    low_edge_quantile: float,
    high_edge_quantile: float,
    *,
    grid_length: int,
    num_iter: int,
    min_radius: int,
    max_radius: int,
    min_roundness: float,
    min_dist: int,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """The RANSAC branch of ``ops.detect.find_circles`` over a mesh.

    The edge stack runs once, on the mesh's first device. The ``num_iter``
    proposals split into disjoint slices of the same threefry counter
    stream, one a mesh device (the slices of a device drawn in one call);
    each device rounds and filters its own and keeps their unique dedupe
    keys, and the union of the keys (over processes too) is exactly the
    whole stream's set of unique triples. Scoring, selection and NMS run
    on the first device. Host (circles, scores), equal to the
    single-device call. Like the JAX package's mesh RANSAC it refuses a
    plane whose dedupe raster would exceed ``RASTER_KEY_LIMIT`` keys
    (:func:`ransac_fits_mesh`).
    """
    img = _as_tensor(image)
    circles, scores, _n = ransac_on_mesh(
        img, mesh, float(low_edge_quantile), float(high_edge_quantile),
        float(min_roundness), grid_length=int(grid_length),
        num_iter=int(num_iter), min_radius=int(min_radius),
        max_radius=int(max_radius), min_dist=int(min_dist), seed=int(seed),
        normalized=False)
    return circles.cpu().numpy().astype(np.int32), scores.cpu().numpy()
