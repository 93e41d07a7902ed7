"""Tiled bead scans through ``magnify_tpu_torch.beads``.

A frame is a (channel, row, col, y, x) uint16 field of ``tiles`` tiles of
``tile_px``^2 that overlap by ``overlap`` pixels. Beads sit on a grid of
``pitch_px`` in the stitched image, each moved from its grid point by a
jitter and given a radius and a brightness in each channel drawn from the
seed, and are painted into every tile that sees them; tile noise is
independent. By grid point (i, j):
(i + j) % 3 == 0 is a bead of the first channel only, == 1 one of the
first channel with a copy in the second moved by ``shift_px`` (the
cross-channel dedupe drops the copy), == 2 a bead of the second channel
only.

The plain reference is the truth the frame was drawn from: a mark at each
bead of the first channel and at each bead of the second channel only,
its fg mask the pixels of its disk that no other bead's disk covers, its
bg mask the pixels that no bead's disk covers, its ROI the stitched
image's pixels in the ``roi_length`` window around it.
"""

from __future__ import annotations

import numpy as np

from bench_torch import geometry, seeding

# The limit of each compared number (see PERF.md for the readings).
LIMITS = {
    "pos_err_px": 0,     # widest distance of a drawn bead from its mark
    "marks_wrong": 0,    # beads not marked at their centre, other marks
    "mask_px_wrong": 0,  # fg and bg pixels unlike the reference's, a frame
    "roi_px_wrong": 0,   # ROI pixels unlike the stitched image's, a frame
}


def _stitched_side(cfg) -> tuple:
    rows, cols = cfg["tiles"]
    step = cfg["tile_px"] - cfg["overlap"]
    return rows * step, cols * step


def make_frames(cfg, seed: int, count: int, device) -> list:
    return [_make_frame(cfg, seed, k, device) for k in range(count)]


def _make_frame(cfg, seed: int, index: int, device) -> dict:
    import torch

    g = seeding.generator(seed, index, device)
    n_ch = len(cfg["channels"])
    rows, cols = cfg["tiles"]
    side = cfg["tile_px"]
    mean, sd = cfg["background"]
    noise = torch.randn((n_ch, rows, cols, side, side), generator=g,
                        device=device)
    tiles = (noise * sd + mean).clamp_(0, 65535).to(torch.int32)
    h, w = _stitched_side(cfg)
    origin, pitch, j = cfg["grid_origin_px"], cfg["pitch_px"], cfg["jitter_px"]
    r0, r1 = cfg["radius_px"]
    ny = (h - origin - j - r1 - 1) // pitch + 1
    nx = (w - origin - j - r1 - 1) // pitch + 1
    jitter = torch.randint(-j, j + 1, (ny, nx, 2), generator=g, device=device)
    radius = torch.randint(r0, r1 + 1, (ny, nx), generator=g, device=device)
    bright = [torch.randint(b0, b1 + 1, (ny * nx,), generator=g,
                            device=device).cpu().numpy()
              for b0, b1 in cfg["brightness"]]
    tiles = tiles.cpu().numpy().astype(np.uint16)
    jitter, radius = jitter.cpu().numpy(), radius.cpu().numpy()
    ii, jj = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    y = (origin + pitch * ii + jitter[..., 0]).reshape(-1)
    x = (origin + pitch * jj + jitter[..., 1]).reshape(-1)
    r = radius.reshape(-1)
    cls = ((ii + jj) % 3).reshape(-1)
    sy, sx = cfg["shift_px"]
    first = cls != 2
    second = cls != 0
    painted = [(y[first], x[first], r[first], bright[0][first]),
               (np.where(cls == 1, y + sy, y)[second],
                np.where(cls == 1, x + sx, x)[second], r[second],
                bright[1][second])]
    clip = cfg["overlap"] // 2
    step = side - cfg["overlap"]
    for ch, (by, bx, br, val) in enumerate(painted):
        for tr in range(rows):
            for tc in range(cols):
                geometry.paint(tiles[ch, tr, tc], by + clip - tr * step,
                               bx + clip - tc * step, br, val)
    keep = first | (cls == 2)
    return {"tiles": tiles, "y": y[keep], "x": x[keep], "radius": r[keep]}


def to_input(cfg, frame):
    import magnify_tpu_torch as mt

    return mt.DataArray(frame["tiles"],
                        dims=("channel", "row", "col", "y", "x"),
                        coords={"channel": list(cfg["channels"])})


def _kwargs(cfg, traffic, device) -> dict:
    kw = dict(cfg["call"], device=device, detector=traffic["detector"])
    if "num_iter" in traffic:
        kw["num_iter"] = traffic["num_iter"]
    return kw


def make_call(cfg, traffic, device):
    import magnify_tpu_torch as mt

    kw = _kwargs(cfg, traffic, device)
    return lambda frame: mt.beads(to_input(cfg, frame), **kw)


def extract(cfg, xp) -> dict:
    def get(name, *dims):
        return np.asarray(xp[name].transpose("mark", *dims).values)

    return {"y": get("y"), "x": get("x"), "valid": get("valid"),
            "fg": get("fg", "roi_y", "roi_x"),
            "bg": get("bg", "roi_y", "roi_x"),
            "roi": get("roi", "channel", "roi_y", "roi_x")}


def stitched(cfg, tiles) -> np.ndarray:
    """(channel, H, W): each tile's part that stitching keeps (the
    overlap split in half between neighbours), joined."""
    clip, rem = cfg["overlap"] // 2, cfg["overlap"] % 2
    side = cfg["tile_px"]
    keep = tiles[..., clip:side - clip - rem, clip:side - clip - rem]
    n_ch, rows, cols, th, tw = keep.shape
    return np.ascontiguousarray(keep.transpose(0, 1, 3, 2, 4)).reshape(
        n_ch, rows * th, cols * tw)


def expected(cfg, frame, quantum: int = 1) -> dict:
    """Centres, fg, bg and ROIs of the drawn beads; ``quantum`` 2 puts
    every centre on the even pixels below it: the control, the answer at
    half resolution."""
    image = stitched(cfg, frame["tiles"])
    _c, h, w = image.shape
    L = cfg["roi_length"]
    y = frame["y"] // quantum * quantum
    x = frame["x"] // quantum * quantum
    r = frame["radius"]
    count = np.zeros((h, w), np.int16)
    for rad in np.unique(r):
        off = geometry.disk(int(rad))
        sel = r == rad
        ys = (y[sel, None] + off[None, :, 0]).reshape(-1)
        xs = (x[sel, None] + off[None, :, 1]).reshape(-1)
        ok = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
        np.add.at(count, (ys[ok], xs[ok]), 1)
    top = geometry.window_corner(y, L, h)
    left = geometry.window_corner(x, L, w)
    own = geometry.disk_mask(L, y - top, x - left, r)
    wins = np.stack([count[t:t + L, le:le + L] for t, le in zip(top, left)])
    roi = np.stack([image[:, t:t + L, le:le + L] for t, le in zip(top, left)])
    return {"y": y, "x": x, "fg": own & (wins == 1), "bg": wins == 0,
            "roi": roi, "top": top, "left": left, "h": h, "w": w}


def compare(cfg, frame, want, got) -> dict:
    """The compared numbers of one result against the reference's answer
    ``want`` for its frame; each drawn bead is held against the mark
    nearest it, its masks where they lie in the image."""
    n_want, n_got = len(want["y"]), len(got["y"])
    invalid = int((~got["valid"].astype(bool)).sum())
    if n_got == 0 or n_want == 0:
        return {"pos_err_px": 1e9 if n_want else 0.0,
                "marks_wrong": n_want + n_got + invalid,
                "mask_px_wrong": 0, "roi_px_wrong": 0}
    d = np.maximum(np.abs(got["y"][:, None] - want["y"][None, :]),
                   np.abs(got["x"][:, None] - want["x"][None, :]))
    d = np.nan_to_num(d, nan=1e9)
    nearest = d.argmin(axis=0)  # the mark nearest each drawn bead
    L = cfg["roi_length"]
    gy = np.nan_to_num(np.round(got["y"][nearest]), nan=0).astype(np.int64)
    gx = np.nan_to_num(np.round(got["x"][nearest]), nan=0).astype(np.int64)
    dy = want["top"] - geometry.window_corner(gy, L, want["h"])
    dx = want["left"] - geometry.window_corner(gx, L, want["w"])
    mask_wrong = sum(geometry.placed_mismatch(got[k][nearest], want[k], dy, dx)
                     for k in ("fg", "bg"))
    return {"pos_err_px": float(d.min(axis=0).max()),
            "marks_wrong": (int((d.min(axis=0) > 0).sum())
                            + int((d.min(axis=1) > 0).sum()) + invalid),
            "mask_px_wrong": mask_wrong,
            "roi_px_wrong": int((got["roi"][nearest] != want["roi"]).sum())}
