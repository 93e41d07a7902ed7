"""Chip frames through ``magnify_tpu_torch.microfluidic_chip``.

A frame is a (time, y, x) uint16 stack of a chip with ``grid`` chambers at
``pitch_px``: a dim noisy background and one bright button a chamber
(none in the blank chambers), each button's jitter from the grid point,
radius and brightness drawn from the seed, and the blank chambers too.
Only timestep 0 is searched; the later timesteps hold the same buttons at
``timestep_brightness`` over fresh noise (a kinetic series), and the
program copies the positions to them and crops them.

The plain reference is the truth the frame was drawn from: every
non-blank chamber's button at its drawn centre, its fg mask the drawn
disk, its bg mask the annulus between ``max_button_radius`` and
``chamber_radius``, its ROI the frame's pixels in the ``roi_length``
window around it, its tag the pinlist's name; a blank chamber has the
tag "" and its masks and crops where the program placed it.
"""

from __future__ import annotations

import io

import numpy as np

from bench_torch import geometry, seeding

# The limit of each compared number (see PERF.md for the readings).
LIMITS = {
    "pos_err_px": 0,     # widest distance of a button from its drawn centre
    "marks_wrong": 0,    # chambers off their centre, mistagged or not valid
    "mask_px_wrong": 0,  # fg and bg pixels unlike the reference's, a frame
    "roi_px_wrong": 0,   # ROI pixels unlike the frame's, a frame
}


def _shape(cfg) -> tuple:
    rows, cols = cfg["grid"]
    rd, cd = cfg["pitch_px"]
    return rows, cols, round((rows + 1) * rd), round((cols + 1) * cd)


def make_frames(cfg, seed: int, count: int, device) -> list:
    return [_make_frame(cfg, seed, k, device) for k in range(count)]


def _make_frame(cfg, seed: int, index: int, device) -> dict:
    import torch

    g = seeding.generator(seed, index, device)
    rows, cols, h, w = _shape(cfg)
    n_t = cfg["timesteps"]
    mean, sd = cfg["background"]
    noise = torch.randn((n_t, h, w), generator=g, device=device)
    # The dark field lies far below 2**15, so int16 holds it as uint16
    # would, at half the bytes to move to the host.
    stack = noise.mul_(sd).add_(mean).clamp_(0, 2**15 - 1).to(torch.int16)
    del noise
    j = cfg["jitter_px"]
    jitter = torch.randint(-j, j + 1, (rows, cols, 2), generator=g,
                           device=device)
    r0, r1 = cfg["radius_px"]
    radius = torch.randint(r0, r1 + 1, (rows, cols), generator=g,
                           device=device)
    b0, b1 = cfg["brightness"]
    bright = torch.randint(b0, b1 + 1, (rows, cols), generator=g,
                           device=device)
    order = torch.randperm(rows * cols, generator=g, device=device)
    stack = stack.cpu().numpy().view(np.uint16)
    jitter, radius, bright, order = (t.cpu().numpy() for t in
                                     (jitter, radius, bright, order))
    rd, cd = cfg["pitch_px"]
    grid_y = np.round((np.arange(rows) + 1) * rd).astype(np.int64)
    grid_x = np.round((np.arange(cols) + 1) * cd).astype(np.int64)
    cy = grid_y[:, None] + jitter[..., 0]
    cx = grid_x[None, :] + jitter[..., 1]
    blank = np.zeros(rows * cols, bool)
    blank[order[:round(cfg["blank_share"] * rows * cols)]] = True
    blank = blank.reshape(rows, cols)
    on = ~blank
    for t, scale in enumerate(cfg["timestep_brightness"][:n_t]):
        geometry.paint(stack[t], cy[on], cx[on], radius[on],
                       np.round(bright[on] * scale).astype(np.uint16))
    names = np.array([[f"m{i}_{k}" for k in range(cols)]
                      for i in range(rows)], dtype=object)
    names[blank] = ""
    lines = ["Indices,MutantID"] + [
        f'"({k + 1}, {i + 1})",{names[i, k] or "BLANK"}'
        for i in range(rows) for k in range(cols)]
    return {"stack": stack, "pinlist": "\n".join(lines) + "\n",
            "cy": cy, "cx": cx, "radius": radius, "blank": blank,
            "tag": names.astype(str)}


def to_input(cfg, frame):
    import magnify_tpu_torch as mt

    return mt.DataArray(frame["stack"], dims=("time", "y", "x"))


def make_call(cfg, traffic, device):
    import magnify_tpu_torch as mt

    kw = dict(cfg["call"], device=device, detector=traffic["detector"])
    if "num_iter" in traffic:
        kw["num_iter"] = traffic["num_iter"]

    def call(frame):
        return mt.microfluidic_chip(
            to_input(cfg, frame), pinlist=io.StringIO(frame["pinlist"]),
            **kw)
    return call


def extract(cfg, xc) -> dict:
    """(rows, cols, ...) numpy arrays of a result, timesteps after the
    chamber axes."""
    def get(name, *dims):
        return np.asarray(xc[name].transpose("mark_row", "mark_col",
                                             *dims).values)

    roi_dims = ("channel",) if "channel" in xc["roi"].dims else ()
    roi = get("roi", *roi_dims, "time", "roi_y", "roi_x")
    if not roi_dims:
        roi = roi[:, :, None]
    return {"y": get("y", "time"), "x": get("x", "time"),
            "valid": get("valid", "time"), "tag": get("tag").astype(str),
            "fg": get("fg", "time", "roi_y", "roi_x"),
            "bg": get("bg", "time", "roi_y", "roi_x"), "roi": roi}


def expected(cfg, frame, quantum: int = 1) -> dict:
    """The reference's answer by (row, col): centres, fg, bg, ROIs and
    window corners (a blank chamber's at its grid point with the fg disk
    of ``max_button_radius``, as the program leaves a chamber it does not
    refine; :func:`compare` checks a blank one where the program placed
    it). ``quantum`` 2 puts every centre on the even pixels below it: the
    control, the answer at half resolution."""
    cy = frame["cy"] // quantum * quantum
    cx = frame["cx"] // quantum * quantum
    radius = np.where(frame["blank"], cfg["max_button_radius"],
                      frame["radius"])
    return dict(_windows(cfg, frame["stack"], cy, cx, radius),
                cy=cy, cx=cx, tag=frame["tag"], blank=frame["blank"])


def _windows(cfg, stack, cy, cx, radius) -> dict:
    """fg, bg (rows, cols, L, L), ROIs (rows, cols, 1, T, L, L) and the
    windows' corners (rows, cols) at integer centres ``cy``/``cx``."""
    L = cfg["roi_length"]
    n_t, h, w = stack.shape
    rows, cols = cy.shape
    top = geometry.window_corner(cy, L, h).reshape(-1)
    left = geometry.window_corner(cx, L, w).reshape(-1)
    ry, rx = cy.reshape(-1) - top, cx.reshape(-1) - left
    fg = geometry.disk_mask(L, ry, rx, radius.reshape(-1))
    n = len(ry)
    bg = (geometry.disk_mask(L, ry, rx, np.full(n, cfg["chamber_radius"]))
          & ~geometry.disk_mask(L, ry, rx,
                                np.full(n, cfg["max_button_radius"])))
    roi = np.stack([stack[:, t:t + L, le:le + L] for t, le in zip(top, left)])
    shape = (rows, cols)
    return {"fg": fg.reshape(shape + (L, L)), "bg": bg.reshape(shape + (L, L)),
            "roi": roi.reshape(shape + (1, n_t, L, L)),
            "top": top.reshape(shape), "left": left.reshape(shape)}


def _centre(v) -> np.ndarray:
    """Integer centres of float positions (NaN, a grid not fitted, as 0)."""
    return np.nan_to_num(np.round(v), nan=0, posinf=0,
                         neginf=0).astype(np.int64)


def compare(cfg, frame, want, got) -> dict:
    """The compared numbers of one result against the reference's
    answer ``want`` for its frame. Masks are compared where they lie in
    the frame (the window of the result's mark against the reference's);
    a blank chamber's masks and crops where the program placed it."""
    on = ~want["blank"]
    n_t, h, w = frame["stack"].shape
    L = cfg["roi_length"]
    pos = np.maximum(np.abs(got["y"] - want["cy"][..., None]),
                     np.abs(got["x"] - want["cx"][..., None]))
    pos = np.nan_to_num(pos, nan=1e9)
    where = dict(want)
    if (~on).any():
        at = _windows(cfg, frame["stack"],
                      np.where(on, want["cy"], _centre(got["y"][..., 0])),
                      np.where(on, want["cx"], _centre(got["x"][..., 0])),
                      np.where(on, frame["radius"], cfg["max_button_radius"]))
        where = {k: np.where(_bcast(on, at[k]), want[k], at[k])
                 for k in ("fg", "bg", "roi", "top", "left")}
    mask_wrong = 0
    for t in range(n_t):
        top = geometry.window_corner(_centre(got["y"][..., t]), L, h)
        left = geometry.window_corner(_centre(got["x"][..., t]), L, w)
        dy = (where["top"] - top).reshape(-1)
        dx = (where["left"] - left).reshape(-1)
        for k in ("fg", "bg"):
            mask_wrong += geometry.placed_mismatch(
                got[k][:, :, t].reshape(-1, L, L),
                where[k].reshape(-1, L, L), dy, dx)
    wrong = (((pos > 0).any(axis=-1) & on) | (got["tag"] != want["tag"])
             | ~got["valid"].astype(bool).all(axis=-1))
    return {"pos_err_px": float(pos[on].max()) if on.any() else 0.0,
            "marks_wrong": int(wrong.sum()),
            "mask_px_wrong": mask_wrong,
            "roi_px_wrong": int((got["roi"] != where["roi"]).sum())}


def _bcast(on, arr):
    return on.reshape(on.shape + (1,) * (arr.ndim - 2))
