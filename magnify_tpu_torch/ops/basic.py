"""BaSiC-style retrospective shading estimation in torch.

The port of ``magnify_tpu.ops.basic``: a stack of same-channel tiles is
decomposed as

    I_i(x)  ~=  b_i * S(x) + D(x) + R_i(x)

with S the multiplicative flat field, D the additive dark field, b_i a
per-image baseline and R_i a robust residual (the image content), after
BaSiC (Peng et al. 2017). S and D are kept smooth by soft-thresholding
their DCT coefficients, and the content loses influence by iteratively
reweighted least squares. Everything runs at the working resolution
(128 x 128, the DCTs two 128 x 128 matrix products) in float32 on one
device, and the fields are resized back to the tile resolution.

The solver is the JAX package's, step for step, as a Python loop over the
iterations. It is close to the jitted JAX solver but not bit-equal (XLA
fuses the reductions and contracts multiply-adds inside its scan). Where
the fit recovers the shading (per-tile baselines that differ, sparse
content), the tests hold the flat field within 1e-4, the dark field within
1e-5 of the stack's mean (or twice the JAX solver's own spread under a
1e-7 relative change of its input, at most 1e-4 x the mean: 1.4e-5 x the
mean on a 192 x 320 stack) and the corrected integer tiles within one
count.
Where it does not (tiles at one background level, dense content), the
solver is ill-conditioned: the JAX solver's own fields move by far more
than a 1e-7 relative change of its input, and so do this port's
(``scripts/basic_conditioning.py``).
``basicpy``, which the JAX package's ``basic_correct`` prefers when it is
installed, is built on JAX and is never imported here.
"""

from __future__ import annotations

import contextlib
import functools
import threading

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["basic_transform", "fit_basic"]

WORKING_SIZE = 128


@functools.lru_cache(maxsize=2)
def _dct_matrix(n: int) -> np.ndarray:
    """Orthonormal DCT-II matrix C (float64): dct2(X) = C @ X @ C.T."""
    k = np.arange(n)[:, None]
    x = np.arange(n)[None, :]
    c = np.cos(np.pi * (x + 0.5) * k / n) * np.sqrt(2.0 / n)
    c[0] /= np.sqrt(2.0)
    return c


#: Serializes the fits' changes of the process-wide matmul precision.
_PRECISION_LOCK = threading.Lock()


@contextlib.contextmanager
def _full_f32_matmul():
    """float32 matrix products in full float32 (no TF32 on the card),
    whatever the process set; restored on exit.

    The setting is process-wide: fits on several threads take turns under
    a lock, so none restores the setting while another solves, and a fit
    raises if other code changed it before the fit ended (its products may
    then have run in TF32). Other matmuls of the process run in full
    float32 while a fit holds the setting.
    """
    with _PRECISION_LOCK:
        saved = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision("highest")
        try:
            yield
            if torch.get_float32_matmul_precision() != "highest":
                raise RuntimeError(
                    "fit_basic: the float32 matmul precision was changed "
                    "during the fit")
        finally:
            torch.set_float32_matmul_precision(saved)


def _shrink_dct(x, thresh: float, c):
    """Proximal operator of ``thresh * ||DCT(x)||_1`` (orthonormal DCT)."""
    coef = c @ x @ c.T
    coef = torch.sign(coef) * torch.clamp(torch.abs(coef) - thresh, min=0.0)
    return c.T @ coef @ c


def _median_rows(x: torch.Tensor) -> torch.Tensor:
    """Median of each row, the two middle values averaged for an even
    count, as ``jnp.median`` takes it (``torch.median`` returns the lower
    one)."""
    s = torch.sort(x, dim=1).values
    m = x.shape[1]
    return (s[:, (m - 1) // 2] + s[:, m // 2]) / 2


def _reweight_schedule(max_iters: int, reweight_iters: int) -> np.ndarray:
    """The iterations that refresh the IRLS weights: ``reweight_iters`` of
    the ``max_iters``, evenly spaced from the first."""
    total = max(int(max_iters), 1)
    n_rw = max(min(int(reweight_iters), total), 1)
    rw_at = np.zeros(total, bool)
    rw_at[np.round(np.linspace(0, total - 1, n_rw)).astype(int)] = True
    return rw_at


def _fit_basic_working(stack: torch.Tensor, smooth_flat: float,
                       smooth_dark: float, *, get_darkfield: bool,
                       max_iters: int, reweight_iters: int):
    """Fit (S, D, b) on the working-resolution stack (n, w, w) of mean ~1,
    float32 on the stack's device. The gauge (b_i - c, S, D + c S) is
    pinned by the per-image median baselines the alternation starts from,
    as in the JAX package."""
    n, w, _ = stack.shape
    c = torch.as_tensor(_dct_matrix(w).astype(np.float32),
                        device=stack.device)

    b0 = _median_rows(stack.reshape(n, -1))
    b0 = b0 / torch.clamp(b0.mean(), min=1e-6)
    s = torch.clamp(stack.mean(dim=0), min=0.05)
    d = torch.zeros((w, w), dtype=torch.float32, device=stack.device)
    r0 = stack - b0[:, None, None] * s[None]
    sc0 = torch.clamp(torch.abs(r0).mean(), min=1e-6)
    wgt = 1.0 / (torch.abs(r0) / sc0 + 0.1)
    wgt = wgt / wgt.mean()
    b = b0

    lam_s = smooth_flat * 1e-3
    lam_d = smooth_dark * 1e-3

    for do_reweight in _reweight_schedule(max_iters, reweight_iters):
        # Per-pixel weighted regression of I_i(x) on b_i: slope S(x),
        # intercept D(x), by the 2 x 2 normal equations.
        bw = b[:, None, None]
        sw = wgt.sum(dim=0)
        swb = (wgt * bw).sum(dim=0)
        swbb = (wgt * bw * bw).sum(dim=0)
        swi = (wgt * stack).sum(dim=0)
        swbi = (wgt * bw * stack).sum(dim=0)
        if get_darkfield:
            det = swbb * sw - swb * swb
            det = torch.where(torch.abs(det) < 1e-8, 1e-8, det)
            s = (sw * swbi - swb * swi) / det
            d = (swbb * swi - swb * swbi) / det
        else:
            s = swbi / torch.clamp(swbb, min=1e-8)
            d = torch.zeros_like(s)
        s = torch.clamp(_shrink_dct(s, lam_s, c), min=0.05)
        if get_darkfield:
            d = _shrink_dct(d, lam_d, c)
        num = (wgt * (stack - d[None]) * s[None]).sum(dim=(1, 2))
        den = (wgt * (s * s)[None]).sum(dim=(1, 2))
        b = torch.clamp(num / torch.clamp(den, min=1e-6), min=1e-3)
        if do_reweight:
            resid = stack - b[:, None, None] * s[None] - d[None]
            scale = torch.clamp(torch.abs(resid).mean(), min=1e-6)
            new_wgt = 1.0 / (torch.abs(resid) / scale + 0.1)
            wgt = new_wgt / new_wgt.mean()

    s_mean = torch.clamp(s.mean(), min=1e-6)
    return s / s_mean, d, b * s_mean


def _resize(x: torch.Tensor, size) -> torch.Tensor:
    """Bilinear resize of (n, h, w) planes: ``jax.image.resize(method=
    "linear")``, which filters an axis that shrinks with a triangle as wide
    as the scale (antialiasing) and interpolates an axis that grows. One
    axis at a time, each with torch's antialiased kernel only where it
    shrinks (on an axis that grows that kernel's weights are off by ~4e-6
    relative)."""
    out = x[:, None]
    for axis, new in ((2, int(size[0])), (3, int(size[1]))):
        if out.shape[axis] == new:
            continue
        shape = list(out.shape[2:])
        shape[axis - 2] = new
        out = F.interpolate(out, size=tuple(shape), mode="bilinear",
                            antialias=new < out.shape[axis],
                            align_corners=False)
    return out[:, 0]


def fit_basic(images, get_darkfield: bool = True,
              smoothness_flatfield: float = 1.0,
              smoothness_darkfield: float = 3.0, max_iters: int = 40,
              reweight_iters: int = 8, device="cuda"):
    """Fit a flat field and a dark field to a stack of same-channel tiles.

    ``images`` (n_tiles, h, w), any numeric dtype. Returns (flatfield (h,
    w) float32 with mean 1, darkfield (h, w) float32, zero without
    ``get_darkfield``) as numpy arrays at the tile resolution.
    ``max_iters`` is the total solver iteration count, and
    ``reweight_iters`` of them (evenly spaced) refresh the IRLS weights,
    the meanings of basicpy's knobs. The solver runs in float32 on
    ``device``; its matrix products run in full float32 on a card, with
    the process-wide matmul precision held at "highest" until the fit ends.
    """
    images = np.asarray(images, np.float32)
    n, h, w = images.shape
    # The host mean, as the JAX package takes it: it normalizes the stack
    # to mean ~1 so that the thresholds do not depend on the input scale.
    scale = float(np.maximum(images.mean(), 1e-6))
    with _full_f32_matmul():
        x = torch.as_tensor(np.ascontiguousarray(images)).to(device)
        work = _resize(x, (WORKING_SIZE, WORKING_SIZE))
        s, d, _b = _fit_basic_working(
            work / scale, float(smoothness_flatfield),
            float(smoothness_darkfield), get_darkfield=bool(get_darkfield),
            max_iters=int(max_iters), reweight_iters=int(reweight_iters))
        flat = _resize(s[None], (h, w))[0]
        dark = _resize((d * scale)[None], (h, w))[0]
    if not get_darkfield:
        dark = torch.zeros_like(dark)
    return (flat.cpu().numpy().astype(np.float32),
            dark.cpu().numpy().astype(np.float32))


def basic_transform(images, flatfield, darkfield) -> np.ndarray:
    """Apply the correction as basicpy's ``transform`` does:
    ``(image - darkfield) / flatfield`` in float32."""
    return (np.asarray(images, np.float32) - darkfield) / flatfield
