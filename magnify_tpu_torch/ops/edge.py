"""Edge-detection stack: normalize -> blur -> Scharr -> exact quantiles ->
Canny.

Torch port of ``magnify_tpu.ops.edge`` on the dense detector's path,
bit-identical to it: the 5-tap Gaussian blur rounds to uint8 values, Scharr
runs on the rounded blur, the Canny thresholds are exact order statistics
of the f32 gradient magnitude interpolated as ``np.quantile`` does, and
Canny quantizes gradients to int16 (trunc) and compares squared magnitudes
against squared thresholds with OpenCV's fixed-point sector tests.

Every sum below is written as eager ops in the reference's order (no
``addcmul``/``alpha=``/compile). Where the reference's compiled program
contracts a multiply-add into one fused multiply-add (XLA on the CPU does,
inside ``jit``), the port computes that FMA exactly with :func:`fma_f32`.

Every function takes one (H, W) plane or a batch (N, H, W) of planes of one
size (the chip path's per-chamber crops, which the JAX package runs under
``jax.vmap``); a batch gives, plane for plane, what the single-plane call
gives, with per-plane normalization and per-plane quantiles.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from magnify_tpu_torch import _build
from magnify_tpu_torch.ops.hysteresis import hysteresis

__all__ = [
    "atan2_f32",
    "canny",
    "canny_nms",
    "edge_pipeline",
    "fma_f32",
    "gaussian_blur5_u8",
    "histogram_quantile",
    "histogram_quantiles",
    "NORMALIZE_U8_LAUNCHES_PER_CALL",
    "normalize_to_u8",
    "normalize_u8",
    "normalize_u8_launches",
    "scharr",
    "sqrt_f32",
]

# OpenCV's fixed 5-tap Gaussian for ksize=5, sigma=0: [1, 4, 6, 4, 1] / 16.
_GAUSS5 = np.array([1.0, 4.0, 6.0, 4.0, 1.0], dtype=np.float32) / 16.0
_SMOOTH = np.array([3.0, 10.0, 3.0], dtype=np.float32)
_DERIV = np.array([-1.0, 0.0, 1.0], dtype=np.float32)
_TG22 = 13573  # tan(22.5 deg) in Q15, as used by OpenCV's Canny.

#: Kernel launches of :func:`normalize_u8` since the count was last reset.
normalize_u8_launches = 0
#: Kernel launches of one call on a non-empty batch: min/max, quantize.
NORMALIZE_U8_LAUNCHES_PER_CALL = 2


def normalize_to_u8(img: torch.Tensor) -> torch.Tensor:
    """Per-plane min-max normalization to [0, 255] with trunc cast, as f32
    (``magnify_tpu.ops.edge.normalize_to_u8``; the host twin is
    :func:`magnify_tpu_torch.ops.detect.normalize_planes_u8`). A constant
    plane comes out all zero."""
    x = img.to(torch.float32)
    x = x - x.amin(dim=(-2, -1), keepdim=True)
    peak = x.amax(dim=(-2, -1), keepdim=True)
    return torch.trunc(torch.where(peak > 0, 255.0 * x / peak, x))


def normalize_u8(planes: torch.Tensor) -> torch.Tensor:
    """uint8 planes from uint16 planes (H, W) or (N, H, W), each min-max
    normalized on its own: :func:`normalize_to_u8` cast to uint8, bit for
    bit, and so the uint8 planes the host gives
    (:func:`magnify_tpu_torch.ops.detect.normalize_planes_u8`).

    CUDA tensors take the kernel (``csrc/normalize_u8.cu``):
    :data:`NORMALIZE_U8_LAUNCHES_PER_CALL` launches on the current stream,
    no host sync. CPU tensors take the plain twin, :func:`normalize_to_u8`.
    """
    global normalize_u8_launches
    if planes.dtype != torch.uint16:
        raise TypeError(f"normalize_u8: uint16 planes required, got "
                        f"{planes.dtype}")
    if planes.ndim not in (2, 3):
        raise ValueError(f"normalize_u8: shape {tuple(planes.shape)}; one "
                         "(H, W) or (N, H, W) shape required")
    if planes.device.type == "cpu":
        return normalize_to_u8(planes).to(torch.uint8)
    if planes.device.type != "cuda":
        raise ValueError(f"normalize_u8: a tensor on {planes.device}; a "
                         "CUDA device (or the CPU) required")
    if not planes.is_contiguous():
        raise ValueError("normalize_u8: contiguous planes required")
    n_planes = planes.shape[0] if planes.ndim == 3 else 1
    h, w = planes.shape[-2:]
    if n_planes > 65535 or h * w >= 2**31:
        raise ValueError(f"normalize_u8: {n_planes} plane(s) of {h}x{w}; at "
                         "most 65,535 planes of under 2^31 pixels")
    out = torch.empty(planes.shape, dtype=torch.uint8, device=planes.device)
    if out.numel() == 0:
        return out
    stats = torch.empty(2 * n_planes, dtype=torch.int32,
                        device=planes.device)
    with torch.cuda.device(planes.device):  # the launch goes to its card
        err = _build.load().mg_normalize_u8(
            planes.data_ptr(), n_planes, h, w, stats.data_ptr(),
            out.data_ptr(),
            torch.cuda.current_stream(planes.device).cuda_stream)
    normalize_u8_launches += NORMALIZE_U8_LAUNCHES_PER_CALL
    _build.check(err, "mg_normalize_u8")
    return out


def _sepconv(img: torch.Tensor, krow, kcol) -> torch.Tensor:
    """Separable 2-D correlation with BORDER_REFLECT_101 semantics."""
    ph, pw = len(krow) // 2, len(kcol) // 2
    lead, (h, w) = img.shape[:-2], img.shape[-2:]
    x = F.pad(img.reshape(-1, 1, h, w), (pw, pw, ph, ph), mode="reflect")
    x = x.reshape(lead + (h + 2 * ph, w + 2 * pw))
    out = torch.zeros(lead + (h, w + 2 * pw), dtype=torch.float32,
                      device=img.device)
    for i, kv in enumerate(krow):
        if kv != 0.0:
            out = out + float(kv) * x[..., i:i + h, :]
    out2 = torch.zeros(lead + (h, w), dtype=torch.float32, device=img.device)
    for j, kv in enumerate(kcol):
        if kv != 0.0:
            out2 = out2 + float(kv) * out[..., j:j + w]
    return out2


def gaussian_blur5_u8(img_u8: torch.Tensor) -> torch.Tensor:
    """5x5 Gaussian blur on uint8-valued data, rounded (half to even)."""
    return torch.round(_sepconv(img_u8.to(torch.float32), _GAUSS5, _GAUSS5))


def scharr(img: torch.Tensor):
    """Scharr dx, dy (float32), matching cv.Scharr's kernels and borders."""
    return _sepconv(img, _SMOOTH, _DERIV), _sepconv(img, _DERIV, _SMOOTH)


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root (the IEEE operation XLA
    emits). Torch's vectorized f32 CPU sqrt is off by one ulp on ~0.5% of
    inputs, which could move a quantile threshold; the f64 root rounded
    to f32 is exact on every device."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` for f32 tensors with ONE rounding, as an FMA unit does.

    The product of two f32 values is exact in f64; the f64 sum is made
    round-to-odd from its exact error term (TwoSum), and rounding that to
    f32 is then the correctly rounded result (f64 carries more than the
    24 + 2 bits this needs). Plain f64 ops, so every device agrees.
    """
    p = a.to(torch.float64) * b.to(torch.float64)
    c64 = c.to(torch.float64)
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    bits = s.view(torch.int64)
    to_odd = (err != 0) & ((bits & 1) == 0)
    # One f64 ulp toward the exact sum: toward larger magnitude when the
    # error has the sign of s.
    step = torch.where((err > 0) == (s > 0), 1, -1)
    bits = torch.where(to_odd, bits + step, bits)
    return bits.view(torch.float64).to(torch.float32)


# fdlibm's float arctangent (``s_atanf.c``/``e_atan2f.c``, as the GNU C
# library builds it): the split points, atan(0.5, 1, 1.5, inf) in two parts,
# and the 11 odd-polynomial coefficients.
_ATAN_HI = (4.6364760399e-01, 7.8539812565e-01, 9.8279368877e-01,
            1.5707962513e+00)
_ATAN_LO = (5.0121582440e-09, 3.7748947079e-08, 3.4473217170e-08,
            7.5497894159e-08)
_ATAN_T = (3.3333334327e-01, -2.0000000298e-01, 1.4285714924e-01,
           -1.1111110449e-01, 9.0908870101e-02, -7.6918758452e-02,
           6.6610731184e-02, -5.8335702866e-02, 4.9768779427e-02,
           -3.6531571299e-02, 1.6285819933e-02)
_PI_O_2, _PI, _PI_LO, _TINY = (1.5707963705e+00, 3.1415927410e+00,
                               -8.7422776573e-08, 1e-30)


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    """An f32 constant as a tensor (a Python-float operand may take another
    rounding path than an f32 tensor does)."""
    return torch.tensor(np.float32(v), device=like.device).expand_as(like)


def _atanf(x: torch.Tensor) -> torch.Tensor:
    """fdlibm's ``atanf``: four-interval argument reduction and the odd
    polynomial in two halves, every step one rounded f32 operation."""
    hx = x.view(torch.int32)
    ix = hx & 0x7FFFFFFF
    one, two, h = _f32(1.0, x), _f32(2.0, x), _f32(1.5, x)
    ax = x.abs()
    interval = torch.where(ix < 0x3F300000, 0, torch.where(
        ix < 0x3F980000, 1, torch.where(ix < 0x401C0000, 2, 3)))
    small = ix < 0x3EE00000  # |x| < 7/16: no reduction
    xr = torch.where(small, x, torch.where(
        interval == 0, (two * ax - one) / (two + ax), torch.where(
            interval == 1, (ax - one) / (ax + one), torch.where(
                interval == 2, (ax - h) / (one + h * ax), -one / ax))))
    t = [_f32(c, x) for c in _ATAN_T]
    z = xr * xr
    w = z * z
    s1 = z * (t[0] + w * (t[2] + w * (t[4] + w * (t[6] + w * (
        t[8] + w * t[10])))))
    s2 = w * (t[1] + w * (t[3] + w * (t[5] + w * (t[7] + w * t[9]))))
    hi = torch.tensor(np.float32(_ATAN_HI), device=x.device)[interval]
    lo = torch.tensor(np.float32(_ATAN_LO), device=x.device)[interval]
    reduced = hi - ((xr * (s1 + s2) - lo) - xr)
    out = torch.where(small, xr - xr * (s1 + s2),
                      torch.where(hx < 0, -reduced, reduced))
    inf_val = _f32(np.float32(_ATAN_HI[3]) + np.float32(_ATAN_LO[3]), x)
    out = torch.where(ix >= 0x4C000000,
                      torch.where(hx > 0, inf_val, -inf_val), out)
    out = torch.where(ix < 0x31000000, x, out)  # |x| < 2^-29
    return torch.where(ix > 0x7F800000, x + x, out)  # NaN


def atan2_f32(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``arctan2(y, x)`` of f32 tensors as XLA computes it on the CPU.

    XLA's CPU backend lowers ``atan2`` to the C library's ``atan2f``; the
    GNU C library's is fdlibm's float algorithm, which is not correctly
    rounded (it differs from the rounded true value on ~16% of gradient
    pairs, by one ulp). The reference's gradient angles come from it, and
    a one-ulp angle can move a perimeter score, so the port computes the
    same algorithm: each step one rounded f32 operation, the same on every
    device. Finite inputs (the Scharr gradients) are handled exactly as
    ``atan2f`` does; infinities are not (no gradient is infinite).
    """
    hx = x.view(torch.int32)
    ix = hx & 0x7FFFFFFF
    hy = y.view(torch.int32)
    iy = hy & 0x7FFFFFFF
    quadrant = ((hy >> 31) & 1) | ((hx >> 30) & 2)  # 2*sign(x) + sign(y)
    k = (iy - ix) >> 23
    z = _atanf((y / x).abs())
    z = torch.where(k > 60, _f32(np.float32(_PI_O_2)
                                 + np.float32(0.5) * np.float32(_PI_LO), z), z)
    z = torch.where((hx < 0) & (k < -60), torch.zeros_like(z), z)
    pi, pi_lo = _f32(_PI, z), _f32(_PI_LO, z)
    out = torch.where(quadrant == 0, z, torch.where(
        quadrant == 1, -z, torch.where(quadrant == 2, pi - (z - pi_lo),
                                       (z - pi_lo) - pi)))
    tiny = np.float32(_TINY)
    on_x_axis = torch.where(quadrant <= 1, y, torch.where(
        quadrant == 2, _f32(np.float32(_PI) + tiny, z),
        _f32(-np.float32(_PI) - tiny, z)))
    out = torch.where(iy == 0, on_x_axis, out)
    on_y_axis = torch.where(hy < 0, _f32(-np.float32(_PI_O_2) - tiny, z),
                            _f32(np.float32(_PI_O_2) + tiny, z))
    out = torch.where((ix == 0) & (iy != 0), on_y_axis, out)
    out = torch.where(hx == 0x3F800000, _atanf(y), out)  # x = 1
    return torch.where((ix > 0x7F800000) | (iy > 0x7F800000), x + y, out)


def histogram_quantiles(values: torch.Tensor, qs, *,
                        batched: bool = False) -> torch.Tensor:
    """Exact quantiles with ``np.quantile``'s linear interpolation.

    The k-th and (k+1)-th order statistics come from one sort; the rank
    ``q * (n - 1)``, its floor and its fraction are f32 exactly as the
    reference computes them, and the interpolation
    ``x_k + frac * (x_k1 - x_k)`` ends in one FMA, as the reference's
    compiled program evaluates it.

    Returns (len(qs),) over all of ``values``; with ``batched`` the leading
    dimension is a batch, each entry has its own quantiles (one sort along
    the flattened rest) and the result is (len(qs), N).
    """
    flat = values.reshape(values.shape[0], -1) if batched else \
        values.reshape(-1)
    n = flat.shape[-1]
    rank = np.asarray(qs, np.float32).reshape(-1) * np.float32(n - 1)
    k = np.clip(np.floor(rank).astype(np.int64), 0, n - 1)
    frac = rank - k.astype(np.float32)
    k1 = np.minimum(k + 1, n - 1)
    srt = torch.sort(flat, dim=-1).values
    x_k = srt[..., torch.as_tensor(k, device=flat.device)]
    x_k1 = srt[..., torch.as_tensor(k1, device=flat.device)]
    frac_t = torch.as_tensor(frac, device=flat.device)
    out = fma_f32(frac_t.expand_as(x_k), x_k1 - x_k, x_k)
    return out.T if batched else out


def histogram_quantile(values: torch.Tensor, q) -> torch.Tensor:
    """The exact quantile ``q`` of all of ``values``: scalar-``q``
    :func:`histogram_quantiles`, as ``magnify_tpu.ops.edge``'s
    ``histogram_quantile`` (without its mesh arguments)."""
    return histogram_quantiles(values, [np.float32(q)])[0]


def canny_nms(dx: torch.Tensor, dy: torch.Tensor, low_thresh: torch.Tensor,
              high_thresh: torch.Tensor):
    """Sector non-max-suppression + double threshold; returns (strong, weak).

    OpenCV's fixed-point sector tests on int16-quantized gradients with L2
    squared magnitudes, compared as f32 (``mag`` can exceed 2^24). For a
    batch (N, H, W) the thresholds are (N,), one pair per plane.
    """
    xs = torch.clamp(torch.trunc(dx), -32768, 32767).to(torch.int32)
    ys = torch.clamp(torch.trunc(dy), -32768, 32767).to(torch.int32)
    mag = xs * xs + ys * ys
    low2 = (low_thresh.to(torch.float32) ** 2)[..., None, None]
    high2 = (high_thresh.to(torch.float32) ** 2)[..., None, None]
    magf = mag.to(torch.float32)

    h, w = magf.shape[-2:]
    mp = F.pad(magf, (1, 1, 1, 1))

    def shift(dr, dc):
        return mp[..., 1 + dr:1 + dr + h, 1 + dc:1 + dc + w]

    left, right = shift(0, -1), shift(0, 1)
    up, down = shift(-1, 0), shift(1, 0)
    ul, ur = shift(-1, -1), shift(-1, 1)
    dl, dr_ = shift(1, -1), shift(1, 1)

    x_abs = torch.abs(xs)
    y_q15 = torch.abs(ys) << 15
    tg22x = x_abs * _TG22
    tg67x = tg22x + (x_abs << 16)

    horiz = y_q15 < tg22x
    vert = y_q15 > tg67x
    same_sign = (xs ^ ys) >= 0

    keep_h = (magf > left) & (magf >= right)
    keep_v = (magf > up) & (magf >= down)
    keep_d_same = (magf > ul) & (magf > dr_)
    keep_d_diff = (magf > ur) & (magf > dl)

    keep = torch.where(
        horiz, keep_h,
        torch.where(vert, keep_v,
                    torch.where(same_sign, keep_d_same, keep_d_diff)),
    )
    cand = (magf > low2) & keep
    strong = cand & (magf > high2)
    return strong, cand


def canny(dx, dy, low_thresh, high_thresh):
    """Canny edges: sector NMS, double threshold, then hysteresis."""
    strong, weak = canny_nms(dx, dy, low_thresh, high_thresh)
    return hysteresis(strong, weak)


def edge_pipeline(img: torch.Tensor, low_edge_quantile: float,
                  high_edge_quantile: float, normalized: bool = True,
                  angles: bool = False):
    """normalize -> blur -> Scharr -> quantile thresholds -> Canny.

    The counterpart of ``magnify_tpu.ops.edge.edge_pipeline``. With
    ``normalized`` (the default here) the caller has already normalized the
    plane to uint8 values
    (:func:`magnify_tpu_torch.ops.detect.normalize_planes_u8`); otherwise
    every plane is min-max normalized first (:func:`normalize_to_u8`), as
    the chip path's per-chamber crops are. ``img``: (H, W), or a batch
    (N, H, W) whose planes each get their own thresholds. Returns (edges
    bool, dx, dy), and with ``angles`` also the gradient angles
    ``arctan2(dy, dx)`` (:func:`atan2_f32`) that the RANSAC scorer reads;
    the dense detector never reads them.

    Note the default: the JAX function's ``normalized`` is False, this
    one's True. A caller passes what the JAX call site means.
    """
    u8 = img.to(torch.float32) if normalized else normalize_to_u8(img)
    blurred = gaussian_blur5_u8(u8)
    dx, dy = scharr(blurred)
    grad = sqrt_f32(dx * dx + dy * dy)
    low_t, high_t = histogram_quantiles(
        grad, [np.float32(low_edge_quantile), np.float32(high_edge_quantile)],
        batched=img.ndim == 3)
    edges = canny(dx, dy, low_t, high_t)
    if angles:
        return edges, dx, dy, atan2_f32(dy, dx)
    return edges, dx, dy
