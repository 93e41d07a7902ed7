// Perimeter-alignment roundness score of circles: the RANSAC detector's
// scorer.
//
//   score(row, col, r) = (1 / n_r) * sum over the n_r Bresenham perimeter
//                        pixels p of the radius-r circle at (row, col) that
//                        are edge pixels of 4 * |wrap(|a_p - e_p|) - pi/2| / pi - 1
//
// with a_p the gradient angle at p and e_p the radial direction of p's
// offset (wrap(d) = d - pi where d > pi).
//
// Replaces: magnify_tpu/ops/score.py:score_circles (:671, an XLA gather and
// sum, not a Pallas kernel). PyTorch has no op that sums in a fixed order,
// and its gather form materializes (N, L) temporaries.
//
// Planes: the kernel reads the UNPADDED (H, W) or (P, H, W) angles (f32)
// and edges (uint8 0/1), while circles are in the coordinates of the
// planes padded by `pad` (the reference pads by 2 * max_radius). A
// perimeter pixel is found as the reference finds it: the flat index
// (o_r + row) * wp + (o_c + col) into the padded plane (hp = H + 2 pad,
// wp = W + 2 pad), clamped to [0, hp * wp - 1] (so a column past the edge
// wraps into the next row), decoded to (pr, pc); it is an edge only inside
// the unpadded plane, and its angle there is the plane's, else 0.
//
// Exactness: the reference is the JAX package's jitted CPU program, and its
// sum order is that of XLA's CPU backend, read from the optimized HLO and
// LLVM IR (XLA_FLAGS=--xla_dump_to=...) at every perimeter length L (the
// padded positions: 1, 8, 12, 16, 24, 32, then 36 and up):
//   * the per-pixel term is align * hit, with align = fma(|d - pi/2|,
//     f32(4/pi), -1): XLA folds "4 * x / pi" into "x * f32(4/pi)" and LLVM
//     contracts the "- 1" into the multiply; a position past n_r is a
//     select to +0;
//   * L = 1 (max_radius 0): the score IS the one term, align * hit, with no
//     sum started from +0 (the division by n = 1 is folded away), so a
//     non-edge pixel whose align is negative scores -0.0;
//   * L = 8 and 12 (max_radius 1, 2): one sum in position order from +0 (a
//     scalar loop, unrolled, not vectorized);
//   * L = 16 to 32 (max_radius 3-5): one 8-wide vector: lane j sums
//     positions j, j + 8, ... in order, then the lanes are halved 8 -> 4 ->
//     2 -> 1 (lanes i and i + 4, then i and i + 2, then 0 and 1);
//   * L > 32: zero-padded to W = ceil(L / 32) windows of 32 (pad
//     (32 W - L) / 2 in front), each window summed in order from +0, then
//     the W window sums in order from +0;
//   * the sum is divided by n_r, correctly rounded.
// Every operation on the summed path is one explicitly rounded intrinsic
// (__fadd_rn, __fsub_rn, __fmaf_rn, __fmul_rn, __fdiv_rn), so nvcc
// contracts nothing. A non-edge or padded position adds nothing to a sum
// started at +0 (a +0 or -0 term leaves it as it is), so every sum skips
// them; only L = 1 computes the signed product.
//
// What bounds it: bytes. Per call it must read each valid circle, the edge
// flag of each distinct perimeter pixel and the angle of each distinct edge
// pixel among them, and write one score per circle (chip_smoke.py::
// _perimeter_work); its float work is 6 operations per edge hit. It runs
// far from that bound: each position is a gather of a table entry, an edge
// byte and (at an edge) an angle, a lane's positions at scattered pixels,
// so the time is the caches' transactions and their latency.
//
// What held the first design (one thread per circle walking its positions
// in order, one load chain at a time) back, and what this one does:
//   * lanes over positions where a call has few circles (the hill-climbs,
//     C8's plane): it took ~L dependent load chains per call however few
//     circles, so here the lanes that hold the reduction's partial sums
//     share a circle and are combined by shuffles in XLA's order (for
//     L > 32, ceil(W / 2) lanes, lane g folding window g and window
//     W - 1 - g so that the lanes' shares come out about even; for
//     L = 16-32, 8 lanes, lane j folding positions j, j + 8, ... then
//     halved); one lane a circle where a call has circles to fill the card;
//   * loads in flight: a lane loads kUnroll positions at once (their table
//     entries, then their edge bytes, then the angles of the edges among
//     them) before it adds any in order;
//   * the table position-major, (L, max_radius + 1) entries {dy << 16 | dx &
//     0xffff, expected's f32 bits}: the lanes of a warp walk their
//     circles' positions in step, so the k-th positions of all the radii
//     they hold are one contiguous run (it was a row per radius, as many
//     cache lines per load as radii in the warp: up to 12 on chip C);
//   * pixels without the pad (the caller's padded copies are gone): a
//     circle whose perimeter lies inside the unpadded plane reads centre
//     pixel + dy * w + dx; one inside the padded plane checks each pixel
//     against the unpadded one (outside: a pad pixel, no edge), in the same
//     unrolled loop; any other (only a hill-climb neighbour can be) finds
//     each pixel as the reference does, clamped flat index and all, one
//     load after another;
//   * the table is read through the read-only cache, so any radius works.
// Tried on the H100 and dropped, each slower on the dense inputs (PERF.md
// section 6; scripts/perimeter_variants.py): staging a chamber crop, or
// the band of plane rows a block's circles reach, in shared memory;
// regrouping a chunk's circles by radius; listing a block's interior
// circles before the others, so that fewer warps check pixels; a
// grid-stride loop; loads at clamped addresses in place of predicated
// ones.
// One launch per call; the wrapper (ops/score.py::perimeter_plan) picks
// the lanes per circle from the number of circles.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 128;
constexpr int kUnroll = 4;  // positions a lane loads at once

enum Form { kOne = 0, kSeq = 1, kLanes8 = 2, kWindows = 3 };

struct Params {
  const float* angles;
  const uint8_t* edges;
  int h, w, pad, hp, wp;
  const int* circles;
  const uint8_t* valid;
  int n, per_plane;
  // (L, max_radius + 1) entries {dy << 16 | dx & 0xffff, expected's bits}.
  const int2* table;
  const int* lengths;
  int max_radius, L, n_windows, lead;
  int lanes;  // lanes a circle
  float* out;
};

__device__ __forceinline__ float align_of(float a, float expected) {
  const float kPi = __int_as_float(0x40490FDB);          // f32(pi)
  const float kHalfPi = __int_as_float(0x3FC90FDB);      // f32(pi / 2)
  const float kFourOverPi = __int_as_float(0x3FA2F983);  // f32(4 / pi)
  float d = fabsf(__fsub_rn(a, expected));
  if (d > kPi) d = __fadd_rn(d, -kPi);
  return __fmaf_rn(fabsf(__fadd_rn(d, -kHalfPi)), kFourOverPi, -1.0f);
}

// The term of one perimeter position from its edge byte and angle.
template <int kForm>
__device__ __forceinline__ float term_of(uint8_t e, float a, float expected) {
  if (kForm == kOne)  // the product itself: -0.0 where align < 0, no edge
    return __fmul_rn(align_of(a, expected), e ? 1.0f : 0.0f);
  return e ? align_of(a, expected) : 0.0f;
}

// Where a circle's perimeter pixels are: kInterior, all inside the
// unpadded plane; kNear, all inside the padded plane (a pixel outside the
// unpadded one is a pad pixel: no edge, angle 0); kFar, some outside it.
enum Where { kInterior = 0, kNear = 1, kFar = 2 };

struct Circle {
  int row, col, r, plane, where;
  int base;  // the centre's pixel in the plane stack (unpadded)
};

__device__ __forceinline__ Circle circle_of(const Params& P, int i) {
  Circle C;
  C.row = P.circles[3 * i];
  C.col = P.circles[3 * i + 1];
  C.r = min(max(P.circles[3 * i + 2], 0), P.max_radius);
  C.plane = i / P.per_plane;
  // r bounds every offset of the clipped radius.
  const long long y = (long long)C.row - P.pad, x = (long long)C.col - P.pad;
  C.where = y - C.r >= 0 && y + C.r < P.h && x - C.r >= 0 && x + C.r < P.w
                ? kInterior
            : C.row - C.r >= 0 && (long long)C.row + C.r < P.hp &&
                    C.col - C.r >= 0 && (long long)C.col + C.r < P.wp
                ? kNear
                : kFar;
  C.base = C.where == kFar
               ? 0
               : (int)(((long long)C.plane * P.h + y) * P.w + x);
  return C;
}

// The table entry of position p of radius r.
__device__ __forceinline__ int2 entry(const Params& P, int p, int r) {
  return __ldg(P.table + p * (P.max_radius + 1) + r);
}

// The term at position p of circle C, its pixel found as the reference
// finds it: the flat index into the padded plane, clamped.
template <int kForm>
__device__ float position_term(const Params& P, const Circle& C, int p) {
  const int2 tb = entry(P, p, C.r);
  const float expected = __int_as_float(tb.y);
  long long pr = (long long)C.row + (tb.x >> 16);
  long long pc = (long long)C.col + (int)(short)(tb.x & 0xffff);
  if (pr < 0 || pr >= P.hp || pc < 0 || pc >= P.wp) {
    const long long last = (long long)P.hp * P.wp - 1;
    long long flat = pr * P.wp + pc;
    flat = flat < 0 ? 0 : (flat > last ? last : flat);
    pr = flat / P.wp;
    pc = flat - pr * P.wp;
  }
  const int y = (int)pr - P.pad, x = (int)pc - P.pad;
  if (y < 0 || y >= P.h || x < 0 || x >= P.w)
    return term_of<kForm>(0, 0.0f, expected);  // a pad pixel
  const long long i = ((long long)C.plane * P.h + y) * P.w + x;
  const uint8_t e = __ldg(P.edges + i);
  return term_of<kForm>(
      e, e || kForm == kOne ? __ldg(P.angles + i) : 0.0f, expected);
}

// acc[k % kAcc] += the terms of positions p0 + k * step < p1, each in order
// from what acc holds. A non-edge position adds nothing to such a sum, so
// only edge positions are added. A circle inside the padded plane loads
// kUnroll (at least kAcc) positions at once: their table entries, then
// their edge bytes (each checked against the unpadded plane if the circle
// is not interior), then the angles of the edges among them. A circle with
// pixels outside the padded plane goes one position after another.
template <int kForm, int kAcc>
__device__ __forceinline__ void fold(const Params& P, const Circle& C,
                                     float (&acc)[kAcc], int p0, int p1,
                                     int step) {
  constexpr int kU = kUnroll > kAcc ? kUnroll : kAcc;
  static_assert(kU % kAcc == 0, "accumulators must divide the unroll");
  if (C.where == kFar) {
    for (int p = p0; p < p1; p += step * kAcc) {
#pragma unroll
      for (int u = 0; u < kAcc; ++u)
        if (p + u * step < p1)
          acc[u] = __fadd_rn(acc[u],
                             position_term<kForm>(P, C, p + u * step));
    }
    return;
  }
  const bool checked = C.where == kNear;
  const int cy = C.row - P.pad, cx = C.col - P.pad;
  for (int p = p0; p < p1; p += step * kU) {
    int pix[kU];
    float ex[kU], a[kU];
    bool e[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int q = p + u * step;
      const int2 tb = entry(P, q < p1 ? q : p0, C.r);
      const int dy = tb.x >> 16, dx = (int)(short)(tb.x & 0xffff);
      pix[u] = C.base + dy * P.w + dx;
      ex[u] = __int_as_float(tb.y);
      e[u] = q < p1 && (!checked || ((unsigned)(cy + dy) < (unsigned)P.h &&
                                     (unsigned)(cx + dx) < (unsigned)P.w));
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) e[u] = e[u] && __ldg(P.edges + pix[u]);
#pragma unroll
    for (int u = 0; u < kU; ++u)
      a[u] = e[u] ? __ldg(P.angles + pix[u]) : 0.0f;
#pragma unroll
    for (int u = 0; u < kU; ++u)
      if (e[u])
        acc[u % kAcc] = __fadd_rn(acc[u % kAcc], align_of(a[u], ex[u]));
  }
}

// The positions of window w (slot k is position 32 w - lead + k) of a
// perimeter of len positions: [first, last).
__device__ __forceinline__ int2 window_range(const Params& P, int w,
                                             int len) {
  return make_int2(max(32 * w - P.lead, 0), min(32 * w - P.lead + 32, len));
}

// The whole sum of a circle's len positions in one lane, in XLA's order.
template <int kForm>
__device__ __forceinline__ float whole_sum(const Params& P, const Circle& C,
                                           int len) {
  if constexpr (kForm == kOne) {
    return position_term<kForm>(P, C, 0);
  } else if constexpr (kForm == kLanes8) {
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    fold<kForm, 8>(P, C, acc, 0, len, 1);
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[k] = __fadd_rn(acc[k], acc[k + 4]);
#pragma unroll
    for (int k = 0; k < 2; ++k) acc[k] = __fadd_rn(acc[k], acc[k + 2]);
    return __fadd_rn(acc[0], acc[1]);
  } else if constexpr (kForm == kSeq) {
    float acc[1] = {0.0f};
    fold<kForm, 1>(P, C, acc, 0, len, 1);
    return acc[0];
  } else {
    float total = 0.0f;
    for (int w = 0; w < P.n_windows; ++w) {
      const int2 r = window_range(P, w, len);
      float acc[1] = {0.0f};
      fold<kForm, 1>(P, C, acc, r.x, r.y, 1);
      total = __fadd_rn(total, acc[0]);
    }
    return total;
  }
}

// Lanes that score one circle when its positions are spread: kWindows
// pairs window g with window W - 1 - g in lane g, so that the lanes' shares
// of a perimeter are about even.
__host__ __device__ constexpr int spread_lanes(int form, int n_windows) {
  return form == kWindows ? (n_windows + 1) / 2 : form == kLanes8 ? 8 : 1;
}

// Lane `sub` of the G that score circle C: its share of the partial sums.
template <int kForm>
__device__ __forceinline__ float2 share_of(const Params& P, const Circle& C,
                                           int len, int sub) {
  float a[1] = {0.0f}, b[1] = {0.0f};
  if constexpr (kForm == kLanes8) {
    fold<kForm, 1>(P, C, a, sub, len, 8);
  } else {
    const int2 r1 = window_range(P, sub, len);
    fold<kForm, 1>(P, C, a, r1.x, r1.y, 1);
    if (P.n_windows - 1 - sub != sub) {
      const int2 r2 = window_range(P, P.n_windows - 1 - sub, len);
      fold<kForm, 1>(P, C, b, r2.x, r2.y, 1);
    }
  }
  return make_float2(a[0], b[0]);
}

// Circle (b * warps + w) * (32 / G) + l / G in lanes l of warp w of block
// b, G lanes a circle (kSpread: P.lanes, else 1).
template <int kForm, bool kSpread>
__global__ void __launch_bounds__(kThreads) perimeter_score(Params P) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int G = kSpread ? P.lanes : 1, per_warp = 32 / G, c = lane / G,
            sub = lane - c * G;
  const int first = (blockIdx.x * (kThreads / 32) + warp) * per_warp;
  if (first >= P.n) return;  // the whole warp
  const int i = first + c;
  const bool mine = c < per_warp && i < P.n;
  const bool ok = mine && (P.valid == nullptr || P.valid[i]);
  if (mine && !ok && sub == 0) P.out[i] = -__int_as_float(0x7F800000);
  if constexpr (!kSpread) {
    if (!ok) return;
    const Circle C = circle_of(P, i);
    const int len = __ldg(P.lengths + C.r);
    P.out[i] = __fdiv_rn(whole_sum<kForm>(P, C, len), (float)len);
  } else {
    float2 part = make_float2(0.0f, 0.0f);
    int len = 1;
    if (ok) {
      const Circle C = circle_of(P, i);
      len = __ldg(P.lengths + C.r);
      part = share_of<kForm>(P, C, len, sub);
    }
    // Combine a circle's partial sums in XLA's order, in its first lane.
    float total = part.x;
    if constexpr (kForm == kLanes8) {
#pragma unroll
      for (int d = 4; d > 0; d >>= 1)
        total = __fadd_rn(total, __shfl_down_sync(kFull, total, d, 8));
    } else {
      total = 0.0f;
      for (int w = 0; w < P.n_windows; ++w) {
        const int g = w < G ? w : P.n_windows - 1 - w;
        const float lo = __shfl_sync(kFull, part.x, c * G + g);
        const float hi = __shfl_sync(kFull, part.y, c * G + g);
        total = __fadd_rn(total, w < G ? lo : hi);
      }
    }
    if (ok && sub == 0) P.out[i] = __fdiv_rn(total, (float)len);
  }
}

template <int kForm>
int launch(const Params& P, cudaStream_t s) {
  const int per_block = (kThreads / 32) * (32 / P.lanes);
  const unsigned blocks = (unsigned)((P.n + per_block - 1) / per_block);
  if constexpr (kForm == kLanes8 || kForm == kWindows) {
    if (P.lanes > 1) {
      perimeter_score<kForm, true><<<blocks, kThreads, 0, s>>>(P);
      return (int)cudaGetLastError();
    }
  }
  perimeter_score<kForm, false><<<blocks, kThreads, 0, s>>>(P);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Scores of `n` circles (row, col, radius) int32, in the coordinates of
// the planes padded by `pad`, `per_plane` consecutive circles on each
// plane (n for one plane). `angles` (n / per_plane, h, w) f32 and `edges`
// uint8 0/1; `valid` n uint8 (null: all valid) gives -inf where 0. Tables:
// `table` (L, max_radius + 1) int32 pairs {dy << 16 | dx & 0xffff,
// expected's f32 bits}, `lengths` (max_radius + 1,) int32. `lanes` a
// circle: 1, or the lanes that spread its positions (ceil(ceil(L / 32) /
// 2) for L > 32, 8 for L = 16-32; at most 32). One launch on `stream`, no
// synchronisation. Returns cudaGetLastError().
int mg_perimeter_score(const void* angles, const void* edges, int h, int w,
                       int pad, const void* circles, const void* valid,
                       int n, int per_plane, const void* table,
                       const void* lengths, int max_radius, int L, int lanes,
                       void* out, void* stream) {
  if (n <= 0) return 0;
  const int form = L == 1 ? kOne : L < 16 ? kSeq : L <= 32 ? kLanes8
                                                           : kWindows;
  const int n_windows = form == kWindows ? (L + 31) / 32 : 1;
  if ((lanes != 1 && lanes != spread_lanes(form, n_windows)) || lanes > 32 ||
      per_plane <= 0)
    return (int)cudaErrorInvalidValue;
  const Params P = {static_cast<const float*>(angles),
                    static_cast<const uint8_t*>(edges),
                    h, w, pad, h + 2 * pad, w + 2 * pad,
                    static_cast<const int*>(circles),
                    static_cast<const uint8_t*>(valid), n, per_plane,
                    static_cast<const int2*>(table),
                    static_cast<const int*>(lengths), max_radius, L,
                    n_windows,
                    form == kWindows ? (n_windows * 32 - L) / 2 : 0, lanes,
                    static_cast<float*>(out)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (form) {
    case kOne: return launch<kOne>(P, s);
    case kSeq: return launch<kSeq>(P, s);
    case kLanes8: return launch<kLanes8>(P, s);
    default: return launch<kWindows>(P, s);
  }
}

}  // extern "C"
