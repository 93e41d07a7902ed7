// Perimeter-alignment roundness score of circles: the RANSAC detector's
// scorer.
//
//   score(row, col, r) = (1 / n_r) * sum over the n_r Bresenham perimeter
//                        pixels p of the radius-r circle at (row, col) that
//                        are edge pixels of 4 * |wrap(|a_p - e_p|) - pi/2| / pi - 1
//
// with a_p the gradient angle at p and e_p the radial direction of p's
// offset (wrap(d) = d - pi where d > pi). The planes are padded by 2 * R on
// every side, so every perimeter pixel of a circle that touches the image
// lies inside; a pixel index is clamped into the plane all the same.
//
// Replaces: magnify_tpu/ops/score.py:score_circles (:671, an XLA gather and
// sum, not a Pallas kernel). PyTorch has no op that sums in a fixed order,
// and its gather form materializes (N, L) temporaries (at 5e6 proposals a
// plane holds ~1e5 unique circles: tens of MB per temporary).
//
// Exactness: the reference is the JAX package's jitted CPU program, and its
// sum order is that of XLA's CPU backend, read from the optimized HLO and
// LLVM IR:
//   * the per-pixel term is align * hit, with align = fma(|d - pi/2|,
//     f32(4/pi), -1): XLA folds "4 * x / pi" into "x * f32(4/pi)" and LLVM
//     contracts the "- 1" into the multiply;
//   * a perimeter of L > 32 padded positions is summed as XLA's tree
//     reduction rewrites it: zero-padded to W = ceil(L / 32) windows of 32
//     (pad (32 W - L) / 2 in front), each window summed in order from +0,
//     then the W window sums in order from +0;
//   * L <= 32 (radii below 6) is reduced by one 8-wide vector: lane j sums
//     positions j, j + 8, ... in order, then the lanes are halved 8 -> 4 -> 2
//     -> 1 (lanes i and i + 4, then i and i + 2, then 0 and 1);
//   * the sum is divided by n_r, correctly rounded.
// Every operation here is one explicitly rounded intrinsic (__fadd_rn,
// __fmaf_rn, __fdiv_rn), so nvcc contracts nothing behind our back. A
// padded or non-edge position adds +0, which leaves a sum that started at +0
// unchanged, so it is skipped.
//
// Design: one thread per circle; the circle walks its radius's offsets in
// order, reading the offset, length and expected-angle tables through the
// read-only cache (at radius 15 they are 17 x 88 entries, shared by every
// thread). The scores of a batch of planes (the chip path's chamber crops)
// go through one launch: circle i reads plane plane[i].

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float term(float acc, const float* angles,
                                      const uint8_t* edges, long long idx,
                                      float expected) {
  if (!edges[idx]) return acc;
  const float kPi = __int_as_float(0x40490FDB);          // f32(pi)
  const float kHalfPi = __int_as_float(0x3FC90FDB);      // f32(pi / 2)
  const float kFourOverPi = __int_as_float(0x3FA2F983);  // f32(4 / pi)
  float d = fabsf(__fsub_rn(__ldg(angles + idx), expected));
  if (d > kPi) d = __fadd_rn(d, -kPi);
  const float a0 = fabsf(__fadd_rn(d, -kHalfPi));
  return __fadd_rn(acc, __fmaf_rn(a0, kFourOverPi, -1.0f));
}

__global__ void __launch_bounds__(kThreads) perimeter_score_kernel(
    const float* __restrict__ angles, const uint8_t* __restrict__ edges,
    int hp, int wp, const int* __restrict__ circles,
    const int* __restrict__ plane, const uint8_t* __restrict__ valid, int n,
    const int2* __restrict__ offsets, const int* __restrict__ lengths,
    const float* __restrict__ expected, int max_radius, int L,
    float* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  if (valid != nullptr && !valid[i]) {
    out[i] = -__int_as_float(0x7F800000);
    return;
  }
  const int row = circles[3 * i], col = circles[3 * i + 1];
  const int r = min(max(circles[3 * i + 2], 0), max_radius);
  const int len = __ldg(lengths + r);
  const int2* offs = offsets + (long long)r * L;
  const float* expect = expected + (long long)r * L;
  const long long plane_size = (long long)hp * wp;
  const long long base = plane != nullptr ? plane[i] * plane_size : 0;
  const float* a = angles + base;
  const uint8_t* e = edges + base;

  auto pixel = [&](int p) -> long long {
    const int2 o = __ldg(offs + p);
    const long long idx = (long long)(o.x + row) * wp + (o.y + col);
    return min(max(idx, 0LL), plane_size - 1);
  };

  float total = 0.0f;
  if (L > 32) {
    const int n_windows = (L + 31) / 32;
    const int lead = (n_windows * 32 - L) / 2;
    for (int w = 0; w < n_windows; ++w) {
      float acc = 0.0f;
      const int p0 = max(w * 32 - lead, 0);
      const int p1 = min(w * 32 - lead + 32, len);
      for (int p = p0; p < p1; ++p)
        acc = term(acc, a, e, pixel(p), __ldg(expect + p));
      total = __fadd_rn(total, acc);
    }
  } else {
    float lane[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int p = 0; p < len; ++p)
      lane[p & 7] = term(lane[p & 7], a, e, pixel(p), __ldg(expect + p));
    for (int k = 0; k < 4; ++k) lane[k] = __fadd_rn(lane[k], lane[k + 4]);
    for (int k = 0; k < 2; ++k) lane[k] = __fadd_rn(lane[k], lane[k + 2]);
    total = __fadd_rn(lane[0], lane[1]);
  }
  out[i] = __fdiv_rn(total, (float)len);
}

}  // namespace

extern "C" {

// Scores of `n` circles (n, 3) int32 (row, col, radius), already shifted
// into the padded planes. `angles` (n_planes, hp, wp) f32 and `edges`
// (n_planes, hp, wp) uint8 0/1; `plane` (n,) int32 names each circle's
// plane (null: plane 0); `valid` (n,) uint8 (null: all valid) gives -inf
// where 0. Tables: `offsets` (max_radius + 1, L, 2) int32, `lengths`
// (max_radius + 1,) int32, `expected` (max_radius + 1, L) f32. One launch on
// `stream`, no synchronisation. Returns the launch's cudaGetLastError().
int mg_perimeter_score(const void* angles, const void* edges, int hp, int wp,
                       const void* circles, const void* plane,
                       const void* valid, int n, const void* offsets,
                       const void* lengths, const void* expected,
                       int max_radius, int L, void* out, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  perimeter_score_kernel<<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(angles), static_cast<const uint8_t*>(edges),
      hp, wp, static_cast<const int*>(circles),
      static_cast<const int*>(plane), static_cast<const uint8_t*>(valid), n,
      static_cast<const int2*>(offsets), static_cast<const int*>(lengths),
      static_cast<const float*>(expected), max_radius, L,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
