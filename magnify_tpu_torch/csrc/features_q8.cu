// The dense detector's int8 alignment features on the H100: per pixel, the
// 8 channels round(127 * edge * (cos 2ka, sin 2ka)), k = 1, 3, 5, 7, of the
// gradient angle a, from the edge mask and the Scharr gradients.
//
// Replaces: the features half of the int8 score maps,
// magnify_tpu/ops/score.py:498 _alignment_features (grads given, qdtype
// "int8") with :478 _cs2_from_grads, one XLA fusion on the TPU (no Pallas
// kernel). The port's torch chain (ops/score.py
// alignment_features_q8_plain) computes the same values in about 370 ATen
// launches, most of them over float64 and int64 planes, because torch has
// no single-rounding float32 multiply-add: ops/edge.py fma_f32 emulates one
// with TwoSum and round-to-odd in float64.
//
// Arithmetic, in this order, each step one explicitly rounded intrinsic so
// that nvcc contracts nothing (it would fuse a*b+c otherwise):
//   xx = dx*dx, yy = dy*dy, g2 = xx + yy;
//   (c1, s1) = ((xx - yy) / g2, ((2*dx)*dy) / g2) where g2 > 0, else (1, 0)
//     (a NaN g2 is not > 0);
//   c_{k+1} = fma(c_k, c1, -(s_k*s1)), s_{k+1} = fma(s_k, c1, c_k*s1), the
//     first product of each line contracted into the sum as XLA's CPU
//     program contracts it, the second rounded on its own; up to k = 7;
//   channel 2j, 2j + 1 (k = 2j + 1) = int8(rint((e*c_k) * 127)),
//     int8(rint((e*s_k) * 127)), e = 1.0f or 0.0f.
// __fmaf_rn is the single rounding that fma_f32 emulates, and
// __fmul_rn/__fadd_rn/__fsub_rn/__fdiv_rn are the IEEE operations of
// torch's separate launches (nvcc's default -prec-div=true, no flush to
// zero), so the features are the torch chain's bit for bit. rintf rounds
// half to even, as torch.round does, and the conversion to int8 is the C++
// float-to-int8 cast that torch's .to(torch.int8) makes.
//
// What bounds it: bytes. A pixel reads its edge byte and two floats and
// writes 8 bytes: 17 B, 0.25 ms at 3.35 TB/s for the dense chip's 49.4 Mpx
// search plane. The arithmetic, two IEEE divisions, 12 multiplies and FMAs
// of the recurrence and 8 quantizations, is about 100 instructions a
// pixel, below that bound at the card's rate.
//
// Design: no shared memory, no atomics, one launch a call. blockIdx.y walks
// the planes of a batch (N, H, W) and each thread takes 4 consecutive
// pixels of one plane's flat H*W pixels (so a group never spans two
// planes): one 16-byte load of dx and of dy and one 4-byte load of the
// edges, and per channel one 4-byte store, where the addresses are aligned
// and the group is whole; otherwise element by element (a plane's last
// group, a plane whose H*W is not a multiple of 4, so that its later
// planes or channels start off a 4-byte boundary, or a view that starts
// off one). A warp covers 128 consecutive pixels, so every load and store
// of a warp is contiguous.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPix = 4;  // consecutive pixels a thread
constexpr int kChannels = 8;
constexpr int kMaxGridY = 65535;

__device__ __forceinline__ bool aligned(const void* p, unsigned bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

__device__ __forceinline__ uint32_t quantize(float e, float v) {
  const int8_t q = static_cast<int8_t>(rintf(__fmul_rn(__fmul_rn(e, v),
                                                       127.0f)));
  return static_cast<uint8_t>(q);
}

// The 8 int8 channels of one pixel, channel c in byte c of the pair.
__device__ __forceinline__ uint2 features_of(float e, float dx, float dy) {
  const float xx = __fmul_rn(dx, dx), yy = __fmul_rn(dy, dy);
  const float g2 = __fadd_rn(xx, yy);
  float c1 = 1.0f, s1 = 0.0f;
  if (g2 > 0.0f) {
    c1 = __fdiv_rn(__fsub_rn(xx, yy), g2);
    s1 = __fdiv_rn(__fmul_rn(__fmul_rn(2.0f, dx), dy), g2);
  }
  float c = c1, s = s1;
  uint32_t lo = 0, hi = 0;
#pragma unroll
  for (int k = 1; k <= 7; k += 2) {
    const uint32_t pair = quantize(e, c) | quantize(e, s) << 8;
    if (k < 5) {
      lo |= pair << (8 * (k - 1));
    } else {
      hi |= pair << (8 * (k - 5));
    }
    if (k == 7) break;
#pragma unroll
    for (int step = 0; step < 2; ++step) {  // harmonic k -> k + 2
      const float cn = __fmaf_rn(c, c1, -__fmul_rn(s, s1));
      const float sn = __fmaf_rn(s, c1, __fmul_rn(c, s1));
      c = cn;
      s = sn;
    }
  }
  return make_uint2(lo, hi);
}

__global__ void __launch_bounds__(kThreads)
features_q8(const uint8_t* __restrict__ edges, const float* __restrict__ dx,
            const float* __restrict__ dy, int planes, long long hw,
            int8_t* __restrict__ out) {
  const long long p =
      ((long long)blockIdx.x * kThreads + threadIdx.x) * kPix;
  if (p >= hw) return;
  const int n_pix = hw - p < kPix ? (int)(hw - p) : kPix;
  for (int n = blockIdx.y; n < planes; n += gridDim.y) {
    const long long i = (long long)n * hw + p;
    float fx[kPix], fy[kPix], fe[kPix];
    const bool whole = n_pix == kPix;
    if (whole && aligned(dx + i, 16) && aligned(dy + i, 16) &&
        aligned(edges + i, 4)) {
      const float4 vx = *reinterpret_cast<const float4*>(dx + i);
      const float4 vy = *reinterpret_cast<const float4*>(dy + i);
      const uint32_t ve = *reinterpret_cast<const uint32_t*>(edges + i);
      fx[0] = vx.x, fx[1] = vx.y, fx[2] = vx.z, fx[3] = vx.w;
      fy[0] = vy.x, fy[1] = vy.y, fy[2] = vy.z, fy[3] = vy.w;
#pragma unroll
      for (int j = 0; j < kPix; ++j)
        fe[j] = (ve >> (8 * j) & 0xffu) ? 1.0f : 0.0f;
    } else {
#pragma unroll
      for (int j = 0; j < kPix; ++j) {
        const bool in = j < n_pix;
        fx[j] = in ? dx[i + j] : 0.0f;
        fy[j] = in ? dy[i + j] : 0.0f;
        fe[j] = in && edges[i + j] ? 1.0f : 0.0f;
      }
    }
    // words[c]: channel c of the 4 pixels, pixel j in byte j.
    uint32_t words[kChannels] = {};
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      const uint2 f = features_of(fe[j], fx[j], fy[j]);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        words[c] |= (f.x >> (8 * c) & 0xffu) << (8 * j);
        words[c + 4] |= (f.y >> (8 * c) & 0xffu) << (8 * j);
      }
    }
    int8_t* dst = out + (long long)n * kChannels * hw + p;
#pragma unroll
    for (int c = 0; c < kChannels; ++c, dst += hw) {
      if (whole && aligned(dst, 4)) {
        *reinterpret_cast<uint32_t*>(dst) = words[c];
      } else {
        for (int j = 0; j < n_pix; ++j)
          dst[j] = static_cast<int8_t>(words[c] >> (8 * j));
      }
    }
  }
}

}  // namespace

extern "C" {

// edges: `planes` contiguous (h*w) uint8 0/1 planes (a bool tensor's
// bytes); dx, dy: the same shape in float32; out: (planes, 8, h*w) int8.
// planes >= 1, 1 <= hw < 2^40. One launch on `stream`, no synchronisation.
// Returns cudaGetLastError() after it.
int mg_features_q8(const void* edges, const void* dx, const void* dy,
                   int planes, long long hw, void* out, void* stream) {
  const long long blocks = (hw + (long long)kThreads * kPix - 1) /
                           ((long long)kThreads * kPix);
  const dim3 grid((unsigned)blocks,
                  (unsigned)(planes < kMaxGridY ? planes : kMaxGridY));
  features_q8<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(edges), static_cast<const float*>(dx),
      static_cast<const float*>(dy), planes, hw, static_cast<int8_t*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
