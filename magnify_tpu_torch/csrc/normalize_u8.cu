// Per-plane min-max normalization of uint16 planes to uint8 on the H100.
//
// Replaces: the host's normalization of the dense finders' search planes,
// magnify_tpu/ops/detect.py:992 normalize_planes_u8, which is the numpy twin
// of magnify_tpu/ops/edge.py:42 normalize_to_u8 for whole planes. It is no
// TPU kernel: the JAX package normalizes on the host so that 1 byte a pixel
// crosses its link. On the H100 that host pass (about seven float32 passes
// through temporaries) took half of a dense frame's wall time, so the
// finders now send the raw uint16 planes and this kernel makes the uint8
// planes where detection reads them.
//
// The arithmetic is the host's float32, so the planes are bit for bit the
// same: lo and hi are the plane's min and max, peak = (float)hi - (float)lo,
// q = trunc(255 * ((float)v - (float)lo) / peak), and 0 everywhere where
// peak == 0. Every uint16 value is exact in float32, and so are v - lo and
// 255 * (v - lo) (below 2^24); the one rounding is the division's, to
// nearest even, as numpy divides. No fused multiply-add, no fast-math
// division and no reciprocal.
//
// What bounds it: bytes. Pass 1 reads 2 bytes a pixel; pass 2 reads 2 and
// writes 1: 5 bytes a pixel, 0.072 ms at 3.35 TB/s for the chip's 48.5 Mpx
// plane (the plane is 97 MB, twice the 50 MB L2, so pass 2 reads it from
// device memory again). A dozen instructions a pixel, most of them the
// IEEE division, stay below that.
//
// Design: two launches on the caller's stream for a batch of B planes of
// H x W, blockIdx.y the plane, nothing sent back to the host.
//  1. min/max: each thread folds 16-byte loads (8 pixels) in a grid-stride
//     loop into two packed halfword minima and maxima (__vminu2/__vmaxu2),
//     then warp shuffles and one shared-memory step reduce the block, and
//     one atomicMin and one atomicMax a block go into the plane's pair of
//     32-bit words (which the caller sets to 0xffffffff and 0 on the stream
//     first). Min and max are exact in any order: no run-to-run variation.
//  2. quantize: 16-byte loads, 8 pixels through the arithmetic above, one
//     8-byte store.
// A plane that does not start on 16 bytes (a view, or the planes of a batch
// whose H * W is not a multiple of 8) and a plane length that is not a
// multiple of 8 leave up to 7 head and 7 tail pixels, which the first
// threads of the plane's first block take one by one. Where a plane's
// output does not start on 8 bytes (its input start was not on 16), pass 2
// stores the 8 bytes one by one.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 8;          // pixels in one 16-byte load
constexpr int kBlocksPerSm = 8;  // 2,048 resident threads an SM

// The 16-byte aligned body of the plane that starts at p with n pixels:
// `head` pixels before it, `nvec` groups of 8 in it, `tail` after it.
struct Body {
  long long head, nvec, tail;
};

__device__ __forceinline__ Body body_of(const uint16_t* p, long long n) {
  // p is 2-byte aligned: (address mod 16) / 2 pixels past the last boundary.
  const long long past = (reinterpret_cast<uintptr_t>(p) & 15) >> 1;
  long long head = past ? kVec - past : 0;
  if (head > n) head = n;
  const long long nvec = (n - head) / kVec;
  return {head, nvec, n - head - nvec * kVec};
}

// The scalar pixel a thread takes among the head and tail, or -1.
__device__ __forceinline__ long long scalar_index(const Body& s, long long t) {
  if (t < s.head) return t;
  if (t < s.head + s.tail) return s.head + s.nvec * kVec + (t - s.head);
  return -1;
}

__global__ void __launch_bounds__(kThreads)
normalize_minmax(const uint16_t* __restrict__ in, long long n, int planes,
                 unsigned* __restrict__ stats) {
  const int b = blockIdx.y;
  const uint16_t* p = in + (long long)b * n;
  const Body s = body_of(p, n);
  const uint4* v = reinterpret_cast<const uint4*>(p + s.head);
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  unsigned lo2 = 0xffffffffu, hi2 = 0u;  // two halfword lanes each
  for (long long i = t; i < s.nvec; i += stride) {
    const uint4 q = __ldg(v + i);
    lo2 = __vminu2(__vminu2(lo2, q.x), __vminu2(q.y, __vminu2(q.z, q.w)));
    hi2 = __vmaxu2(__vmaxu2(hi2, q.x), __vmaxu2(q.y, __vmaxu2(q.z, q.w)));
  }
  unsigned lo = min(lo2 & 0xffffu, lo2 >> 16);
  unsigned hi = max(hi2 & 0xffffu, hi2 >> 16);
  const long long k = scalar_index(s, t);
  if (k >= 0) {
    lo = min(lo, (unsigned)p[k]);
    hi = max(hi, (unsigned)p[k]);
  }
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  __shared__ unsigned s_lo[kWarps], s_hi[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_lo[warp] = lo;
    s_hi[warp] = hi;
  }
  __syncthreads();
  if (warp != 0) return;
  lo = lane < kWarps ? s_lo[lane] : 0xffffu;
  hi = lane < kWarps ? s_hi[lane] : 0u;
  for (int o = kWarps / 2; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  if (lane == 0) {
    atomicMin(stats + b, lo);
    atomicMax(stats + planes + b, hi);
  }
}

// trunc(255 * (v - lo) / peak) in the host's float32 steps; 0 if peak == 0.
__device__ __forceinline__ unsigned quantize(unsigned v, float lo, float peak) {
  if (!(peak > 0.f)) return 0u;
  const float x = __fsub_rn(__uint2float_rn(v), lo);
  return __float2uint_rz(__fdiv_rn(__fmul_rn(255.f, x), peak));
}

// Two halfword pixels of `w` to two bytes, low pixel in the low byte.
__device__ __forceinline__ unsigned quantize2(unsigned w, float lo,
                                              float peak) {
  return quantize(w & 0xffffu, lo, peak) |
         (quantize(w >> 16, lo, peak) << 8);
}

__global__ void __launch_bounds__(kThreads)
normalize_quantize(const uint16_t* __restrict__ in, long long n, int planes,
                   const unsigned* __restrict__ stats,
                   uint8_t* __restrict__ out) {
  const int b = blockIdx.y;
  const uint16_t* p = in + (long long)b * n;
  uint8_t* o = out + (long long)b * n;
  const Body s = body_of(p, n);
  const float lo = __uint2float_rn(stats[b]);
  const float peak = __fsub_rn(__uint2float_rn(stats[planes + b]), lo);
  const uint4* v = reinterpret_cast<const uint4*>(p + s.head);
  uint8_t* ob = o + s.head;
  const bool aligned = (reinterpret_cast<uintptr_t>(ob) & 7) == 0;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = t; i < s.nvec; i += stride) {
    const uint4 q = __ldg(v + i);
    const uint2 r = make_uint2(
        quantize2(q.x, lo, peak) | (quantize2(q.y, lo, peak) << 16),
        quantize2(q.z, lo, peak) | (quantize2(q.w, lo, peak) << 16));
    if (aligned) {
      reinterpret_cast<uint2*>(ob)[i] = r;
    } else {
      for (int j = 0; j < 4; ++j) {
        ob[i * kVec + j] = (uint8_t)(r.x >> (8 * j));
        ob[i * kVec + 4 + j] = (uint8_t)(r.y >> (8 * j));
      }
    }
  }
  const long long k = scalar_index(s, t);
  if (k >= 0) o[k] = (uint8_t)quantize(p[k], lo, peak);
}

}  // namespace

extern "C" {

// Normalize `planes` contiguous uint16 planes of h x w at `in` to uint8 at
// `out` (planes, h, w); `stats` is scratch of 2 * planes 32-bit words.
// planes <= 65535. Two memsets and two launches on `stream`, no
// synchronisation. Returns the first CUDA error that is not cudaSuccess,
// else 0.
int mg_normalize_u8(const void* in, int planes, int h, int w, void* stats,
                    void* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = (long long)h * w;
  unsigned* st = static_cast<unsigned*>(stats);
  cudaError_t e;
  if ((e = cudaMemsetAsync(st, 0xff, planes * sizeof(unsigned), s)) !=
      cudaSuccess)
    return (int)e;
  if ((e = cudaMemsetAsync(st + planes, 0, planes * sizeof(unsigned), s)) !=
      cudaSuccess)
    return (int)e;
  int device = 0, sms = 0;
  if ((e = cudaGetDevice(&device)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  device)) != cudaSuccess)
    return (int)e;
  // Enough blocks to fill the card once over all planes; each thread then
  // strides over its plane.
  const long long groups = (n / kVec + kThreads - 1) / kThreads;
  long long per_plane = (long long)sms * kBlocksPerSm / planes;
  if (per_plane > groups) per_plane = groups;
  if (per_plane < 1) per_plane = 1;
  const dim3 grid((unsigned)per_plane, (unsigned)planes);
  const uint16_t* src = static_cast<const uint16_t*>(in);
  normalize_minmax<<<grid, kThreads, 0, s>>>(src, n, planes, st);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  normalize_quantize<<<grid, kThreads, 0, s>>>(src, n, planes, st,
                                               static_cast<uint8_t*>(out));
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  return 0;
}

}  // extern "C"
