// Exact int8 -> int32 ring correlation: the dense detector's score maps.
//
//   out[r, y, x] = sum_c sum_(i,j) w[r, c, i, j] * f[c, y + i - R, x + j - R]
//
// with zeros outside the plane (correlation, not convolution: the ring
// kernel is not flipped), as XLA's conv_general_dilated with SAME padding
// and preferred_element_type=int32 computes it.
//
// Replaces: magnify_tpu/ops/score.py:score_maps (unfolded int8 form,
// :635-643) and :score_maps_folded (space-to-depth form, :579-587). Those
// are XLA convolutions, not Pallas kernels; PyTorch has no int8
// convolution on CUDA, and a float convolution through cuDNN may pick an
// FFT or Winograd algorithm whose rounding breaks exactness.
//
// What bounds it: integer multiply-adds and shared-memory loads. At the
// 1024^2 bead frame (radii 8-12, padded plane 1072^2) the ring kernel has
// 2,128 nonzero taps over 5 radii and 8 channels, so the map costs
// 2.45e9 multiply-adds, each fed by one byte from shared memory. Device
// memory traffic is small: 8 bytes a pixel in, 20 bytes a pixel out.
//
// Design: the ring kernel is zero off its Bresenham rings, so the host
// compacts it into a tap list per radius (packed i | j << 8 | c << 16 |
// w << 24) and the kernel loops over taps only (2,128 instead of
// 5 x 8 x 625 = 25,000 dense weights). A CTA owns a 32 x 32 output tile:
// it stages the 8 feature channels of the tile plus an R-pixel halo in
// shared memory once, then for each radius stages that radius's taps as
// (shared-memory offset, weight) pairs and lets every thread accumulate 4
// output pixels (4 rows, one column) in int32 registers. Threads of a warp
// read 32 consecutive bytes per tap (no bank conflicts); the tap itself is
// a broadcast. int32 accumulation is exact: |sum| <= 127 * sum|w| < 2^31.
// wgmma, dp4a packing and TMA staging are left to later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 32;
constexpr int kRowsPerThread = 4;  // blockDim = (32, kTileH / 4)
constexpr int kThreads = kTileW * (kTileH / kRowsPerThread);

__global__ void __launch_bounds__(kThreads)
ring_corr_kernel(const int8_t* __restrict__ f, int c_in, int h, int w,
                 const int32_t* __restrict__ taps,
                 const int32_t* __restrict__ offsets, int n_radii, int rad,
                 int32_t* __restrict__ out) {
  extern __shared__ int32_t smem32[];
  const int sw = kTileW + 2 * rad;
  const int sh = kTileH + 2 * rad;
  const int plane = sh * sw;
  const int feat_words = (c_in * plane + 3) / 4;
  int8_t* fs = reinterpret_cast<int8_t*>(smem32);
  int32_t* ts = smem32 + feat_words;

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kTileW + tx;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;

  for (int i = tid; i < c_in * plane; i += kThreads) {
    const int c = i / plane;
    const int rem = i - c * plane;
    const int sy = rem / sw;
    const int sx = rem - sy * sw;
    const int gy = y0 + sy - rad;
    const int gx = x0 + sx - rad;
    fs[i] = (gy >= 0 && gy < h && gx >= 0 && gx < w)
                ? f[((size_t)c * h + gy) * w + gx]
                : (int8_t)0;
  }

  const int8_t* base = fs + ty * sw + tx;
  const int row_step = (kTileH / kRowsPerThread) * sw;
  for (int r = 0; r < n_radii; ++r) {
    const int t0 = offsets[r];
    const int nt = offsets[r + 1] - t0;
    __syncthreads();  // the previous radius is done with ts (and fs is ready)
    for (int k = tid; k < nt; k += kThreads) {
      const int t = taps[t0 + k];
      const int i = t & 0xff;
      const int j = (t >> 8) & 0xff;
      const int c = (t >> 16) & 0xff;
      // offset < 2^23 (checked by the host), weight in the low byte
      ts[k] = ((c * plane + i * sw + j) << 8) | (t >> 24 & 0xff);
    }
    __syncthreads();

    int acc[kRowsPerThread];
#pragma unroll
    for (int q = 0; q < kRowsPerThread; ++q) acc[q] = 0;
    for (int k = 0; k < nt; ++k) {
      const int p = ts[k];
      const int wt = (int)(int8_t)(p & 0xff);
      const int8_t* src = base + (p >> 8);
#pragma unroll
      for (int q = 0; q < kRowsPerThread; ++q) {
        acc[q] += wt * (int)src[q * row_step];
      }
    }
    const int x = x0 + tx;
#pragma unroll
    for (int q = 0; q < kRowsPerThread; ++q) {
      const int y = y0 + ty + q * (kTileH / kRowsPerThread);
      if (y < h && x < w) out[((size_t)r * h + y) * w + x] = acc[q];
    }
  }
}

}  // namespace

extern "C" {

// f: (c_in, h, w) int8; taps: packed int32 per tap, radius r's taps at
// [offsets[r], offsets[r + 1]); max_taps = max taps of one radius;
// rad: the kernel's half-width R; out: (n_radii, h, w) int32.
// Returns cudaGetLastError() after the launch.
int mg_ring_corr(const void* f, int c_in, int h, int w, const void* taps,
                 const void* offsets, int n_radii, int max_taps, int rad,
                 void* out, void* stream) {
  const int plane = (kTileH + 2 * rad) * (kTileW + 2 * rad);
  const size_t smem =
      4 * ((size_t)(c_in * plane + 3) / 4) + 4 * (size_t)max_taps;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ring_corr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH);
  const dim3 block(kTileW, kTileH / kRowsPerThread);
  ring_corr_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      static_cast<const int8_t*>(f), c_in, h, w,
      static_cast<const int32_t*>(taps), static_cast<const int32_t*>(offsets),
      n_radii, rad, static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}

const char* mg_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
