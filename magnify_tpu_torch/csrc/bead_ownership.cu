// Bead ownership masks on the H100: for every bead's ROI window, the pixels
// that its own disk alone covers (fg) and the pixels that no disk covers
// (bg).
//
// Replaces: no TPU kernel. The JAX package builds these masks on the host
// (magnify_tpu/components/find.py:298, a KD-tree of the marks, then
// (pairs, L, L) cover temporaries summed per window), and so did the port
// (magnify_tpu_torch/components/find.py _bead_ownership_host). On the H100
// that host pass was the largest part of a bead frame's host time, while
// the card, which has just found the marks, can make the masks in
// microseconds and copy them back once.
//
// Semantics, bit for bit those of _bead_ownership_host: a mark (r0, c0, r)
// with radius rad = clamp(r, 0, max_radius) covers pixel (y, x) where
// |y - r0| <= rad and |x - c0| <= ext[rad][|y - r0|], ext being the
// Bresenham extent table (ops/geom.py extent_lut). count(y, x) is the
// number of marks, over all n, that cover the pixel;
//   fg = this window's own mark covers the pixel and count == 1,
//   bg = count == 0.
// The windows' corners come from the host (one definition of a window).
//
// What bounds it: bytes. The output is 2 * n * L^2 bytes (12.7 MB at a
// bead frame's 1,764 marks and L = 60: 3.8 us at 3.35 TB/s); the marks,
// corners and table it reads are 20 bytes a mark and 4 (max_radius + 1)^2
// bytes. The arithmetic is a compare or two a pixel for each mark whose disk
// meets its window.
//
// Design: one block of 256 threads a window. The block walks over the
// marks a tile of 256 at a time, one mark a thread (the next tile's mark is
// loaded before the current tile's barrier), and appends the marks whose
// disk's bounding box meets its window to a list in shared memory, in the
// window's own coordinates. Each thread holds 4 groups of 4 consecutive
// pixels of the window in registers: each pixel's window row and column in
// one word, and three 16-bit masks over its pixels: covered at least once,
// covered twice or more (only 0, 1 and "more" matter), covered by the
// window's own mark. One __syncthreads_count a tile gives every thread the
// list's length. When the list might overflow on the next tile, and after
// the last tile, the block rasterizes the list into its pixels and empties
// it, so the result is exact at any density with no neighbour search and no
// cap. A window larger than 4,096 pixels is done in chunks of 4,096, each
// with its own walk over the marks. The masks leave as one 4-byte store of 4
// pixels a thread and mask (a warp writes 128 contiguous bytes), or byte by
// byte where L^2 is not a multiple of 4 (the windows then do not start on 4
// bytes). No atomics reach device memory and no order of the marks matters:
// the result is deterministic.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroups = 4;                          // pixel groups a thread
constexpr int kPix = 4 * kGroups;                   // pixels a thread (<= 32)
constexpr int kChunk = kThreads * kPix;             // pixels a block pass
constexpr int kCap = 2 * kThreads;                  // marks the list holds

struct Mark {
  int row, col, rad;
};

__device__ __forceinline__ Mark load_mark(const int* __restrict__ marks,
                                          int j, int n, int max_radius) {
  if (j >= n) return {0, 0, -1};
  return {__ldg(marks + 3 * j), __ldg(marks + 3 * j + 1),
          min(max(__ldg(marks + 3 * j + 2), 0), max_radius)};
}

__global__ void __launch_bounds__(kThreads)
bead_ownership(const int* __restrict__ marks, const int* __restrict__ tops,
               const int* __restrict__ lefts, const int* __restrict__ lut,
               int n, int L, int max_radius, uint8_t* __restrict__ out) {
  // (row, col) relative to the window's corner, clamped radius, own mark.
  __shared__ int4 list[kCap];
  __shared__ int appended;  // marks appended since the block started
  const int win = blockIdx.x;
  const int tid = threadIdx.x;
  const long long top = tops[win], left = lefts[win];
  const int area = L * L;
  const int stride = max_radius + 1;
  uint8_t* fg_out = out + (long long)win * area;
  uint8_t* bg_out = out + ((long long)n + win) * area;
  const bool vector_store = (area & 3) == 0;
  if (tid == 0) appended = 0;
  __syncthreads();
  int total = 0, start = 0;  // the same in every thread

  for (int chunk = 0; chunk < area; chunk += kChunk) {
    // Pixel q of this thread: window offset chunk + 4 * (tid + g * kThreads)
    // + j for q = 4 * g + j, its window row and column in one word (L <
    // 32,768, so both fit 16 bits, also past the window's end).
    unsigned yx[kPix];
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int p = chunk + 4 * (tid + g * kThreads);
      int row = p / L, col = p - row * L;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        yx[4 * g + j] = (unsigned)row << 16 | (unsigned)col;
        if (++col == L) {
          col = 0;
          ++row;
        }
      }
    }
    unsigned once = 0, twice = 0, own = 0;  // bit q: pixel q
    Mark m = load_mark(marks, tid, n, max_radius);
    for (int base = 0; base < n; base += kThreads) {
      const int j = base + tid;
      // 64-bit: no mark's coordinates can wrap the test.
      const bool hit = m.rad >= 0 && (long long)m.row + m.rad >= top &&
                       (long long)m.row - m.rad < top + L &&
                       (long long)m.col + m.rad >= left &&
                       (long long)m.col - m.rad < left + L;
      if (hit) {
        list[atomicAdd(&appended, 1) - start] =
            make_int4((int)(m.row - top), (int)(m.col - left), m.rad,
                      j == win);
      }
      m = load_mark(marks, j + kThreads, n, max_radius);
      total += __syncthreads_count(hit);
      if (total - start <= kCap - kThreads && base + kThreads < n) continue;
      // A listed mark lies within L + max_radius of the window, so no
      // difference below wraps.
      for (int e = 0; e < total - start; ++e) {
        const int4 k = list[e];
        const int* ext = lut + k.z * stride;
        unsigned cover = 0;
#pragma unroll
        for (int q = 0; q < kPix; ++q) {
          const int dr = abs((int)(yx[q] >> 16) - k.x);
          const int width = dr <= k.z ? __ldg(ext + dr) : -1;
          cover |= (unsigned)(abs((int)(yx[q] & 0xffffu) - k.y) <= width)
                   << q;
        }
        twice |= once & cover;
        once |= cover;
        if (k.w) own |= cover;
      }
      start = total;
      __syncthreads();  // the list is read before the next tile appends
    }
    const unsigned fg = own & once & ~twice, bg = ~once;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int p = chunk + 4 * (tid + g * kThreads);
      if (p >= area) break;
      unsigned fg4 = 0, bg4 = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        fg4 |= (fg >> (4 * g + j) & 1u) << (8 * j);
        bg4 |= (bg >> (4 * g + j) & 1u) << (8 * j);
      }
      if (vector_store) {
        *reinterpret_cast<unsigned*>(fg_out + p) = fg4;
        *reinterpret_cast<unsigned*>(bg_out + p) = bg4;
      } else {
        for (int j = 0; j < 4 && p + j < area; ++j) {
          fg_out[p + j] = (uint8_t)(fg4 >> (8 * j));
          bg_out[p + j] = (uint8_t)(bg4 >> (8 * j));
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// marks: (n, 3) int32 (row, col, radius); tops, lefts: (n,) int32 window
// corners; lut: (max_radius + 1)^2 int32 extent table; out: (2, n, L, L)
// uint8, fg then bg, 4-byte aligned. 1 <= n < 2^30, 1 <= L < 32,768. One
// launch on `stream`, no synchronisation. Returns cudaGetLastError() after
// it.
int mg_bead_ownership(const void* marks, const void* tops, const void* lefts,
                      const void* lut, int n, int L, int max_radius, void* out,
                      void* stream) {
  bead_ownership<<<n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(marks), static_cast<const int*>(tops),
      static_cast<const int*>(lefts), static_cast<const int*>(lut), n, L,
      max_radius, static_cast<uint8_t*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
