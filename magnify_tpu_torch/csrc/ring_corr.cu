// Exact int8 -> int32 ring correlation: the dense detector's score maps.
//
//   out[r, y, x] = sum_c sum_(i,j) w[r, c, i, j] * f[c, y + i - R, x + j - R]
//
// with zeros outside the plane (correlation, not convolution: the ring
// kernel is not flipped), as XLA's conv_general_dilated with SAME padding
// and preferred_element_type=int32 computes it.
//
// Replaces: magnify_tpu/ops/score.py:score_maps (unfolded int8 form, the
// conv at :637) and :score_maps_folded (space-to-depth form, :581). Those
// are XLA convolutions, not Pallas kernels; PyTorch has no int8
// convolution on CUDA, and a float convolution through cuDNN may pick an
// FFT or Winograd algorithm whose rounding breaks exactness.
//
// What bounds it: shared-memory traffic and instruction throughput, not
// device memory. The ring kernel is zero off its Bresenham rings and the
// rings of different radii never share a position: at radii 8-12 its 2,128
// nonzero weights sit on 292 (i, j) positions, with about 7.3 of the 8
// channels nonzero at each. Each output pixel and ring position needs the 8
// feature channels at one shifted pixel (8 bytes from shared memory) and two
// dp4a; device memory traffic is small (8 bytes a pixel in, 4 per radius
// out).
//
// Design: the host packs the kernel by position, not by tap (score.py,
// pack_positions): one entry (i | j << 16, w[c0..c3], w[c4..c7], radius) per
// ring position, the two weight words 4 signed bytes each, radius r's at
// [offsets[r], offsets[r + 1]). A CTA owns a 32 x 64 output tile. It stages
// the tile plus its halo from the (C, H, W) global layout into shared memory
// interleaved by channel, [y][x][8 bytes] (where the width is a multiple of
// 4, with one 4-byte load per channel for 4 pixels and a byte transpose), so
// one 8-byte load feeds two __dp4a (4 int8 products each, exact int32 sums).
// Each thread keeps 8 output rows of one column in registers and walks the
// position list of each radius once: per position one broadcast 16-byte load
// of the entry, then 8 x (one 8-byte feature load, two __dp4a). That is 292
// 8-byte loads and 584 dp4a per pixel at radii 8-12, where a tap list costs
// 2,128 byte loads and 2,128 multiply-adds. Warps read 32 consecutive pixels
// (256 contiguous bytes, no bank conflicts). The halo is a template constant
// (the smallest of kHalos that covers R), so the row step between a thread's
// 8 rows is an immediate. Designs that reuse feature rows in registers
// across the positions of a column were slower on the card (PERF.md,
// Findings): the runs of consecutive ring rows are short, and walking them
// cost more instructions than the loads they saved. int32 is exact: |sum| <=
// 127 * sum|w| per radius: 1.64e6 at radii 8-12 and 2.12e6 at the chip's
// radii 4-15, both below 2^24.
//
// A batch of planes (N, C, H, W) -> (N, n_radii, H, W) goes through one
// launch: blockIdx.x = plane * tiles_x + the tile's column index, and each
// CTA offsets its feature and output pointers by its plane. The chip path
// scores every chamber's padded crop that way (1,568 planes of 8 x 132 x
// 132 at radii 4-15: 668 positions, a 16-pixel halo).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 64;         // output columns per CTA: 2 warps wide
constexpr int kTileH = 32;         // output rows per CTA
constexpr int kRowsPerThread = 8;  // blockDim = (kTileW, kTileH / 8)
constexpr int kThreadRows = kTileH / kRowsPerThread;
constexpr int kThreads = kTileW * kThreadRows;

__device__ __forceinline__ uint32_t byte_at(const int8_t* f, size_t i) {
  return static_cast<uint32_t>(static_cast<uint8_t>(f[i]));
}

template <int kHalo>
__global__ void __launch_bounds__(kThreads)
ring_corr_kernel(const int8_t* __restrict__ f, int h, int w, int tiles_x,
                 const int4* __restrict__ table,
                 const int* __restrict__ offsets, int n_radii, int rad,
                 int32_t* __restrict__ out) {
  constexpr int sw = kTileW + 2 * kHalo;
  constexpr int sh = kTileH + 2 * kHalo;
  extern __shared__ __align__(16) unsigned char smem[];
  int4* ts = reinterpret_cast<int4*>(smem);
  const int n_pos = offsets[n_radii];
  uint2* fs = reinterpret_cast<uint2*>(ts + n_pos);

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kTileW + tx;
  const int x0 = (blockIdx.x % tiles_x) * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const size_t plane = (size_t)h * w;
  // This CTA's plane of the batch: 8 feature channels in, n_radii maps out.
  // 8 * plane is a multiple of 4 bytes where w is, so the 4-byte loads
  // below stay aligned in every plane.
  const size_t batch = blockIdx.x / tiles_x;
  f += batch * 8 * plane;
  out += batch * n_radii * plane;

  // Shared pixel (sy, sx) is plane pixel (y0 + sy - kHalo, x0 + sx - kHalo).
  if ((w & 3) == 0) {
    // Groups of 4 pixels: kHalo and x0 are multiples of 4, so a group is
    // wholly inside the plane's columns or wholly outside.
    constexpr int gw = sw / 4;
    const uint32_t* f32 = reinterpret_cast<const uint32_t*>(f);
    const size_t plane32 = plane / 4;
    for (int i = tid; i < sh * gw; i += kThreads) {
      const int sy = i / gw;
      const int sx = (i - sy * gw) * 4;
      const int gy = y0 + sy - kHalo;
      const int gx = x0 + sx - kHalo;
      uint32_t c[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
      if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
        const size_t g = ((size_t)gy * w + gx) / 4;
#pragma unroll
        for (int ch = 0; ch < 8; ++ch) c[ch] = f32[g + ch * plane32];
      }
      // c[ch] holds channel ch of the 4 pixels; pixel p's 8 channels are
      // byte p of c[0..3] and byte p of c[4..7].
      uint32_t t[2][4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const uint32_t* q = c + 4 * half;
        const uint32_t a01 = __byte_perm(q[0], q[1], 0x5140);
        const uint32_t a23 = __byte_perm(q[2], q[3], 0x5140);
        const uint32_t b01 = __byte_perm(q[0], q[1], 0x7362);
        const uint32_t b23 = __byte_perm(q[2], q[3], 0x7362);
        t[half][0] = __byte_perm(a01, a23, 0x5410);
        t[half][1] = __byte_perm(a01, a23, 0x7632);
        t[half][2] = __byte_perm(b01, b23, 0x5410);
        t[half][3] = __byte_perm(b01, b23, 0x7632);
      }
      // sw and sx are multiples of 4 pixels, so dst is 32-byte aligned.
      uint4* dst = reinterpret_cast<uint4*>(fs + sy * sw + sx);
      dst[0] = make_uint4(t[0][0], t[1][0], t[0][1], t[1][1]);
      dst[1] = make_uint4(t[0][2], t[1][2], t[0][3], t[1][3]);
    }
  } else {
    for (int i = tid; i < sh * sw; i += kThreads) {
      const int sy = i / sw;
      const int sx = i - sy * sw;
      const int gy = y0 + sy - kHalo;
      const int gx = x0 + sx - kHalo;
      uint2 v = make_uint2(0u, 0u);
      if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
        const size_t g = (size_t)gy * w + gx;
        v.x = byte_at(f, g) | byte_at(f, g + plane) << 8 |
              byte_at(f, g + 2 * plane) << 16 |
              byte_at(f, g + 3 * plane) << 24;
        v.y = byte_at(f, g + 4 * plane) | byte_at(f, g + 5 * plane) << 8 |
              byte_at(f, g + 6 * plane) << 16 |
              byte_at(f, g + 7 * plane) << 24;
      }
      fs[i] = v;
    }
  }
  // Entry k's (i, j) becomes the byte offset of the feature that output
  // (ly, lx) reads, relative to shared pixel (ly, lx).
  for (int k = tid; k < n_pos; k += kThreads) {
    int4 t = table[k];
    const int i = t.x & 0xffff;
    const int j = t.x >> 16;
    t.x = ((i - rad + kHalo) * sw + (j - rad + kHalo)) * (int)sizeof(uint2);
    ts[k] = t;
  }
  __syncthreads();

  const unsigned char* base =
      reinterpret_cast<const unsigned char*>(fs + ty * sw + tx);
  constexpr int kRowStep = kThreadRows * sw * (int)sizeof(uint2);
  const int x = x0 + tx;
  for (int r = 0; r < n_radii; ++r) {
    int acc[kRowsPerThread];
#pragma unroll
    for (int q = 0; q < kRowsPerThread; ++q) acc[q] = 0;
    const int k1 = offsets[r + 1];
#pragma unroll 2
    for (int k = offsets[r]; k < k1; ++k) {
      const int4 t = ts[k];
      const unsigned char* src = base + t.x;
#pragma unroll
      for (int q = 0; q < kRowsPerThread; ++q) {
        const uint2 v = *reinterpret_cast<const uint2*>(src + q * kRowStep);
        acc[q] = __dp4a(static_cast<int>(v.x), t.y, acc[q]);
        acc[q] = __dp4a(static_cast<int>(v.y), t.z, acc[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < kRowsPerThread; ++q) {
      const int y = y0 + ty + q * kThreadRows;
      if (y < h && x < w) out[((size_t)r * h + y) * w + x] = acc[q];
    }
  }
}

constexpr int kHalos[] = {4, 8, 12, 16, 24, 32, 48};

// The halo staged for half-width `rad`: the smallest of kHalos that covers
// it, or -1 if none does.
int halo_for(int rad) {
  for (int halo : kHalos) {
    if (rad <= halo) return halo;
  }
  return -1;
}

// Shared memory: the position entries (int4), then the feature tile (uint2
// per pixel).
size_t smem_bytes(int halo, int n_pos) {
  return sizeof(int4) * (size_t)n_pos +
         sizeof(uint2) * (size_t)(kTileH + 2 * halo) * (kTileW + 2 * halo);
}

template <int kHalo>
int launch(const int8_t* f, int n_planes, int h, int w, const int4* table,
           const int* offsets, int n_radii, int n_pos, int rad, int32_t* out,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(kHalo, n_pos);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ring_corr_kernel<kHalo>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int tiles_x = (w + kTileW - 1) / kTileW;
  const dim3 grid(tiles_x * n_planes, (h + kTileH - 1) / kTileH);
  const dim3 block(kTileW, kThreadRows);
  ring_corr_kernel<kHalo><<<grid, block, smem, stream>>>(
      f, h, w, tiles_x, table, offsets, n_radii, rad, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory (bytes) one CTA needs for half-width `rad` and `n_pos`
// position entries, or -1 if no halo covers `rad`.
int mg_ring_corr_smem(int rad, int n_pos) {
  const int halo = halo_for(rad);
  return halo < 0 ? -1 : (int)smem_bytes(halo, n_pos);
}

// f: (n_planes, 8, h, w) int8; table: (n_pos, 4) int32 entries (i | j << 16,
// weights of channels 0-3, of channels 4-7, radius), radius r's at
// [offsets[r], offsets[r + 1]) with offsets[n_radii] = n_pos; rad: the
// kernel's half-width R; out: (n_planes, n_radii, h, w) int32. One launch
// for the whole batch. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue if no halo covers rad.
int mg_ring_corr(const void* f, int n_planes, int h, int w, const void* table,
                 const void* offsets, int n_radii, int n_pos, int rad,
                 void* out, void* stream) {
  const int8_t* fp = static_cast<const int8_t*>(f);
  const int4* tp = static_cast<const int4*>(table);
  const int* op = static_cast<const int*>(offsets);
  int32_t* o = static_cast<int32_t*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (halo_for(rad)) {
    case 4:
      return launch<4>(fp, n_planes, h, w, tp, op, n_radii, n_pos, rad, o,
                        s);
    case 8:
      return launch<8>(fp, n_planes, h, w, tp, op, n_radii, n_pos, rad, o,
                        s);
    case 12:
      return launch<12>(fp, n_planes, h, w, tp, op, n_radii, n_pos, rad, o,
                        s);
    case 16:
      return launch<16>(fp, n_planes, h, w, tp, op, n_radii, n_pos, rad, o,
                        s);
    case 24:
      return launch<24>(fp, n_planes, h, w, tp, op, n_radii, n_pos, rad, o,
                        s);
    case 32:
      return launch<32>(fp, n_planes, h, w, tp, op, n_radii, n_pos, rad, o,
                        s);
    case 48:
      return launch<48>(fp, n_planes, h, w, tp, op, n_radii, n_pos, rad, o,
                        s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* mg_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
