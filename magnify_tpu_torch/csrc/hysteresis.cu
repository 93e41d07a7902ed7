// Canny hysteresis on the H100: grow strong edge pixels through weak ones
// (8-connected, zero border) to the least fixpoint.
//
// Replaces: magnify_tpu/ops/pallas_kernels.py:_hysteresis_call (whole-plane
// VMEM kernel, _hysteresis_kernel) and :_hysteresis_tiled_call (serpentine
// tiled kernel, _tiled_hysteresis_kernel). One design serves every plane
// size: the plane stays in device memory and tiles grow in shared memory.
//
// What bounds it: bytes and sweeps, not arithmetic. A sweep reads the uint8
// `cur` and `weak` planes once (2 bytes a pixel) and writes back only tiles
// that grew; a 1024^2 plane is ~2 MB, which the 50 MB L2 holds across
// sweeps. The fixpoint loop inside a tile runs on shared memory only. The
// number of sweeps is set by how often an edge chain crosses a tile border
// after the neighbouring tile has already run in that sweep; bead edges are
// short closed loops, so frames converge in a few sweeps.
//
// Design: one CTA per tile of `tile_rows` x kTileW pixels. The CTA loads
// its tile plus a 1-pixel halo of `cur` and `weak` into shared memory,
// grows the interior to a local fixpoint (halo pixels act as fixed seeds;
// `__syncthreads_or` carries the changed flag), writes the interior back
// and, if any interior pixel grew, sets the global `changed` word. The host
// relaunches sweeps until a sweep leaves `changed` at 0.
//
// Updating `cur` in place in global memory while other CTAs read it as
// their halo is safe because growth is monotone: a CTA that reads a halo
// pixel before its owner sets it sees a smaller set, which can only delay
// growth, never add a pixel outside the fixpoint (every pixel set is weak
// and touches a set pixel). A sweep that changes nothing ran on a constant
// plane, so every tile is closed under growth and the plane is the least
// fixpoint. This is the argument of the Pallas tiled kernel's docstring
// (pallas_kernels.py:157-166), with stale halos in place of stale blocks.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 128;   // tile width: 4 warps of 32 contiguous bytes
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
hysteresis_sweep_kernel(uint8_t* __restrict__ cur,
                        const uint8_t* __restrict__ weak, int h, int w,
                        int tile_rows, int* __restrict__ changed) {
  extern __shared__ uint8_t smem[];
  const int sw = kTileW + 2;
  const int sh = tile_rows + 2;
  volatile uint8_t* cs = smem;
  uint8_t* ws = smem + sh * sw;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * tile_rows;
  const int tid = threadIdx.x;

  for (int i = tid; i < sh * sw; i += kThreads) {
    const int sy = i / sw;
    const int sx = i - sy * sw;
    const int gy = y0 + sy - 1;
    const int gx = x0 + sx - 1;
    const bool in = gy >= 0 && gy < h && gx >= 0 && gx < w;
    // __ldcg skips L1, so a neighbour's write earlier in this sweep is seen
    // when it has reached L2 (not needed for correctness, only for speed).
    cs[i] = in ? __ldcg(cur + (size_t)gy * w + gx) : 0;
    ws[i] = in ? weak[(size_t)gy * w + gx] : 0;
  }
  __syncthreads();

  const int n_in = tile_rows * kTileW;
  int grew = 0;
  while (true) {
    int ch = 0;
    for (int i = tid; i < n_in; i += kThreads) {
      const int p = (1 + i / kTileW) * sw + 1 + i % kTileW;
      if (ws[p] && !cs[p]) {
        if (cs[p - sw - 1] | cs[p - sw] | cs[p - sw + 1] | cs[p - 1] |
            cs[p + 1] | cs[p + sw - 1] | cs[p + sw] | cs[p + sw + 1]) {
          cs[p] = 1;
          ch = 1;
        }
      }
    }
    if (!__syncthreads_or(ch)) break;
    grew = 1;
  }
  if (!grew) return;  // uniform across the CTA: it came from __syncthreads_or

  // Interior pixels belong to this CTA alone, so the write-back races with
  // nothing but halo reads of other CTAs (see the note above).
  for (int i = tid; i < n_in; i += kThreads) {
    const int gy = y0 + i / kTileW;
    const int gx = x0 + i % kTileW;
    if (gy < h && gx < w) {
      cur[(size_t)gy * w + gx] = cs[(1 + i / kTileW) * sw + 1 + i % kTileW];
    }
  }
  if (tid == 0) atomicOr(changed, 1);
}

}  // namespace

extern "C" {

// One sweep over the plane. `cur` (h, w) uint8 0/1 is updated in place;
// `weak` (h, w) uint8 0/1; `changed` one int32 the caller zeroes first.
// Returns cudaGetLastError() after the launch.
int mg_hysteresis_sweep(void* cur, const void* weak, int h, int w,
                        int tile_rows, void* changed, void* stream) {
  const dim3 grid((w + kTileW - 1) / kTileW, (h + tile_rows - 1) / tile_rows);
  const size_t smem = 2 * (size_t)(tile_rows + 2) * (kTileW + 2);
  hysteresis_sweep_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<uint8_t*>(cur), static_cast<const uint8_t*>(weak), h, w,
      tile_rows, static_cast<int*>(changed));
  return (int)cudaGetLastError();
}

}  // extern "C"
