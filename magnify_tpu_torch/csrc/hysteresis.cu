// Canny hysteresis on the H100 as connected-component labelling.
//
// Replaces: magnify_tpu/ops/pallas_kernels.py:_hysteresis_call (whole-plane
// VMEM kernel, _hysteresis_kernel) and :_hysteresis_tiled_call (serpentine
// tiled kernel, _tiled_hysteresis_kernel). Both compute the least fixpoint
// of cur = cur | (weak & dilate8(cur)) from cur = strong, 8-connected, with
// a zero border. One design serves every plane size, and a batch of planes
// of one size in the same four launches: the per-chamber crops of the chip
// path (1,568 planes of 72 x 72) go through one call. The planes of a batch
// lie one after another in every buffer; a pixel's index is its offset in
// the whole batch, and only neighbours inside one plane are ever united, so
// components never join across planes.
//
// The same set without a fixpoint. With F = weak | strong,
//
//   out = F & (the 8-connected component of F holds a strong pixel).
//
// Fixpoint within it: every pixel the fixpoint holds is strong, or weak and
// next to a pixel it held one step earlier; by induction on the step it is
// in F and joined inside F to a strong pixel. It within the fixpoint: take p
// in F and a path s = p0, p1, ..., pk = p inside F from a strong s. Strong
// pixels are held from the start, and a pixel of the path that is not
// strong is weak and next to a held one, so it is held one step later; by
// induction along the path p is held. Strong pixels outside `weak` are
// seeds only: they are in F and seed their component, as they are held but
// never grown into by the fixpoint.
//
// What bounds it: bytes and launch latency, not arithmetic. The masks are
// read once (2 bytes a pixel) and the result written once (1 byte); the
// int32 label plane (4 bytes a pixel, 4 MB at 1024^2) is written once and
// read back by the later passes, mostly from the 50 MB L2. The fixpoint
// design it replaces relaunched sweeps until one changed nothing, a host
// round trip per sweep; this one is four launches per plane, fixed by the
// shape (not by the number of planes), with no host sync between them.
//
// Design: block-based union-find labelling (Playne & Hawick, "A New
// Algorithm for Parallel Connected-Component Labelling on GPUs", IEEE TPDS
// 2018; Allegretti, Bolelli & Grana, "Optimized Block-Based Algorithms to
// Label Connected Components on GPUs", IEEE TPDS 2020). A label is a parent
// pointer: the index of a pixel of the same component, the pixel's own
// index at a root, -1 outside F. Parents always point to smaller indices, so
// a union (atomicMin on the larger root) keeps the forest acyclic and every
// loop lock-free.
//  1. local:  one CTA per tile of tile_rows x kTileW pixels labels F inside
//             its tile in shared memory (tile-local indices), then writes
//             each pixel's tile root as a plane index. Tile-local order is
//             plane order restricted to the tile, so parents still point to
//             smaller plane indices.
//  2. merge:  the pixels on each tile's top row and side columns unite, in
//             the label plane, with their neighbours in other tiles.
//  3. mark:   each strong pixel finds its root and sets the root label's
//             bit 31 (labels are < 2^31 - 1, so a marked root is negative
//             but never -1).
//  4. output: out = (label != -1) & (bit 31 of the root's label).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 128;  // tile width: 4 warps of 32 contiguous pixels
constexpr int kThreads = 256;
constexpr int kLoadAhead = 8;  // mask loads a thread keeps in flight
constexpr int kMarked = static_cast<int>(0x80000000u);

// Root of x in a forest whose roots may carry the mark bit.
template <typename Ptr>
__device__ __forceinline__ int find_root(Ptr labels, int x) {
  int p = labels[x] & ~kMarked;
  while (p != x) {
    x = p;
    p = labels[x] & ~kMarked;
  }
  return x;
}

// Root of x, halving the path on the way: each visited pixel is pointed at
// its grandparent. A plain store of an ancestor keeps the forest valid even
// where it overwrites a concurrent atomicMin link: the thread that made
// that link goes on to unite with the parent it replaced (see unite).
template <typename Ptr, typename Load>
__device__ __forceinline__ int find_halving(Ptr labels, int x, Load load) {
  int p = load(labels + x);
  while (p != x) {
    const int gp = load(labels + p);
    if (gp != p) labels[x] = gp;
    x = p;
    p = gp;
  }
  return x;
}

// Lock-free union: hang the larger root under the smaller. If the larger
// root was hung elsewhere meanwhile (atomicMin returns another value), its
// old parent is united with the smaller root in the next round. Every round
// that fails replaces a or b by a smaller index, so the loop ends.
template <typename Ptr, typename Load>
__device__ void unite(Ptr labels, int a, int b, Load load) {
  while (true) {
    a = find_halving(labels, a, load);
    b = find_halving(labels, b, load);
    if (a == b) return;
    if (a > b) { const int t = a; a = b; b = t; }
    const int old = atomicMin(const_cast<int*>(labels + b), a);
    if (old == b) return;
    b = old;
  }
}

struct SharedLoad {
  __device__ int operator()(volatile int* p) const { return *p; }
};
struct GlobalLoad {  // L2, not a stale L1 line: other SMs are writing
  __device__ int operator()(int* p) const { return __ldcg(p); }
};

__global__ void __launch_bounds__(kThreads)
hyst_local(const uint8_t* __restrict__ strong,
           const uint8_t* __restrict__ weak, int h, int w, int tiles_x,
           int tile_rows, int* __restrict__ labels) {
  extern __shared__ int smem[];
  volatile int* lab = smem;
  // blockIdx.x = plane * tiles_x + the tile's column index.
  const int base = (blockIdx.x / tiles_x) * h * w;
  const int x0 = (blockIdx.x % tiles_x) * kTileW;
  const int y0 = blockIdx.y * tile_rows;
  const int n = tile_rows * kTileW;
  const int tid = threadIdx.x;

  // A warp holds 32 consecutive pixels of one row (kTileW and n are
  // multiples of 32, so whole warps run each round). Each pixel of F starts
  // as a child of the first pixel of its run of F within those 32, so runs
  // are stars and the unions below link runs, not pixels. The masks are
  // read kLoadAhead rounds at a time, so a thread's loads are in flight
  // together.
  const int lane = tid & 31;
  for (int i0 = 0; i0 < n; i0 += kLoadAhead * kThreads) {
    bool f[kLoadAhead];
#pragma unroll
    for (int k = 0; k < kLoadAhead; ++k) {
      const int i = i0 + k * kThreads + tid;
      const int gy = y0 + i / kTileW;
      const int gx = x0 + i % kTileW;
      f[k] = false;
      if (i < n && gy < h && gx < w) {
        const int g = base + gy * w + gx;
        f[k] = strong[g] | weak[g];
      }
    }
#pragma unroll
    for (int k = 0; k < kLoadAhead; ++k) {
      const int i = i0 + k * kThreads + tid;
      if (i < n) {  // uniform across the warp: n is a multiple of 128
        const unsigned gaps =
            ~__ballot_sync(0xffffffffu, f[k]) & ((1u << lane) - 1);
        lab[i] = f[k] ? i - lane + (gaps ? 32 - __clz(gaps) : 0) : -1;
      }
    }
  }
  __syncthreads();

  // Each 8-neighbour edge is the backward edge (left, up-left, up,
  // up-right) of one of its ends. An edge is skipped where other edges in
  // the tile already join its ends: left inside a warp's 32 pixels (one
  // run), up where left and up-left are in F (left joins up-left, which
  // sits in up's run), up-left where left or up is in F, up-right where up
  // or right is in F.
  for (int i = tid; i < n; i += kThreads) {
    if (lab[i] < 0) continue;
    const int lx = i % kTileW;
    const bool left = lx > 0 && lab[i - 1] >= 0;
    const bool right = lx + 1 < kTileW && lab[i + 1] >= 0;
    if (left && lx % 32 == 0) unite(lab, i, i - 1, SharedLoad());
    if (i >= kTileW) {
      const int u = i - kTileW;
      const bool up_left = lx > 0 && lab[u - 1] >= 0;
      if (lab[u] >= 0) {
        if (!(left && up_left)) unite(lab, i, u, SharedLoad());
      } else {
        if (up_left && !left) unite(lab, i, u - 1, SharedLoad());
        if (lx + 1 < kTileW && !right && lab[u + 1] >= 0)
          unite(lab, i, u + 1, SharedLoad());
      }
    }
  }
  __syncthreads();

  for (int i = tid; i < n; i += kThreads) {
    const int gy = y0 + i / kTileW;
    const int gx = x0 + i % kTileW;
    if (gy >= h || gx >= w) continue;
    int v = -1;
    if (lab[i] >= 0) {
      const int r = find_halving(lab, i, SharedLoad());
      v = base + (y0 + r / kTileW) * w + x0 + r % kTileW;
    }
    labels[base + gy * w + gx] = v;
  }
}

__global__ void __launch_bounds__(kThreads)
hyst_merge(int h, int w, int tiles_x, int tile_rows,
           int* __restrict__ labels) {
  const int base = (blockIdx.x / tiles_x) * h * w;
  const int tx = blockIdx.x % tiles_x;
  const int ty = blockIdx.y;
  const int x0 = tx * kTileW;
  const int y0 = ty * tile_rows;
  const int tw = min(kTileW, w - x0);
  const int th = min(tile_rows, h - y0);
  // The tile's top row, then its left and right columns below that row:
  // the only pixels with a backward neighbour in another tile.
  const int n = tw + 2 * (th - 1);
  for (int k = threadIdx.x; k < n; k += kThreads) {
    int y, x;
    if (k < tw) {
      y = y0;
      x = x0 + k;
    } else if (k < tw + th - 1) {
      y = y0 + 1 + (k - tw);
      x = x0;
    } else {
      y = y0 + 1 + (k - tw - (th - 1));
      x = x0 + tw - 1;
    }
    const int p = base + y * w + x;
    if (__ldcg(labels + p) < 0) continue;
    // (yy, xx) is a position in this plane: a neighbour outside the plane
    // is no neighbour, whatever lies there in the batch.
    auto in_f = [&](int yy, int xx) {
      return yy >= 0 && xx >= 0 && xx < w &&
             __ldcg(labels + base + yy * w + xx) >= 0;
    };
    auto other_tile = [&](int yy, int xx) {
      return yy / tile_rows != ty || xx / kTileW != tx;
    };
    const bool left = in_f(y, x - 1);
    const bool up_left = in_f(y - 1, x - 1);
    const bool up = in_f(y - 1, x);
    const bool up_right = in_f(y - 1, x + 1);
    const bool right = in_f(y, x + 1);
    // The skips of hyst_local, now across tiles: every horizontal edge is
    // united (inside a tile by hyst_local, across by a left union here),
    // and a pixel that skips `up` relies on its left neighbour, a border
    // pixel too, uniting with that neighbour's up.
    if (left && other_tile(y, x - 1)) unite(labels, p, p - 1, GlobalLoad());
    if (up && other_tile(y - 1, x) && !(left && up_left))
      unite(labels, p, p - w, GlobalLoad());
    if (up_left && other_tile(y - 1, x - 1) && !left && !up)
      unite(labels, p, p - w - 1, GlobalLoad());
    if (up_right && other_tile(y - 1, x + 1) && !up && !right)
      unite(labels, p, p - w + 1, GlobalLoad());
  }
}

__global__ void __launch_bounds__(kThreads)
hyst_mark(const uint8_t* __restrict__ strong, int n, int* __restrict__ labels) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= n || !strong[p]) return;
  const int r = find_root(labels, p);
  if (__ldcg(labels + r) >= 0) atomicOr(labels + r, kMarked);
}

__global__ void __launch_bounds__(kThreads)
hyst_output(const int* __restrict__ labels, int n, uint8_t* __restrict__ out) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= n) return;
  uint8_t o = 0;
  if (labels[p] != -1) o = labels[find_root(labels, p)] < 0;
  out[p] = o;
}

}  // namespace

extern "C" {

// Hysteresis of `n_planes` planes: `strong`, `weak` (n_planes, h, w) uint8
// 0/1, `labels` (n_planes, h, w) int32 scratch, `out` (n_planes, h, w) uint8
// 0/1; n_planes * h * w < 2^31 - 1. Four launches on `stream` for the whole
// batch, no synchronisation. Returns the first cudaGetLastError() that is
// not cudaSuccess, else 0.
int mg_hysteresis(const void* strong, const void* weak, int n_planes, int h,
                  int w, int tile_rows, void* labels, void* out,
                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* st = static_cast<const uint8_t*>(strong);
  int* lab = static_cast<int*>(labels);
  const size_t smem = (size_t)tile_rows * kTileW * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        hyst_local, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int tiles_x = (w + kTileW - 1) / kTileW;
  const dim3 tiles(tiles_x * n_planes, (h + tile_rows - 1) / tile_rows);
  const int n = n_planes * h * w;
  const int blocks = (n + kThreads - 1) / kThreads;
  cudaError_t e;
  hyst_local<<<tiles, kThreads, smem, s>>>(
      st, static_cast<const uint8_t*>(weak), h, w, tiles_x, tile_rows, lab);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  hyst_merge<<<tiles, kThreads, 0, s>>>(h, w, tiles_x, tile_rows, lab);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  hyst_mark<<<blocks, kThreads, 0, s>>>(st, n, lab);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  hyst_output<<<blocks, kThreads, 0, s>>>(lab, n,
                                          static_cast<uint8_t*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
