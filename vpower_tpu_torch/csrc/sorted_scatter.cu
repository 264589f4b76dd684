// Sorted-segment deposit (K1): out[c, id] = carry[c, id] + sum of
// svals[k, c] over the rows k with sids[k] == id, summed in row order.
//
// Replaces the Pallas TPU kernel vpower_tpu/deposit/mxu_scatter.py:_kernel
// (driven by deposit_planned).  That kernel expresses the histogram as
// one-hot matrix products on the MXU, with a three-term bf16 split of
// every value and (window, block) pair tables sized for SMEM; all of
// that works around a TPU that has no scatter worth using and no float
// atomics.  None of it carries over.
//
// What bounds it on the H100: bytes.  Every one of the n_cells * C
// outputs is written once (the 512^3 seed grid of the NN descent is
// 7 x 134M floats, 3.76 GB, against 0.32 GB of rows), so the floor is
// the write stream: ~1.2 ms at 3.35 TB/s.  Most cells are empty (0.075
// rows per cell on the bench workload), so any per-cell search of the
// rows is wasted latency: one thread per cell with two binary searches
// of the 10M ids ran at ~6 ms, slower than index_add_.
//
// Design: tiles of consecutive cells.  A first small kernel finds each
// tile's row range [r0, r1) with one binary search per tile boundary.
// The main kernel gives each block one tile (and one group of at most
// kMaxGroup channels): it zeroes a channel-major copy of the tile in
// shared memory, walks the tile's rows with one thread per row, and
// each thread whose row starts a run of equal ids sums that run in row
// order from 0.0f into the tile (one writer per cell, no atomics).  The
// block then writes carry + sum for every cell of the tile, one channel
// plane at a time, 16 bytes per thread where the alignment allows.  The
// sum order is the row order and an empty cell is carry + 0.0f, so the
// result equals a sequential scatter-add of the rows onto zeros plus
// carry (the plain version on the CPU) bit for bit.  A run of many rows
// in one cell is summed by one thread: slow, but right.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGroup = 64;         // channels per block (grid.y groups)
constexpr int kTileBytes = 48 * 1024; // shared tile: no opt-in needed
constexpr int kMaxTile = 4096;

// Channels per block, and cells per tile: the largest power of two
// whose group tile fits kTileBytes (at least 128 cells).
int group_chans(int n_chan) { return n_chan < kMaxGroup ? n_chan : kMaxGroup; }

int tile_cells(int n_chan) {
  const int per = kTileBytes / (4 * group_chans(n_chan));
  int t = kMaxTile;
  while (t > per) t >>= 1;
  return t;
}

__device__ __forceinline__ long long lower_bound(const int* __restrict__ a,
                                                 long long n, int key) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    long long mid = (lo + hi) >> 1;
    if (a[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// offs[t] = first row whose id >= min(t * tile, n_cells), t in [0, n_tiles]:
// rows of ids < 0 fall before tile 0 and rows of ids >= n_cells after
// the last tile, so neither is ever summed.
__global__ void tile_offsets_kernel(const int* __restrict__ sids,
                                    long long n_rows, long long n_cells,
                                    int tile, long long n_tiles,
                                    long long* __restrict__ offs) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t > n_tiles) return;
  long long key = t * tile;
  if (key > n_cells) key = n_cells;
  offs[t] = lower_bound(sids, n_rows, (int)key);
}

__global__ void __launch_bounds__(kThreads)
sorted_scatter_kernel(const int* __restrict__ sids,
                      const float* __restrict__ svals,
                      const float* __restrict__ carry,
                      float* __restrict__ out,
                      const long long* __restrict__ offs, int n_chan,
                      long long n_cells, int tile, int group, int vec) {
  extern __shared__ float sm[];  // (group, tile), channel-major
  const long long t = blockIdx.x;
  const int c0 = blockIdx.y * group;
  const int nc = n_chan - c0 < group ? n_chan - c0 : group;
  const long long cell0 = t * tile;
  const int cnt = n_cells - cell0 < tile ? (int)(n_cells - cell0) : tile;
  const long long r0 = offs[t], r1 = offs[t + 1];

  for (int i = threadIdx.x; i < nc * tile; i += kThreads) sm[i] = 0.0f;
  __syncthreads();

  for (long long k = r0 + threadIdx.x; k < r1; k += kThreads) {
    const int id = sids[k];
    if (k > r0 && sids[k - 1] == id) continue;  // not the start of its run
    long long e = k + 1;
    while (e < r1 && sids[e] == id) ++e;
    const int li = (int)(id - cell0);
    for (int c = 0; c < nc; ++c) {
      const float* col = svals + c0 + c;
      float s = 0.0f;
      for (long long j = k; j < e; ++j) s += col[j * n_chan];
      sm[c * tile + li] = s;
    }
  }
  __syncthreads();

  for (int c = 0; c < nc; ++c) {
    const long long plane = (long long)(c0 + c) * n_cells + cell0;
    const float* tc = sm + c * tile;
    if (vec) {  // cnt % 4 == 0 and the planes are 16-byte aligned
      float4* o4 = reinterpret_cast<float4*>(out + plane);
      const float4* c4 =
          carry ? reinterpret_cast<const float4*>(carry + plane) : nullptr;
      for (int i = threadIdx.x; i < cnt / 4; i += kThreads) {
        float4 s = reinterpret_cast<const float4*>(tc)[i];
        if (c4) {
          const float4 a = c4[i];
          s.x = a.x + s.x; s.y = a.y + s.y; s.z = a.z + s.z; s.w = a.w + s.w;
        }
        o4[i] = s;
      }
    } else {
      for (int i = threadIdx.x; i < cnt; i += kThreads) {
        float s = tc[i];
        if (carry) s = carry[plane + i] + s;
        out[plane + i] = s;
      }
    }
  }
}

}  // namespace

// int64 entries of the scratch buffer sorted_scatter needs: n_tiles + 1.
extern "C" long long sorted_scatter_scratch(int n_chan, long long n_cells) {
  const int tile = tile_cells(n_chan);
  return (n_cells + tile - 1) / tile + 1;
}

// sids (n_rows,) int32 sorted ascending; svals (n_rows, n_chan) f32
// row-major; carry (n_chan, n_cells) f32 or null; out (n_chan, n_cells)
// f32; scratch sorted_scatter_scratch(n_chan, n_cells) int64.  Ids
// outside [0, n_cells) are never summed.  Launches on `stream` and
// returns the cudaError_t of the launches (0 = success).
extern "C" int sorted_scatter(const int* sids, const float* svals,
                              const float* carry, float* out,
                              long long* scratch, long long n_rows,
                              int n_chan, long long n_cells, void* stream) {
  if (n_cells <= 0 || n_chan <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const int tile = tile_cells(n_chan);
  const int group = group_chans(n_chan);
  const long long n_tiles = (n_cells + tile - 1) / tile;
  tile_offsets_kernel<<<(unsigned int)((n_tiles + kThreads) / kThreads),
                        kThreads, 0, st>>>(sids, n_rows, n_cells, tile,
                                           n_tiles, scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int vec = n_cells % 4 == 0 && (uintptr_t)out % 16 == 0 &&
                  (carry == nullptr || (uintptr_t)carry % 16 == 0);
  const dim3 grid((unsigned int)n_tiles, (n_chan + group - 1) / group);
  sorted_scatter_kernel<<<grid, kThreads, (size_t)group * tile * 4, st>>>(
      sids, svals, carry, out, scratch, n_chan, n_cells, tile, group, vec);
  return (int)cudaGetLastError();
}
