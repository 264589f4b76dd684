// Sorted-segment deposit (K1): out[c, id] = carry[c, id] + sum of
// svals[k, c] over the rows k with sids[k] == id, summed in row order.
// With a periodic shift d = (dx, dy, dz) on an n^3 cube, each cell's sum
// lands at the shifted cell instead:
//   out[c, wrap(id + d)] = carry[c, wrap(id + d)] + sum.
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
//
// Shift, in place.  A caller that sums deposits over a lattice of
// offsets (deposit_offsets_rolled: the CIC corners, the SPH footprint)
// moves each offset's grid by its offset before adding it.  K1 reads
// the whole carry and writes every cell on every call anyway, so the
// move costs no bytes inside K1, where a torch.roll of the grid read and
// wrote it once more an offset.  The shift is a bijection of the
// periodic cube: the destinations of one tile's cells are cells no other
// tile writes, and each destination is read from the carry and written
// by the one thread that owns it, in one iteration.  So out may be the
// carry itself, and the shifted kernel's carry and out are not
// __restrict__.  Without it the compiler keeps each load after the
// stores before it (on an H100, 10M rows of 4 channels into 512^3 with
// a carry: 1.64-1.87 ms a call against 1.58 unshifted), so both write
// loops read the carry through the read-only cache (__ldg; 1.58 ms): an
// element is read once, by the thread that then writes it, and never
// after, so no stale line is ever read.  The unshifted kernel never
// runs in place and keeps its __restrict__ pointers and code.
//
// Where a tile holds whole z-rows (tile % n == 0: at 512^3 with 4
// channels a tile is 4 rows), dx and dy move whole rows and dz rotates
// inside a row.  The run sums go into the shared tile already rotated
// by dz, so the write loop reads the tile in order, keeps its 16-byte
// loads and stores, and only the row it writes to moves.  Other shapes
// take a per-cell write loop with scalar stores, which runs at about
// twice the row loop's time (on an H100 with the call above: 2.98 ms
// forced at 512^3 against 1.60; 2.77 ms at 500^3, where K1 and a
// torch.roll of the grid took 3.87).  The shape alone picks the path; a
// call without a shift runs the unshifted kernel.
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

// The shifted write loops: kRows (the tile holds whole z-rows), kCells
// (any other shape); kPlain is the unshifted kernel's.
enum Mode { kPlain = 0, kRows = 1, kCells = 2 };

struct Shift {
  int n, dx, dy, dz;  // the cube's side; the shift, each in [0, n)
};

__device__ __forceinline__ int wrap_add(int a, int d, int n) {
  a += d;
  return a >= n ? a - n : a;
}

// Zero the block's (nc, tile) shared tile, then sum each run of equal
// ids in rows [r0, r1) in row order from 0.0f into it (one writer per
// cell).  kRows puts each sum at its z rotated by dz inside its row.
template <int kMode>
__device__ __forceinline__ void sum_tile(float* sm,
                                         const int* __restrict__ sids,
                                         const float* __restrict__ svals,
                                         long long r0, long long r1,
                                         long long cell0, int tile, int c0,
                                         int nc, int n_chan, Shift sh) {
  for (int i = threadIdx.x; i < nc * tile; i += kThreads) sm[i] = 0.0f;
  __syncthreads();

  for (long long k = r0 + threadIdx.x; k < r1; k += kThreads) {
    const int id = sids[k];
    if (k > r0 && sids[k - 1] == id) continue;  // not the start of its run
    long long e = k + 1;
    while (e < r1 && sids[e] == id) ++e;
    int li = (int)(id - cell0);
    if constexpr (kMode == kRows) {
      const int z = li % sh.n;
      li += wrap_add(z, sh.dz, sh.n) - z;
    }
    for (int c = 0; c < nc; ++c) {
      const float* col = svals + c0 + c;
      float s = 0.0f;
      for (long long j = k; j < e; ++j) s += col[j * n_chan];
      sm[c * tile + li] = s;
    }
  }
  __syncthreads();
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
  sum_tile<kPlain>(sm, sids, svals, offs[t], offs[t + 1], cell0, tile, c0,
                   nc, n_chan, Shift{1, 0, 0, 0});

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

// The shifted kernel: carry and out may be one grid, so neither is
// __restrict__.  Rows and cells fit an int: n_cells < 2^31.
template <int kMode>
__global__ void __launch_bounds__(kThreads)
shifted_scatter_kernel(const int* __restrict__ sids,
                       const float* __restrict__ svals, const float* carry,
                       float* out, const long long* __restrict__ offs,
                       int n_chan, long long n_cells, int tile, int group,
                       int vec, Shift sh) {
  extern __shared__ float sm[];  // (group, tile), channel-major
  const long long t = blockIdx.x;
  const int c0 = blockIdx.y * group;
  const int nc = n_chan - c0 < group ? n_chan - c0 : group;
  const long long cell0 = t * tile;
  const int cnt = n_cells - cell0 < tile ? (int)(n_cells - cell0) : tile;
  sum_tile<kMode>(sm, sids, svals, offs[t], offs[t + 1], cell0, tile, c0, nc,
                  n_chan, sh);

  if constexpr (kMode == kRows) {
    // element i of the tile (of 4 floats with vec: n % 4 == 0 and the
    // planes 16-byte aligned) lies in its row j at z = (i - j per_row) w,
    // already rotated; the row moves by (dx, dy).  The carry is read
    // through the read-only cache (__ldg), which lets the compiler batch
    // the unrolled loads ahead of the stores: safe in place, since each
    // element is read once, by the thread that then writes it, and never
    // read after it is written.
    const int w = vec ? 4 : 1;
    const int n_el = cnt / w, per_row = sh.n / w;
    const int row0 = (int)(cell0 / sh.n);
    for (int c = 0; c < nc; ++c) {
      const long long plane = (long long)(c0 + c) * n_cells;
      const float* tc = sm + c * tile;
#pragma unroll 4
      for (int i = threadIdx.x; i < n_el; i += kThreads) {
        const int j = i / per_row, r = row0 + j;
        const int x = r / sh.n, y = r - x * sh.n;
        const long long at =
            plane + (wrap_add(x, sh.dx, sh.n) * sh.n + wrap_add(y, sh.dy, sh.n))
                        * sh.n + (i - j * per_row) * w;
        if (vec) {
          float4 s = reinterpret_cast<const float4*>(tc)[i];
          if (carry) {
            const float4 a = __ldg(reinterpret_cast<const float4*>(carry + at));
            s.x = a.x + s.x; s.y = a.y + s.y; s.z = a.z + s.z; s.w = a.w + s.w;
          }
          *reinterpret_cast<float4*>(out + at) = s;
        } else {
          float s = tc[i];
          if (carry) s = __ldg(carry + at) + s;
          out[at] = s;
        }
      }
    }
  } else {  // kCells: any shape, one cell a step, scalar stores
#pragma unroll 2
    for (int i = threadIdx.x; i < cnt; i += kThreads) {
      const int cell = (int)cell0 + i;
      const int r = cell / sh.n, z = cell - r * sh.n;
      const int x = r / sh.n, y = r - x * sh.n;
      const int dst = (wrap_add(x, sh.dx, sh.n) * sh.n +
                       wrap_add(y, sh.dy, sh.n)) * sh.n +
                      wrap_add(z, sh.dz, sh.n);
#pragma unroll 4
      for (int c = 0; c < nc; ++c) {
        const long long at = (long long)(c0 + c) * n_cells + dst;
        float s = sm[c * tile + i];
        if (carry) s = __ldg(carry + at) + s;
        out[at] = s;
      }
    }
  }
}

int launch(int mode, const int* sids, const float* svals, const float* carry,
           float* out, long long* scratch, long long n_rows, int n_chan,
           long long n_cells, Shift sh, cudaStream_t st) {
  const int tile = tile_cells(n_chan);
  const int group = group_chans(n_chan);
  const long long n_tiles = (n_cells + tile - 1) / tile;
  tile_offsets_kernel<<<(unsigned int)((n_tiles + kThreads) / kThreads),
                        kThreads, 0, st>>>(sids, n_rows, n_cells, tile,
                                           n_tiles, scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long whole = mode == kRows ? sh.n : n_cells;
  const int vec = mode != kCells && whole % 4 == 0 &&
                  (uintptr_t)out % 16 == 0 &&
                  (carry == nullptr || (uintptr_t)carry % 16 == 0);
  const dim3 grid((unsigned int)n_tiles, (n_chan + group - 1) / group);
  const size_t smem = (size_t)group * tile * 4;
  if (mode == kRows)
    shifted_scatter_kernel<kRows><<<grid, kThreads, smem, st>>>(
        sids, svals, carry, out, scratch, n_chan, n_cells, tile, group, vec,
        sh);
  else if (mode == kCells)
    shifted_scatter_kernel<kCells><<<grid, kThreads, smem, st>>>(
        sids, svals, carry, out, scratch, n_chan, n_cells, tile, group, vec,
        sh);
  else
    sorted_scatter_kernel<<<grid, kThreads, smem, st>>>(
        sids, svals, carry, out, scratch, n_chan, n_cells, tile, group, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// int64 entries of the scratch buffer sorted_scatter needs: n_tiles + 1.
extern "C" long long sorted_scatter_scratch(int n_chan, long long n_cells) {
  const int tile = tile_cells(n_chan);
  return (n_cells + tile - 1) / tile + 1;
}

// 1 where a shifted call on an n_grid^3 cube takes the whole-row write
// loop (the tile holds whole z-rows), 0 where it takes the per-cell one.
extern "C" int sorted_scatter_rows(int n_chan, int n_grid) {
  return n_grid > 0 && tile_cells(n_chan) % n_grid == 0;
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
  return launch(kPlain, sids, svals, carry, out, scratch, n_rows, n_chan,
                n_cells, Shift{0, 0, 0, 0}, (cudaStream_t)stream);
}

// The same on n_cells = n_grid^3, each cell's sum at the cell shifted by
// (dx, dy, dz) with periodic wrap; out may be carry itself.
extern "C" int sorted_scatter_shifted(const int* sids, const float* svals,
                                      const float* carry, float* out,
                                      long long* scratch, long long n_rows,
                                      int n_chan, int n_grid, int dx, int dy,
                                      int dz, void* stream) {
  if (n_grid <= 0 || n_chan <= 0) return 0;
  const Shift sh{n_grid, ((dx % n_grid) + n_grid) % n_grid,
                 ((dy % n_grid) + n_grid) % n_grid,
                 ((dz % n_grid) + n_grid) % n_grid};
  const long long n_cells = (long long)n_grid * n_grid * n_grid;
  return launch(sorted_scatter_rows(n_chan, n_grid) ? kRows : kCells, sids,
                svals, carry, out, scratch, n_rows, n_chan, n_cells, sh,
                (cudaStream_t)stream);
}
