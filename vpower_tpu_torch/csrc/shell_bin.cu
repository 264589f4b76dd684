// Shell sums (K5): for each spherical k-shell, the weighted power and the
// weighted mode count of a grid, as per-x-slice partial sums and then one
// sum across the slices.
//
// Replaces no Pallas kernel.  The JAX package bins with one-hot matrix
// products that it leaves to XLA (vpower_tpu/spectrum/power.py:
// _cascade_bin), which on a TPU land on the MXU.  On the H100 the same
// products built a float one-hot of up to 2^28 elements a chunk of slices
// and multiplied it as an M = 1 matrix product: a histogram dressed as a
// matrix product, ~1,800 times its bound on the folded range-1024 sweep.
//
// What bounds it on the H100: bytes.  Every mode's power (4 B) and shell
// id (4 B) is read once; the outputs are a few KB.  A 512^3 grid is
// 1.07 GB, 0.32 ms at 3.35 TB/s.
//
// Design.  One CTA of 8 warps for each x-slice, or for a part of one when
// the slices are too few to fill the card (eight CTAs a streaming
// multiprocessor); a slice is one contiguous run of n1 * n2 modes.  Each
// warp walks its own contiguous stretch, a lane taking 16 B of power and
// 16 B of ids a step where the row length and the pointers allow.  A lane
// first sums the runs of equal ids among its own elements; then, one run
// at a time, the warp sums the lanes of equal id with a segmented shuffle
// tree over neighbouring lanes, as deep as the longest segment needs, and
// the head of each segment adds the sum to the warp's private histogram
// in shared memory ((Psum, count) pairs) with a plain read-add-write.
// Where the heads' ids rise or fall strictly across the lanes they all add
// at once; else (rare: along a row of the lattice the ids rise, then
// fall) heads of one id add in lane order, one a round (__match_any_sync),
// so no two lanes touch one bin at once.  The adds take about half of
// K5's time: a version that skips them ran at 75-88% of the bound, K5 at
// 42-47% (H100).  At the end the CTA sums its warps' histograms in warp
// order and writes one partial row; a second small kernel sums the rows
// in a fixed order in float64 and rounds once.  No float atomics
// anywhere, so a result has the same bits on every run.  Counts of
// integer weights are exact (below 2^24 a bin), so Nsample equals any
// exact count bit for bit.  Shells beyond what the private histograms
// hold in shared memory are summed in windows of shells, each window a
// pass over the CTA's stretch.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHistBytes = 64 * 1024;  // a CTA's private histograms
constexpr unsigned kFull = 0xffffffffu;

// shells a window: the warps' (Psum, count) histograms fill kHistBytes
template <typename T>
int window_bins() { return kHistBytes / (kWarps * 2 * (int)sizeof(T)); }

// V consecutive elements from element i * V: one 16-byte load where
// V * sizeof = 16, read once (evict first)
__device__ __forceinline__ void load(const float* p, long long i,
                                     float (&v)[4]) {
  const float4 t = __ldcs(reinterpret_cast<const float4*>(p) + i);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load(const double* p, long long i,
                                     double (&v)[2]) {
  const double2 t = __ldcs(reinterpret_cast<const double2*>(p) + i);
  v[0] = t.x; v[1] = t.y;
}
__device__ __forceinline__ void load(const int* p, long long i, int (&v)[4]) {
  const int4 t = __ldcs(reinterpret_cast<const int4*>(p) + i);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load(const int* p, long long i, int (&v)[2]) {
  const int2 t = __ldcs(reinterpret_cast<const int2*>(p) + i);
  v[0] = t.x; v[1] = t.y;
}
template <typename T>
__device__ __forceinline__ void load(const T* p, long long i, T (&v)[1]) {
  v[0] = __ldcs(p + i);
}

// One shell's (Psum, count), side by side: one shared load and one store
// an add.
template <typename T> struct Pair;
template <> struct alignas(8) Pair<float> { float p, c; };
template <> struct alignas(16) Pair<double> { double p, c; };

// The warp's lanes each hold one run: shell k (local to the window, -1 =
// none), power sum s, count c.  Lanes of one k that neighbour each other
// form a segment, summed by a fixed shuffle tree (as deep as the longest
// segment needs) into its first lane, the head; heads add into the warp's
// histogram h.  Where the adding heads' shells rise or fall strictly
// across the lanes, no two are equal and all add at once; otherwise heads
// of one shell add in lane order, one a round.
template <typename T>
__device__ __forceinline__ void warp_add(int k, T s, T c, int lane,
                                         Pair<T>* __restrict__ h) {
  const int up = __shfl_up_sync(kFull, k, 1);
  const bool head = lane == 0 || up != k;
  const unsigned heads = __ballot_sync(kFull, head);
  const unsigned above = lane == 31 ? 0u : heads & (kFull << (lane + 1));
  const int end = above ? __ffs(above) - 1 : 32;  // the segment's end
  const unsigned longest =
      __reduce_max_sync(kFull, head ? (unsigned)(end - lane) : 0u);
  for (unsigned off = 1; off < longest; off <<= 1) {
    const T ts = __shfl_down_sync(kFull, s, off);
    const T tc = __shfl_down_sync(kFull, c, off);
    if (lane + (int)off < end) { s += ts; c += tc; }
  }
  const bool adds = head && k >= 0;
  const unsigned adders = __ballot_sync(kFull, adds);
  const unsigned later = lane == 31 ? 0u : adders & (kFull << (lane + 1));
  const int nk = __shfl_sync(kFull, k, later ? __ffs(later) - 1 : lane);
  const bool rise = !adds || !later || nk > k;
  const bool fall = !adds || !later || nk < k;
  if (__all_sync(kFull, rise) || __all_sync(kFull, fall)) {
    if (adds) {
      Pair<T> v = h[k];
      v.p += s;
      v.c += c;
      h[k] = v;
    }
    __syncwarp();
    return;
  }
  // lanes that add nothing get keys no shell has, one each
  const unsigned same = __match_any_sync(kFull, adds ? k : -2 - lane);
  const unsigned rank = __popc(same & ((1u << lane) - 1u));
  const unsigned rounds = __reduce_max_sync(kFull, rank);
  for (unsigned r = 0; r <= rounds; ++r) {
    if (adds && rank == r) {
      Pair<T> v = h[k];
      v.p += s;
      v.c += c;
      h[k] = v;
    }
    __syncwarp();
  }
}

// partial[row] = (Psum[n_bins], count[n_bins]) of one CTA's stretch: the
// whole of slice `row` (splits = 1) or part row % splits of slice
// row / splits.  row_vecs = n1 * n2 / V; weights (n2,) or null.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
shell_bin_kernel(const T* __restrict__ power, const int* __restrict__ bins,
                 const T* __restrict__ weights, T* __restrict__ partial,
                 long long row_vecs, int n2, int n_bins, int win,
                 int splits) {
  extern __shared__ __align__(16) unsigned char smem[];
  Pair<T>* hist = reinterpret_cast<Pair<T>*>(smem);  // (kWarps, win)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  Pair<T>* h = hist + (size_t)warp * win;
  const long long slice = blockIdx.x / splits;
  const long long part = blockIdx.x % splits;
  const long long a = row_vecs * part / splits;
  const long long b = row_vecs * (part + 1) / splits;
  const long long wa = a + (b - a) * warp / kWarps;
  const long long wb = a + (b - a) * (warp + 1) / kWarps;
  const T* pw = power + slice * row_vecs * V;
  const int* bi = bins + slice * row_vecs * V;
  T* out = partial + (long long)blockIdx.x * 2 * n_bins;
  const int zstep = (int)((32LL * V) % n2);  // kz advance of a warp step

  for (int bin0 = 0; bin0 < n_bins; bin0 += win) {
    const int cnt = n_bins - bin0 < win ? n_bins - bin0 : win;
    for (int i = threadIdx.x; i < kWarps * win; i += kThreads)
      hist[i] = Pair<T>{T(0), T(0)};
    __syncthreads();

    long long i = wa + lane;
    int z0 = (int)((i * V) % n2);  // kz of the lane's first element
    T pv[V];
    int id[V];
#pragma unroll
    for (int e = 0; e < V; ++e) { pv[e] = T(0); id[e] = -1; }
    if (i < wb) { load(pw, i, pv); load(bi, i, id); }
    for (long long step = wa; step < wb; step += 32) {
      T npv[V];
      int nid[V];
#pragma unroll
      for (int e = 0; e < V; ++e) { npv[e] = T(0); nid[e] = -1; }
      if (i + 32 < wb) { load(pw, i + 32, npv); load(bi, i + 32, nid); }

      // the lane's elements: window-local shell (-1 = not in the window),
      // weighted power, weight
      int key[V];
      T val[V], cw[V];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        key[e] = (i < wb && id[e] >= bin0 && id[e] < bin0 + cnt)
                     ? id[e] - bin0 : -1;
        if (weights) {
          int z = z0 + e;
          while (z >= n2) z -= n2;
          const T w = __ldg(weights + z);
          val[e] = pv[e] * w;
          cw[e] = w;
        } else {
          val[e] = pv[e];
          cw[e] = T(1);
        }
      }
      // runs of equal keys among the lane's elements, each summed into
      // its first element (right to left)
      bool start[V];
      int nr = 0;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        start[e] = e == 0 || key[e] != key[e - 1];
        nr += start[e] && key[e] >= 0;
      }
#pragma unroll
      for (int e = V - 1; e > 0; --e)
        if (!start[e]) { val[e - 1] += val[e]; cw[e - 1] += cw[e]; }
      // the warp adds its lanes' r-th runs together, r = 0, 1, ...
      const unsigned passes = __reduce_max_sync(kFull, (unsigned)nr);
      for (unsigned r = 0; r < passes; ++r) {
        int k = -1;
        T s = T(0), c = T(0);
        unsigned seen = 0;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const bool run = start[e] && key[e] >= 0;
          if (run && seen == r) { k = key[e]; s = val[e]; c = cw[e]; }
          seen += run;
        }
        warp_add(k, s, c, lane, h);
      }

      z0 += zstep;
      if (z0 >= n2) z0 -= n2;
      i += 32;
#pragma unroll
      for (int e = 0; e < V; ++e) { pv[e] = npv[e]; id[e] = nid[e]; }
    }
    __syncthreads();

    // the CTA's row: its warps' histograms summed in warp order
    for (int j = threadIdx.x; j < 2 * cnt; j += kThreads) {
      const int ch = j < cnt ? 0 : 1;
      const int c = j - ch * cnt;
      T t = T(0);
      for (int w = 0; w < kWarps; ++w) {
        const Pair<T> v = hist[(size_t)w * win + c];
        t += ch ? v.c : v.p;
      }
      out[ch * n_bins + bin0 + c] = t;
    }
    __syncthreads();
  }
}

// out[col] = sum over the rows of partial[row, col], in float64, rounded
// once: each warp sums a contiguous eighth of the rows in row order, then
// the eighths are added in order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
shell_bin_finish_kernel(const T* __restrict__ partial, long long rows,
                        int n_cols, T* __restrict__ out) {
  __shared__ double part[kWarps][32];
  const int lane = threadIdx.x & 31, g = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  double s = 0.0;
  if (col < n_cols) {
    const long long r0 = rows * g / kWarps, r1 = rows * (g + 1) / kWarps;
    for (long long r = r0; r < r1; ++r) s += (double)partial[r * n_cols + col];
  }
  part[g][lane] = s;
  __syncthreads();
  if (g == 0 && col < n_cols) {
    double t = 0.0;
    for (int j = 0; j < kWarps; ++j) t += part[j][lane];
    out[col] = (T)t;
  }
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || n <= 0)
    n = 132;
  return n;
}

// CTAs a slice: one, or more where the slices number fewer than eight a
// streaming multiprocessor (eight ran 4% faster than four on the cells'
// grids, H100), each CTA with at least one 16-byte load a thread
long long splits_of(long long n0, long long row_len) {
  long long want = 8LL * sm_count() / n0;
  long long most = row_len / (4LL * kThreads);
  if (want < 1) want = 1;
  if (most < 1) most = 1;
  return want < most ? want : most;
}

template <typename T, int V>
int launch(const T* power, const int* bins, const T* weights, T* partial,
           T* out, long long n0, long long row_len, int n2, int n_bins,
           cudaStream_t st) {
  const int win = n_bins < window_bins<T>() ? n_bins : window_bins<T>();
  const size_t smem = (size_t)kWarps * 2 * win * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        shell_bin_kernel<T, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long splits = splits_of(n0, row_len);
  const long long rows = n0 * splits;
  shell_bin_kernel<T, V><<<(unsigned int)rows, kThreads, smem, st>>>(
      power, bins, weights, partial, row_len / V, n2, n_bins, win,
      (int)splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n_cols = 2 * n_bins;
  shell_bin_finish_kernel<T><<<(n_cols + 31) / 32, kThreads, 0, st>>>(
      partial, rows, n_cols, out);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* power, const int* bins, const void* weights,
             void* partial, void* out, long long n0, long long row_len,
             int n2, int n_bins, cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(T);
  const T* p = (const T*)power;
  const T* w = (const T*)weights;
  if (row_len % kVec == 0 && (uintptr_t)power % 16 == 0 &&
      (uintptr_t)bins % (4 * kVec) == 0)
    return launch<T, kVec>(p, bins, w, (T*)partial, (T*)out, n0, row_len, n2,
                           n_bins, st);
  return launch<T, 1>(p, bins, w, (T*)partial, (T*)out, n0, row_len, n2,
                      n_bins, st);
}

}  // namespace

// Rows of the partial buffer shell_bin needs, each 2 * n_bins elements.
extern "C" long long shell_bin_rows(long long n0, long long row_len) {
  return n0 * splits_of(n0, row_len);
}

// power (n0, row_len) float32 (dbl = 0) or float64 (dbl = 1), row-major;
// bins (n0, row_len) int32; weights (n2,) of power's type, or null, where
// row_len is a multiple of n2 and weights[j % n2] weighs element j of a
// row; partial (shell_bin_rows(n0, row_len), 2, n_bins) and out
// (2, n_bins) of power's type.  out[0] = Psum, out[1] = the count.  Ids
// outside [0, n_bins) are dropped.  Launches on `stream` and returns the
// cudaError_t of the launches (0 = success).
extern "C" int shell_bin(const void* power, const int* bins,
                         const void* weights, void* partial, void* out,
                         long long n0, long long row_len, int n2, int n_bins,
                         int dbl, void* stream) {
  if (n0 <= 0 || row_len <= 0 || n2 <= 0 || n_bins <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  return dbl ? dispatch<double>(power, bins, weights, partial, out, n0,
                                row_len, n2, n_bins, st)
             : dispatch<float>(power, bins, weights, partial, out, n0,
                               row_len, n2, n_bins, st);
}
