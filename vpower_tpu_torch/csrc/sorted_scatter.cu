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
// What bounds it on the H100: memory traffic.  Every one of the
// n_cells * C outputs is written once (the seed grid of the 512^3
// descent is 7 x 134M floats, 3.8 GB), every row of svals is read once,
// and each thread's two binary searches in sids are ~2 log2(N) dependent
// reads that neighbouring threads share through L1/L2.
//
// Design: one thread per output cell.  The thread binary-searches its
// run [lo, hi) in the sorted ids, sums the run's rows in order in f32,
// adds carry if given, and writes every channel of its cell, empty cells
// included (so the output needs no zero-fill).  Consecutive threads own
// consecutive cells, so the writes of each channel are coalesced.  No
// atomics: the sum order is the row order, the result is deterministic
// and equals a sequential scatter-add of the rows (torch index_add_ on
// the CPU) bit for bit.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ long long lower_bound(const int* __restrict__ a,
                                                 long long n, int key) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    long long mid = (lo + hi) >> 1;
    if (a[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void sorted_scatter_kernel(const int* __restrict__ sids,
                                      const float* __restrict__ svals,
                                      const float* __restrict__ carry,
                                      float* __restrict__ out,
                                      long long n_rows, int n_chan,
                                      long long n_cells) {
  long long cell = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= n_cells) return;
  long long lo = lower_bound(sids, n_rows, (int)cell);
  long long hi = lo;
  if (lo < n_rows && sids[lo] == (int)cell) {
    hi = lower_bound(sids + lo, n_rows - lo, (int)cell + 1) + lo;
  }
  for (int c = 0; c < n_chan; ++c) {
    float s = 0.0f;
    for (long long k = lo; k < hi; ++k) s += svals[k * n_chan + c];
    if (carry != nullptr) s = carry[(long long)c * n_cells + cell] + s;
    out[(long long)c * n_cells + cell] = s;
  }
}

}  // namespace

// sids (n_rows,) int32 sorted ascending; svals (n_rows, n_chan) f32
// row-major; carry (n_chan, n_cells) f32 or null; out (n_chan, n_cells)
// f32.  Ids outside [0, n_cells) are never summed.  Launches on
// `stream` and returns the cudaError_t of the launch (0 = success).
extern "C" int sorted_scatter(const int* sids, const float* svals,
                              const float* carry, float* out,
                              long long n_rows, int n_chan,
                              long long n_cells, void* stream) {
  if (n_cells <= 0) return 0;
  const int threads = 256;
  long long blocks = (n_cells + threads - 1) / threads;
  sorted_scatter_kernel<<<(unsigned int)blocks, threads, 0,
                          (cudaStream_t)stream>>>(
      sids, svals, carry, out, n_rows, n_chan, n_cells);
  return (int)cudaGetLastError();
}
