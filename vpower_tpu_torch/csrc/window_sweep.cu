// Exact nearest-neighbour span scan (K4): one pass of the window sweep.
//
// Replaces the Pallas TPU kernel
// vpower_tpu/deposit/nn_window.py:_window_kernel (driven by
// window_pass).  The grid is cut into (8, 8, zc) tiles, zc = 64 or 128.
// Tile t owns the rows [s0[t], s1[t]) of a channels-first (8, R) f32
// array [x, y, z, payload..., pad] (cell units).  Every cell of the tile
// scans those rows in order and keeps the candidate whose squared
// distance is strictly smaller than its running best, starting from the
// pass-input state (n_pay + 1, n, n, n) = [payload..., d2].
//
// Float semantics, as the Pallas kernel (not its XLA mirror): query
// centres (float)i + 0.5f; with `wrap` the minimum image
// d - n * rintf(d * (float)(1.0 / n)) (round half to even, like
// jnp.round); d2 = (dx*dx + dy*dy) + dz*dz with no FMA contraction
// (built with -fmad=false).  The plain PyTorch version
// (deposit/nn_window.py:window_pass_plain) computes the same, so the two
// agree bit for bit.
//
// What bounds it on the H100: FP32 issue.  A pass is one compare per
// (cell, row of its tile's span) pair: at 512^3 with 10M particles,
// ~134M cells x ~2,000 rows, ~2.6e11 pairs.  Shared memory and DRAM are
// far from the limit: a tile's span (~2,000 rows of 32 B) is read once
// per block from L2, the state once in and once out (~5 GB at 512^3).
// Measured on an H100 80GB HBM3 at a 700 W limit: the 512^3 tier-1
// pass (32.3M rows, 2.65e11 pairs, 4 payload channels) in 0.141 s, about
// half the card's FP32 issue rate at ~9 instructions a pair.
//
// Design: one block of 256 threads per (8, 8, 32) cells, i.e. per tile
// and z segment.  A thread owns the 8 cells (x, y, z0 + 4j), j < 8, so
// dx*dx + dy*dy of a row is computed once for its 8 cells (the sum is
// left to right, so this is the same arithmetic), and keeps
// [payload..., d2] of its cells in registers (the payload count is a
// template parameter).  The span streams through shared memory in
// chunks of 512 rows, channel-major (each channel of a chunk is one
// coalesced load); every thread scans each chunk in order, so "first in
// span order wins a tie" holds as in the TPU kernel.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 8;
constexpr int kZT = 4;                        // threads along z
constexpr int kCPT = 8;                       // cells per thread
constexpr int kZB = kZT * kCPT;               // z extent of a block
constexpr int kThreads = kTile * kTile * kZT;  // 256
constexpr int kChunk = 512;                   // rows staged per round
constexpr int kMaxPay = 5;

template <int NPAY, bool WRAP>
__global__ void __launch_bounds__(kThreads)
    window_sweep_kernel(const int* __restrict__ s0v,
                        const int* __restrict__ s1v,
                        const float* __restrict__ rows, long long n_rows,
                        const float* __restrict__ state,
                        float* __restrict__ out, int n, int zc, int nty,
                        int ntz, float n_f, float inv_n) {
  __shared__ float sm[3 + NPAY][kChunk];
  const int zsegs = zc / kZB;
  const int t = blockIdx.x / zsegs;  // flat tile id (tx * nty + ty) * ntz + tz
  const int zs = blockIdx.x % zsegs;
  const int tx = t / (nty * ntz);
  const int ty = (t / ntz) % nty;
  const int tz = t % ntz;
  const int lz = threadIdx.x % kZT;
  const int ly = (threadIdx.x / kZT) % kTile;
  const int lx = threadIdx.x / (kZT * kTile);
  const int x = tx * kTile + lx;
  const int y = ty * kTile + ly;
  const int z0 = tz * zc + zs * kZB + lz;
  const long long n3 = (long long)n * n * n;
  const long long line = ((long long)x * n + y) * n;
  const float qx = (float)x + 0.5f;
  const float qy = (float)y + 0.5f;

  float qz[kCPT], bd[kCPT];
  float pay[NPAY > 0 ? NPAY : 1][kCPT];
#pragma unroll
  for (int j = 0; j < kCPT; ++j) {
    const int z = z0 + kZT * j;
    qz[j] = (float)z + 0.5f;
    bd[j] = state[NPAY * n3 + line + z];
#pragma unroll
    for (int c = 0; c < NPAY; ++c) pay[c][j] = state[c * n3 + line + z];
  }

  const int s0 = s0v[t];
  const int s1 = s1v[t];
  for (int base = s0; base < s1; base += kChunk) {
    const int cnt = min(kChunk, s1 - base);
    __syncthreads();  // the previous chunk is consumed
    for (int i = threadIdx.x; i < cnt; i += kThreads) {
#pragma unroll
      for (int c = 0; c < 3 + NPAY; ++c) {
        sm[c][i] = rows[c * n_rows + base + i];
      }
    }
    __syncthreads();
    for (int k = 0; k < cnt; ++k) {
      float dx = qx - sm[0][k];
      float dy = qy - sm[1][k];
      if (WRAP) {
        dx = dx - n_f * rintf(dx * inv_n);
        dy = dy - n_f * rintf(dy * inv_n);
      }
      const float dxy = dx * dx + dy * dy;
      const float pz = sm[2][k];
#pragma unroll
      for (int j = 0; j < kCPT; ++j) {
        float dz = qz[j] - pz;
        if (WRAP) dz = dz - n_f * rintf(dz * inv_n);
        const float d2 = dxy + dz * dz;
        if (d2 < bd[j]) {
          bd[j] = d2;
#pragma unroll
          for (int c = 0; c < NPAY; ++c) pay[c][j] = sm[3 + c][k];
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kCPT; ++j) {
    const int z = z0 + kZT * j;
    out[NPAY * n3 + line + z] = bd[j];
#pragma unroll
    for (int c = 0; c < NPAY; ++c) out[c * n3 + line + z] = pay[c][j];
  }
}

template <int NPAY>
void launch(bool wrap, int blocks, cudaStream_t stream, const int* s0,
            const int* s1, const float* rows, long long n_rows,
            const float* state, float* out, int n, int zc, int nty, int ntz,
            float n_f, float inv_n) {
  if (wrap) {
    window_sweep_kernel<NPAY, true><<<blocks, kThreads, 0, stream>>>(
        s0, s1, rows, n_rows, state, out, n, zc, nty, ntz, n_f, inv_n);
  } else {
    window_sweep_kernel<NPAY, false><<<blocks, kThreads, 0, stream>>>(
        s0, s1, rows, n_rows, state, out, n, zc, nty, ntz, n_f, inv_n);
  }
}

}  // namespace

// s0, s1 (T,) i32 with T = (n/8)^2 (n/zc); rows (8, n_rows) f32; state
// and out (n_pay + 1, n, n, n) f32, out not aliasing state.  Requires
// n % zc == 0, zc % 32 == 0, 0 <= n_pay <= 5, and every span inside
// [0, n_rows).  Launches one pass on `stream` and returns the
// cudaError_t of the launch (0 = success).
extern "C" int window_sweep(const int* s0, const int* s1, const float* rows,
                            long long n_rows, const float* state, float* out,
                            int n, int zc, int n_pay, int wrap,
                            void* stream) {
  if (n <= 0 || zc <= 0 || zc % kZB != 0 || n % zc != 0 || n % kTile != 0 ||
      n_pay < 0 || n_pay > kMaxPay) {
    return (int)cudaErrorInvalidValue;
  }
  const int nty = n / kTile;
  const int ntz = n / zc;
  const long long blocks = (long long)(n / kTile) * nty * ntz * (zc / kZB);
  const float n_f = (float)n;
  const float inv_n = (float)(1.0 / n);
  cudaStream_t st = (cudaStream_t)stream;
  const bool w = wrap != 0;
  const int b = (int)blocks;
  switch (n_pay) {
    case 0: launch<0>(w, b, st, s0, s1, rows, n_rows, state, out, n, zc, nty, ntz, n_f, inv_n); break;
    case 1: launch<1>(w, b, st, s0, s1, rows, n_rows, state, out, n, zc, nty, ntz, n_f, inv_n); break;
    case 2: launch<2>(w, b, st, s0, s1, rows, n_rows, state, out, n, zc, nty, ntz, n_f, inv_n); break;
    case 3: launch<3>(w, b, st, s0, s1, rows, n_rows, state, out, n, zc, nty, ntz, n_f, inv_n); break;
    case 4: launch<4>(w, b, st, s0, s1, rows, n_rows, state, out, n, zc, nty, ntz, n_f, inv_n); break;
    default: launch<5>(w, b, st, s0, s1, rows, n_rows, state, out, n, zc, nty, ntz, n_f, inv_n); break;
  }
  return (int)cudaGetLastError();
}
