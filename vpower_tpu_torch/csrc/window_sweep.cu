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
// What bounds it on the H100: instruction issue.  Scored in full, a pass
// is one distance and one compare per (cell, row of its tile's span)
// pair: at 512^3 with 10M particles ~134M cells x ~2,000 rows, 2.65e11
// pairs.  A first design did exactly that, with the winner's payload
// copied on every win (1 + n_pay selects a pair), and took 141 ms on an
// H100 80GB HBM3 at a 700 W limit.  Most of those pairs cannot win: a
// block holds 32 of its tile's 128 z cells, and a row farther from all
// of them than the block's largest running best is dead.  The bytes are
// few beside the pairs: the state read and written once (~5 GB at
// 512^3), each span read from L2 once per block.
//
// Design: one block of 64 * kZT threads per (8, 8, kZB) cells (a tile
// and a z segment); a thread owns kCPT cells of one column, kZT apart in
// z (so a warp's loads and stores of the state are runs of kZT words), a
// warp 32 / kZT columns in a kWX x kWY patch.  Each exactness
// argument rests on two facts: rounding is monotone, and bd only falls
// during a pass, so a bound taken early stays an upper bound.
//  1. A cell carries its best d2 and the winner's span position, not
//     its payload: one compare and two selects a pair whatever n_pay
//     is.  A cell that some row beat gathers the payload once at the
//     end from `rows`; a cell that no row beat keeps its input payload.
//     The scan order and the strict < are unchanged, so the same row
//     wins.
//  2. Wrap-free passes stage a row only if it can beat some cell of the
//     block: with B the largest input bd of the block and m_a the
//     distance from the row to the block's nearest cell centre on axis
//     a (0 inside), computed with the scan's own float operations, the
//     row is dropped iff (m_x^2 + m_y^2) + m_z^2 >= B.  That sum is a
//     lower bound of the d2 the scan would compute for every cell of
//     the block.  The kept rows are compacted in span order (ballot and
//     popc within a warp, warp totals through shared memory) into a
//     chunk of shared memory, [x, y, z, position] as one float4 a row,
//     which every thread then scans in order.  Wrap passes stage every
//     row.
//  3. A thread skips a row when dx*dx + dy*dy >= the largest bd of its
//     cells (refreshed every 32 rows; a stale, larger value is safe):
//     d2 = dxy + dz*dz >= dxy.  A warp gains when all its lanes skip,
//     so a warp's columns form a compact patch: 4 x 2 (of 1 x 8, 2 x 4
//     and 4 x 2 the fastest, by ~1% over 2 x 4 and ~12% over 1 x 8).
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 8;
constexpr int kZT = 4;                         // threads along z a column
constexpr int kCPT = 8;                        // cells a thread (along z)
constexpr int kZB = kZT * kCPT;                // z extent of a block
constexpr int kThreads = kTile * kTile * kZT;  // 256
constexpr int kWarps = kThreads / 32;
constexpr int kWX = 4;                         // warp patch: kWX x kWY columns
constexpr int kWY = 32 / kZT / kWX;
constexpr int kChunk = 1024;                   // kept rows staged per scan
constexpr int kRefresh = 32;                   // rows between bmax refreshes
constexpr int kMaxPay = 5;
static_assert(32 % kZT == 0 && kTile % kWX == 0 && kTile % kWY == 0,
              "a warp is a kWX x kWY patch of columns");
static_assert((kTile / kWX) * (kTile / kWY) == kWarps, "warps tile 8 x 8");
static_assert(kChunk % kThreads == 0, "staging rounds fill a chunk");

__device__ __forceinline__ float axis_gap(float p, float lo, float hi) {
  return p < lo ? lo - p : (p > hi ? p - hi : 0.0f);
}

template <int NPAY, bool WRAP>
__global__ void __launch_bounds__(kThreads)
    window_sweep_kernel(const int* __restrict__ s0v,
                        const int* __restrict__ s1v,
                        const float* __restrict__ rows, long long n_rows,
                        const float* __restrict__ state,
                        float* __restrict__ out, int n, int zc, int nty,
                        int ntz, float n_f, float inv_n) {
  __shared__ float4 sm[kChunk];
  __shared__ int wtot[2][kWarps];
  __shared__ float wmax[kWarps];
  const int zsegs = zc / kZB;
  const int t = blockIdx.x / zsegs;  // flat tile id (tx * nty + ty) * ntz + tz
  const int zs = blockIdx.x % zsegs;
  const int tx = t / (nty * ntz);
  const int ty = (t / ntz) % nty;
  const int tz = t % ntz;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int col = lane / kZT;
  const int lx = (warp % (kTile / kWX)) * kWX + col % kWX;
  const int ly = (warp / (kTile / kWX)) * kWY + col / kWX;
  const int x = tx * kTile + lx;
  const int y = ty * kTile + ly;
  const int zb = tz * zc + zs * kZB;  // first z of the block
  const int z0 = zb + lane % kZT;       // cells z0 + kZT * j, j < kCPT
  const long long n3 = (long long)n * n * n;
  const long long line = ((long long)x * n + y) * n;
  const float qx = (float)x + 0.5f;
  const float qy = (float)y + 0.5f;

  float qz[kCPT], bd[kCPT];
  int bk[kCPT];
#pragma unroll
  for (int j = 0; j < kCPT; ++j) {
    qz[j] = (float)(z0 + kZT * j) + 0.5f;
    bd[j] = state[NPAY * n3 + line + z0 + kZT * j];
    bk[j] = -1;
  }

  const int s1 = s1v[t];
  int rd = s0v[t];  // next span row to stage

  // B: the block's largest input bd (wrap-free passes with rows only)
  float B = 0.0f;
  if (!WRAP && rd < s1) {
    float tmax = bd[0];
#pragma unroll
    for (int j = 1; j < kCPT; ++j) tmax = fmaxf(tmax, bd[j]);
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, s));
    }
    if (lane == 0) wmax[warp] = tmax;
    __syncthreads();
    B = wmax[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) B = fmaxf(B, wmax[w]);
  }
  const float lox = (float)(tx * kTile) + 0.5f;
  const float hix = (float)(tx * kTile + kTile - 1) + 0.5f;
  const float loy = (float)(ty * kTile) + 0.5f;
  const float hiy = (float)(ty * kTile + kTile - 1) + 0.5f;
  const float loz = (float)zb + 0.5f;
  const float hiz = (float)(zb + kZB - 1) + 0.5f;

  int round = 0;
  while (rd < s1) {
    // stage: rounds of kThreads span rows, the kept ones compacted in
    // span order, until the chunk could overflow or the span ends
    int fill = 0;
    while (rd < s1 && fill <= kChunk - kThreads) {
      const int i = rd + threadIdx.x;
      bool keep = false;
      float4 r;
      if (i < s1) {
        r = make_float4(rows[i], rows[n_rows + i], rows[2 * n_rows + i],
                        __int_as_float(i));
        keep = true;
        if (!WRAP) {
          const float mx = axis_gap(r.x, lox, hix);
          const float my = axis_gap(r.y, loy, hiy);
          const float mz = axis_gap(r.z, loz, hiz);
          keep = !((mx * mx + my * my) + mz * mz >= B);
        }
      }
      const unsigned bal = __ballot_sync(0xffffffffu, keep);
      if (lane == 0) wtot[round & 1][warp] = __popc(bal);
      __syncthreads();
      int off = fill;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int c = wtot[round & 1][w];
        off += w < warp ? c : 0;
        fill += c;
      }
      if (keep) sm[off + __popc(bal & ((1u << lane) - 1u))] = r;
      rd += kThreads;
      ++round;
    }
    __syncthreads();  // the kept rows are visible

    // scan the chunk in order
    for (int k0 = 0; k0 < fill; k0 += kRefresh) {
      float bmax = bd[0];
#pragma unroll
      for (int j = 1; j < kCPT; ++j) bmax = fmaxf(bmax, bd[j]);
      const int k1 = min(k0 + kRefresh, fill);
      for (int k = k0; k < k1; ++k) {
        const float4 r = sm[k];
        float dx = qx - r.x;
        float dy = qy - r.y;
        if (WRAP) {
          dx = dx - n_f * rintf(dx * inv_n);
          dy = dy - n_f * rintf(dy * inv_n);
        }
        const float dxy = dx * dx + dy * dy;
        if (dxy >= bmax) continue;  // no cell can take it
        const int pos = __float_as_int(r.w);
#pragma unroll
        for (int j = 0; j < kCPT; ++j) {
          float dz = qz[j] - r.z;
          if (WRAP) dz = dz - n_f * rintf(dz * inv_n);
          const float d2 = dxy + dz * dz;
          const bool take = d2 < bd[j];
          bd[j] = take ? d2 : bd[j];
          bk[j] = take ? pos : bk[j];
        }
      }
    }
    __syncthreads();  // the chunk is consumed
  }

#pragma unroll
  for (int j = 0; j < kCPT; ++j) out[NPAY * n3 + line + z0 + kZT * j] = bd[j];
  // the payload a channel at a time: a thread's kCPT loads in flight
#pragma unroll 1
  for (int c = 0; c < NPAY; ++c) {
    float v[kCPT];
#pragma unroll
    for (int j = 0; j < kCPT; ++j) {
      v[j] = bk[j] >= 0 ? rows[(3 + c) * n_rows + bk[j]]
                        : state[c * n3 + line + z0 + kZT * j];
    }
#pragma unroll
    for (int j = 0; j < kCPT; ++j) out[c * n3 + line + z0 + kZT * j] = v[j];
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
