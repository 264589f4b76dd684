// Value-carry nearest-neighbour repair sweep (K2): one Jacobi pass.
//
// Replaces the Pallas TPU kernel
// vpower_tpu/deposit/nn_pallas.py:_sweep_vals_kernel (driven by
// sweep_tiles_vals).  The state is a channels-first (C, n, n, n) f32
// field [x, y, z, payload..., occ?] naming, per cell, the best
// candidate particle found so far.  For every cell centre the pass
// offers, in this order,
//   for s in (2, 1): for dx, dy, dz in {-1, 0, 1}^3:
//     at (0, 0, 0): the k seed fields;
//     elsewhere:    the state field, then the k seed fields,
// each read at cell (x + dx*s, y + dy*s, z + dz*s) mod n, and takes a
// candidate only when its squared distance is strictly smaller than the
// running best, which starts from the cell's own pass-input state.
// Candidates are always read from the pass input, never from this
// pass's output (Jacobi): several passes are several launches.
//
// What bounds it on the H100: bytes.  A cell reads 26 state and 27 * k
// seed neighbours of C floats each (27 * (1 + k) * C loads, ~1.1 KB at
// k = 2, C = 7), so a pass over a 256^3 seeded level touches ~18 GB of
// loads; most hit L1/L2, because neighbouring cells share neighbours,
// and DRAM sees ~(1 + k) * C * 4 bytes in and C * 4 out per cell.
//
// Design: one thread per output cell, consecutive threads along z, so
// each neighbour read of a warp is one contiguous run of a channel
// plane (coalesced).  Neighbours come straight from global memory with
// a periodic index wrap: there is no padded copy (the TPU's wrap_pad
// halo exists for DMA alignment).  Indices wrap even when periodic == 0;
// only the distance metric changes, exactly as the TPU kernel's
// mode="wrap" halo did.
//
// Float semantics match the JAX kernel bit for bit: cell centres are
// ((float)i + 0.5f) * cell, the minimum image is d - box * rintf(d / box)
// (round half to even, like jnp.round; IEEE division), and
// dx*dx + dy*dy + dz*dz is summed left to right with no FMA contraction
// (built with -fmad=false).
#include <cuda_runtime.h>

namespace {

constexpr int kMaxChan = 16;
constexpr float kBig = 3.0e38f;

__device__ __forceinline__ float min_image(float d, float box, int periodic) {
  return periodic ? d - box * rintf(d / box) : d;
}

__global__ void nn_sweep_vals_kernel(const float* __restrict__ state,
                                     const float* __restrict__ seeds,
                                     float* __restrict__ out, int n,
                                     int n_ch, int k, int has_occ,
                                     int payload_out, int periodic,
                                     float box, float cell) {
  const long long n3 = (long long)n * n * n;
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n3) return;
  const int z = (int)(idx % n);
  const int y = (int)((idx / n) % n);
  const int x = (int)(idx / ((long long)n * n));
  const float fx = ((float)x + 0.5f) * cell;
  const float fy = ((float)y + 0.5f) * cell;
  const float fz = ((float)z + 0.5f) * cell;

  float best[kMaxChan];
#pragma unroll
  for (int c = 0; c < kMaxChan; ++c) {
    if (c < n_ch) best[c] = state[c * n3 + idx];
  }
  float best_d;
  {
    float dx = min_image(fx - best[0], box, periodic);
    float dy = min_image(fy - best[1], box, periodic);
    float dz = min_image(fz - best[2], box, periodic);
    best_d = dx * dx + dy * dy + dz * dz;
    // occ read from memory: a runtime index into best[] would put the
    // array in local memory
    if (has_occ && !(state[(n_ch - 1) * n3 + idx] > 0.5f)) best_d = kBig;
  }

  for (int si = 0; si < 2; ++si) {
    const int s = si == 0 ? 2 : 1;
    for (int ox = -1; ox <= 1; ++ox) {
      int xn = (x + ox * s) % n;
      if (xn < 0) xn += n;
      for (int oy = -1; oy <= 1; ++oy) {
        int yn = (y + oy * s) % n;
        if (yn < 0) yn += n;
        for (int oz = -1; oz <= 1; ++oz) {
          int zn = (z + oz * s) % n;
          if (zn < 0) zn += n;
          const long long nb = ((long long)xn * n + yn) * n + zn;
          const bool centre = ox == 0 && oy == 0 && oz == 0;
          // f == -1: the state field; f >= 0: seed rank f
          for (int f = centre ? 0 : -1; f < k; ++f) {
            const float* src = f < 0 ? state : seeds + (long long)f * n_ch * n3;
            const float px = src[nb];
            const float py = src[n3 + nb];
            const float pz = src[2 * n3 + nb];
            float dx = min_image(fx - px, box, periodic);
            float dy = min_image(fy - py, box, periodic);
            float dz = min_image(fz - pz, box, periodic);
            float cd = dx * dx + dy * dy + dz * dz;
            if (has_occ && !(src[(n_ch - 1) * n3 + nb] > 0.5f)) cd = kBig;
            if (cd < best_d) {
              best_d = cd;
              best[0] = px;
              best[1] = py;
              best[2] = pz;
#pragma unroll
              for (int c = 3; c < kMaxChan; ++c) {
                if (c < n_ch) best[c] = src[c * n3 + nb];
              }
            }
          }
        }
      }
    }
  }

  if (payload_out) {
    const int n_pay = n_ch - 3 - (has_occ ? 1 : 0);
#pragma unroll
    for (int c = 3; c < kMaxChan; ++c) {
      if (c < 3 + n_pay) out[(c - 3) * n3 + idx] = best[c];
    }
  } else {
#pragma unroll
    for (int c = 0; c < kMaxChan; ++c) {
      if (c < n_ch) out[c * n3 + idx] = best[c];
    }
  }
}

}  // namespace

// state (n_ch, n, n, n) f32; seeds (k * n_ch, n, n, n) f32 or null
// (k = 0); out (n_ch, n, n, n) f32, or (n_ch - 3 - has_occ, n, n, n)
// when payload_out.  out must not alias state or seeds.  Requires
// 3 + has_occ <= n_ch <= 16.  Launches one pass on `stream` and returns
// the cudaError_t of the launch (0 = success).
extern "C" int nn_sweep_vals(const float* state, const float* seeds,
                             float* out, int n, int n_ch, int k, int has_occ,
                             int payload_out, int periodic, float box,
                             float cell, void* stream) {
  if (n_ch < 3 + (has_occ ? 1 : 0) || n_ch > kMaxChan) {
    return (int)cudaErrorInvalidValue;
  }
  const long long n3 = (long long)n * n * n;
  const int threads = 256;
  long long blocks = (n3 + threads - 1) / threads;
  nn_sweep_vals_kernel<<<(unsigned int)blocks, threads, 0,
                         (cudaStream_t)stream>>>(
      state, seeds, out, n, n_ch, k, has_occ, payload_out, periodic, box,
      cell);
  return (int)cudaGetLastError();
}
