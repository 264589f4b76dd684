// Index-carry nearest-neighbour repair sweep (K3): one Jacobi pass.
//
// Replaces the Pallas TPU kernel
// vpower_tpu/deposit/nn_pallas.py:_sweep_kernel (driven by sweep_tiles).
// The index twin of csrc/nn_sweep.cu (K2): the state names, per cell,
// the best candidate particle found so far by its int32 index (-1 = no
// candidate) and its position, channels-first (3, n, n, n) f32.  For
// every cell centre the pass offers, in this order,
//   for s in (2, 1): for dx, dy, dz in {-1, 0, 1}^3:
//     at (0, 0, 0): the k seed fields;
//     elsewhere:    the state field, then the k seed fields,
// each read at cell (x + dx*s, y + dy*s, z + dz*s) mod n, and takes a
// candidate only when its squared distance is strictly smaller than the
// running best, which starts from the cell's own pass-input state.
// Candidates are read from the pass input only (Jacobi).  Outputs: the
// best index, position and squared distance (3e38 where none).
//
// What bounds it on the H100: as K2, the neighbour reads.  A cell reads
// 26 state and 27 * k seed neighbours of 4 words each (~0.9 KB at
// k = 2), almost all from L1/L2 because neighbouring cells share
// neighbours; DRAM sees (1 + k) * 16 bytes in and 20 out per cell, so a
// 512^3 pass moves >= 2.4 GB (seeded) or 1.2 GB (state only) at the
// least, ~0.7 or ~0.4 ms at 3.35 TB/s.  Measured on an H100 80GB HBM3
// at a 700 W limit: 100.8 ms seeded and 44.4 ms state-only at 512^3, so
// the L1/L2 neighbour traffic, not DRAM, sets the pace.
//
// Design: one thread per output cell, consecutive threads along z
// (each neighbour read of a warp is one contiguous run of a plane);
// neighbours come straight from global memory with a periodic index
// wrap, also when periodic == 0 (only the metric changes, as the TPU
// kernel's mode="wrap" halo did).  The TPU's padded halos (wrap_pad)
// served its DMA alignment and are not carried over.
//
// Float semantics match the JAX kernel bit for bit: cell centres
// ((float)i + 0.5f) * cell, the minimum image d - box * rintf(d / box)
// (round half to even, IEEE division), dx*dx + dy*dy + dz*dz left to
// right with no FMA contraction (built with -fmad=false).
#include <cuda_runtime.h>

namespace {

constexpr float kBig = 3.0e38f;

__device__ __forceinline__ float min_image(float d, float box, int periodic) {
  return periodic ? d - box * rintf(d / box) : d;
}

__global__ void nn_index_sweep_kernel(
    const int* __restrict__ state_idx, const float* __restrict__ state_pos,
    const int* __restrict__ seed_idx, const float* __restrict__ seed_pos,
    int* __restrict__ out_idx, float* __restrict__ out_pos,
    float* __restrict__ out_d2, int n, int k, int periodic, float box,
    float cell) {
  const long long n3 = (long long)n * n * n;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n3) return;
  const int z = (int)(idx % n);
  const int y = (int)((idx / n) % n);
  const int x = (int)(idx / ((long long)n * n));
  const float fx = ((float)x + 0.5f) * cell;
  const float fy = ((float)y + 0.5f) * cell;
  const float fz = ((float)z + 0.5f) * cell;

  int bi = state_idx[idx];
  float bx = state_pos[idx];
  float by = state_pos[n3 + idx];
  float bz = state_pos[2 * n3 + idx];
  float bd;
  {
    const float dx = min_image(fx - bx, box, periodic);
    const float dy = min_image(fy - by, box, periodic);
    const float dz = min_image(fz - bz, box, periodic);
    bd = bi >= 0 ? dx * dx + dy * dy + dz * dz : kBig;
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
            const int ci = f < 0 ? state_idx[nb] : seed_idx[f * n3 + nb];
            const float* p = f < 0 ? state_pos : seed_pos + 3LL * f * n3;
            const float px = p[nb];
            const float py = p[n3 + nb];
            const float pz = p[2 * n3 + nb];
            const float dx = min_image(fx - px, box, periodic);
            const float dy = min_image(fy - py, box, periodic);
            const float dz = min_image(fz - pz, box, periodic);
            const float cd = ci >= 0 ? dx * dx + dy * dy + dz * dz : kBig;
            if (cd < bd) {
              bd = cd;
              bi = ci;
              bx = px;
              by = py;
              bz = pz;
            }
          }
        }
      }
    }
  }

  out_idx[idx] = bi;
  out_pos[idx] = bx;
  out_pos[n3 + idx] = by;
  out_pos[2 * n3 + idx] = bz;
  out_d2[idx] = bd;
}

}  // namespace

// state_idx (n, n, n) i32; state_pos (3, n, n, n) f32; seed_idx
// (k, n, n, n) i32 and seed_pos (3k, n, n, n) f32, or null with k = 0;
// out_idx (n, n, n) i32, out_pos (3, n, n, n) f32, out_d2 (n, n, n) f32,
// none aliasing an input.  Launches one pass on `stream` and returns the
// cudaError_t of the launch (0 = success).
extern "C" int nn_index_sweep(const int* state_idx, const float* state_pos,
                              const int* seed_idx, const float* seed_pos,
                              int* out_idx, float* out_pos, float* out_d2,
                              int n, int k, int periodic, float box,
                              float cell, void* stream) {
  if (n <= 0 || k < 0 || (k > 0 && (seed_idx == nullptr ||
                                    seed_pos == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const long long n3 = (long long)n * n * n;
  const int threads = 256;
  const long long blocks = (n3 + threads - 1) / threads;
  nn_index_sweep_kernel<<<(unsigned int)blocks, threads, 0,
                          (cudaStream_t)stream>>>(
      state_idx, state_pos, seed_idx, seed_pos, out_idx, out_pos, out_d2, n,
      k, periodic, box, cell);
  return (int)cudaGetLastError();
}
