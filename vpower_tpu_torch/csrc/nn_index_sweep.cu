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
// running best, which starts from the cell's own pass-input state.  A
// candidate with a negative index scores 3e38.  Candidates are read from
// the pass input only (Jacobi).  Outputs: the best index, position and
// squared distance (3e38 where none).  Neighbour indices wrap around the
// grid also when periodic == 0: only the metric changes.
//
// What bounds it on the H100: instruction rate.  A cell scores 52 (state
// only) to 52 + 54 k candidates of ~20 instructions each (4 shared
// loads, 8 FP32 operations, the validity test, compares and selects; a
// seed candidate also settles ties), and the build has no fused
// multiply-add, so a 512^3 pass with k = 2 issues ~4e11 instructions:
// ~15 ms at 132 SMs x 128 lanes x ~1.75 GHz.  The bytes are few beside
// that: (1 + k) * 16 in and 20 out per cell, 9.1 GB or 2.7 ms at
// 3.35 TB/s for that pass.  A first design, one thread per cell reading
// every neighbour from global memory with three % wraps and a 64-bit
// address per neighbour and three IEEE divides per candidate, waited on
// L1/L2 load latency instead: ~0.9 KB of neighbour reads a cell,
// 101 ms for the seeded 512^3 pass and 45 ms state-only.
//
// Design (K2's): one block of 256 threads per 4 x 8 x 32 tile of cells
// (z fastest: a warp is one z row, each thread 4 cells along x).  Each
// field (the state, then each seed rank) is staged in turn into shared
// memory with a 2-cell halo, four planes: x, y, z and the index as raw
// bytes, with the periodic index wrap computed once per block for each
// staged plane, row and column, by cp.async copies that are all in
// flight before the thread waits once.  The candidate loop then reads
// shared memory at compile-time offsets: no %, no 64-bit arithmetic.  A
// cell carries only its best distance and the winner's place in the
// candidate order; the winner's index and position are gathered once, at
// the end, from the pass input, which a Jacobi pass never changes.
// Fields scanned later (the seeds) meet candidates of earlier order
// positions (the state's later offsets come after the seeds' earlier
// ones), so they take a candidate also on an equal distance with an
// earlier position: the result is the first candidate in the global order
// at the minimum distance, the one the strict in-order scan keeps.  Two
// particles at one position have different indices, so the index shows
// the order even where position and distance cannot.
//
// Float semantics match the JAX kernel bit for bit: cell centres are
// ((float)i + 0.5f) * cell, the minimum image is d - box * rintf(d / box)
// (round half to even, like jnp.round; IEEE division), and
// dx*dx + dy*dy + dz*dz is summed left to right with no FMA contraction
// (built with -fmad=false).  The shortcuts are exact.  When |d| <= box/2,
// d / box rounds into [-0.5, 0.5] and rintf gives 0, so d is its own
// minimum image (only the sign of a zero can differ, and it is squared
// away).  A block whose valid staged candidates all lie that near every
// centre of its tile on each axis (checked while staging) takes no
// minimum image at all; that is every block away from the box faces.  At
// the faces only the candidates with a far |d| divide.
#include <cuda_runtime.h>

namespace {

constexpr float kBig = 3.0e38f;
constexpr int kThreads = 256;
constexpr int kTX = 4, kTY = 8, kTZ = 32;  // output tile; kTY warps, kTZ lanes
constexpr int kHalo = 2;                   // the stride-2 offsets
constexpr int kSX = kTX + 2 * kHalo, kSY = kTY + 2 * kHalo;
constexpr int kSZ = kTZ + 2 * kHalo, kSYZ = kSY * kSZ;
constexpr int kSCells = kSX * kSYZ;  // staged cells per field
constexpr int kPlanes = 4;           // staged planes: x, y, z, index
constexpr int kSmemBytes = kPlanes * kSCells * (int)sizeof(float);
static_assert(kSX + kSY + kSZ <= kThreads, "one thread per wrapped index");
static_assert(kTY * 32 == kThreads && kTZ == 32, "a warp is one z row");

__device__ __forceinline__ int wrap(int i, int n) { return ((i % n) + n) % n; }

// 4-byte global -> shared copy that does not hold a register or wait:
// a thread starts all its staging copies, then waits once
__device__ __forceinline__ void copy_async(float* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// the staged index plane holds the int32 bits
__device__ __forceinline__ bool valid(const float* __restrict__ sm, int j) {
  return __float_as_int(sm[3 * kSCells + j]) >= 0;
}

// The squared minimum-image distance.  Out of line: the candidate loop
// unrolls 36 distances, and three inlined IEEE divides in each would make
// the loop too large for the instruction cache, though few candidates
// divide.
__device__ __noinline__ float image_dist2(float dx, float dy, float dz,
                                          float box) {
  dx = dx - box * rintf(dx / box);
  dy = dy - box * rintf(dy / box);
  dz = dz - box * rintf(dz / box);
  return dx * dx + dy * dy + dz * dz;
}

// kWrap: take the minimum image of the candidates with a far |d| (off:
// the open box, or a block where no |d| can exceed box / 2)
template <bool kWrap>
__device__ __forceinline__ float dist2(float fx, float fy, float fz, float px,
                                       float py, float pz, float box,
                                       float half) {
  const float dx = fx - px, dy = fy - py, dz = fz - pz;
  if (kWrap &&
      !(fabsf(dx) <= half && fabsf(dy) <= half && fabsf(dz) <= half)) {
    return image_dist2(dx, dy, dz, box);
  }
  return dx * dx + dy * dy + dz * dz;
}

// Offers one staged field to the thread's kTX cells (x neighbours, one
// staged plane apart) in candidate order.  A winner is recorded as
// (order << 16) + f + 1, order = stride index * 27 + offset index, which
// sorts as the candidate order.  kState: the state field (no centre
// candidate, and it is scanned first, so strict < alone keeps the first
// minimum); otherwise seed rank f, whose candidates also win an equal
// distance held by a later order position.
template <bool kWrap, bool kState>
__device__ __forceinline__ void scan(const float* __restrict__ sm, int f,
                                     int base, const float (&fx)[kTX],
                                     float fy, float fz, float (&bd)[kTX],
                                     int (&bp)[kTX], float box, float half) {
#pragma unroll 1
  for (int si = 0; si < 2; ++si) {
    const int s = 2 - si;
#pragma unroll 1
    for (int ox = -1; ox <= 1; ++ox) {
#pragma unroll
      for (int oy = -1; oy <= 1; ++oy) {
#pragma unroll
        for (int oz = -1; oz <= 1; ++oz) {
          if (kState && ox == 0 && oy == 0 && oz == 0) continue;
          const int off = (ox + 1) * 9 + (oy + 1) * 3 + (oz + 1);
          const int pos = ((si * 27 + off) << 16) + f + 1;
          const int so = (ox * kSYZ + oy * kSZ + oz) * s;
#pragma unroll
          for (int i = 0; i < kTX; ++i) {
            const int j = base + i * kSYZ + so;
            float cd = dist2<kWrap>(fx[i], fy, fz, sm[j], sm[kSCells + j],
                                    sm[2 * kSCells + j], box, half);
            if (!valid(sm, j)) cd = kBig;
            if (cd < bd[i] || (!kState && cd == bd[i] && pos < bp[i])) {
              bd[i] = cd;
              bp[i] = pos;
            }
          }
        }
      }
    }
  }
}

template <bool kState>
__device__ __forceinline__ void scan_field(bool min_image, const float* sm,
                                           int f, int base,
                                           const float (&fx)[kTX], float fy,
                                           float fz, float (&bd)[kTX],
                                           int (&bp)[kTX], float box,
                                           float half) {
  if (min_image)
    scan<true, kState>(sm, f, base, fx, fy, fz, bd, bp, box, half);
  else
    scan<false, kState>(sm, f, base, fx, fy, fz, bd, bp, box, half);
}

template <bool kPeriodic>
__global__ void __launch_bounds__(kThreads, 4)
nn_index_sweep_kernel(const int* __restrict__ state_idx,
                      const float* __restrict__ state_pos,
                      const int* __restrict__ seed_idx,
                      const float* __restrict__ seed_pos,
                      int* __restrict__ out_idx, float* __restrict__ out_pos,
                      float* __restrict__ out_d2, int n, int k, float box,
                      float cell) {
  // x, y, z and index planes of the staged field, (kSX, kSY, kSZ) each
  extern __shared__ float sm[];
  // wrapped grid index of each staged x plane, y row and z column
  __shared__ int gx[kSX], gy[kSY], gz[kSZ];
  const long long n3 = (long long)n * n * n;
  const int ntz = (n + kTZ - 1) / kTZ, nty = (n + kTY - 1) / kTY;
  const int b = blockIdx.x;
  const int z0 = (b % ntz) * kTZ;
  const int y0 = (b / ntz % nty) * kTY;
  const int x0 = b / (ntz * nty) * kTX;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int y = y0 + warp, z = z0 + lane;
  const float half = 0.5f * box;
  const float fy = ((float)y + 0.5f) * cell;
  const float fz = ((float)z + 0.5f) * cell;
  // the tile's centres lie in [lo, hi] on each axis (cells past n too)
  const float lo[3] = {((float)x0 + 0.5f) * cell, ((float)y0 + 0.5f) * cell,
                       ((float)z0 + 0.5f) * cell};
  const float hi[3] = {((float)(x0 + kTX - 1) + 0.5f) * cell,
                       ((float)(y0 + kTY - 1) + 0.5f) * cell,
                       ((float)(z0 + kTZ - 1) + 0.5f) * cell};
  // staged index of the thread's cell 0, at (kHalo, warp + kHalo, lane + kHalo)
  const int base = (kHalo * kSY + warp + kHalo) * kSZ + lane + kHalo;
  float fx[kTX], bd[kTX];
  int bp[kTX];  // winner's position in the candidate order; -1: own cell
  {
    const int t = threadIdx.x;
    if (t < kSX) {
      gx[t] = wrap(x0 - kHalo + t, n);
    } else if (t < kSX + kSY) {
      gy[t - kSX] = wrap(y0 - kHalo + t - kSX, n);
    } else if (t < kSX + kSY + kSZ) {
      gz[t - kSX - kSY] = wrap(z0 - kHalo + t - kSX - kSY, n);
    }
    __syncthreads();
  }

  for (int f = -1; f < k; ++f) {
    // rank f's position is channels 3f .. 3f + 2 of seed_pos
    const float* pos = f < 0 ? state_pos : seed_pos + 3LL * f * n3;
    const int* idx = f < 0 ? state_idx : seed_idx + (long long)f * n3;
    if (f >= 0) __syncthreads();  // every read of the last field is done
    for (int j = threadIdx.x; j < kSCells; j += kThreads) {
      const int sx = j / kSYZ, sy = j / kSZ % kSY, sz = j % kSZ;
      const long long g = ((long long)gx[sx] * n + gy[sy]) * n + gz[sz];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        copy_async(sm + c * kSCells + j, pos + c * n3 + g);
      }
      copy_async(sm + 3 * kSCells + j, idx + g);
    }
    copy_wait();
    // near: every valid staged candidate is within box / 2 of every
    // centre of the tile on each axis, rounding included (fl(hi - p) and
    // fl(p - lo) bound every fl(c - p) and fl(p - c)), so no candidate
    // needs a minimum image.  Each thread tests the cells it copied.
    int near = 1;
    if (kPeriodic) {
      for (int j = threadIdx.x; j < kSCells; j += kThreads) {
        bool ok = true;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float p = sm[c * kSCells + j];
          ok = ok && hi[c] - p <= half && p - lo[c] <= half;
        }
        // an invalid candidate scores kBig whatever its distance
        near = near && (ok || !valid(sm, j));
      }
    }
    near = __syncthreads_and(near);  // the barrier of the staging too
    const bool min_image = kPeriodic && !near;
    if (f < 0) {
#pragma unroll
      for (int i = 0; i < kTX; ++i) {
        const int j = base + i * kSYZ;
        fx[i] = ((float)(x0 + i) + 0.5f) * cell;
        bd[i] = dist2<kPeriodic>(fx[i], fy, fz, sm[j], sm[kSCells + j],
                                 sm[2 * kSCells + j], box, half);
        if (!valid(sm, j)) bd[i] = kBig;
        bp[i] = -1;
      }
      scan_field<true>(min_image, sm, f, base, fx, fy, fz, bd, bp, box, half);
    } else {
      scan_field<false>(min_image, sm, f, base, fx, fy, fz, bd, bp, box, half);
    }
  }

  if (y >= n || z >= n) return;
  // the winners' index and position from the pass input, the loads of all
  // the thread's cells in flight together
  long long own[kTX];
  int wi[kTX];
  float wp[kTX][3];
#pragma unroll
  for (int i = 0; i < kTX; ++i) {
    const int x = x0 + i < n ? x0 + i : n - 1;  // past n: not written
    own[i] = ((long long)x * n + y) * n + z;
    const int* ip = state_idx;
    const float* pp = state_pos;
    long long nb = own[i];
    if (bp[i] >= 0) {  // decode the winner: field, stride and offset
      const int fi = (bp[i] & 0xffff) - 1, order = bp[i] >> 16;
      const int s = order < 27 ? 2 : 1, off = order % 27;
      nb = ((long long)wrap(x + (off / 9 - 1) * s, n) * n +
            wrap(y + (off / 3 % 3 - 1) * s, n)) * n +
           wrap(z + (off % 3 - 1) * s, n);
      if (fi >= 0) {
        ip = seed_idx + (long long)fi * n3;
        pp = seed_pos + 3LL * fi * n3;
      }
    }
    wi[i] = ip[nb];
#pragma unroll
    for (int c = 0; c < 3; ++c) wp[i][c] = pp[c * n3 + nb];
  }
#pragma unroll
  for (int i = 0; i < kTX; ++i) {
    if (x0 + i >= n) continue;
    out_idx[own[i]] = wi[i];
#pragma unroll
    for (int c = 0; c < 3; ++c) out_pos[c * n3 + own[i]] = wp[i][c];
    out_d2[own[i]] = bd[i];
  }
}

template <bool kPeriodic>
int launch(const int* state_idx, const float* state_pos, const int* seed_idx,
           const float* seed_pos, int* out_idx, float* out_pos, float* out_d2,
           int n, int k, float box, float cell, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      nn_index_sweep_kernel<kPeriodic>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)((n + kTX - 1) / kTX) *
                           ((n + kTY - 1) / kTY) * ((n + kTZ - 1) / kTZ);
  nn_index_sweep_kernel<kPeriodic>
      <<<(unsigned int)blocks, kThreads, kSmemBytes, stream>>>(
          state_idx, state_pos, seed_idx, seed_pos, out_idx, out_pos, out_d2,
          n, k, box, cell);
  return (int)cudaGetLastError();
}

}  // namespace

// state_idx (n, n, n) i32; state_pos (3, n, n, n) f32; seed_idx
// (k, n, n, n) i32 and seed_pos (3k, n, n, n) f32, or null with k = 0;
// out_idx (n, n, n) i32, out_pos (3, n, n, n) f32, out_d2 (n, n, n) f32,
// none aliasing an input.  k < 65535: a winner's seed rank is carried in
// 16 bits.  Launches one pass on `stream` and returns the cudaError_t of
// the launch (0 = success).
extern "C" int nn_index_sweep(const int* state_idx, const float* state_pos,
                              const int* seed_idx, const float* seed_pos,
                              int* out_idx, float* out_pos, float* out_d2,
                              int n, int k, int periodic, float box,
                              float cell, void* stream) {
  if (n <= 0 || k < 0 || k >= 0xffff ||
      (k > 0 && (seed_idx == nullptr || seed_pos == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  return periodic ? launch<true>(state_idx, state_pos, seed_idx, seed_pos,
                                 out_idx, out_pos, out_d2, n, k, box, cell, st)
                  : launch<false>(state_idx, state_pos, seed_idx, seed_pos,
                                  out_idx, out_pos, out_d2, n, k, box, cell,
                                  st);
}
