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
// What bounds it on the H100: bytes, ~C * 4 in and C * 4 out per cell
// (~1.9 ms for a 512^3 C = 6 pass at 3.35 TB/s), and instruction rate:
// a cell scores 52 (state only) to 52 + 54 k candidates of ~15
// instructions each (3 shared loads, 8 FP32 operations, a compare, two
// selects), ~3.5 ms of instructions for a 512^3 pass.  A first design, one
// thread per cell reading every neighbour from global memory with a %
// wrap per neighbour, 64-bit addresses and all C channels of each winner
// held in 78 registers, waited on load latency: ~60 ms per 512^3 pass.
//
// Design: one block of 256 threads per 4 x 8 x 32 tile of cells (z
// fastest: a warp is one z row).  Each field (the state, then each seed
// field) is staged in turn into shared memory with a 2-cell halo:
// only the channels the comparison reads (x, y, z, and occ with
// has_occ), with the periodic index wrap computed once per block for
// each staged plane, row and column, by cp.async copies that are all in
// flight before the thread waits once.  The candidate loop then reads
// shared memory at compile-time offsets: no %, no 64-bit arithmetic.  A
// cell carries only its best distance and the winner's position in the
// candidate order; the winner's channels are gathered once, at the end,
// from the pass input (one channel of the thread's cells at a time, so
// their loads overlap), which a Jacobi pass never changes, so they are
// the channels the old per-candidate copy took.  Fields scanned later
// (the seeds) meet candidates of earlier order positions (the state's
// later offsets come after the seeds' earlier ones), so they take a
// candidate also on an equal distance with an earlier position: the
// result is the first candidate in the global order at the minimum
// distance, the one the strict in-order scan keeps.
//
// Float semantics match the JAX kernel bit for bit: cell centres are
// ((float)i + 0.5f) * cell, the minimum image is d - box * rintf(d / box)
// (round half to even, like jnp.round; IEEE division), and
// dx*dx + dy*dy + dz*dz is summed left to right with no FMA contraction
// (built with -fmad=false).  The shortcuts are exact.  When |d| <= box/2,
// d / box rounds into [-0.5, 0.5] and rintf gives 0, so d is its own
// minimum image (only the sign of a zero can differ, and it is squared
// away).  A block whose staged candidates all lie that near every centre
// of its tile on each axis (checked while staging) takes no minimum
// image at all; that is every block away from the box faces.  At the
// faces only the candidates with a far |d| divide.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxChan = 16;
constexpr float kBig = 3.0e38f;
constexpr int kThreads = 256;
constexpr int kTX = 4, kTY = 8, kTZ = 32;  // output tile; kTY warps, kTZ lanes
constexpr int kHalo = 2;                   // the stride-2 offsets
constexpr int kSX = kTX + 2 * kHalo, kSY = kTY + 2 * kHalo;
constexpr int kSZ = kTZ + 2 * kHalo, kSYZ = kSY * kSZ;
constexpr int kSCells = kSX * kSYZ;  // staged cells per field
static_assert(kSX + kSY + kSZ <= kThreads, "one thread per wrapped index");

__device__ __forceinline__ int wrap(int i, int n) { return ((i % n) + n) % n; }

// 4-byte global -> shared copy that does not hold a register or wait:
// a thread starts all its staging copies, then waits once
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The squared minimum-image distance.  Out of line: the candidate loop
// unrolls 36 distances, and three inlined IEEE divides in each made the
// loop too large for the instruction cache, though few candidates divide.
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
// minimum); otherwise seed field f, whose candidates also win an equal
// distance held by a later order position.
template <bool kWrap, bool kOcc, bool kState>
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
            if (kOcc && !(sm[3 * kSCells + j] > 0.5f)) cd = kBig;
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

template <bool kOcc, bool kState>
__device__ __forceinline__ void scan_field(bool min_image, const float* sm,
                                           int f, int base,
                                           const float (&fx)[kTX], float fy,
                                           float fz, float (&bd)[kTX],
                                           int (&bp)[kTX], float box,
                                           float half) {
  if (min_image)
    scan<true, kOcc, kState>(sm, f, base, fx, fy, fz, bd, bp, box, half);
  else
    scan<false, kOcc, kState>(sm, f, base, fx, fy, fz, bd, bp, box, half);
}

template <bool kPeriodic, bool kOcc>
__global__ void __launch_bounds__(kThreads, 4)
nn_sweep_vals_kernel(const float* __restrict__ state,
                     const float* __restrict__ seeds, float* __restrict__ out,
                     int n, int n_ch, int k, int payload_out, int d2_out,
                     float box, float cell) {
  // x, y, z (, occ) planes of the staged field, (kSX, kSY, kSZ) each
  extern __shared__ float sm[];
  // wrapped grid index of each staged x plane, y row and z column
  __shared__ int gx[kSX], gy[kSY], gz[kSZ];
  constexpr int kNst = kOcc ? 4 : 3;
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
    const float* src = f < 0 ? state : seeds + (long long)f * n_ch * n3;
    if (f >= 0) __syncthreads();  // every read of the last field is done
    for (int j = threadIdx.x; j < kSCells; j += kThreads) {
      const int sx = j / kSYZ, sy = j / kSZ % kSY, sz = j % kSZ;
      const long long g = ((long long)gx[sx] * n + gy[sy]) * n + gz[sz];
#pragma unroll
      for (int c = 0; c < kNst; ++c) {
        const long long ch = c < 3 ? c : n_ch - 1;
        copy_async(sm + c * kSCells + j, src + ch * n3 + g);
      }
    }
    copy_wait();
    // near: every valid staged candidate is within box / 2 of every
    // centre of the tile on each axis, rounding included (fl(hi - p) and
    // fl(p - lo) bound every fl(c - p) and fl(p - c)), so no candidate
    // needs a minimum image
    int near = 1;
    for (int j = threadIdx.x; j < kSCells; j += kThreads) {
      bool ok = true;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float p = sm[c * kSCells + j];
        ok = ok && hi[c] - p <= half && p - lo[c] <= half;
      }
      // an invalid candidate scores kBig whatever its distance
      if (kOcc) ok = ok || !(sm[3 * kSCells + j] > 0.5f);
      near = near && ok;
    }
    near = __syncthreads_and(near);
    const bool min_image = kPeriodic && !near;
    if (f < 0) {
#pragma unroll
      for (int i = 0; i < kTX; ++i) {
        const int j = base + i * kSYZ;
        fx[i] = ((float)(x0 + i) + 0.5f) * cell;
        bd[i] = dist2<kPeriodic>(fx[i], fy, fz, sm[j], sm[kSCells + j],
                                 sm[2 * kSCells + j], box, half);
        if (kOcc && !(sm[3 * kSCells + j] > 0.5f)) bd[i] = kBig;
        bp[i] = -1;
      }
      scan_field<kOcc, true>(min_image, sm, f, base, fx, fy, fz, bd, bp, box,
                             half);
    } else {
      scan_field<kOcc, false>(min_image, sm, f, base, fx, fy, fz, bd, bp, box,
                              half);
    }
  }

  if (y >= n || z >= n) return;
  // the winners' channels from the pass input, one channel of all the
  // thread's cells at a time, so their loads are in flight together
  const float* src[kTX];
  long long idx[kTX], nb[kTX];
#pragma unroll
  for (int i = 0; i < kTX; ++i) {
    const int x = x0 + i < n ? x0 + i : n - 1;  // past n: not written
    idx[i] = ((long long)x * n + y) * n + z;
    src[i] = state;
    nb[i] = idx[i];
    if (bp[i] >= 0) {  // decode the winner: field, stride and offset
      const int fi = (bp[i] & 0xffff) - 1, order = bp[i] >> 16;
      const int s = order < 27 ? 2 : 1, off = order % 27;
      nb[i] = ((long long)wrap(x + (off / 9 - 1) * s, n) * n +
               wrap(y + (off / 3 % 3 - 1) * s, n)) * n +
              wrap(z + (off % 3 - 1) * s, n);
      if (fi >= 0) src[i] = seeds + (long long)fi * n_ch * n3;
    }
  }
  const int n_pay = n_ch - 3 - (kOcc ? 1 : 0);
  const int c0 = payload_out ? 3 : 0, c1 = payload_out ? 3 + n_pay : n_ch;
  for (int c = c0; c < c1; ++c) {
    float v[kTX];
#pragma unroll
    for (int i = 0; i < kTX; ++i) v[i] = src[i][c * n3 + nb[i]];
#pragma unroll
    for (int i = 0; i < kTX; ++i) {
      if (x0 + i < n) out[(c - c0) * n3 + idx[i]] = v[i];
    }
  }
  if (d2_out) {
#pragma unroll
    for (int i = 0; i < kTX; ++i) {
      if (x0 + i < n) out[n_pay * n3 + idx[i]] = bd[i];
    }
  }
}

template <bool kPeriodic, bool kOcc>
int launch(const float* state, const float* seeds, float* out, int n,
           int n_ch, int k, int payload_out, int d2_out, float box, float cell,
           cudaStream_t stream) {
  const int smem = (kOcc ? 4 : 3) * kSCells * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      nn_sweep_vals_kernel<kPeriodic, kOcc>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)((n + kTX - 1) / kTX) *
                           ((n + kTY - 1) / kTY) * ((n + kTZ - 1) / kTZ);
  nn_sweep_vals_kernel<kPeriodic, kOcc>
      <<<(unsigned int)blocks, kThreads, smem, stream>>>(
          state, seeds, out, n, n_ch, k, payload_out, d2_out, box, cell);
  return (int)cudaGetLastError();
}

}  // namespace

// state (n_ch, n, n, n) f32; seeds (k * n_ch, n, n, n) f32 or null
// (k = 0); out (n_ch, n, n, n) f32, or (n_ch - 3 - has_occ + d2_out,
// n, n, n) when payload_out: the payload channels, then with d2_out the
// best squared distance (the exact path's seed bound; it runs this
// with no payload channel, C = 3).  out must not alias state or seeds.
// Requires 3 + has_occ <= n_ch <= 16.  Launches one pass on `stream`
// and returns the cudaError_t of the launch (0 = success).
extern "C" int nn_sweep_vals(const float* state, const float* seeds,
                             float* out, int n, int n_ch, int k, int has_occ,
                             int payload_out, int d2_out, int periodic,
                             float box, float cell, void* stream) {
  if (n_ch < 3 + (has_occ ? 1 : 0) || n_ch > kMaxChan ||
      (d2_out && !payload_out) || n < 1 || k < 0 || k >= 0xffff) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  if (periodic) {
    return has_occ ? launch<true, true>(state, seeds, out, n, n_ch, k,
                                        payload_out, d2_out, box, cell, st)
                   : launch<true, false>(state, seeds, out, n, n_ch, k,
                                         payload_out, d2_out, box, cell, st);
  }
  return has_occ ? launch<false, true>(state, seeds, out, n, n_ch, k,
                                       payload_out, d2_out, box, cell, st)
                 : launch<false, false>(state, seeds, out, n, n_ch, k,
                                        payload_out, d2_out, box, cell, st);
}
