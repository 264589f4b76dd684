// SPH weights (K6): each sorted row's kernel-weight sum over the offset
// cube (the normalization pass), and for one offset d every row's values
// times its normalized weight at d (the rows K1 deposits for d).
//
// Replaces no Pallas kernel.  The JAX package computes the SPH weights with
// elementwise jnp operations that it leaves to XLA, which fuses them
// (vpower_tpu/deposit/sph.py: _sph_deposit_mxu, offset_weight and
// norm_weight).  The port's torch version (deposit/sph.py: _axis_sq,
// _weight_sum, _offset_weight, kernel_weight) runs them as about 23 small
// kernels an offset in each of its two passes, each a round trip of an (N,)
// tensor through device memory, then one product pass an offset: 44% of a
// 512^3 SPH spectrum on the H100.
//
// What bounds it on the H100.  The normalization pass: FP32 instructions,
// (2 s_max + 1)^3 kernel evaluations a row (1.26 G for 10M rows at s_max 2).
// What the function needs is some 19 operations an evaluation: 18 once its
// axis terms are made (the sum, square root, division, spline, accumulate),
// plus a row's 3 (2 s_max + 1) axis terms of 9 and (2 s_max + 1)^2 (x, y)
// sums; the divisions and square roots are longer.  This kernel recomputes
// the z term in its innermost loop, 9 more an evaluation.  It reads 16 B a
// row and writes 4.  The rows of an offset: bytes.  A row reads
// its position, h and weight sum (20 B) and its C values, and writes C
// weighted values: (20 + 8 C) B a row, 0.52 GB at C = 4 and 10M rows,
// 0.16 ms at 3.35 TB/s.
//
// Design.  One thread a sorted row and no shared memory: a row's weights
// depend on that row alone.  The three per-axis squared distances to an
// offset's cell centre are worked out in registers where they are needed
// (a centre moves along one axis with that axis's offset only), so no
// per-axis tensor is made.  The normalization pass sums over the offsets in
// x, y, z order from 0.0f and writes the raw sum; the rows pass applies the
// degenerate rule (a sum <= 0 puts weight 1 at offset (0, 0, 0), 0
// elsewhere) and writes svals * w into one (N, C) buffer that the caller
// reuses for every offset.  Rows of 4 channels move as 16-byte vectors.
//
// Every operation is the torch version's own correctly rounded float32
// operation, in its order: IEEE division (__fdiv_rn) and square root
// (__fsqrt_rn), rintf for torch.round (half to even), fmaxf as torch's
// CUDA clamp, no FMA contraction (the build's -fmad=false), and the scalars
// cell and box size rounded to float32 once, as torch rounds them.  So the
// sums and rows equal the torch version's bit for bit.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSphere = 1;  // kernel ids: 0 the M4 cubic spline, 1 sphere

struct Geom {
  float cell;    // box size / n_grid
  float box;     // box size
  int periodic;  // minimum image on the axis distances
  int kernel;
};

// The unclipped base cell of a coordinate as a float, as torch forms it:
// floor(p / cell), through int32.
__device__ __forceinline__ float base_of(float p, const Geom& g) {
  return (float)(int)floorf(__fdiv_rn(p, g.cell));
}

// Squared distance along one axis to the centre ((base + d) + 0.5) * cell,
// minimum image when periodic (_axis_sq).
__device__ __forceinline__ float axis_sq(float p, float base, int d,
                                         const Geom& g) {
  float delta = p - ((base + (float)d) + 0.5f) * g.cell;
  if (g.periodic) delta = delta - g.box * rintf(__fdiv_rn(delta, g.box));
  return delta * delta;
}

// torch.clamp(v, min=0.0) on the card: NaN kept, else max(v, 0)
__device__ __forceinline__ float clamp0(float v) {
  return isnan(v) ? v : fmaxf(v, 0.0f);
}

// kernel_weight(sqrt(sq) / h) in its order of operations
__device__ __forceinline__ float kernel_w(float sq, float h, int kernel) {
  const float q = __fdiv_rn(__fsqrt_rn(sq), h);
  if (kernel == kSphere) return q < 1.0f ? 1.0f : 0.0f;
  const float q2 = q * q;
  const float inner = (1.0f - 6.0f * q2) + 6.0f * (q * q2);
  const float m = clamp0(1.0f - q);
  const float outer = 2.0f * (m * (m * m));
  return clamp0(q < 0.5f ? inner : outer);
}

__global__ void __launch_bounds__(kThreads)
    weight_sum_kernel(const float* __restrict__ spos,
                      const float* __restrict__ sh,
                      float* __restrict__ wsum, long long n_rows, int s_max,
                      Geom g) {
  const long long k = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (k >= n_rows) return;
  const float px = spos[3 * k], py = spos[3 * k + 1], pz = spos[3 * k + 2];
  const float bx = base_of(px, g), by = base_of(py, g), bz = base_of(pz, g);
  const float h = sh[k];
  float acc = 0.0f;
  for (int dx = -s_max; dx <= s_max; ++dx) {
    const float sx = axis_sq(px, bx, dx, g);
    for (int dy = -s_max; dy <= s_max; ++dy) {
      const float sxy = sx + axis_sq(py, by, dy, g);
      for (int dz = -s_max; dz <= s_max; ++dz)
        acc = acc + kernel_w(sxy + axis_sq(pz, bz, dz, g), h, g.kernel);
    }
  }
  wsum[k] = acc;
}

__global__ void __launch_bounds__(kThreads)
    offset_rows_kernel(const float* __restrict__ spos,
                       const float* __restrict__ sh,
                       const float* __restrict__ wsum,
                       const float* __restrict__ svals,
                       float* __restrict__ out, long long n_rows, int n_chan,
                       int dx, int dy, int dz, Geom g, int vec) {
  const long long k = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (k >= n_rows) return;
  const float px = spos[3 * k], py = spos[3 * k + 1], pz = spos[3 * k + 2];
  const float sq = (axis_sq(px, base_of(px, g), dx, g) +
                    axis_sq(py, base_of(py, g), dy, g)) +
                   axis_sq(pz, base_of(pz, g), dz, g);
  const float ws = wsum[k];
  float w;
  if (ws <= 0.0f)
    w = dx == 0 && dy == 0 && dz == 0 ? 1.0f : 0.0f;
  else
    w = __fdiv_rn(kernel_w(sq, sh[k], g.kernel), ws);
  if (vec) {
    float4 v = reinterpret_cast<const float4*>(svals)[k];
    v.x = v.x * w; v.y = v.y * w; v.z = v.z * w; v.w = v.w * w;
    reinterpret_cast<float4*>(out)[k] = v;
  } else {
    for (int c = 0; c < n_chan; ++c)
      out[k * n_chan + c] = svals[k * n_chan + c] * w;
  }
}

unsigned int blocks(long long n_rows) {
  return (unsigned int)((n_rows + kThreads - 1) / kThreads);
}

}  // namespace

// spos (n_rows, 3) f32 row-major, the sorted positions in [0, box); sh
// (n_rows,) f32 the clamped radii; wsum (n_rows,) f32 out: each row's sum
// of kernel weights over the offsets (-s_max..s_max)^3.  Launches on
// `stream` and returns the cudaError_t of the launch (0 = success).
extern "C" int sph_weight_sum(const float* spos, const float* sh, float* wsum,
                              long long n_rows, int s_max, float cell,
                              float box, int periodic, int kernel,
                              void* stream) {
  if (n_rows <= 0) return 0;
  weight_sum_kernel<<<blocks(n_rows), kThreads, 0, (cudaStream_t)stream>>>(
      spos, sh, wsum, n_rows, s_max, Geom{cell, box, periodic, kernel});
  return (int)cudaGetLastError();
}

// The same rows, wsum from sph_weight_sum, svals (n_rows, n_chan) f32
// row-major; out (n_rows, n_chan) f32: svals times each row's normalized
// weight at offset (dx, dy, dz).
extern "C" int sph_offset_rows(const float* spos, const float* sh,
                               const float* wsum, const float* svals,
                               float* out, long long n_rows, int n_chan,
                               int dx, int dy, int dz, float cell, float box,
                               int periodic, int kernel, void* stream) {
  if (n_rows <= 0 || n_chan <= 0) return 0;
  const int vec = n_chan == 4 && (uintptr_t)svals % 16 == 0 &&
                  (uintptr_t)out % 16 == 0;
  offset_rows_kernel<<<blocks(n_rows), kThreads, 0, (cudaStream_t)stream>>>(
      spos, sh, wsum, svals, out, n_rows, n_chan, dx, dy, dz,
      Geom{cell, box, periodic, kernel}, vec);
  return (int)cudaGetLastError();
}
