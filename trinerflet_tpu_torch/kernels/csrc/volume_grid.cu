// K10: the voxel-grid trilinear sampler of the registry's volume-grid
// geometry, forward and backward.
//
// Replaces trinerflet_tpu/models/registry.py:68 sample_volume_grid and its
// autodiff. On the TPU the 8 corner lookups are "ONE flat row-take of packed
// corner rows" of the flattened (R^3, 1 + F) grid, because a TPU gather costs
// per row; its backward is XLA's scatter-add.
//
// What bounds it on the H100: bytes, as scattered row reads. Per point the
// forward reads 8 grid rows of CH = 1 + F f32 (64 B each at the default
// F = 15) and writes one; about 30 flops of coordinate and weight
// arithmetic and 2 per corner and channel. The floor is the points in, the
// samples out and each distinct grid row touched once.
//
// Coordinates, as jitted JAX computes them (this file is compiled with
// -fmad=false, so every operation rounds alone but the one fused
// multiply-add XLA forms; rinv is float32(1 / bound), as XLA folds the
// division by the static bound, and rinv * 0.5 is exact):
//   q = clip(fmaf(x, rinv * 0.5, 0.5) * (R - 1), 0, hi), hi = float32(R - 1 - 1e-6)
// (63.0 exactly at R = 64, 30.999998 at R = 32), q0 = floor(q), f = q - q0;
// corner (dx, dy, dz), dx the most significant, has the row
//   (min(q0x + dx, R-1) * R + min(q0y + dy, R-1)) * R + min(q0z + dz, R-1)
// and the weight ((wx * wy) * wz), wx = f_x or 1 - f_x. A corner whose index
// is clamped has weight 0 (it exists only when q sits on hi = R - 1).
//
// Forward: one thread per (point, group of 4 channels); the threads of a
// point read the 8 rows whole between them, neighbouring threads on
// neighbouring addresses, and sum the corners in JAX's order.
//
// Backward: one thread per point, one launch, two outputs, each optional.
// The grid gradient adds w_k * g into the 8 rows with float32 atomics (as
// K2's and K7's backwards do; rows with a zero cotangent add nothing). The
// point's gradient stays in registers: s_k = g . row_k, then
//   dL/df_d = sum_k s_k (+-1) prod_{e != d} w_e,
// times the clip's gradient (JAX's: 1 inside, 0.5 where q sits exactly on 0
// or hi, 0 outside), (R - 1), 0.5 and rinv, in JAX's order. Bound: bytes
// (the cotangents, the points and the touched rows read, the touched rows
// read-modify-written, the points' gradient written).

#include <cuda_runtime.h>
#include <stdint.h>

struct VoxelCell {
  long long rows[8];
  float w[8];
  float f[3];
  float qpre[3];  // before the clip, for its gradient
};

__device__ __forceinline__ void voxel_cell(const float* __restrict__ x, long long n, int R, float rinv,
                                           float hi, VoxelCell& c) {
  int q0[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float qpre = fmaf(x[3 * n + d], rinv * 0.5f, 0.5f) * (float)(R - 1);
    const float q = fminf(fmaxf(qpre, 0.0f), hi);
    const float fq = floorf(q);
    q0[d] = (int)fq;
    c.f[d] = q - fq;
    c.qpre[d] = qpre;
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int b0 = (k >> 2) & 1, b1 = (k >> 1) & 1, b2 = k & 1;
    const float wx = b0 ? c.f[0] : 1.0f - c.f[0];
    const float wy = b1 ? c.f[1] : 1.0f - c.f[1];
    const float wz = b2 ? c.f[2] : 1.0f - c.f[2];
    c.w[k] = wx * wy * wz;
    const long long i0 = min(q0[0] + b0, R - 1), i1 = min(q0[1] + b1, R - 1), i2 = min(q0[2] + b2, R - 1);
    c.rows[k] = (i0 * R + i1) * R + i2;
  }
}

__global__ void volume_grid_kernel(const float* __restrict__ x, const float* __restrict__ grid, long long N,
                                   int R, int CH, int G, float rinv, float hi, float* __restrict__ out) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N * G) return;
  const long long n = i / G;
  const int c0 = (int)(i - n * G) * 4;
  const int nc = min(4, CH - c0);
  VoxelCell c;
  voxel_cell(x, n, R, rinv, hi, c);
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float* __restrict__ row = grid + c.rows[k] * CH + c0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < nc) acc[j] = acc[j] + row[j] * c.w[k];
  }
  float* o = out + n * CH + c0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < nc) o[j] = acc[j];
}

__global__ void volume_grid_backward_kernel(const float* __restrict__ x, const float* __restrict__ g,
                                            const float* __restrict__ grid, long long N, int R, int CH,
                                            float rinv, float hi, float* __restrict__ ggrid,
                                            float* __restrict__ gx) {
  long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  VoxelCell c;
  voxel_cell(x, n, R, rinv, hi, c);
  const float* __restrict__ gn = g + n * CH;
  float s[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) s[k] = 0.0f;
  for (int ch = 0; ch < CH; ++ch) {
    const float gc = gn[ch];
    if (gc == 0.0f) continue;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (ggrid) atomicAdd(ggrid + c.rows[k] * CH + ch, c.w[k] * gc);
      if (gx) s[k] = s[k] + gc * grid[c.rows[k] * CH + ch];
    }
  }
  if (!gx) return;
  float df[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int b0 = (k >> 2) & 1, b1 = (k >> 1) & 1, b2 = k & 1;
    const float wx = b0 ? c.f[0] : 1.0f - c.f[0];
    const float wy = b1 ? c.f[1] : 1.0f - c.f[1];
    const float wz = b2 ? c.f[2] : 1.0f - c.f[2];
    df[0] = df[0] + (b0 ? s[k] : -s[k]) * (wy * wz);
    df[1] = df[1] + (b1 ? s[k] : -s[k]) * (wx * wz);
    df[2] = df[2] + (b2 ? s[k] : -s[k]) * (wx * wy);
  }
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float v = c.qpre[d];
    const float cg = (v > 0.0f && v < hi) ? 1.0f : ((v == 0.0f || v == hi) ? 0.5f : 0.0f);
    gx[3 * n + d] = df[d] * cg * (float)(R - 1) * 0.5f * rinv;
  }
}

// x (N, 3) f32 in world units, grid (R^3, CH) f32 rows -> out (N, CH) f32;
// rinv = float32(1 / bound).
extern "C" int volume_grid_launch(const float* x, const float* grid, long long N, int R, int CH,
                                  float rinv, float hi, float* out, cudaStream_t stream) {
  if (N == 0) return 0;
  if (R < 2 || CH < 1) return (int)cudaErrorInvalidValue;
  const int G = (CH + 3) / 4;
  const int threads = 256;
  unsigned int blocks = (unsigned int)((N * G + threads - 1) / threads);
  volume_grid_kernel<<<blocks, threads, 0, stream>>>(x, grid, N, R, CH, G, rinv, hi, out);
  return (int)cudaGetLastError();
}

// x (N, 3) f32, g (N, CH) f32, grid (R^3, CH) f32 -> adds w * g into ggrid
// (R^3, CH) f32, which the caller zeroes (float atomics in an unspecified
// order; null: not computed), and writes dL/dx into gx (N, 3) f32 (null: not
// computed).
extern "C" int volume_grid_backward_launch(const float* x, const float* g, const float* grid, long long N,
                                           int R, int CH, float rinv, float hi, float* ggrid, float* gx,
                                           cudaStream_t stream) {
  if (N == 0 || (!ggrid && !gx)) return 0;
  if (R < 2 || CH < 1) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  unsigned int blocks = (unsigned int)((N + threads - 1) / threads);
  volume_grid_backward_kernel<<<blocks, threads, 0, stream>>>(x, g, grid, N, R, CH, rinv, hi, ggrid, gx);
  return (int)cudaGetLastError();
}
