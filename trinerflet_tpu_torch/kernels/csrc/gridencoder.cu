// K7: multiresolution hash / tiled grid encoder, forward and table-gradient
// backward, one thread per (point, level), all levels in one launch.
//
// Replaces trinerflet_tpu/models/gridencoder.py:115 grid_encode with its row
// gather :91 _gather_rows, and the gather's backward, the sort + one-hot
// matmul scatter ops/scatter.py:326 scatter_add_rows. On the TPU all 8
// corner lookups of a level are one row gather and their backward one
// blocked scatter-add, because a TPU gather costs per row and its native
// scatter serialises per row.
//
// What bounds it on the H100: bytes, as scattered row reads. Per (point,
// level) the forward reads 8 table rows of C f32 (8 B each at C = 2) and
// writes C f32; about 40 flops of coordinate, weight and sum arithmetic. The
// floor is the points in, the features out and each distinct table row
// touched once. The tables stay where they are: the launcher passes one
// (pointer, resolution, wrap) entry per level by value, so nothing is
// concatenated per call (the hash-grid field's 16 tables hold 49 MB).
//
// Design, forward: each thread computes JAX's function step by step for its
// (point n, level l): u = clip((x / bound + 1) * 0.5, 0, 1), pos = u * res,
// p0 = floor(pos), frac = pos - p0 (smoothstep: frac^2 (3 - 2 frac)); the 8
// corners in meshgrid(..., indexing="ij") order (dimension 0 the most
// significant bit), each weight the product over d of frac or 1 - frac taken
// in d order, each corner coordinate clipped to [0, res]; the row index is
// dense, sum_d c_d (res+1)^d in uint32, while the dense level fits its table
// or the grid is tiled, else the spatial hash XOR_d c_d * prime_d (wrapping
// uint32, primes 1, 2654435761, 805459861); then index mod size. A level's
// size is either at least its dense count (the index is already below it)
// or exactly 2^log2_hashmap_size, so the modulo is the identity or a mask:
// the launcher passes wrap = size - 1 for a power-of-two size, else all
// ones. The corner rows are summed in corner order into out[n, l*C + c]
// (level-major, as jnp.concatenate(outs, -1)).
//
// Rounding: the JAX package runs grid_encode under jit, where XLA turns
// x / bound into x * f32(1 / bound) and fuses the + 1 into one fused
// multiply-add; one ulp there moves floor(pos) at a cell edge and changes
// all 8 corners. This file is compiled with -fmad=false and uses fmaf() at
// exactly that place, as the plain version (models/gridencoder.py) does.
//
// Backward: the same thread recomputes its indices and weights, reads its
// C-wide cotangent row and adds w * g into the 8 corner rows of zeroed f32
// gradient tables with atomicAdd (one launch for all levels); rows whose
// cotangent is all zero add nothing. Bound: bytes (cotangents and points in,
// the touched rows read-modify-written, the gradient tables written); the
// atomics' contention on the coarse levels' shared rows is the risk.
//
// K7x, the coordinate gradient (replaces JAX's autodiff of grid_encode in x,
// trinerflet_tpu/models/gridencoder.py:115-147, which analytic normals on a
// hash-grid field take): one thread per point loops over the levels, so the
// (N, 3) result is written once, without atomics. Per level it recomputes
// the corner rows as the forward does, reads its C-wide cotangent and the 8
// rows, and adds sum_k (g . row_k) dw_k/dfrac_d, times the smoothstep's
// derivative 6 f (1 - f) and the level's resolution; the sum over levels is
// then multiplied by the clip's gradient (JAX's: 1 inside, 0.5 where the
// coordinate sits exactly on 0 or 1, 0 outside), 0.5 and 1 / bound. Bound:
// bytes (the same row reads as the forward, the cotangents, the points in
// and (N, 3) out); about 30 flops per corner and channel.

#include <cuda_runtime.h>
#include <stdint.h>

#define K7_MAX_LEVELS 32

struct GridLevels {
  float* table[K7_MAX_LEVELS];     // (size, C) f32 rows; the gradient tables in the backward
  uint32_t res[K7_MAX_LEVELS];     // level resolution
  uint32_t wrap[K7_MAX_LEVELS];    // size - 1 (power-of-two size) or 0xFFFFFFFF (identity)
  int hashed[K7_MAX_LEVELS];       // 1: spatial hash, 0: dense index
};

// The cell coordinate in [0, 1] before the clip, as jit rounds it.
__device__ __forceinline__ float unit_coord(float x, float inv_bound) {
  return fmaf(x, inv_bound, 1.0f) * 0.5f;
}

// The cell corner p0 and the linear fraction of a clipped coordinate u at
// resolution res.
__device__ __forceinline__ float cell(float u, float fres, uint32_t* p0) {
  float pos = u * fres;
  float f0 = floorf(pos);
  *p0 = (uint32_t)f0;
  return pos - f0;
}

// The table rows of the 8 corners of cell p0 at level l.
__device__ __forceinline__ void corner_rows(const uint32_t p0[3], int l, const GridLevels& lv,
                                            uint32_t idx[8]) {
  const uint32_t res = lv.res[l];
  const bool hashed = lv.hashed[l] != 0;
  const uint32_t s1 = res + 1u, s2 = s1 * s1, wrap = lv.wrap[l];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int b0 = (k >> 2) & 1, b1 = (k >> 1) & 1, b2 = k & 1;
    const uint32_t c0 = min(p0[0] + b0, res), c1 = min(p0[1] + b1, res), c2 = min(p0[2] + b2, res);
    const uint32_t h = hashed ? (c0 ^ (c1 * 2654435761u) ^ (c2 * 805459861u)) : (c0 + c1 * s1 + c2 * s2);
    idx[k] = h & wrap;
  }
}

// Corner weights and table rows of point n at level l.
__device__ __forceinline__ void corners(const float* __restrict__ x, long long n, int l,
                                        const GridLevels& lv, float inv_bound, int smooth,
                                        float w[8], uint32_t idx[8]) {
  const float fres = (float)lv.res[l];
  float frac[3];
  uint32_t p0[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    float u = fminf(fmaxf(unit_coord(x[3 * n + d], inv_bound), 0.0f), 1.0f);
    float fr = cell(u, fres, &p0[d]);
    if (smooth) fr = fr * fr * (3.0f - 2.0f * fr);
    frac[d] = fr;
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int b0 = (k >> 2) & 1, b1 = (k >> 1) & 1, b2 = k & 1;
    float wk = b0 ? frac[0] : 1.0f - frac[0];
    wk = wk * (b1 ? frac[1] : 1.0f - frac[1]);
    wk = wk * (b2 ? frac[2] : 1.0f - frac[2]);
    w[k] = wk;
  }
  corner_rows(p0, l, lv, idx);
}

template <int C>
__device__ __forceinline__ void load_row(const float* __restrict__ r, float* v) {
  if constexpr (C == 1) {
    v[0] = r[0];
  } else if constexpr (C == 2) {
    float2 q = *reinterpret_cast<const float2*>(r);
    v[0] = q.x;
    v[1] = q.y;
  } else {
#pragma unroll
    for (int k = 0; k < C / 4; ++k) {
      float4 q = reinterpret_cast<const float4*>(r)[k];
      v[4 * k] = q.x;
      v[4 * k + 1] = q.y;
      v[4 * k + 2] = q.z;
      v[4 * k + 3] = q.w;
    }
  }
}

template <int C>
__global__ void grid_encode_kernel(const float* __restrict__ x, long long N, int L, GridLevels lv,
                                   float inv_bound, int smooth, float* __restrict__ out) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N * L) return;
  long long n = i / L;
  int l = (int)(i - n * L);
  float w[8];
  uint32_t idx[8];
  corners(x, n, l, lv, inv_bound, smooth, w, idx);
  const float* __restrict__ table = lv.table[l];
  float acc[C], v[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    load_row<C>(table + (size_t)idx[k] * C, v);
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = acc[c] + w[k] * v[c];
  }
  float* o = out + i * C;  // = n * L * C + l * C
#pragma unroll
  for (int c = 0; c < C; ++c) o[c] = acc[c];
}

template <int C>
__global__ void grid_encode_backward_kernel(const float* __restrict__ x, const float* __restrict__ g,
                                            long long N, int L, GridLevels lv, float inv_bound,
                                            int smooth) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N * L) return;
  float gv[C];
  bool any = false;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    gv[c] = g[i * C + c];
    any |= gv[c] != 0.0f;
  }
  if (!any) return;
  long long n = i / L;
  int l = (int)(i - n * L);
  float w[8];
  uint32_t idx[8];
  corners(x, n, l, lv, inv_bound, smooth, w, idx);
  float* __restrict__ table = lv.table[l];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    float* dst = table + (size_t)idx[k] * C;
#pragma unroll
    for (int c = 0; c < C; ++c) atomicAdd(dst + c, w[k] * gv[c]);
  }
}

// K7x: one thread per point, the levels in a loop.
template <int C>
__global__ void grid_encode_backward_x_kernel(const float* __restrict__ x, const float* __restrict__ g,
                                              long long N, int L, GridLevels lv, float inv_bound,
                                              int smooth, float* __restrict__ dx) {
  long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float u[3], clip_g[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float v = unit_coord(x[3 * n + d], inv_bound);
    u[d] = fminf(fmaxf(v, 0.0f), 1.0f);
    // JAX's gradient of clip(v, 0, 1): a max then a min, a tie split in half
    clip_g[d] = (v > 0.0f && v < 1.0f) ? 1.0f : ((v == 0.0f || v == 1.0f) ? 0.5f : 0.0f);
  }
  float acc[3] = {0.0f, 0.0f, 0.0f};
  for (int l = 0; l < L; ++l) {
    const float* __restrict__ gl = g + (n * L + l) * C;
    float gv[C];
    bool any = false;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      gv[c] = gl[c];
      any |= gv[c] != 0.0f;
    }
    if (!any) continue;
    const float fres = (float)lv.res[l];
    float frac[3], dfrac[3];
    uint32_t p0[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float lin = cell(u[d], fres, &p0[d]);
      frac[d] = smooth ? lin * lin * (3.0f - 2.0f * lin) : lin;
      dfrac[d] = smooth ? 6.0f * lin * (1.0f - lin) : 1.0f;
    }
    uint32_t idx[8];
    corner_rows(p0, l, lv, idx);
    const float* __restrict__ table = lv.table[l];
    float dw[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int b0 = (k >> 2) & 1, b1 = (k >> 1) & 1, b2 = k & 1;
      float v[C];
      load_row<C>(table + (size_t)idx[k] * C, v);
      float s = 0.0f;
#pragma unroll
      for (int c = 0; c < C; ++c) s = s + gv[c] * v[c];
      const float w0 = b0 ? frac[0] : 1.0f - frac[0];
      const float w1 = b1 ? frac[1] : 1.0f - frac[1];
      const float w2 = b2 ? frac[2] : 1.0f - frac[2];
      dw[0] = dw[0] + (b0 ? s : -s) * (w1 * w2);
      dw[1] = dw[1] + (b1 ? s : -s) * (w0 * w2);
      dw[2] = dw[2] + (b2 ? s : -s) * (w0 * w1);
    }
#pragma unroll
    for (int d = 0; d < 3; ++d) acc[d] = acc[d] + dw[d] * dfrac[d] * fres;
  }
#pragma unroll
  for (int d = 0; d < 3; ++d) dx[3 * n + d] = acc[d] * clip_g[d] * 0.5f * inv_bound;
}

static int fill_levels(GridLevels* lv, int L, void* const* tables, const uint32_t* res,
                       const uint32_t* wrap, const int* hashed) {
  if (L < 1 || L > K7_MAX_LEVELS) return (int)cudaErrorInvalidValue;
  for (int l = 0; l < L; ++l) {
    lv->table[l] = (float*)tables[l];
    lv->res[l] = res[l];
    lv->wrap[l] = wrap[l];
    lv->hashed[l] = hashed[l];
  }
  return 0;
}

// x (N, 3) f32 in world units; L level tables (size_l, C) f32 given by host
// arrays of device pointers, resolutions, wraps and hash flags -> out
// (N, L*C) f32. C must be 1, 2, 4 or 8 and 1 <= L <= 32.
extern "C" int grid_encode_launch(const float* x, long long N, int L, int C, void* const* tables,
                                  const uint32_t* res, const uint32_t* wrap, const int* hashed,
                                  float inv_bound, int smooth, float* out, cudaStream_t stream) {
  GridLevels lv;
  int err = fill_levels(&lv, L, tables, res, wrap, hashed);
  if (err) return err;
  if (N == 0) return 0;
  const int threads = 256;
  unsigned int blocks = (unsigned int)((N * L + threads - 1) / threads);
  switch (C) {
    case 1: grid_encode_kernel<1><<<blocks, threads, 0, stream>>>(x, N, L, lv, inv_bound, smooth, out); break;
    case 2: grid_encode_kernel<2><<<blocks, threads, 0, stream>>>(x, N, L, lv, inv_bound, smooth, out); break;
    case 4: grid_encode_kernel<4><<<blocks, threads, 0, stream>>>(x, N, L, lv, inv_bound, smooth, out); break;
    case 8: grid_encode_kernel<8><<<blocks, threads, 0, stream>>>(x, N, L, lv, inv_bound, smooth, out); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// x (N, 3) f32, g (N, L*C) f32 -> adds w * g into the L gradient tables
// (size_l, C) f32, which the caller zeroes (order of the float atomics
// unspecified).
extern "C" int grid_encode_backward_launch(const float* x, const float* g, long long N, int L, int C,
                                           void* const* grads, const uint32_t* res,
                                           const uint32_t* wrap, const int* hashed,
                                           float inv_bound, int smooth, cudaStream_t stream) {
  GridLevels lv;
  int err = fill_levels(&lv, L, grads, res, wrap, hashed);
  if (err) return err;
  if (N == 0) return 0;
  const int threads = 256;
  unsigned int blocks = (unsigned int)((N * L + threads - 1) / threads);
  switch (C) {
    case 1: grid_encode_backward_kernel<1><<<blocks, threads, 0, stream>>>(x, g, N, L, lv, inv_bound, smooth); break;
    case 2: grid_encode_backward_kernel<2><<<blocks, threads, 0, stream>>>(x, g, N, L, lv, inv_bound, smooth); break;
    case 4: grid_encode_backward_kernel<4><<<blocks, threads, 0, stream>>>(x, g, N, L, lv, inv_bound, smooth); break;
    case 8: grid_encode_backward_kernel<8><<<blocks, threads, 0, stream>>>(x, g, N, L, lv, inv_bound, smooth); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K7x. x (N, 3) f32, g (N, L*C) f32, the L tables (size_l, C) f32 -> dx
// (N, 3) f32, every row written.
extern "C" int grid_encode_backward_x_launch(const float* x, const float* g, long long N, int L,
                                             int C, void* const* tables, const uint32_t* res,
                                             const uint32_t* wrap, const int* hashed,
                                             float inv_bound, int smooth, float* dx,
                                             cudaStream_t stream) {
  GridLevels lv;
  int err = fill_levels(&lv, L, tables, res, wrap, hashed);
  if (err) return err;
  if (N == 0) return 0;
  const int threads = 128;
  unsigned int blocks = (unsigned int)((N + threads - 1) / threads);
  switch (C) {
    case 1: grid_encode_backward_x_kernel<1><<<blocks, threads, 0, stream>>>(x, g, N, L, lv, inv_bound, smooth, dx); break;
    case 2: grid_encode_backward_x_kernel<2><<<blocks, threads, 0, stream>>>(x, g, N, L, lv, inv_bound, smooth, dx); break;
    case 4: grid_encode_backward_x_kernel<4><<<blocks, threads, 0, stream>>>(x, g, N, L, lv, inv_bound, smooth, dx); break;
    case 8: grid_encode_backward_x_kernel<8><<<blocks, threads, 0, stream>>>(x, g, N, L, lv, inv_bound, smooth, dx); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
