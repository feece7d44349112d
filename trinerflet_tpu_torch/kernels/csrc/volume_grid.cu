// K10: the voxel-grid trilinear sampler of the registry's volume-grid
// geometry, forward and backward.
//
// Replaces trinerflet_tpu/models/registry.py:68 sample_volume_grid and its
// autodiff. On the TPU the 8 corner lookups are "ONE flat row-take of packed
// corner rows" of the flattened (R^3, 1 + F) grid, because a TPU gather costs
// per row; its backward is XLA's scatter-add.
//
// What bounds it on the H100: bytes, as row reads and row updates scattered
// over the grid (16.8 MB at R = 64, CH = 16: it lives in the L2). Per point
// the forward reads 8 grid rows of CH = 1 + F f32 (64 B each at the default
// F = 15) and writes one; about 30 flops of coordinate and weight arithmetic
// and 2 per corner and channel. The floor is the points in, the samples out
// and each distinct grid row touched once. The backward reads the cotangent
// row and adds w_k * g into the 8 corner rows; for dL/dx it reads the 8 rows.
// In practice the forward is bound by the L2's bandwidth: its row loads ask
// the L2 for 8 rows a point (on the registry-grid step ~226 MB of sectors a
// call against 13 MB of distinct rows: neighbouring samples share rows, but
// rarely within one warp's instruction); the backward's grid gradient by its
// float4 atomics.
//
// Layout: a lane group of LP lanes per point, LP the power of two covering
// the row's float4 slices (4 lanes at CH = 16, 2 at CH = 5 or 8, at most 8;
// past 32 channels a lane takes every LP-th slice). Lanes 0-2 of the group
// read the point's coordinates once and pass them by shuffles (at LP < 4
// each lane reads all three); every lane computes the cell itself, in 32-bit
// row arithmetic (R^3 < 2^31; the address is one wide multiply-add). In the
// forward and in dL/dx alone a warp covers 32 / LP consecutive points, so its
// load of a corner row's slices reads 32 / LP whole rows, and its loads of
// the points' cotangents and stores of their outputs are contiguous. When CH
// % 4 == 0 and the rows are 16-byte aligned each lane moves its slice as one
// float4 (__ldg loads, float4 stores, float4 atomics); otherwise as up to 4
// scalars (the tail). Lanes past N work on the last point and store nothing,
// so every warp is whole at its shuffles.
//
// Coordinates, as jitted JAX computes them (this file is compiled with
// -fmad=false, so every operation rounds alone but the one fused
// multiply-add XLA forms; rinv is float32(1 / bound), as XLA folds the
// division by the static bound, and rinv * 0.5 is exact):
//   q = clip(fmaf(x, rinv * 0.5, 0.5) * (R - 1), 0, hi), hi = float32(R - 1 - 1e-6)
// (63.0 exactly at R = 64, 30.999998 at R = 32), q0 = floor(q), f = q - q0;
// corner k = (dx, dy, dz), dx the most significant, has the row
//   (min(q0x + dx, R-1) * R + min(q0y + dy, R-1)) * R + min(q0z + dz, R-1)
// and the weight w_k = (wx * wy) * wz, wx = f_x or 1 - f_x. A corner whose
// index is clamped has weight 0 (it exists only when q sits on hi = R - 1).
//
// Forward: out = sum over k = 0..7, in that order, of row_k * w_k, each
// product and each add rounded alone from 0, as JAX sums: the plain
// version's bits.
//
// Backward: one launch, two outputs, each optional (a template each, so the
// grid gradient alone reads no grid row and dL/dx alone issues no atomic).
// Each lane reads its slice of the cotangent; a slice of zeros (a masked
// sample) adds nothing and reads nothing. The grid gradient adds w_k * g
// into the 8 rows with float atomics (float4 on the vector path: a warp's
// instruction updates 32 / LP whole rows), in an unspecified order. The
// point's gradient: s_k = g . row_k, each lane summing its channels in
// order, then the lane group's partial sums added by an xor butterfly
// (every lane ends with the same bits); then
//   dL/df_d = sum_k s_k (+-1) prod_{e != d} w_e,
// times the clip's gradient (JAX's: 1 inside, 0.5 where q sits exactly on 0
// or hi, 0 outside), (R - 1), 0.5 and rinv, in JAX's order; lane d of the
// group writes component d. The same bits on every call, with or without
// the grid gradient. With the grid gradient and one slice a lane (CH <= 32)
// a lane group walks kRun = 8 consecutive points in order and sums w_k * g
// over each run of points in one cell in registers, adding a corner's sum
// when the cell changes: on the registry-grid step 36% of consecutive
// samples share a cell, and the merge took the call from 0.141 to 0.109 ms
// on an H100 (4 points a group: 0.111).
//
// K10², the backward of the coordinate gradient (replaces JAX's autodiff of
// sample_volume_grid twice, which training through an analytic normal on a
// voxel grid takes: models/registry.py:443 under jax.value_and_grad). Given
// the cotangent gg of dL/dx, with q_d = clip'(q_d) (R - 1) 0.5 rinv (dq/dx),
// A_d = gg_d q_d and omega_k = sum_d A_d dw_k/df_d (corner k's weight
// differentiated along gg):
//   dL/dg = sum_k omega_k row_k;  dL/drow_k += omega_k g;
//   dL/dx_e = q_e sum_{d != e} A_d sum_k s_k (+-1)(+-1) w_third,
// s_k = g . row_k (the trilinear Hessian has no diagonal). First design: the
// forward's lane groups, one point a group, each lane its float4 slices of g
// and of the 8 rows; dL/dg stored per slice; the grid gradient by float4
// atomics of omega_k g (no run merging); the s_k by the xor butterfly, dL/dx
// by lane d of the group. A point whose A is zero reads nothing. Bound:
// bytes (g, gg and the points in, the 8 rows a point, dL/dg and dL/dx out,
// the touched rows of the grid gradient updated).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;

struct VoxelCell {
  unsigned rows[8];
  float w[8];
  float f[3];
  float qpre[3];  // before the clip, for its gradient
};

__device__ __forceinline__ void voxel_cell(const float (&xv)[3], int R, float rinv, float hi, VoxelCell& c) {
  unsigned q0[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float qpre = fmaf(xv[d], rinv * 0.5f, 0.5f) * (float)(R - 1);
    const float q = fminf(fmaxf(qpre, 0.0f), hi);
    const float fq = floorf(q);
    q0[d] = (unsigned)fq;
    c.f[d] = q - fq;
    c.qpre[d] = qpre;
  }
  const unsigned top = (unsigned)(R - 1), r = (unsigned)R;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const unsigned b0 = (k >> 2) & 1, b1 = (k >> 1) & 1, b2 = k & 1;
    const float wx = b0 ? c.f[0] : 1.0f - c.f[0];
    const float wy = b1 ? c.f[1] : 1.0f - c.f[1];
    const float wz = b2 ? c.f[2] : 1.0f - c.f[2];
    c.w[k] = wx * wy * wz;
    c.rows[k] = (min(q0[0] + b0, top) * r + min(q0[1] + b1, top)) * r + min(q0[2] + b2, top);
  }
}

// The point's coordinates, read once: lanes 0-2 of the group read one each
// and the group shares them by shuffles (at LP < 4 each lane reads all three).
template <int LP>
__device__ __forceinline__ void load_point(const float* __restrict__ x, long long n, int s, float (&xv)[3]) {
  if constexpr (LP >= 4) {
    const float v = s < 3 ? __ldg(x + 3 * n + s) : 0.0f;
    const int base = (threadIdx.x & 31) & ~(LP - 1);
#pragma unroll
    for (int d = 0; d < 3; ++d) xv[d] = __shfl_sync(kFull, v, base + d);
  } else {
#pragma unroll
    for (int d = 0; d < 3; ++d) xv[d] = __ldg(x + 3 * n + d);
  }
}

// A slice of nc <= 4 channels at p (nc == 4 and p 16-byte aligned on the
// vector path), the rest zero.
template <bool VEC>
__device__ __forceinline__ float4 load_slice(const float* __restrict__ p, int nc) {
  if constexpr (VEC) {
    return __ldg(reinterpret_cast<const float4*>(p));
  } else {
    float4 v = make_float4(__ldg(p), 0.0f, 0.0f, 0.0f);
    if (nc > 1) v.y = __ldg(p + 1);
    if (nc > 2) v.z = __ldg(p + 2);
    if (nc > 3) v.w = __ldg(p + 3);
    return v;
  }
}

template <bool VEC>
__device__ __forceinline__ void store_slice(float* p, float4 v, int nc) {
  if constexpr (VEC) {
    *reinterpret_cast<float4*>(p) = v;
  } else {
    p[0] = v.x;
    if (nc > 1) p[1] = v.y;
    if (nc > 2) p[2] = v.z;
    if (nc > 3) p[3] = v.w;
  }
}

// p[0..nc) += v: one float4 atomic on the vector path, else a scalar
// atomic for each nonzero channel.
template <bool VEC>
__device__ __forceinline__ void add_slice(float* p, float4 v, int nc) {
  if constexpr (VEC) {
    atomicAdd(reinterpret_cast<float4*>(p), v);
  } else {
    if (v.x != 0.0f) atomicAdd(p, v.x);
    if (nc > 1 && v.y != 0.0f) atomicAdd(p + 1, v.y);
    if (nc > 2 && v.z != 0.0f) atomicAdd(p + 2, v.z);
    if (nc > 3 && v.w != 0.0f) atomicAdd(p + 3, v.w);
  }
}

__device__ __forceinline__ float4 scale(float w, float4 g) { return make_float4(w * g.x, w * g.y, w * g.z, w * g.w); }

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

template <int LP, bool VEC>
__global__ void __launch_bounds__(kThreads)
volume_grid_kernel(const float* __restrict__ x, const float* __restrict__ grid, long long N, int R, int CH,
                   float rinv, float hi, float* __restrict__ out) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long n = t / LP;
  const int s = (int)(t % LP);
  float xv[3];
  load_point<LP>(x, n < N ? n : N - 1, s, xv);
  if (n >= N) return;
  VoxelCell c;
  voxel_cell(xv, R, rinv, hi, c);
  for (int c0 = 4 * s; c0 < CH; c0 += 4 * LP) {
    const int nc = min(4, CH - c0);
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float4 r = load_slice<VEC>(grid + (size_t)c.rows[k] * CH + c0, nc);
      acc.x = acc.x + r.x * c.w[k];
      acc.y = acc.y + r.y * c.w[k];
      acc.z = acc.z + r.z * c.w[k];
      acc.w = acc.w + r.w * c.w[k];
    }
    store_slice<VEC>(out + n * CH + c0, acc, nc);
  }
}

// T consecutive points a lane group, in order. With T > 1 (the grid
// gradient, one slice a lane) a lane sums w_k * g over a run of points in
// one cell in registers and adds each corner's sum when the cell changes or
// the walk ends; with T = 1 it adds each point's terms.
template <int LP, int T, bool VEC, bool GG, bool GX>
__global__ void __launch_bounds__(kThreads)
volume_grid_backward_kernel(const float* __restrict__ x, const float* __restrict__ g,
                            const float* __restrict__ grid, long long N, int R, int CH, float rinv,
                            float hi, float* __restrict__ ggrid, float* __restrict__ gx) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long grp = t / LP;
  const int s = (int)(t % LP);
  float4 run[8];
  unsigned run_rows[8];
  bool open = false;
  for (int i = 0; i < T; ++i) {
    const long long n = grp * T + i;
    const bool live = n < N;
    float xv[3];
    load_point<LP>(x, live ? n : N - 1, s, xv);
    VoxelCell c;
    voxel_cell(xv, R, rinv, hi, c);
    float sk[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) sk[k] = 0.0f;
    if (live) {
      for (int c0 = 4 * s; c0 < CH; c0 += 4 * LP) {
        const int nc = min(4, CH - c0);
        const float4 gv = load_slice<VEC>(g + n * CH + c0, nc);
        if (gv.x == 0.0f && gv.y == 0.0f && gv.z == 0.0f && gv.w == 0.0f) continue;
        if constexpr (GG && T == 1) {
#pragma unroll
          for (int k = 0; k < 8; ++k) add_slice<VEC>(ggrid + (size_t)c.rows[k] * CH + c0, scale(c.w[k], gv), nc);
        } else if constexpr (GG) {
          if (open && run_rows[0] != c.rows[0]) {
#pragma unroll
            for (int k = 0; k < 8; ++k) add_slice<VEC>(ggrid + (size_t)run_rows[k] * CH + c0, run[k], nc);
            open = false;
          }
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            run[k] = open ? add4(run[k], scale(c.w[k], gv)) : scale(c.w[k], gv);
            run_rows[k] = c.rows[k];
          }
          open = true;
        }
        if constexpr (GX) {
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const float4 r = load_slice<VEC>(grid + (size_t)c.rows[k] * CH + c0, nc);
            sk[k] = sk[k] + gv.x * r.x;
            sk[k] = sk[k] + gv.y * r.y;
            sk[k] = sk[k] + gv.z * r.z;
            sk[k] = sk[k] + gv.w * r.w;
          }
        }
      }
    }
    if constexpr (GX) {
#pragma unroll
      for (int o = LP / 2; o > 0; o >>= 1) {
#pragma unroll
        for (int k = 0; k < 8; ++k) sk[k] = sk[k] + __shfl_xor_sync(kFull, sk[k], o);
      }
      if (live) {
        float df[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int b0 = (k >> 2) & 1, b1 = (k >> 1) & 1, b2 = k & 1;
          const float wx = b0 ? c.f[0] : 1.0f - c.f[0];
          const float wy = b1 ? c.f[1] : 1.0f - c.f[1];
          const float wz = b2 ? c.f[2] : 1.0f - c.f[2];
          df[0] = df[0] + (b0 ? sk[k] : -sk[k]) * (wy * wz);
          df[1] = df[1] + (b1 ? sk[k] : -sk[k]) * (wx * wz);
          df[2] = df[2] + (b2 ? sk[k] : -sk[k]) * (wx * wy);
        }
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          if (d % LP != s) continue;
          const float v = c.qpre[d];
          const float cg = (v > 0.0f && v < hi) ? 1.0f : ((v == 0.0f || v == hi) ? 0.5f : 0.0f);
          gx[3 * n + d] = df[d] * cg * (float)(R - 1) * 0.5f * rinv;
        }
      }
    }
  }
  if constexpr (GG && T > 1) {
    if (open) {
      const int c0 = 4 * s, nc = min(4, CH - c0);
#pragma unroll
      for (int k = 0; k < 8; ++k) add_slice<VEC>(ggrid + (size_t)run_rows[k] * CH + c0, run[k], nc);
    }
  }
}

// K10²: one point a lane group; ggrid, gx and dg may each be null.
template <int LP, bool VEC>
__global__ void __launch_bounds__(kThreads)
volume_grid_backward_x_backward_kernel(const float* __restrict__ x, const float* __restrict__ g,
                                       const float* __restrict__ ggx, const float* __restrict__ grid, long long N,
                                       int R, int CH, float rinv, float hi, float* __restrict__ ggrid,
                                       float* __restrict__ gx, float* __restrict__ dg) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long n = t / LP;
  const int s = (int)(t % LP);
  const bool live = n < N;
  float xv[3];
  load_point<LP>(x, live ? n : N - 1, s, xv);
  VoxelCell c;
  voxel_cell(xv, R, rinv, hi, c);
  float q[3], A[3];
  bool any = false;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float v = c.qpre[d];
    const float cg = (v > 0.0f && v < hi) ? 1.0f : ((v == 0.0f || v == hi) ? 0.5f : 0.0f);
    q[d] = cg * (float)(R - 1) * 0.5f * rinv;
    A[d] = live ? __ldg(ggx + 3 * n + d) * q[d] : 0.0f;
    any |= A[d] != 0.0f;
  }
  float omega[8], sk[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int b0 = (k >> 2) & 1, b1 = (k >> 1) & 1, b2 = k & 1;
    const float wx = b0 ? c.f[0] : 1.0f - c.f[0];
    const float wy = b1 ? c.f[1] : 1.0f - c.f[1];
    const float wz = b2 ? c.f[2] : 1.0f - c.f[2];
    omega[k] = A[0] * ((b0 ? 1.0f : -1.0f) * (wy * wz)) + A[1] * ((b1 ? 1.0f : -1.0f) * (wx * wz)) +
               A[2] * ((b2 ? 1.0f : -1.0f) * (wx * wy));
    sk[k] = 0.0f;
  }
  if (live) {
    for (int c0 = 4 * s; c0 < CH; c0 += 4 * LP) {
      const int nc = min(4, CH - c0);
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (any) {
        const float4 gv = load_slice<VEC>(g + n * CH + c0, nc);
        const bool gz = gv.x == 0.0f && gv.y == 0.0f && gv.z == 0.0f && gv.w == 0.0f;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float4 r = load_slice<VEC>(grid + (size_t)c.rows[k] * CH + c0, nc);
          acc = add4(acc, scale(omega[k], r));
          sk[k] = sk[k] + gv.x * r.x;
          sk[k] = sk[k] + gv.y * r.y;
          sk[k] = sk[k] + gv.z * r.z;
          sk[k] = sk[k] + gv.w * r.w;
          if (ggrid != nullptr && !gz && omega[k] != 0.0f)
            add_slice<VEC>(ggrid + (size_t)c.rows[k] * CH + c0, scale(omega[k], gv), nc);
        }
      }
      if (dg != nullptr) store_slice<VEC>(dg + n * CH + c0, acc, nc);
    }
  }
  if (gx == nullptr) return;
#pragma unroll
  for (int o = LP / 2; o > 0; o >>= 1) {
#pragma unroll
    for (int k = 0; k < 8; ++k) sk[k] = sk[k] + __shfl_xor_sync(kFull, sk[k], o);
  }
  if (!live) return;
  float hx[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int b[3] = {(k >> 2) & 1, (k >> 1) & 1, k & 1};
    float fac[3], sg[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      fac[d] = b[d] ? c.f[d] : 1.0f - c.f[d];
      sg[d] = b[d] ? 1.0f : -1.0f;
    }
#pragma unroll
    for (int e = 0; e < 3; ++e) {
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        if (d == e) continue;
        hx[e] = hx[e] + A[d] * sk[k] * (sg[d] * sg[e] * fac[3 - d - e]);
      }
    }
  }
#pragma unroll
  for (int d = 0; d < 3; ++d)
    if (d % LP == s) gx[3 * n + d] = hx[d] * q[d];
}

// The lanes a point takes: the power of two covering its float4 slices, at
// most 8.
int lanes_per_point(int CH) {
  const int slices = (CH + 3) / 4;
  return slices > 4 ? 8 : slices > 2 ? 4 : slices;
}

bool aligned16(const void* p) { return p == nullptr || ((uintptr_t)p & 15) == 0; }

unsigned int blocks_for(long long N, int LP) { return (unsigned int)((N * LP + kThreads - 1) / kThreads); }

template <int LP, bool VEC>
void launch_forward(const float* x, const float* grid, long long N, int R, int CH, float rinv, float hi,
                    float* out, cudaStream_t stream) {
  volume_grid_kernel<LP, VEC><<<blocks_for(N, LP), kThreads, 0, stream>>>(x, grid, N, R, CH, rinv, hi, out);
}

// The grid gradient walks kRun points a lane group where a lane holds one
// slice (CH <= 4 * LP); dL/dx alone, or wider rows, a point a group.
constexpr int kRun = 8;

template <int LP, bool VEC>
void launch_backward(const float* x, const float* g, const float* grid, long long N, int R, int CH, float rinv,
                     float hi, float* ggrid, float* gx, cudaStream_t stream) {
  const bool runs = ggrid && CH <= 4 * LP;
  const unsigned int blocks = blocks_for(runs ? (N + kRun - 1) / kRun : N, LP);
  if (ggrid && gx && runs)
    volume_grid_backward_kernel<LP, kRun, VEC, true, true><<<blocks, kThreads, 0, stream>>>(
        x, g, grid, N, R, CH, rinv, hi, ggrid, gx);
  else if (ggrid && gx)
    volume_grid_backward_kernel<LP, 1, VEC, true, true><<<blocks, kThreads, 0, stream>>>(
        x, g, grid, N, R, CH, rinv, hi, ggrid, gx);
  else if (ggrid && runs)
    volume_grid_backward_kernel<LP, kRun, VEC, true, false><<<blocks, kThreads, 0, stream>>>(
        x, g, grid, N, R, CH, rinv, hi, ggrid, gx);
  else if (ggrid)
    volume_grid_backward_kernel<LP, 1, VEC, true, false><<<blocks, kThreads, 0, stream>>>(
        x, g, grid, N, R, CH, rinv, hi, ggrid, gx);
  else
    volume_grid_backward_kernel<LP, 1, VEC, false, true><<<blocks, kThreads, 0, stream>>>(
        x, g, grid, N, R, CH, rinv, hi, ggrid, gx);
}

template <int LP, bool VEC>
void launch_backward_x_backward(const float* x, const float* g, const float* ggx, const float* grid, long long N,
                                int R, int CH, float rinv, float hi, float* ggrid, float* gx, float* dg,
                                cudaStream_t stream) {
  volume_grid_backward_x_backward_kernel<LP, VEC><<<blocks_for(N, LP), kThreads, 0, stream>>>(
      x, g, ggx, grid, N, R, CH, rinv, hi, ggrid, gx, dg);
}

// F(LP, VEC) for the LP and VEC of this call.
#define K10_DISPATCH(F, LP, VEC, ...)                                          \
  switch (LP) {                                                                 \
    case 1: VEC ? F<1, true>(__VA_ARGS__) : F<1, false>(__VA_ARGS__); break;    \
    case 2: VEC ? F<2, true>(__VA_ARGS__) : F<2, false>(__VA_ARGS__); break;    \
    case 4: VEC ? F<4, true>(__VA_ARGS__) : F<4, false>(__VA_ARGS__); break;    \
    default: VEC ? F<8, true>(__VA_ARGS__) : F<8, false>(__VA_ARGS__); break;   \
  }

bool valid_shape(int R, int CH) { return R >= 2 && CH >= 1 && (long long)R * R * R < (1ll << 31); }

}  // namespace

// x (N, 3) f32 in world units, grid (R^3, CH) f32 rows -> out (N, CH) f32;
// rinv = float32(1 / bound).
extern "C" int volume_grid_launch(const float* x, const float* grid, long long N, int R, int CH,
                                  float rinv, float hi, float* out, cudaStream_t stream) {
  if (N == 0) return 0;
  if (!valid_shape(R, CH)) return (int)cudaErrorInvalidValue;
  const int LP = lanes_per_point(CH);
  const bool vec = CH % 4 == 0 && aligned16(grid) && aligned16(out);
  K10_DISPATCH(launch_forward, LP, vec, x, grid, N, R, CH, rinv, hi, out, stream)
  return (int)cudaGetLastError();
}

// x (N, 3) f32, g (N, CH) f32, grid (R^3, CH) f32 -> adds w * g into ggrid
// (R^3, CH) f32, which the caller zeroes (float atomics in an unspecified
// order; null: not computed), and writes dL/dx into gx (N, 3) f32 (null: not
// computed). One launch.
extern "C" int volume_grid_backward_launch(const float* x, const float* g, const float* grid, long long N,
                                           int R, int CH, float rinv, float hi, float* ggrid, float* gx,
                                           cudaStream_t stream) {
  if (N == 0 || (!ggrid && !gx)) return 0;
  if (!valid_shape(R, CH)) return (int)cudaErrorInvalidValue;
  const int LP = lanes_per_point(CH);
  const bool vec = CH % 4 == 0 && aligned16(g) && aligned16(grid) && aligned16(ggrid);
  K10_DISPATCH(launch_backward, LP, vec, x, g, grid, N, R, CH, rinv, hi, ggrid, gx, stream)
  return (int)cudaGetLastError();
}

// K10². x (N, 3) f32, g (N, CH) f32 (the coordinate gradient's cotangent),
// ggx (N, 3) f32 (the cotangent of its dL/dx), grid (R^3, CH) f32 rows ->
// adds omega_k g into ggrid (R^3, CH) f32, which the caller zeroes (float
// atomics in an unspecified order), writes dL/dx into gx (N, 3) and dL/dg
// into dg (N, CH) f32; each null: not computed. One launch.
extern "C" int volume_grid_backward_x_backward_launch(const float* x, const float* g, const float* ggx,
                                                      const float* grid, long long N, int R, int CH, float rinv,
                                                      float hi, float* ggrid, float* gx, float* dg,
                                                      cudaStream_t stream) {
  if (N == 0 || (!ggrid && !gx && !dg)) return 0;
  if (!valid_shape(R, CH)) return (int)cudaErrorInvalidValue;
  const int LP = lanes_per_point(CH);
  const bool vec = CH % 4 == 0 && aligned16(g) && aligned16(grid) && aligned16(ggrid) && aligned16(dg);
  K10_DISPATCH(launch_backward_x_backward, LP, vec, x, g, ggx, grid, N, R, CH, rinv, hi, ggrid, gx, dg, stream)
  return (int)cudaGetLastError();
}
