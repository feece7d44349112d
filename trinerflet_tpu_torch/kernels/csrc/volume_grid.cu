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
// over each run of points in one cell in registers (CornerRun, which K10²
// shares), adding a corner's sum when the cell changes: on the
// registry-grid step 36% of consecutive samples share a cell, and the merge
// took the call from 0.141 to 0.109 ms on an H100 (4 points a group: 0.111).
//
// K10², the backward of the coordinate gradient (replaces JAX's autodiff of
// sample_volume_grid twice, which training through an analytic normal on a
// voxel grid takes: models/registry.py:443 under jax.value_and_grad). Given
// the cotangent gg of dL/dx, with q_d = clip'(q_d) (R - 1) 0.5 rinv (dq/dx),
// A_d = gg_d q_d and omega_k = sum_d A_d dw_k/df_d (corner k's weight
// differentiated along gg):
//   dL/dg = sum_k omega_k row_k;  dL/drow_k += omega_k g;
//   dL/dx_e = q_e sum_{d != e} A_d sum_k s_k (+-1)(+-1) w_third,
// s_k = g . row_k (the trilinear Hessian has no diagonal). Bound: bytes, as
// chip_smoke's _k10xx_rows counts them: gg in, x and g of the points gg
// reaches, each grid row their corners touch read once, dL/dg (and dL/dx)
// out and the grid gradient written once (0.0254 ms on the
// registry-grid-analytic step on an H100). There gg reaches 19% of the
// points (those whose shading the loss reads), in every span, and 28% of
// consecutive live points share a cell. The first design, a lane group per
// point over all N, left most lanes idle beside the few live ones and added
// 32 unmerged float4 atomics a live point (0.1224 ms, the atomics 31% of
// it; 80 registers).
//
// Design: a block per span of kK10xxSpan = 192 consecutive points. The span's
// points and gg are staged in shared memory (coalesced); a thread a point
// computes A, and ballots and a scan of the 32-point chunks' counts rank
// the live points (A not zero) in point order into a compact list. Dead
// points read no g and no grid row: the block writes their dL/dg rows as
// coalesced float4 zero slabs, and the span's dL/dx leaves shared memory as
// one slab (zeros where dead). Lane groups of LP lanes (a lane a float4
// slice, as K10's) take the live points, a warp's groups together, for
// dL/dg, dL/dx, and, where a lane holds one slice (CH <= 4 LP), to stage
// omega_k, the corner rows and g in shared memory. Then a lane group takes
// each run of consecutive live points in one cell and walks it with the K10
// backward's CornerRun: omega_k g summed per corner in order in registers,
// each corner's float4 added once, a zero sum not at all (on the
// registry-grid-analytic step 1.39 live points a run: 28% fewer adds). Past
// 32 channels a lane takes every LP-th slice and adds each point's terms.
// dL/dg and dL/dx are the first design's arithmetic per point, its bits;
// the grid gradient is a float32 sum of the same terms in another order,
// held to the float-summation bound (models/registry.py
// sample_volume_grid_backward_x_backward_error). The grid gradient's zero
// fill stays the wrapper's torch.zeros_like: 0.0046 ms of the first
// design's call, and a cooperative launch that zeroes it first would save
// only a launch gap while capping the grid at the resident blocks.
// Measured on the H100 (scripts/torch_second_order_timing.py, ga): 0.0625
// ms against the first design's 0.1226 in one interleaved call, 92
// registers (the adds 13% of the call: 0.0546 ms without them). Measured
// and left out: a group walking T = 1, 2, 4 or 8 live points and merging
// them during the per-point pass (0.081-0.144 ms: 168 registers); the run
// pass reading g from device memory again (0.0757); a thread per (run,
// corner, slice) in place of the walk (0.0713); register caps (spills,
// slower); spans of 128, 256, 320 and 384 points (0.0698, 0.0653, 0.0673,
// 0.0680 against 0.0627 at 192); 64 threads a block (slower), 160 or 192
// (no gain); a runtime test of gx in place of the GX template (0.0662
// against 0.0626 at ga, where dL/dx is not asked: 96 registers, not 92).

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

// load_slice from shared memory
template <bool VEC>
__device__ __forceinline__ float4 shared_slice(const float* p, int nc) {
  if constexpr (VEC) {
    return *reinterpret_cast<const float4*>(p);
  } else {
    float4 v = make_float4(p[0], 0.0f, 0.0f, 0.0f);
    if (nc > 1) v.y = p[1];
    if (nc > 2) v.z = p[2];
    if (nc > 3) v.w = p[3];
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

// A lane's sums of weight(k) * g over a run of consecutive points in one
// cell, for its slice at c0 of the 8 corner rows (the K10 backward's w_k,
// K10²'s omega_k): a corner's sum is added when the cell changes or the
// walk ends, and a sum of zeros (a zero weight or a zero g) adds nothing.
template <bool VEC>
struct CornerRun {
  float4 sum[8];
  unsigned rows[8];
  bool open = false;

  __device__ __forceinline__ void flush(float* ggrid, int CH, int c0, int nc) {
    if (!open) return;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float4 v = sum[k];
      if (v.x != 0.0f || v.y != 0.0f || v.z != 0.0f || v.w != 0.0f)
        add_slice<VEC>(ggrid + (size_t)rows[k] * CH + c0, v, nc);
    }
    open = false;
  }

  template <typename Weight>
  __device__ __forceinline__ void add(float* ggrid, const unsigned* cell_rows, float4 gv, int CH, int c0, int nc,
                                      Weight weight) {
    if (open && rows[0] != cell_rows[0]) flush(ggrid, CH, c0, nc);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float4 t = scale(weight(k), gv);
      sum[k] = open ? add4(sum[k], t) : t;
      rows[k] = cell_rows[k];
    }
    open = true;
  }
};

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
  CornerRun<VEC> run;
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
          run.add(ggrid, c.rows, gv, CH, c0, nc, [&](int k) { return c.w[k]; });
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
  if constexpr (GG && T > 1) run.flush(ggrid, CH, 4 * s, min(4, CH - 4 * s));
}

// K10²: a block per span of kK10xxSpan consecutive points, kK10xxThreads
// threads. ggrid, gx and dg may each be null (gx: GX false).
constexpr int kK10xxSpan = 192, kK10xxThreads = 128;

// dq/dx of one coordinate (from q before the clip), rounded as the first
// design rounded it (one rounding an operation, left to right).
__device__ __forceinline__ float coord_gradient(float qpre, int R, float rinv, float hi) {
  const float cg = (qpre > 0.0f && qpre < hi) ? 1.0f : ((qpre == 0.0f || qpre == hi) ? 0.5f : 0.0f);
  return cg * (float)(R - 1) * 0.5f * rinv;
}

// RUN: a lane holds one slice (CH <= 4 LP), and the grid gradient is added
// a run of live points in one cell at a time; else each point's terms.
// GX: dL/dx asked for (the s_k work and the dL/dx slab).
template <int LP, bool VEC, bool RUN, bool GX>
__global__ void __launch_bounds__(kK10xxThreads)
volume_grid_backward_x_backward_kernel(const float* __restrict__ x, const float* __restrict__ g,
                                       const float* __restrict__ ggx, const float* __restrict__ grid, long long N,
                                       int R, int CH, float rinv, float hi, float* __restrict__ ggrid,
                                       float* __restrict__ gx, float* __restrict__ dg) {
  constexpr int P = kK10xxSpan, B = kK10xxThreads, W = P / 32;
  static_assert(P % 32 == 0 && W <= 32 && B % 32 == 0, "a span is whole 32-point chunks");
  __shared__ float xs[3 * P], ggs[3 * P];  // the span's points and gg
  __shared__ float dxs[GX ? 3 * P : 1];    // its dL/dx (zeros where dead)
  __shared__ float om[RUN ? 8 * P : 1];    // a live point's omega_k, by slot
  __shared__ unsigned rows[RUN ? 8 * P : 1];  // its corner rows (the first names its cell), by slot
  extern __shared__ float4 k10xx_dynamic[];
  float* gs = reinterpret_cast<float*>(k10xx_dynamic);  // RUN: (P, CH) the live points' g, by slot
  __shared__ unsigned live_bits[W];        // a 32-point chunk's live points, by ballot
  __shared__ int before[W + 1];            // live points before each chunk
  __shared__ int ids[P];                   // the live points in order (a slot's point)
  const int tid = threadIdx.x, lane = tid & 31;
  const long long n0 = (long long)blockIdx.x * P;
  const int np = (int)min((long long)P, N - n0);
  for (int j = tid; j < 3 * np; j += B) {
    xs[j] = x[3 * n0 + j];
    ggs[j] = ggx[3 * n0 + j];
    if constexpr (GX) dxs[j] = 0.0f;
  }
  __syncthreads();
  // live: A = gg dq/dx not zero; ranked in point order by ballots and a scan
  // of the chunks' counts
  for (int ch = tid >> 5; ch < W; ch += B / 32) {
    const int p = ch * 32 + lane;
    bool live = false;
    if (p < np) {
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const float qpre = fmaf(xs[3 * p + d], rinv * 0.5f, 0.5f) * (float)(R - 1);
        live |= ggs[3 * p + d] * coord_gradient(qpre, R, rinv, hi) != 0.0f;
      }
    }
    const unsigned bits = __ballot_sync(kFull, live);
    if (lane == 0) live_bits[ch] = bits;
  }
  __syncthreads();
  if (tid < 32) {
    int c = lane < W ? __popc(live_bits[lane]) : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, c, o);
      if (lane >= o) c += y;
    }
    if (lane < W) before[lane + 1] = c;
    if (lane == 0) before[0] = 0;
  }
  __syncthreads();
  for (int p = tid; p < np; p += B) {
    const unsigned b = live_bits[p >> 5], below = b & ((1u << (p & 31)) - 1u);
    if ((b >> (p & 31)) & 1u) ids[before[p >> 5] + __popc(below)] = p;
  }
  // the dead points' dL/dg rows: zero slabs over the span, coalesced
  if (dg != nullptr) {
    if constexpr (VEC) {
      const int S4 = CH / 4;
      float4* out = reinterpret_cast<float4*>(dg + n0 * CH);
      for (int j = tid; j < np * S4; j += B) {
        const int p = j / S4;
        if (!((live_bits[p >> 5] >> (p & 31)) & 1u)) out[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    } else {
      for (int j = tid; j < np * CH; j += B) {
        const int p = j / CH;
        if (!((live_bits[p >> 5] >> (p & 31)) & 1u)) dg[n0 * CH + j] = 0.0f;
      }
    }
  }
  __syncthreads();
  const int nl = before[W];
  // the live points, a lane group each (a lane a float4 slice): dL/dg, dL/dx;
  // a warp's groups take slots together, so its shuffles see every lane
  const int grp = tid / LP, s = tid % LP, G = B / LP;
  const int first = (tid & ~31) / LP;  // the warp's first group
  for (int base = first; base < nl; base += G) {
    const int slot = base + grp - first;
    const bool act = slot < nl;
    const int p = act ? ids[slot] : 0;
    const long long n = n0 + p;
    const float xv[3] = {xs[3 * p], xs[3 * p + 1], xs[3 * p + 2]};
    VoxelCell c;
    voxel_cell(xv, R, rinv, hi, c);
    float q[3], A[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      q[d] = coord_gradient(c.qpre[d], R, rinv, hi);
      A[d] = ggs[3 * p + d] * q[d];
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
    if (act) {
      if constexpr (RUN) {
        if (s == 0) {
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            om[8 * slot + k] = omega[k];
            rows[8 * slot + k] = c.rows[k];
          }
        }
      }
      for (int c0 = 4 * s; c0 < CH; c0 += 4 * LP) {
        const int nc = min(4, CH - c0);
        float4 gv = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (GX || ggrid != nullptr) gv = load_slice<VEC>(g + n * CH + c0, nc);
        if (RUN && ggrid != nullptr) store_slice<VEC>(gs + slot * CH + c0, gv, nc);
        float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float4 r = load_slice<VEC>(grid + (size_t)c.rows[k] * CH + c0, nc);
          acc = add4(acc, scale(omega[k], r));
          if constexpr (GX) {
            sk[k] = sk[k] + gv.x * r.x;
            sk[k] = sk[k] + gv.y * r.y;
            sk[k] = sk[k] + gv.z * r.z;
            sk[k] = sk[k] + gv.w * r.w;
          }
        }
        if constexpr (!RUN) {
          if (ggrid != nullptr && (gv.x != 0.0f || gv.y != 0.0f || gv.z != 0.0f || gv.w != 0.0f)) {
#pragma unroll
            for (int k = 0; k < 8; ++k)
              if (omega[k] != 0.0f) add_slice<VEC>(ggrid + (size_t)c.rows[k] * CH + c0, scale(omega[k], gv), nc);
          }
        }
        if (dg != nullptr) store_slice<VEC>(dg + n * CH + c0, acc, nc);
      }
    }
    if constexpr (GX) {
#pragma unroll
      for (int o = LP / 2; o > 0; o >>= 1) {
#pragma unroll
        for (int k = 0; k < 8; ++k) sk[k] = sk[k] + __shfl_xor_sync(kFull, sk[k], o);
      }
      if (act) {
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
          if (d % LP == s) dxs[3 * p + d] = hx[d] * q[d];
      }
    }
  }
  if constexpr (RUN) {
    // the grid gradient: a run of consecutive live points in one cell sums
    // omega_k g per corner in order and adds each corner's float4 once
    if (ggrid != nullptr) {
      __syncthreads();
      const auto head = [&](int i) { return i == 0 || rows[8 * i] != rows[8 * (i - 1)]; };
      const int c0 = 4 * s, nc = min(4, CH - c0);
      for (int h = grp; h < nl; h += G) {
        if (c0 >= CH || !head(h)) continue;
        CornerRun<VEC> run;
        for (int i = h; i == h || (i < nl && !head(i)); ++i) {
          const float4 gv = shared_slice<VEC>(gs + i * CH + c0, nc);
          run.add(ggrid, rows + 8 * h, gv, CH, c0, nc, [&](int k) { return om[8 * i + k]; });
        }
        run.flush(ggrid, CH, c0, nc);
      }
    }
  }
  if constexpr (GX) {
    __syncthreads();
    for (int j = tid; j < 3 * np; j += B) gx[3 * n0 + j] = dxs[j];  // the span's dL/dx, one slab
  }
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

// K10²'s spans; the runs' merged adds where a lane holds one slice, each
// point's adds past 32 channels (LP 8, more than one slice a lane).
// The live points' g rows take kK10xxSpan * CH floats of dynamic shared
// memory (at most 24 KB at 192 points and CH <= 32; with the static arrays
// under the 48 KB a block may use without opting in).
template <int LP, bool VEC, bool RUN, bool GX>
void launch_x_backward_spans(const float* x, const float* g, const float* ggx, const float* grid, long long N, int R,
                             int CH, float rinv, float hi, float* ggrid, float* gx, float* dg, cudaStream_t stream) {
  const unsigned int blocks = (unsigned int)((N + kK10xxSpan - 1) / kK10xxSpan);
  const size_t dynamic = RUN && ggrid ? sizeof(float) * kK10xxSpan * CH : 0;
  volume_grid_backward_x_backward_kernel<LP, VEC, RUN, GX><<<blocks, kK10xxThreads, dynamic, stream>>>(
      x, g, ggx, grid, N, R, CH, rinv, hi, ggrid, gx, dg);
}

template <int LP, bool VEC>
void launch_backward_x_backward(const float* x, const float* g, const float* ggx, const float* grid, long long N,
                                int R, int CH, float rinv, float hi, float* ggrid, float* gx, float* dg,
                                cudaStream_t stream) {
  if (LP < 8 || CH <= 4 * LP) {
    if (gx) launch_x_backward_spans<LP, VEC, true, true>(x, g, ggx, grid, N, R, CH, rinv, hi, ggrid, gx, dg, stream);
    else launch_x_backward_spans<LP, VEC, true, false>(x, g, ggx, grid, N, R, CH, rinv, hi, ggrid, gx, dg, stream);
  } else if constexpr (LP == 8) {
    if (gx) launch_x_backward_spans<LP, VEC, false, true>(x, g, ggx, grid, N, R, CH, rinv, hi, ggrid, gx, dg, stream);
    else launch_x_backward_spans<LP, VEC, false, false>(x, g, ggx, grid, N, R, CH, rinv, hi, ggrid, gx, dg, stream);
  }
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
