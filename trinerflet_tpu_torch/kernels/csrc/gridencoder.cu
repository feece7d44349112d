// K7: multiresolution hash / tiled grid encoder, forward and table-gradient
// backward, all levels in one launch each.
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
// The function, per (point n, level l), as JAX computes it step by step:
// u = clip((x / bound + 1) * 0.5, 0, 1), pos = u * res, p0 = floor(pos),
// frac = pos - p0 (smoothstep: frac^2 (3 - 2 frac)); the 8 corners in
// meshgrid(..., indexing="ij") order (dimension 0 the most significant
// bit), each weight the product over d of frac or 1 - frac taken in d
// order, each corner coordinate clipped to [0, res]; the row index is dense,
// sum_d c_d (res+1)^d in uint32, while the dense level fits its table or the
// grid is tiled, else the spatial hash XOR_d c_d * prime_d (wrapping uint32,
// primes 1, 2654435761, 805459861); then index mod size. A level's size is
// either at least its dense count (the index is already below it) or
// exactly 2^log2_hashmap_size, so the modulo is the identity or a mask: the
// launcher passes wrap = size - 1 for a power-of-two size, else all ones.
// The corner rows are summed in corner order into out[n, l*C + c]
// (level-major, as jnp.concatenate(outs, -1)).
//
// Rounding: the JAX package runs grid_encode under jit, where XLA turns
// x / bound into x * f32(1 / bound) and fuses the + 1 into one fused
// multiply-add; one ulp there moves floor(pos) at a cell edge and changes
// all 8 corners. This file is compiled with -fmad=false and uses fmaf() at
// exactly that place, as the plain version (models/gridencoder.py) does; the
// forward gives the plain version's bits.
//
// Design, forward: a block takes a tile of 32 consecutive points and all L
// levels, one warp a level and one lane a point, so a warp holds
// neighbouring samples of one ray (the renderers lay a ray's samples out
// contiguously) at one level: its 32 gathers fall in one table, where
// neighbouring samples share cells and so rows and L1 lines, and each lane
// has exactly one (point, level), so every warp keeps its eight row loads
// in flight at once. The tile's points are read once, coalesced, into
// shared memory; its (32, L*C) outputs are staged in shared memory and
// written as one coalesced slab (written straight from the lanes they
// would be 32 rows L*C floats apart). No division per thread. Loading
// corners j and j + 4 as one 16-byte load where their rows share an
// aligned pair was measured and dropped: it took registers and time on
// the proposal and hash-grid steps.
//
// Backward: the same blocks, each lane reading its C-wide cotangent and its
// point straight from memory; a warp whose 32 rows carry no cotangent at
// its level returns at once. Each corner's term w * g is combined before it
// reaches memory: (1) at C <= 2 the terms of corners j and j + 4 go into
// one unit, the aligned row pair, whenever both rows lie in it; (2) lanes
// in a run of consecutive lanes that add to the same unit (a ray's samples
// in one cell) are summed by a segmented shuffle scan (fixed order within
// the warp) and the run's last lane adds the sum; (3) the add is one
// vector reduction, atomicAdd on a float2 (C = 1 pairs) or float4 (C = 2
// pairs, C = 4 rows; two for C = 8), instead of 8 C scalar float atomics a
// (point, level). Corners are computed a pair at a time, which keeps the
// registers down and the resident warps up. Units whose sum is zero add
// nothing: the gradient tables are zeroed by the caller and never hold -0,
// so adding zero changes no bit. The order of the float atomics across
// warps is unspecified; every entry stays a float32 sum of the same terms,
// within the float-summation bound (models/gridencoder.py
// grid_encode_backward_error).
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
// and (N, 3) out); about 30 flops per corner and channel. Rounding: each
// term and the level sum are the plain version's, operation by operation,
// a level without cotangent skipped where the plain version adds zero, and
// the channel sum g . row runs in channel order: at C <= 2, where that is
// the only order, dx is the plain version's bits. The forward's layout (a
// warp per (32-point tile, level), cotangents and level terms staged in
// shared memory, the levels summed in order after a barrier) was measured
// and dropped: ~1.6x the instructions, and 0.097 ms against this loop's
// 0.094 on a registry-hash-normals chunk (scripts/torch_k7x_k11_timing.py).
//
// K7x², the backward of K7x (replaces JAX's autodiff of grid_encode twice,
// trinerflet_tpu/models/gridencoder.py:115-147, which training through an
// analytic normal on a hash-grid field takes: models/registry.py:443 under
// jax.value_and_grad). Given the cotangent gg of dL/dx, per level with A_d =
// gg_d clip'(u_d) 0.5 / bound, f the fraction (smoothstep applied), f', f''
// its derivatives in the linear fraction, c_d = A_d f'_d res and omega_k =
// sum_d c_d dw_k/df_d (a corner weight's derivative along gg):
//   dL/dg_l = sum_k omega_k T[idx_k];  dL/dT[idx_k] += omega_k g_l;
//   dL/dx_e += (sum_{d != e} c_d sum_k s_k d2w_k/df_d df_e f'_e
//               + A_e res f''_e sum_k s_k dw_k/df_e) res clip'(u_e) 0.5 / bound,
// s_k = g_l . T[idx_k] (the trilinear weights' d2w/df_d^2 is 0; f'' is
// 6 - 12 t under smoothstep, 0 for linear). Bound: bytes (gg and the points
// in; g and the corner rows of the points whose A is not zero; dL/dg and
// dL/dx out, the touched rows of the table gradient updated); about 60
// flops per corner. On a training step most points are masked samples (gg
// reaches ~18% of them, spread over every tile) and the table terms are 8 C
// float atomics a (point, level), which held half of the first design's
// time (a thread per point over the levels: scalar atomics, g read and
// dL/dg written 4 L C bytes apart across a warp, dead lanes idle beside
// live ones walking 16 levels). Design: a block per span of 128
// consecutive points (K7XX_SPAN), their points and gg staged in shared
// memory, the live ones (A not zero) ranked in order by ballots and taken
// in tiles of 32, a warp a level and a lane a point, as the K7 backward
// lays out its work; their g rows read a row a warp (coalesced) into shared
// memory, where each lane's dL/dg replaces its g; the table terms omega_k g
// go, before the row loads (they need no row), through the K7 backward's
// scatter_corners (row pairs, runs of lanes on one unit summed by the
// segmented scan, one float2 / float4 atomic a run); each warp stores its
// level's dL/dx terms, and after a barrier they are summed in level order,
// as the first design's loop summed them. Then the span's dL/dg and dL/dx
// go out as slabs (zeros for the points that are not live). Every term,
// dL/dg and dL/dx are the first design's operation by operation; the table
// gradient is a float32 sum of the same terms in another order. Measured
// and kept out: spans of 32, 64, 256 and 512 points (128 was fastest), a
// register cap for more resident warps (spills), the scatter after the row
// loads; the scatter's adds themselves cost little, its merging most.

#include <cuda_runtime.h>
#include <stdint.h>

#define K7_MAX_LEVELS 32
#define K7_TILE 32  // points a block, one a lane; a warp a level

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

// The table row of corner k (dimension 0 its most significant bit) of cell
// p0 at level l.
__device__ __forceinline__ uint32_t corner_row(const uint32_t p0[3], int k, int l, const GridLevels& lv) {
  const uint32_t res = lv.res[l], s1 = res + 1u;
  const int b0 = (k >> 2) & 1, b1 = (k >> 1) & 1, b2 = k & 1;
  const uint32_t c0 = min(p0[0] + b0, res), c1 = min(p0[1] + b1, res), c2 = min(p0[2] + b2, res);
  const uint32_t h = lv.hashed[l] ? (c0 ^ (c1 * 2654435761u) ^ (c2 * 805459861u)) : (c0 + c1 * s1 + c2 * (s1 * s1));
  return h & lv.wrap[l];
}

// The table rows of the 8 corners of cell p0 at level l.
__device__ __forceinline__ void corner_rows(const uint32_t p0[3], int l, const GridLevels& lv,
                                            uint32_t idx[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) idx[k] = corner_row(p0, k, l, lv);
}

// The weight of corner k: the product over d of frac or 1 - frac, in d order.
__device__ __forceinline__ float corner_weight(const float frac[3], int k) {
  const int b0 = (k >> 2) & 1, b1 = (k >> 1) & 1, b2 = k & 1;
  float wk = b0 ? frac[0] : 1.0f - frac[0];
  wk = wk * (b1 ? frac[1] : 1.0f - frac[1]);
  return wk * (b2 ? frac[2] : 1.0f - frac[2]);
}

// The clipped unit coordinates of one point.
__device__ __forceinline__ void unit_point(const float* xp, float inv_bound, float u[3]) {
#pragma unroll
  for (int d = 0; d < 3; ++d) u[d] = fminf(fmaxf(unit_coord(xp[d], inv_bound), 0.0f), 1.0f);
}

// The cell corner p0 and the interpolation fractions (smoothstep applied)
// at level l of a point with clipped unit coordinates u.
__device__ __forceinline__ void level_cell(const float u[3], int l, const GridLevels& lv, int smooth,
                                           float frac[3], uint32_t p0[3]) {
  const float fres = (float)lv.res[l];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    float fr = cell(u[d], fres, &p0[d]);
    if (smooth) fr = fr * fr * (3.0f - 2.0f * fr);
    frac[d] = fr;
  }
}

// One table row of C floats, through the read-only data path.
template <int C>
__device__ __forceinline__ void ldg_row(const float* __restrict__ r, float* v) {
  if constexpr (C == 1) {
    v[0] = __ldg(r);
  } else if constexpr (C == 2) {
    const float2 q = __ldg(reinterpret_cast<const float2*>(r));
    v[0] = q.x;
    v[1] = q.y;
  } else {
#pragma unroll
    for (int k = 0; k < C / 4; ++k) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(r) + k);
      v[4 * k] = q.x;
      v[4 * k + 1] = q.y;
      v[4 * k + 2] = q.z;
      v[4 * k + 3] = q.w;
    }
  }
}

// The 8 corner rows of one level into v[k * C + c].
template <int C>
__device__ __forceinline__ void gather_corners(const float* __restrict__ table, const uint32_t idx[8],
                                               float* v) {
#pragma unroll
  for (int k = 0; k < 8; ++k) ldg_row<C>(table + (size_t)idx[k] * C, v + k * C);
}

// np rows of W floats from shared rows of stride S to consecutive global
// floats, the block's threads on consecutive floats.
__device__ __forceinline__ void write_slab(const float* sh, float* gl, int np, int W, int S) {
  int p = threadIdx.x / W, c = threadIdx.x - p * W;
  const int dp = blockDim.x / W, dc = blockDim.x - dp * W;
  for (int j = threadIdx.x; j < np * W; j += blockDim.x) {
    gl[j] = sh[p * S + c];
    c += dc;
    p += dp;
    if (c >= W) {
      c -= W;
      ++p;
    }
  }
}

// The tile's points into shared memory (coalesced).
__device__ __forceinline__ void tile_points(const float* __restrict__ x, long long n0, int np, float* xs) {
  for (int j = threadIdx.x; j < 3 * np; j += blockDim.x) xs[j] = x[3 * n0 + j];
}

// A block: K7_TILE consecutive points (one a lane) x L levels (one a warp).
// The bounds' minimum of one block an SM is there by measurement: with it
// ptxas gives the C = 2 kernel 39 registers instead of 32, and the build
// with 32 was slower than the one-thread-per-(point, level) design on the
// proposal step (why is not visible without a per-instruction profile;
// scripts/torch_k7_timing.py --sass prints the count).
template <int C>
__global__ void __launch_bounds__(K7_TILE * K7_MAX_LEVELS, 1) grid_encode_kernel(
    const float* __restrict__ x, long long N, int L, GridLevels lv, float inv_bound, int smooth,
    float* __restrict__ out) {
  extern __shared__ float sm[];
  const int LC = L * C, S = LC | 1;  // odd stride: a warp's rows in distinct banks
  float* xs = sm;                    // (K7_TILE, 3) the tile's points
  float* os = sm + 3 * K7_TILE;      // (K7_TILE, S) their features
  const long long n0 = (long long)blockIdx.x * K7_TILE;
  const int np = (int)min((long long)K7_TILE, N - n0);
  const int l = threadIdx.x >> 5, p = threadIdx.x & 31;
  tile_points(x, n0, np, xs);
  __syncthreads();
  if (p < np) {
    float u[3], frac[3], w[8], v[8 * C];
    uint32_t p0[3], idx[8];
    unit_point(xs + 3 * p, inv_bound, u);
    level_cell(u, l, lv, smooth, frac, p0);
#pragma unroll
    for (int k = 0; k < 8; ++k) w[k] = corner_weight(frac, k);
    corner_rows(p0, l, lv, idx);
    gather_corners<C>(lv.table[l], idx, v);
    float* o = os + p * S + l * C;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < 8; ++k) acc = acc + w[k] * v[k * C + c];
      o[c] = acc;
    }
  }
  __syncthreads();
  write_slab(os, out + n0 * LC, np, LC, S);
}

// v[0..U) += into the unit at p: one vector reduction (two for U = 8).
template <int U>
__device__ __forceinline__ void add_unit(float* p, const float* v) {
  if constexpr (U == 2) {
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  } else {
#pragma unroll
    for (int k = 0; k < U / 4; ++k)
      atomicAdd(reinterpret_cast<float4*>(p) + k, make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]));
  }
}

// One unit a lane (key: its first row): lanes whose unit sum is zero add
// nothing; runs of consecutive adding lanes with the same key are summed by
// a segmented inclusive shuffle scan, and each run's last lane adds the sum.
template <int C, int U>
__device__ __forceinline__ void merge_and_add(float* table, uint32_t key, float* v, int lane) {
  const unsigned FULL = 0xffffffffu;
  bool adds = false;
#pragma unroll
  for (int e = 0; e < U; ++e) adds |= v[e] != 0.0f;
  const unsigned adders = __ballot_sync(FULL, adds);
  if (adders == 0) return;
  const uint32_t left = __shfl_up_sync(FULL, key, 1);
  const unsigned conts = __ballot_sync(FULL, lane > 0 && adds && ((adders >> (lane - 1)) & 1u) && left == key);
  bool last = adds;
  if (conts) {  // some lane continues its left neighbour's run
    const unsigned heads = ~conts, upto = FULL >> (31 - lane);  // lanes 0..lane
    const int start = 31 - __clz(heads & upto);
    const unsigned after = heads & ~upto;
    const int end = after ? __ffs(after) - 1 : 32;
    const unsigned span = __reduce_max_sync(FULL, (unsigned)(end - start));
    for (int o = 1; o < (int)span; o <<= 1) {
#pragma unroll
      for (int e = 0; e < U; ++e) {
        const float y = __shfl_up_sync(FULL, v[e], o);
        if (lane - o >= start) v[e] = y + v[e];
      }
    }
    last = adds && end - 1 == lane;
  }
  if (last) add_unit<U>(table + (size_t)key * C, v);
}

// A term a (C floats) of row i into its unit: at C <= 2 the aligned row
// pair (the other row's half zero), else the row.
template <int C, int U>
__device__ __forceinline__ void place(const float* a, uint32_t i, float* v) {
  if constexpr (U == 2 * C) {
    const bool odd = (i & 1u) != 0;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      v[c] = odd ? 0.0f : a[c];
      v[C + c] = odd ? a[c] : 0.0f;
    }
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = a[c];
  }
}

// The 8 corner terms weight(k) g of one (point, level) into the gradient
// table (the K7 backward's weights w_k, K7x²'s omega_k): corners j and j + 4
// share a unit where they can, then each unit is merged across the warp and
// added. Every lane of the warp calls it; a lane with g = 0 adds nothing.
template <int C, typename Weight>
__device__ __forceinline__ void scatter_corners(float* table, const uint32_t p0[3], int l, const GridLevels& lv,
                                                const float* gv, int lane, Weight weight) {
  constexpr int U = C <= 2 ? 2 * C : C;
  constexpr uint32_t KEY = U == 2 * C ? ~1u : ~0u;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t i0 = corner_row(p0, j, l, lv), i1 = corner_row(p0, j + 4, l, lv);
    const float w0 = weight(j), w1 = weight(j + 4);
    float a0[C], a1[C], va[U], vb[U];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      a0[c] = w0 * gv[c];
      a1[c] = w1 * gv[c];
    }
    const uint32_t k0 = i0 & KEY, k1 = i1 & KEY;
    place<C, U>(a0, i0, va);
    place<C, U>(a1, i1, vb);
    const bool one = k0 == k1;
    if (one) {
#pragma unroll
      for (int e = 0; e < U; ++e) {
        va[e] = va[e] + vb[e];
        vb[e] = 0.0f;
      }
    }
    merge_and_add<C, U>(table, k0, va, lane);
    merge_and_add<C, U>(table, k1, vb, lane);
  }
}

// A block: K7_TILE consecutive points (one a lane) x L levels (one a warp).
template <int C>
__global__ void __launch_bounds__(K7_TILE * K7_MAX_LEVELS) grid_encode_backward_kernel(
    const float* __restrict__ x, const float* __restrict__ g, long long N, int L, GridLevels lv,
    float inv_bound, int smooth) {
  const long long n = (long long)blockIdx.x * K7_TILE + (threadIdx.x & 31);
  const int l = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float gv[C];
  bool live = false;
#pragma unroll
  for (int c = 0; c < C; ++c) gv[c] = 0.0f;
  if (n < N) ldg_row<C>(g + (n * L + l) * C, gv);
#pragma unroll
  for (int c = 0; c < C; ++c) live |= gv[c] != 0.0f;
  if (!__any_sync(0xffffffffu, live)) return;  // no cotangent in this warp's rows
  float u[3] = {0.0f, 0.0f, 0.0f}, frac[3];
  uint32_t p0[3];
  if (n < N) unit_point(x + 3 * n, inv_bound, u);
  level_cell(u, l, lv, smooth, frac, p0);
  const auto w = [&](int k) { return corner_weight(frac, k); };
  scatter_corners<C>(lv.table[l], p0, l, lv, gv, lane, w);
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
      ldg_row<C>(table + (size_t)idx[k] * C, v);
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

// omega_k = sum_d c_d dw_k/df_d: corner k's weight's derivative along gg.
__device__ __forceinline__ float corner_omega(const float frac[3], const float cd[3], int k) {
  const int b0 = (k >> 2) & 1, b1 = (k >> 1) & 1, b2 = k & 1;
  const float f0 = b0 ? frac[0] : 1.0f - frac[0], f1 = b1 ? frac[1] : 1.0f - frac[1];
  const float f2 = b2 ? frac[2] : 1.0f - frac[2];
  return cd[0] * ((b0 ? 1.0f : -1.0f) * (f1 * f2)) + cd[1] * ((b1 ? 1.0f : -1.0f) * (f0 * f2)) +
         cd[2] * ((b2 ? 1.0f : -1.0f) * (f0 * f1));
}

// K7x²: a block per span of K7XX_SPAN consecutive points. Its points whose
// A is not zero (live) are compacted in order into tiles of 32, and each live
// tile is taken a warp a level, a lane a point. Shared memory holds the
// span's points and gg, the live points' g rows (then, in place, their dL/dg
// rows), their dL/dx and one tile's level terms. grads.table[l] is the
// level's gradient table (want_t); dx and dg may be null.
#define K7XX_SPAN 128  // points a block: four 32-point tiles

static size_t k7xx_shared_bytes(int L, int C) {
  return sizeof(float) * ((size_t)K7XX_SPAN * (9 + ((L * C) | 1)) + 3 * K7_TILE * L) +
         sizeof(int) * (2 * K7XX_SPAN + K7XX_SPAN / 32 + 1);
}

template <int C>
__global__ void __launch_bounds__(K7_TILE * K7_MAX_LEVELS) grid_encode_backward_x_backward_kernel(
    const float* __restrict__ x, const float* __restrict__ g, const float* __restrict__ ggx, long long N, int L,
    GridLevels lv, GridLevels grads, int want_t, float inv_bound, int smooth, float* __restrict__ dx,
    float* __restrict__ dg) {
  constexpr int P = K7XX_SPAN, TILES = P / 32;
  extern __shared__ float sm[];
  const int LC = L * C, S = LC | 1;  // odd stride: a warp's rows in distinct banks
  float* xs = sm;                     // (P, 3) the span's points
  float* ggs = xs + 3 * P;            // (P, 3) their gg
  float* gs = ggs + 3 * P;            // (P, S) the live points' g, then their dL/dg, by slot
  float* dxs = gs + P * S;            // (P, 3) the live points' dL/dx, by slot
  float* terms = dxs + 3 * P;         // (L, 32, 3) one live tile's level terms
  int* slot_of = reinterpret_cast<int*>(terms + 3 * K7_TILE * L);  // (P,) a point's slot, or -1
  int* ids = slot_of + P;                                          // (P,) a slot's point
  int* tile_live = ids + P;                                        // (TILES + 1,) live points before each tile
  const long long n0 = (long long)blockIdx.x * P;
  const int np = (int)min((long long)P, N - n0);
  const int l = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  for (int j = threadIdx.x; j < 3 * np; j += blockDim.x) {
    xs[j] = x[3 * n0 + j];
    ggs[j] = ggx[3 * n0 + j];
  }
  __syncthreads();
  // the span's live points, ranked in order by ballots
  auto coeffs = [&](int p, float u[3], float q[3], float A[3]) {
    bool live = false;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float v = unit_coord(xs[3 * p + d], inv_bound);
      u[d] = fminf(fmaxf(v, 0.0f), 1.0f);
      const float cg = (v > 0.0f && v < 1.0f) ? 1.0f : ((v == 0.0f || v == 1.0f) ? 0.5f : 0.0f);
      q[d] = cg * 0.5f * inv_bound;
      A[d] = ggs[3 * p + d] * q[d];
      live |= A[d] != 0.0f;
    }
    return live;
  };
  for (int t = l; t < TILES; t += warps) {
    const int p = t * 32 + lane;
    float u[3], q[3], A[3];
    const bool live = p < np && coeffs(p, u, q, A);
    const unsigned bits = __ballot_sync(0xffffffffu, live);
    if (lane == 0) tile_live[t] = __popc(bits);
    slot_of[p] = live ? -2 - __popc(bits & ((1u << lane) - 1u)) : -1;  // rank within the tile, for now
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int run = 0;
    for (int t = 0; t < TILES; ++t) {
      const int c = tile_live[t];
      tile_live[t] = run;
      run += c;
    }
    tile_live[TILES] = run;
  }
  __syncthreads();
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    const int r = slot_of[p];
    if (r <= -2) {
      const int s = tile_live[p >> 5] + (-2 - r);
      slot_of[p] = s;
      ids[s] = p;
    }
  }
  const int nl = tile_live[TILES];
  __syncthreads();
  // the live points' g rows, a row a warp (coalesced)
  for (int s = l; s < nl; s += warps)
    for (int c = lane; c < LC; c += 32) gs[s * S + c] = g[(n0 + ids[s]) * LC + c];
  __syncthreads();
  for (int t0 = 0; t0 < nl; t0 += 32) {
    const int slot = t0 + lane;
    const bool active = slot < nl;
    float gv[C], dgl[C], term[3] = {0.0f, 0.0f, 0.0f};
    float u[3], q[3], A[3], frac[3] = {0.0f, 0.0f, 0.0f}, dfrac[3], ddfrac[3], cd[3] = {0.0f, 0.0f, 0.0f};
    uint32_t p0[3] = {0u, 0u, 0u};
    const float fres = (float)lv.res[l];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      gv[c] = active ? gs[slot * S + l * C + c] : 0.0f;
      dgl[c] = 0.0f;
    }
    if (active) {
      coeffs(ids[slot], u, q, A);
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const float lin = cell(u[d], fres, &p0[d]);
        frac[d] = smooth ? lin * lin * (3.0f - 2.0f * lin) : lin;
        dfrac[d] = smooth ? 6.0f * lin * (1.0f - lin) : 1.0f;
        ddfrac[d] = smooth ? 6.0f - 12.0f * lin : 0.0f;
        cd[d] = A[d] * dfrac[d] * fres;
      }
    }
    // the table terms omega_k g first: they read no table row, and the row
    // loads below then have the registers to themselves
    if (want_t) {
      const auto w = [&](int k) { return corner_omega(frac, cd, k); };
      scatter_corners<C>(grads.table[l], p0, l, lv, gv, lane, w);
    }
    if (active) {
      uint32_t idx[8];
      corner_rows(p0, l, lv, idx);
      float v[C <= 2 ? 8 * C : 1];  // C <= 2: the 8 rows loaded at once; wider rows one corner at a time
      if constexpr (C <= 2) gather_corners<C>(lv.table[l], idx, v);
      float dw[3] = {0.0f, 0.0f, 0.0f}, hx[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int b[3] = {(k >> 2) & 1, (k >> 1) & 1, k & 1};
        float fac[3], sg[3];
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          fac[d] = b[d] ? frac[d] : 1.0f - frac[d];
          sg[d] = b[d] ? 1.0f : -1.0f;
        }
        const float dwk[3] = {sg[0] * (fac[1] * fac[2]), sg[1] * (fac[0] * fac[2]), sg[2] * (fac[0] * fac[1])};
        const float omega = corner_omega(frac, cd, k);
        float r[C];
        if constexpr (C <= 2) {
#pragma unroll
          for (int c = 0; c < C; ++c) r[c] = v[k * C + c];
        } else {
          ldg_row<C>(lv.table[l] + (size_t)idx[k] * C, r);
        }
        float s = 0.0f;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          dgl[c] = dgl[c] + omega * r[c];
          s = s + gv[c] * r[c];
        }
#pragma unroll
        for (int e = 0; e < 3; ++e) {
          dw[e] = dw[e] + s * dwk[e];
#pragma unroll
          for (int d = 0; d < 3; ++d) {
            if (d == e) continue;
            hx[e] = hx[e] + cd[d] * s * (sg[d] * sg[e] * fac[3 - d - e]);
          }
        }
      }
#pragma unroll
      for (int e = 0; e < 3; ++e) term[e] = (hx[e] * dfrac[e] + A[e] * fres * ddfrac[e] * dw[e]) * fres * q[e];
#pragma unroll
      for (int c = 0; c < C; ++c) gs[slot * S + l * C + c] = dgl[c];
    }
#pragma unroll
    for (int e = 0; e < 3; ++e) terms[(l * 32 + lane) * 3 + e] = term[e];
    __syncthreads();
    // dL/dx: the tile's level terms summed in level order
    for (int j = threadIdx.x; j < 96; j += blockDim.x) {
      const int s = t0 + j / 3;
      if (s < nl) {
        float acc = 0.0f;
        for (int k = 0; k < L; ++k) acc = acc + terms[k * 96 + j];
        dxs[3 * s + j % 3] = acc;
      }
    }
    __syncthreads();
  }
  // the span's dL/dg and dL/dx, zeros for the points that are not live (coalesced)
  if (dg != nullptr) {
    int p = threadIdx.x / LC, c = threadIdx.x - p * LC;
    const int dp = blockDim.x / LC, dc = blockDim.x - dp * LC;
    for (int j = threadIdx.x; j < np * LC; j += blockDim.x) {
      const int s = slot_of[p];
      dg[n0 * LC + j] = s >= 0 ? gs[s * S + c] : 0.0f;
      c += dc;
      p += dp;
      if (c >= LC) {
        c -= LC;
        ++p;
      }
    }
  }
  if (dx != nullptr)
    for (int j = threadIdx.x; j < 3 * np; j += blockDim.x) {
      const int s = slot_of[j / 3];
      dx[3 * n0 + j] = s >= 0 ? dxs[3 * s + j % 3] : 0.0f;
    }
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

// Shared memory of a K7 block: its points and their L * C floats.
static size_t tile_bytes(int L, int C) {
  return (size_t)(3 + ((L * C) | 1)) * K7_TILE * sizeof(float);
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
  const unsigned int blocks = (unsigned int)((N + K7_TILE - 1) / K7_TILE), threads = K7_TILE * L;
  const size_t sh = tile_bytes(L, C);
  switch (C) {
    case 1: grid_encode_kernel<1><<<blocks, threads, sh, stream>>>(x, N, L, lv, inv_bound, smooth, out); break;
    case 2: grid_encode_kernel<2><<<blocks, threads, sh, stream>>>(x, N, L, lv, inv_bound, smooth, out); break;
    case 4: grid_encode_kernel<4><<<blocks, threads, sh, stream>>>(x, N, L, lv, inv_bound, smooth, out); break;
    case 8: grid_encode_kernel<8><<<blocks, threads, sh, stream>>>(x, N, L, lv, inv_bound, smooth, out); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// x (N, 3) f32, g (N, L*C) f32 -> adds w * g into the L gradient tables
// (size_l, C) f32, which the caller zeroes. Each table must be aligned to
// its units (8 bytes at C = 1, else 16) and, at C <= 2, hold an even
// number of rows (a pair's second row may be a padding row, which receives
// zeros only). The order of the float atomics is unspecified.
extern "C" int grid_encode_backward_launch(const float* x, const float* g, long long N, int L, int C,
                                           void* const* grads, const uint32_t* res,
                                           const uint32_t* wrap, const int* hashed,
                                           float inv_bound, int smooth, cudaStream_t stream) {
  GridLevels lv;
  int err = fill_levels(&lv, L, grads, res, wrap, hashed);
  if (err) return err;
  for (int l = 0; l < L; ++l)
    if ((uintptr_t)grads[l] % (C == 1 ? 8 : 16)) return (int)cudaErrorMisalignedAddress;
  if (N == 0) return 0;
  const unsigned int blocks = (unsigned int)((N + K7_TILE - 1) / K7_TILE), threads = K7_TILE * L;
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

// K7x². x (N, 3) f32, g (N, L*C) f32 (K7x's cotangent), ggx (N, 3) f32 (the
// cotangent of K7x's dx), the L tables (size_l, C) f32 -> dx (N, 3) f32 and
// dg (N, L*C) f32, every row written (either null: not computed), and, when
// grads is not null, adds into the L gradient tables (size_l, C) f32, which
// the caller zeroes (float atomics in an unspecified order).
extern "C" int grid_encode_backward_x_backward_launch(const float* x, const float* g, const float* ggx, long long N,
                                                      int L, int C, void* const* tables, const uint32_t* res,
                                                      const uint32_t* wrap, const int* hashed, float inv_bound,
                                                      int smooth, float* dx, float* dg, void* const* grads,
                                                      cudaStream_t stream) {
  GridLevels lv, gl{};
  int err = fill_levels(&lv, L, tables, res, wrap, hashed);
  if (err) return err;
  if (grads != nullptr && (err = fill_levels(&gl, L, grads, res, wrap, hashed))) return err;
  if (N == 0) return 0;
  const int want_t = grads != nullptr;
  if (want_t)
    for (int l = 0; l < L; ++l)
      if ((uintptr_t)grads[l] % (C == 1 ? 8 : 16)) return (int)cudaErrorMisalignedAddress;
  const unsigned int blocks = (unsigned int)((N + K7XX_SPAN - 1) / K7XX_SPAN), threads = K7_TILE * L;
  const size_t sh = k7xx_shared_bytes(L, C);
#define K7XX(CC)                                                                                         \
  case CC:                                                                                               \
    if (sh > 48 * 1024)                                                                                  \
      cudaFuncSetAttribute(grid_encode_backward_x_backward_kernel<CC>,                                     \
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sh);                        \
    grid_encode_backward_x_backward_kernel<CC><<<blocks, threads, sh, stream>>>(x, g, ggx, N, L, lv, gl, want_t, \
                                                                                inv_bound, smooth, dx, dg); \
    break;
  switch (C) {
    K7XX(1)
    K7XX(2)
    K7XX(4)
    K7XX(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef K7XX
  return (int)cudaGetLastError();
}
