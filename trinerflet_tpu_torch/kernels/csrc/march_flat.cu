// K1f: the flat candidate march on the dt_gamma ladder, one warp per ray.
//
// Replaces trinerflet_tpu/ops/raymarch.py:290 march_candidates with
// dt_ladder (:228), _mip_level (:111) and, on the per-ray layout,
// compact_per_ray (:738, first_k_valid's spread ranks, :525). On the TPU
// every (ray, candidate) pair is materialised -- its distance, step, point,
// mip level and occupancy byte, (N, Kc) of each -- and the kept samples are
// chosen by a lane sort of the (N, Kc) validity.
//
// What bounds it on the H100: as K1, latency of dependent byte reads from
// the occupancy grid ((CAS, H^3) bytes, 6 MB at 3 x 128^3, resident in the
// 50 MB L2), plus one expf per candidate in the ladder's geometric phase;
// the bytes it must move are the rays in and the samples out (and, in
// candidate mode, 9 bytes per candidate out). Walked by one thread, a ray's
// candidates are a chain of dependent L2 latencies; a warp per ray makes
// them 32 at a time, and what is left is instruction issue.
//
// Design: a warp per ray. Every lane computes the ray's ladder in closed
// form -- the phase boundaries k1 and j2 once, then t(k) for any k, never
// by the recurrence, whose rounding would drift from the JAX package's ts.
// Round r: lane j tests candidate k = 32 r + j (t < far and occupied) and
// __ballot_sync gives the round's mask; the max_steps cap keeps the mask's
// first (max_steps - count) bits. The walk ends at the first round in which
// a candidate lies at or past far (t rises with k), at the cap, or at Kc.
// Per-ray mode (march_flat_launch) walks once: each round's mask and the
// count before it are kept in shared memory, and lane b (and b + 32, ...)
// of the (N, B) row finds its spread rank tgt_b = ceil(b * count / B) by a
// binary search of the counts and the n-th set bit of one mask, recomputes
// t and dt at that candidate and writes slot b, so a warp's stores are
// contiguous. ceil(b * count * (1/B)) in float32 can exceed the count by
// one (B 7: counts 11-15, 22-31; B 13: 14, 15, 26-31): the slot then takes
// the plain version's, the last candidate (k = Kc - 1) with mask 1. No
// (N, Kc) buffer, no sort. Candidate mode (march_candidates_launch) runs
// the same rounds to Kc and stores each round's 32 t, dt and capped
// validity bytes contiguously: the MarchResults that K5 packs for the exact
// global layout. The rays are read through their strides (a batch's rays
// are often a view), so the wrapper copies nothing.
//
// Exactness: compiled with -fmad=false; fmaf() exactly where jitted XLA
// fuses a*b + c where it tests the points (the ray start, t0 + dt_min k at
// dt_gamma = 0, s0 = t0 + k1 dt_min, the ladder's first and third phases,
// the point o + d t) and float32 reciprocals where it divides by a static
// constant. expf and logf are the functions torch.exp and torch.log call on
// the card, so t, dt, the masks and the counts equal the plain version's
// bit for bit. The cell's p / mip_bound is the true division's result by
// Markstein's correction, as in K1 (march.cu, occupied).

#include <cuda_runtime.h>
#include <stdint.h>

// warps (rays) a block: 4 in per-ray mode; 1 in candidate mode, whose rays
// all run to Kc (measured faster than 2 or 4: a block's slot frees as soon
// as its ray ends)
#define RAYS_PER_BLOCK 4
#define CANDIDATE_RAYS_PER_BLOCK 1
#define FULL 0xffffffffu

struct FlatArgs {
  int n_rays, num_steps, max_steps, budget, grid, cascades, words;
  float bound, gamma, dt_min, dt_max, A, B, inv_dt_min, lg, inv_lg, inv_budget;
  long long ro_s0, ro_s1, rd_s0, rd_s1;  // element strides of rays_o, rays_d
};

// a ray's ladder: its perturbed start t0 and, on the ladder (gamma > 0),
// the first index k1 of the geometric phase, its length j2, its start s0
// and the start t2 of the constant-dt_max phase
struct Ladder {
  float t0, k1, j2, s0, t2;
};

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ Ladder ladder_of(float near, float noise, const FlatArgs& a) {
  Ladder L;
  L.t0 = fmaf(clampf(near * a.gamma, a.dt_min, a.dt_max), noise, near);
  L.k1 = L.j2 = 0.0f;
  L.s0 = L.t2 = L.t0;
  if (a.gamma > 0.0f) {
    L.k1 = ceilf(fmaxf(a.A - L.t0, 0.0f) * a.inv_dt_min);
    L.s0 = fmaf(L.k1, a.dt_min, L.t0);
    L.j2 = ceilf(fmaxf(logf(fmaxf(a.B, L.s0) / L.s0), 0.0f) * a.inv_lg);
    L.t2 = L.s0 * expf(L.j2 * a.lg);
  }
  return L;
}

__device__ __forceinline__ float ladder_t(const Ladder& L, int k, const FlatArgs& a) {
  const float kf = (float)k;
  if (a.gamma == 0.0f) return fmaf(kf, a.dt_min, L.t0);
  if (kf < L.k1) return fmaf(kf, a.dt_min, L.t0);
  if (kf < L.k1 + L.j2) return L.s0 * expf(fmaxf(kf - L.k1, 0.0f) * a.lg);
  return fmaf(kf - L.k1 - L.j2, a.dt_max, L.t2);
}

__device__ __forceinline__ float ladder_dt(float t, const FlatArgs& a) {
  return a.gamma == 0.0f ? a.dt_min : clampf(t * a.gamma, a.dt_min, a.dt_max);
}

// Cell test of o + d*t (clipped to the bound) at step dt: the mip level is
// max(frexp exponent of max|p|, of dt*H/2) clamped to [0, CAS-1], the cell
// q = (int) clip(0.5 * (p / mip_bound + 1) * H, 0, H - 1). Both exponents
// are read from the floats' bits (each argument is at least 1e-30, a normal
// float); p / mip_bound is the true quotient by Markstein's correction
// (see march.cu's occupied).
__device__ __forceinline__ bool occupied(const uint8_t* __restrict__ grid, const float o[3],
                                         const float d[3], float t, float dt, float inv_bound,
                                         const FlatArgs& a) {
  float p[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) p[k] = clampf(fmaf(d[k], t, o[k]), -a.bound, a.bound);
  const float H = (float)a.grid;
  const float mx = fmaxf(fmaxf(fmaxf(fabsf(p[0]), fabsf(p[1])), fabsf(p[2])), 1e-30f);
  const int e_pos = (__float_as_int(mx) >> 23) - 126;
  const int e_dt = (__float_as_int(fmaxf(dt * H * 0.5f, 1e-30f)) >> 23) - 126;
  const int lvl = min(max(max(e_pos, e_dt), 0), a.cascades - 1);
  const float pow2 = __int_as_float((lvl + 127) << 23);
  const bool exact = pow2 <= a.bound;
  const float mip_bound = exact ? pow2 : a.bound;
  const float y = exact ? __int_as_float((127 - lvl) << 23) : inv_bound;
  unsigned int q[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float q1 = p[k] * y;
    const float u = fmaf(fmaf(-q1, mip_bound, p[k]), y, q1);
    q[k] = (unsigned int)clampf(0.5f * (u + 1.0f) * H, 0.0f, H - 1.0f);
  }
  const unsigned int g = (unsigned int)a.grid;
  return grid[((lvl * g + q[0]) * g + q[1]) * g + q[2]] != 0;
}

// rank (1-based) of the b-th kept entry (b 1-based) under the spread law
__device__ __forceinline__ int spread_target(int b, int count, int budget, float inv_budget) {
  if (count <= budget) return b;
  return (int)ceilf((float)b * (float)count * inv_budget);
}

// Position (0-based) of the n-th set bit (1-based n <= popc(w)) of w.
__device__ __forceinline__ int nth_bit(unsigned int w, int n) {
  int lo = 0;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    if (__popc(w & ((1u << (lo + s)) - 1u)) < n) lo += s;
  return lo;
}

// One round of a ray's walk: lane j tests candidate k = 32 r + j. Returns
// the round's valid mask under the cap (at most `room` bits, the first);
// *t_out, *dt_out are the lane's candidate's t and dt, *done whether the
// walk ends with this round (a candidate at or past far).
__device__ __forceinline__ unsigned int walk_round(const uint8_t* __restrict__ occ, const float o[3],
                                                   const float d[3], float far, const Ladder& L,
                                                   int r, int lane, int room, float inv_bound,
                                                   const FlatArgs& a, float* t_out, float* dt_out,
                                                   bool* done) {
  const int k = 32 * r + lane;
  const bool in = k < a.num_steps;
  const float t = ladder_t(L, k, a);
  const float dt = ladder_dt(t, a);
  const bool live = in && t < far;
  const bool v = live && occupied(occ, o, d, t, dt, inv_bound, a);
  unsigned int bal = __ballot_sync(FULL, v);
  if (__popc(bal) > room) bal &= (1u << nth_bit(bal, room + 1)) - 1u;
  *done = __ballot_sync(FULL, in && !live) != 0;
  *t_out = t;
  *dt_out = dt;
  return bal;
}

__global__ void __launch_bounds__(32 * RAYS_PER_BLOCK) march_flat_kernel(
    const float* __restrict__ rays_o, const float* __restrict__ rays_d, const float* __restrict__ nears,
    const float* __restrict__ fars, const float* __restrict__ noise, const uint8_t* __restrict__ occ,
    FlatArgs a, float* __restrict__ t_out, float* __restrict__ dt_out, uint8_t* __restrict__ mask_out,
    float* __restrict__ stride_out, float* __restrict__ t0_out) {
  // per warp: each round's valid mask, and the valid candidates before it
  extern __shared__ unsigned int smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = blockIdx.x * RAYS_PER_BLOCK + warp;
  if (n >= a.n_rays) return;  // the whole warp
  unsigned int* vmask = smem + warp * 2 * a.words;
  int* before = reinterpret_cast<int*>(vmask + a.words);
  const float o[3] = {rays_o[n * a.ro_s0], rays_o[n * a.ro_s0 + a.ro_s1],
                      rays_o[n * a.ro_s0 + 2 * a.ro_s1]};
  const float d[3] = {rays_d[n * a.rd_s0], rays_d[n * a.rd_s0 + a.rd_s1],
                      rays_d[n * a.rd_s0 + 2 * a.rd_s1]};
  const float far = fars[n];
  const Ladder L = ladder_of(nears[n], noise[n], a);
  const float inv_bound = 1.0f / a.bound;  // rounded to nearest

  int count = 0, rounds = 0;
  for (int r = 0; r < a.words; ++r) {
    float t, dt;
    bool done;
    const unsigned int bal =
        walk_round(occ, o, d, far, L, r, lane, a.max_steps - count, inv_bound, a, &t, &dt, &done);
    if (lane == 0) {
      vmask[r] = bal;
      before[r] = count;
    }
    count += __popc(bal);
    rounds = r + 1;
    if (done || count >= a.max_steps) break;
  }
  __syncwarp();

  const int kept = min(count, a.budget);
  float* t_row = t_out + (size_t)n * a.budget;
  float* dt_row = dt_out + (size_t)n * a.budget;
  uint8_t* m_row = mask_out + (size_t)n * a.budget;
  for (int b = lane; b < a.budget; b += 32) {
    float t = 0.0f, dt = 0.0f;
    if (b < kept) {
      const int tgt = spread_target(b + 1, count, a.budget, a.inv_budget);
      int k = a.num_steps - 1;  // a rank past the count: the last candidate
      if (tgt <= count) {       // the last round with fewer than tgt before it
        int lo = 0, hi = rounds - 1;
        while (lo < hi) {
          const int mid = (lo + hi + 1) >> 1;
          if (before[mid] < tgt) lo = mid;
          else hi = mid - 1;
        }
        k = 32 * lo + nth_bit(vmask[lo], tgt - before[lo]);
      }
      t = ladder_t(L, k, a);
      dt = ladder_dt(t, a);
    }
    t_row[b] = t;
    dt_row[b] = dt;
    m_row[b] = b < kept;
  }
  if (lane == 0) {
    stride_out[n] = count > a.budget ? (float)count * a.inv_budget : 1.0f;
    t0_out[n] = L.t0;
  }
}

__global__ void __launch_bounds__(32 * CANDIDATE_RAYS_PER_BLOCK) march_candidates_kernel(
    const float* __restrict__ rays_o, const float* __restrict__ rays_d, const float* __restrict__ nears,
    const float* __restrict__ fars, const float* __restrict__ noise, const uint8_t* __restrict__ occ,
    FlatArgs a, float* __restrict__ ts_out, float* __restrict__ dts_out,
    uint8_t* __restrict__ valid_out) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * CANDIDATE_RAYS_PER_BLOCK + (threadIdx.x >> 5);
  if (n >= a.n_rays) return;  // the whole warp
  const float o[3] = {rays_o[n * a.ro_s0], rays_o[n * a.ro_s0 + a.ro_s1],
                      rays_o[n * a.ro_s0 + 2 * a.ro_s1]};
  const float d[3] = {rays_d[n * a.rd_s0], rays_d[n * a.rd_s0 + a.rd_s1],
                      rays_d[n * a.rd_s0 + 2 * a.rd_s1]};
  const float far = fars[n];
  const Ladder L = ladder_of(nears[n], noise[n], a);
  const float inv_bound = 1.0f / a.bound;
  const size_t row = (size_t)n * a.num_steps;
  int count = 0;
  bool walking = true;  // past far, or past the cap, no candidate is valid: no grid read
  for (int r = 0; r < a.words; ++r) {
    const int k = 32 * r + lane;
    float t, dt;
    bool v = false;
    if (walking) {
      bool done;
      const unsigned int bal =
          walk_round(occ, o, d, far, L, r, lane, a.max_steps - count, inv_bound, a, &t, &dt, &done);
      v = (bal >> lane) & 1u;
      count += __popc(bal);
      walking = !done && count < a.max_steps;
    } else {
      t = ladder_t(L, k, a);
      dt = ladder_dt(t, a);
    }
    if (k < a.num_steps) {
      ts_out[row + k] = t;
      dts_out[row + k] = dt;
      valid_out[row + k] = v;
    }
  }
}

static FlatArgs flat_args(int n_rays, int num_steps, int max_steps, int budget, int grid,
                          int cascades, float bound, float gamma, float dt_min, float dt_max,
                          float A, float B, float inv_dt_min, float lg, float inv_lg,
                          float inv_budget, const long long* strides) {
  FlatArgs a = {n_rays, num_steps, max_steps, budget, grid, cascades, (num_steps + 31) / 32,
                bound, gamma, dt_min, dt_max, A, B, inv_dt_min, lg, inv_lg, inv_budget,
                strides[0], strides[1], strides[2], strides[3]};
  return a;
}

// rays_o/rays_d (N, 3) f32 with element strides (strides[0], strides[1]),
// (strides[2], strides[3]); nears/fars/noise (N,) f32; occ (CAS, H^3) bool
// bytes. Per-ray mode -> t (N, budget) f32, dt (N, budget) f32 (both 0 where
// masked), mask (N, budget) bool, stride (N,), t0 (N,).
extern "C" int march_flat_launch(const float* rays_o, const float* rays_d, const float* nears,
                                 const float* fars, const float* noise, const uint8_t* occ,
                                 int n_rays, int num_steps, int max_steps, int budget, int grid,
                                 int cascades, float bound, float gamma, float dt_min,
                                 float dt_max, float A, float B, float inv_dt_min, float lg,
                                 float inv_lg, float inv_budget, const long long* strides,
                                 float* t_out, float* dt_out, uint8_t* mask_out,
                                 float* stride_out, float* t0_out, cudaStream_t stream) {
  if (budget < 1 || num_steps < 1 || gamma < 0.0f) return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  const FlatArgs a = flat_args(n_rays, num_steps, max_steps, budget, grid, cascades, bound, gamma,
                               dt_min, dt_max, A, B, inv_dt_min, lg, inv_lg, inv_budget, strides);
  const size_t smem = sizeof(unsigned int) * 2 * (size_t)a.words * RAYS_PER_BLOCK;
  if (smem > 48 * 1024) {  // past Kc = 49,152 candidates a ray
    if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(march_flat_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  march_flat_kernel<<<(n_rays + RAYS_PER_BLOCK - 1) / RAYS_PER_BLOCK, 32 * RAYS_PER_BLOCK, smem,
                      stream>>>(rays_o, rays_d, nears, fars, noise, occ, a, t_out, dt_out, mask_out,
                                stride_out, t0_out);
  return (int)cudaGetLastError();
}

// Candidate mode -> ts (N, num_steps) f32, dts (N, num_steps) f32, valid
// (N, num_steps) bool (occupied, t < far, among the ray's first max_steps
// such). The last two pointers are unused (the launchers share a signature).
extern "C" int march_candidates_launch(const float* rays_o, const float* rays_d,
                                       const float* nears, const float* fars, const float* noise,
                                       const uint8_t* occ, int n_rays, int num_steps,
                                       int max_steps, int budget, int grid, int cascades,
                                       float bound, float gamma, float dt_min, float dt_max,
                                       float A, float B, float inv_dt_min, float lg, float inv_lg,
                                       float inv_budget, const long long* strides, float* ts_out,
                                       float* dts_out, uint8_t* valid_out, float* unused0,
                                       float* unused1, cudaStream_t stream) {
  if (num_steps < 1 || gamma < 0.0f) return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  const FlatArgs a = flat_args(n_rays, num_steps, max_steps, budget, grid, cascades, bound, gamma,
                               dt_min, dt_max, A, B, inv_dt_min, lg, inv_lg, inv_budget, strides);
  march_candidates_kernel<<<(n_rays + CANDIDATE_RAYS_PER_BLOCK - 1) / CANDIDATE_RAYS_PER_BLOCK,
                            32 * CANDIDATE_RAYS_PER_BLOCK, 0, stream>>>(
      rays_o, rays_d, nears, fars, noise, occ, a, ts_out, dts_out, valid_out);
  return (int)cudaGetLastError();
}
