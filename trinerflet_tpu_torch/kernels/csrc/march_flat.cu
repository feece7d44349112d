// K1f: the flat candidate march on the dt_gamma ladder, one thread per ray.
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
// candidate mode, 9 bytes per candidate out).
//
// Design: each thread computes its ray's ladder in closed form -- the phase
// boundaries k1 and j2 once, then t(k) for any k, never by the recurrence,
// whose rounding would drift from the JAX package's ts -- and walks k.
// Per-ray mode (march_flat_launch): pass 1 counts the valid candidates,
// stopping at far (t rises with k) or at the max_steps cap; pass 2 walks
// again and writes the spread ranks tgt_b = ceil(b * count / B) straight
// into the (N, B) outputs. No (N, Kc) buffer, no sort. Candidate mode
// (march_candidates_launch): one pass writes every candidate's t, dt and
// capped validity, the MarchResults that K5 packs for the exact global
// layout.
//
// Exactness: compiled with -fmad=false; fmaf() exactly where jitted XLA
// fuses a*b + c where it tests the points (the ray start, t0 + dt_min k at
// dt_gamma = 0, s0 = t0 + k1 dt_min, the ladder's first and third phases,
// the point o + d t) and float32 reciprocals where it divides by a static
// constant. expf and logf are the functions torch.exp and torch.log call on
// the card, so t, dt, the masks and the counts equal the plain version's
// bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

struct FlatArgs {
  int n_rays, num_steps, max_steps, budget, grid, cascades;
  float bound, gamma, dt_min, dt_max, A, B, inv_dt_min, lg, inv_lg, inv_budget;
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
// q = (int) clip(0.5 * (p / mip_bound + 1) * H, 0, H - 1).
__device__ __forceinline__ bool occupied(const uint8_t* __restrict__ grid, const float o[3],
                                         const float d[3], float t, float dt, const FlatArgs& a) {
  float p[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) p[k] = clampf(fmaf(d[k], t, o[k]), -a.bound, a.bound);
  const float H = (float)a.grid;
  float mx = fmaxf(fmaxf(fabsf(p[0]), fabsf(p[1])), fabsf(p[2]));
  int e_pos, e_dt;
  frexpf(fmaxf(mx, 1e-30f), &e_pos);
  frexpf(fmaxf(dt * H * 0.5f, 1e-30f), &e_dt);
  int lvl = min(max(max(e_pos, e_dt), 0), a.cascades - 1);
  float mip_bound = fminf(ldexpf(1.0f, lvl), a.bound);
  int q[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) q[k] = (int)clampf(0.5f * (p[k] / mip_bound + 1.0f) * H, 0.0f, H - 1.0f);
  long long idx = (((long long)lvl * a.grid + q[0]) * a.grid + q[1]) * a.grid + q[2];
  return grid[idx] != 0;
}

// rank (1-based) of the b-th kept entry (b 1-based) under the spread law
__device__ __forceinline__ int spread_target(int b, int count, int budget, float inv_budget) {
  if (count <= budget) return b;
  return (int)ceilf((float)b * (float)count * inv_budget);
}

__global__ void march_flat_kernel(const float* __restrict__ rays_o, const float* __restrict__ rays_d,
                                  const float* __restrict__ nears, const float* __restrict__ fars,
                                  const float* __restrict__ noise, const uint8_t* __restrict__ occ,
                                  FlatArgs a, float* __restrict__ t_out, float* __restrict__ dt_out,
                                  uint8_t* __restrict__ mask_out, float* __restrict__ stride_out,
                                  float* __restrict__ t0_out) {
  int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= a.n_rays) return;
  const float o[3] = {rays_o[3 * n], rays_o[3 * n + 1], rays_o[3 * n + 2]};
  const float d[3] = {rays_d[3 * n], rays_d[3 * n + 1], rays_d[3 * n + 2]};
  const float far = fars[n];
  const Ladder L = ladder_of(nears[n], noise[n], a);

  // pass 1: valid candidates, capped at max_steps
  int count = 0;
  for (int k = 0; k < a.num_steps && count < a.max_steps; ++k) {
    float t = ladder_t(L, k, a);
    if (!(t < far)) break;
    if (occupied(occ, o, d, t, ladder_dt(t, a), a)) ++count;
  }
  // pass 2: the spread ranks' t and dt
  const int kept = min(count, a.budget);
  float* t_row = t_out + (long long)n * a.budget;
  float* dt_row = dt_out + (long long)n * a.budget;
  uint8_t* m_row = mask_out + (long long)n * a.budget;
  int next = 0, rank = 0;
  int tgt = kept > 0 ? spread_target(1, count, a.budget, a.inv_budget) : 0;
  for (int k = 0; k < a.num_steps && next < kept; ++k) {
    float t = ladder_t(L, k, a);
    float dt = ladder_dt(t, a);
    if (t < far && occupied(occ, o, d, t, dt, a) && ++rank == tgt) {
      t_row[next] = t;
      dt_row[next] = dt;
      m_row[next] = 1;
      ++next;
      if (next < kept) tgt = spread_target(next + 1, count, a.budget, a.inv_budget);
    }
  }
  for (int j = kept; j < a.budget; ++j) {
    t_row[j] = 0.0f;
    dt_row[j] = 0.0f;
    m_row[j] = 0;
  }
  stride_out[n] = count > a.budget ? (float)count * a.inv_budget : 1.0f;
  t0_out[n] = L.t0;
}

__global__ void march_candidates_kernel(const float* __restrict__ rays_o,
                                        const float* __restrict__ rays_d,
                                        const float* __restrict__ nears,
                                        const float* __restrict__ fars,
                                        const float* __restrict__ noise,
                                        const uint8_t* __restrict__ occ, FlatArgs a,
                                        float* __restrict__ ts_out, float* __restrict__ dts_out,
                                        uint8_t* __restrict__ valid_out) {
  int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= a.n_rays) return;
  const float o[3] = {rays_o[3 * n], rays_o[3 * n + 1], rays_o[3 * n + 2]};
  const float d[3] = {rays_d[3 * n], rays_d[3 * n + 1], rays_d[3 * n + 2]};
  const float far = fars[n];
  const Ladder L = ladder_of(nears[n], noise[n], a);
  const long long row = (long long)n * a.num_steps;
  int count = 0;
  for (int k = 0; k < a.num_steps; ++k) {
    float t = ladder_t(L, k, a);
    float dt = ladder_dt(t, a);
    // past far, or past the cap, no candidate is valid: skip the grid read
    bool v = t < far && count < a.max_steps && occupied(occ, o, d, t, dt, a);
    count += v;
    ts_out[row + k] = t;
    dts_out[row + k] = dt;
    valid_out[row + k] = v;
  }
}

// rays_o/rays_d (N, 3), nears/fars/noise (N,) f32; occ (CAS, H^3) bool
// bytes. Per-ray mode -> t (N, budget) f32, dt (N, budget) f32 (both 0 where
// masked), mask (N, budget) bool, stride (N,), t0 (N,).
extern "C" int march_flat_launch(const float* rays_o, const float* rays_d, const float* nears,
                                 const float* fars, const float* noise, const uint8_t* occ,
                                 int n_rays, int num_steps, int max_steps, int budget, int grid,
                                 int cascades, float bound, float gamma, float dt_min,
                                 float dt_max, float A, float B, float inv_dt_min, float lg,
                                 float inv_lg, float inv_budget, float* t_out, float* dt_out,
                                 uint8_t* mask_out, float* stride_out, float* t0_out,
                                 cudaStream_t stream) {
  if (budget < 1 || num_steps < 1 || gamma < 0.0f) return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  FlatArgs a = {n_rays, num_steps, max_steps, budget, grid, cascades, bound, gamma, dt_min,
                dt_max, A, B, inv_dt_min, lg, inv_lg, inv_budget};
  const int threads = 128;
  march_flat_kernel<<<(n_rays + threads - 1) / threads, threads, 0, stream>>>(
      rays_o, rays_d, nears, fars, noise, occ, a, t_out, dt_out, mask_out, stride_out, t0_out);
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
                                       float inv_budget, float* ts_out, float* dts_out,
                                       uint8_t* valid_out, float* unused0, float* unused1,
                                       cudaStream_t stream) {
  if (num_steps < 1 || gamma < 0.0f) return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  FlatArgs a = {n_rays, num_steps, max_steps, budget, grid, cascades, bound, gamma, dt_min,
                dt_max, A, B, inv_dt_min, lg, inv_lg, inv_budget};
  const int threads = 128;
  march_candidates_kernel<<<(n_rays + threads - 1) / threads, threads, 0, stream>>>(
      rays_o, rays_d, nears, fars, noise, occ, a, ts_out, dts_out, valid_out);
  return (int)cudaGetLastError();
}
