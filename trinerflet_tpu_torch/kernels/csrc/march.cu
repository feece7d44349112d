// K1: hierarchical occupancy march, one thread per ray.
//
// Replaces trinerflet_tpu/ops/raymarch.py:604 march_hierarchical with
// occupancy_lookup (:121), _mip_level (:111) and first_k_valid (:525). On
// the TPU every candidate is enumerated statically, tested with one large
// gather (from bit-packed 8^3 bricks decoded by a matmul, :146/:179) and the
// kept samples are chosen by lane sorts.
//
// What bounds it on the H100: latency of dependent byte reads from the
// occupancy grids. The grids are (CAS, H^3) bytes -- 2 x 128^3 = 4 MB each,
// 8 MB for the pair -- so they stay resident in the 50 MB L2; the bytes the
// march must move (rays in, samples out) are small, and each ray makes up
// to 2 x (num_coarse + coarse_budget * F) reads.
//
// Design: each thread walks its ray twice per level. Pass 1 counts the valid
// coarse segments; the kept ranks are then known in closed form (the spread
// law tgt_b = ceil(b * count / budget)), and pass 2 records the positions of
// those ranks. The fine level does the same over the kept segments'
// candidates and writes t straight into the ray's output row. No sort, no
// brick table, no scratch memory.
//
// Strided tests (training, march_hierarchical :659-677 and :694-716): with
// coarse stride cs > 1 one probe at t0 + seg*(cs*p + cs/2) stands for the
// cs segments of group p; with fine stride s > 1 one probe at
// t_seg0 + dt*(s*p + (s-1)/2) stands for the s candidates of group p
// (nearest probe). The walks evaluate a probe at the first member of its
// group and reuse the result for the rest, so a stride of s cuts the grid
// reads by s. The probe offsets s*p + (s-1)/2 are exact in f32.
//
// Exactness: the plain version and the JAX package (run under jit) fuse
// a*b + c into one rounding at five places (seven with the strided probes)
// and divide by a static budget as a multiply by its f32 reciprocal; this
// file is compiled with -fmad=false and uses fmaf() at exactly those
// places, so mask matches bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_COARSE_BUDGET 32

struct MarchArgs {
  int n_rays, num_coarse, fine, coarse_budget, budget, grid, cascades, e_dt, fine_stride,
      coarse_stride;
  float bound, dt, seg, half_seg, inv_coarse_budget, inv_budget;
};

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// Cell test of the point o + d*t (clipped to the bound): the mip level is
// max(frexp exponent of max|p|, of dt*H/2) clamped to [0, CAS-1], the cell
// q = (int) clip(0.5 * (p / mip_bound + 1) * H, 0, H - 1).
__device__ __forceinline__ bool occupied(const uint8_t* __restrict__ grid, const float o[3],
                                         const float d[3], float t, const MarchArgs& a) {
  float p[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) p[k] = clampf(fmaf(d[k], t, o[k]), -a.bound, a.bound);
  float mx = fmaxf(fmaxf(fabsf(p[0]), fabsf(p[1])), fabsf(p[2]));
  int e_pos;
  frexpf(fmaxf(mx, 1e-30f), &e_pos);
  int lvl = min(max(max(e_pos, a.e_dt), 0), a.cascades - 1);
  float mip_bound = fminf(ldexpf(1.0f, lvl), a.bound);
  float H = (float)a.grid;
  int q[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) q[k] = (int)clampf(0.5f * (p[k] / mip_bound + 1.0f) * H, 0.0f, H - 1.0f);
  long long idx = (((long long)lvl * a.grid + q[0]) * a.grid + q[1]) * a.grid + q[2];
  return grid[idx] != 0;
}

// Occupancy of coarse segment k, short of far (`in`). Stride 1 tests its
// midpoint t_mid; stride cs > 1 tests the centre of its group at the group's
// first member and carries the result (in `probe`) over the rest of the
// group. t rises with k, so a group whose first member is past far is past
// far throughout and needs no read.
__device__ __forceinline__ bool coarse_probe(const uint8_t* __restrict__ grid, const float o[3],
                                             const float d[3], float t0, float t_mid, int k,
                                             bool in, bool& probe, const MarchArgs& a) {
  const int cs = a.coarse_stride;
  if (cs == 1) return in && occupied(grid, o, d, t_mid, a);
  if (k % cs == 0) probe = in && occupied(grid, o, d, fmaf(a.seg, (float)k + 0.5f * (float)cs, t0), a);
  return in && probe;
}

// Occupancy of fine candidate f of a segment starting at t_seg0, with the
// nearest-probe rule for stride s > 1 (probe at offset s*p + (s-1)/2).
__device__ __forceinline__ bool fine_probe(const uint8_t* __restrict__ grid, const float o[3],
                                           const float d[3], float t_seg0, float t_f, int f,
                                           bool in, bool& probe, const MarchArgs& a) {
  const int s = a.fine_stride;
  if (s == 1) return in && occupied(grid, o, d, t_f, a);
  if (f % s == 0) probe = in && occupied(grid, o, d, fmaf(a.dt, (float)f + 0.5f * (float)(s - 1), t_seg0), a);
  return in && probe;
}

// rank (1-based) of the b-th kept entry (b 1-based) under the spread law
__device__ __forceinline__ int spread_target(int b, int count, int budget, float inv_budget) {
  if (count <= budget) return b;
  return (int)ceilf((float)b * (float)count * inv_budget);
}

__global__ void march_kernel(const float* __restrict__ rays_o, const float* __restrict__ rays_d,
                             const float* __restrict__ nears, const float* __restrict__ fars,
                             const float* __restrict__ noise, const uint8_t* __restrict__ occ,
                             const uint8_t* __restrict__ occ_coarse, MarchArgs a,
                             float* __restrict__ t_out, uint8_t* __restrict__ mask_out,
                             float* __restrict__ stride_out, float* __restrict__ lastocc_out) {
  int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= a.n_rays) return;
  const float o[3] = {rays_o[3 * n], rays_o[3 * n + 1], rays_o[3 * n + 2]};
  const float d[3] = {rays_d[3 * n], rays_d[3 * n + 1], rays_d[3 * n + 2]};
  const float far = fars[n];
  const float t0 = fmaf(a.dt, noise[n], nears[n]);

  // ---- level 1: coarse segment midpoints (or group-centre probes) against
  // the dilated grid
  int count_c = 0, last = 0;
  bool probe_c = false;
  for (int k = 0; k < a.num_coarse; ++k) {
    float t_mid = fmaf(a.seg, (float)k, t0) + a.half_seg;
    if (coarse_probe(occ_coarse, o, d, t0, t_mid, k, t_mid - a.half_seg < far, probe_c, a)) {
      ++count_c;
      last = k + 1;
    }
  }
  int kept_c = min(count_c, a.coarse_budget);
  int seg_idx[MAX_COARSE_BUDGET];
  {
    int next = 0, rank = 0;
    int tgt = kept_c > 0 ? spread_target(1, count_c, a.coarse_budget, a.inv_coarse_budget) : 0;
    for (int k = 0; k < a.num_coarse && next < kept_c; ++k) {
      float t_mid = fmaf(a.seg, (float)k, t0) + a.half_seg;
      if (coarse_probe(occ_coarse, o, d, t0, t_mid, k, t_mid - a.half_seg < far, probe_c, a)) {
        if (++rank == tgt) {
          seg_idx[next++] = k;
          if (next < kept_c) tgt = spread_target(next + 1, count_c, a.coarse_budget, a.inv_coarse_budget);
        }
      }
    }
  }
  float seg_stride = count_c > a.coarse_budget ? (float)count_c * a.inv_coarse_budget : 1.0f;

  // ---- level 2: the kept segments' fine candidates against the exact grid
  int count_f = 0;
  bool probe_f = false;
  for (int b = 0; b < kept_c; ++b) {
    float t_seg0 = fmaf(a.seg, (float)seg_idx[b], t0);
    for (int f = 0; f < a.fine; ++f) {
      float t_f = fmaf(a.dt, (float)f, t_seg0);
      if (fine_probe(occ, o, d, t_seg0, t_f, f, t_f < far, probe_f, a)) ++count_f;
    }
  }
  int kept_f = min(count_f, a.budget);
  float* t_row = t_out + (long long)n * a.budget;
  uint8_t* m_row = mask_out + (long long)n * a.budget;
  {
    int next = 0, rank = 0;
    int tgt = kept_f > 0 ? spread_target(1, count_f, a.budget, a.inv_budget) : 0;
    for (int b = 0; b < kept_c && next < kept_f; ++b) {
      float t_seg0 = fmaf(a.seg, (float)seg_idx[b], t0);
      for (int f = 0; f < a.fine && next < kept_f; ++f) {
        float t_f = fmaf(a.dt, (float)f, t_seg0);
        if (fine_probe(occ, o, d, t_seg0, t_f, f, t_f < far, probe_f, a)) {
          if (++rank == tgt) {
            t_row[next] = t_f;
            m_row[next] = 1;
            ++next;
            if (next < kept_f) tgt = spread_target(next + 1, count_f, a.budget, a.inv_budget);
          }
        }
      }
    }
  }
  for (int j = kept_f; j < a.budget; ++j) {
    t_row[j] = 0.0f;
    m_row[j] = 0;
  }
  float fine_stride = count_f > a.budget ? (float)count_f * a.inv_budget : 1.0f;
  stride_out[n] = seg_stride * fine_stride;
  lastocc_out[n] = (float)last;
}

// rays_o/rays_d (N, 3), nears/fars/noise (N,) f32; occ/occ_coarse (CAS, H^3)
// bool bytes -> t (N, budget) f32, mask (N, budget) bool, stride (N,),
// seg_lastocc (N,). e_dt is the frexp exponent of dt*H/2, computed on the host;
// fine_stride / coarse_stride are the occupancy test strides (1 = exact).
extern "C" int march_hierarchical_launch(
    const float* rays_o, const float* rays_d, const float* nears, const float* fars,
    const float* noise, const uint8_t* occ, const uint8_t* occ_coarse,
    int n_rays, int num_coarse, int fine, int coarse_budget, int budget, int grid,
    int cascades, int e_dt, int fine_stride, int coarse_stride, float bound, float dt, float seg, float half_seg,
    float inv_coarse_budget, float inv_budget,
    float* t_out, uint8_t* mask_out, float* stride_out, float* lastocc_out,
    cudaStream_t stream) {
  if (coarse_budget < 1 || coarse_budget > MAX_COARSE_BUDGET || budget < 1 ||
      fine_stride < 1 || coarse_stride < 1)
    return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  MarchArgs a = {n_rays, num_coarse, fine, coarse_budget, budget, grid, cascades, e_dt,
                 fine_stride, coarse_stride, bound, dt, seg, half_seg, inv_coarse_budget, inv_budget};
  const int threads = 128;
  march_kernel<<<(n_rays + threads - 1) / threads, threads, 0, stream>>>(
      rays_o, rays_d, nears, fars, noise, occ, occ_coarse, a, t_out, mask_out, stride_out,
      lastocc_out);
  return (int)cudaGetLastError();
}
