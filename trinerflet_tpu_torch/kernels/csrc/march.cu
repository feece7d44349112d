// K1: hierarchical occupancy march, one warp per ray.
//
// Replaces trinerflet_tpu/ops/raymarch.py:604 march_hierarchical with
// occupancy_lookup (:121), _mip_level (:111) and first_k_valid (:525). On
// the TPU every candidate is enumerated statically, tested with one large
// gather (from bit-packed 8^3 bricks decoded by a matmul, :146/:179) and the
// kept samples are chosen by lane sorts.
//
// What bounds it on the H100: the grids are (CAS, H^3) bytes -- 2 x 128^3 =
// 4 MB each, 8 MB for the pair -- so they stay resident in the 50 MB L2; the
// bytes the march must move (rays in, samples out) are small, and each ray
// makes up to num_coarse + coarse_budget * F reads. Walked by one thread,
// those reads are a chain of dependent L2 latencies; a warp per ray makes
// them 32 at a time, and what is left is instruction issue (each probe's
// arithmetic, once per lane).
//
// Design: a warp per ray, each level walked once. The coarse level takes 32
// segments a round, one per lane; each lane tests its probe, __ballot_sync
// gives the round's mask of valid segments, kept in shared memory. The
// count is the sum of the masks' popcounts, seg_lastocc the highest set bit,
// and the rounds stop at the first round whose first segment starts at or
// past far (t rises with the segment, so nothing later is valid). Lane b of
// the kept segments (at most MAX_COARSE_BUDGET = 32) then finds the segment
// of its spread rank tgt_b = ceil(b * count / budget) in the masks. The fine
// level probes the kept segments' candidates, 32 a round, the same way, and
// lane b (and b + 32, ...) of the row writes t and mask of its rank, so a
// warp's stores are contiguous. No sort, no brick table, no scratch in
// device memory.
//
// Strided tests (training, march_hierarchical :659-677 and :694-716): with
// coarse stride cs > 1 one probe at t0 + seg*(cs*p + cs/2) stands for the
// cs segments of group p; with fine stride s > 1 one probe at
// t_seg0 + dt*(s*p + (s-1)/2) stands for the s candidates of group p
// (nearest probe). The group's first lane in the round reads (its first
// member, or lane 0 for a group begun in the round before) and the others
// take its result by __shfl_sync, so a stride of s cuts the grid reads by s.
// The probe offsets s*p + (s-1)/2 are exact in f32.
//
// A spread rank past the count. ceil(b * count * (1/budget)) in float32 can
// exceed the count by one (budget 7, count 11; budget 13, count 14). The
// plain version (first_k_valid) then takes the last segment as the coarse
// rank, and as the fine rank the first position that is not valid among the
// coarse_budget * F candidate slots (the last slot when every one is
// valid); the kernel does the same.
//
// Exactness: the plain version and the JAX package (run under jit) fuse
// a*b + c into one rounding at five places (seven with the strided probes)
// and divide by a static budget as a multiply by its f32 reciprocal; this
// file is compiled with -fmad=false and uses fmaf() at exactly those
// places, so mask matches bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_COARSE_BUDGET 32
#define RAYS_PER_BLOCK 4   // warps per block
#define FULL 0xffffffffu

struct MarchArgs {
  int n_rays, num_coarse, fine, coarse_budget, budget, grid, cascades, e_dt, fine_stride,
      coarse_stride, words_c, words_f;
  float bound, dt, seg, half_seg, inv_coarse_budget, inv_budget;
};

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// Cell test of the point o + d*t (clipped to the bound): the mip level is
// max(frexp exponent of max|p|, of dt*H/2) clamped to [0, CAS-1], the cell
// q = (int) clip(0.5 * (p / mip_bound + 1) * H, 0, H - 1). The exponent is
// read from the float's bits (max|p| >= 1e-30 is normal). p / mip_bound is
// the true division's result by Markstein's correction: with y the
// reciprocal rounded to nearest, q1 = p y, r = p - q1 mip_bound (exact in
// an fma), q1 + r y rounded is p / mip_bound rounded, for every normal
// quotient (exact when mip_bound = 2^lvl); a subnormal one, which may come
// out another subnormal, adds nothing to 1 and takes the same cell.
__device__ __forceinline__ bool occupied(const uint8_t* __restrict__ grid, const float o[3],
                                         const float d[3], float t, float inv_bound, const MarchArgs& a) {
  float p[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) p[k] = clampf(fmaf(d[k], t, o[k]), -a.bound, a.bound);
  const float mx = fmaxf(fmaxf(fmaxf(fabsf(p[0]), fabsf(p[1])), fabsf(p[2])), 1e-30f);
  const int e_pos = (__float_as_int(mx) >> 23) - 126;
  const int lvl = min(max(max(e_pos, a.e_dt), 0), a.cascades - 1);
  const float pow2 = __int_as_float((lvl + 127) << 23);
  const bool exact = pow2 <= a.bound;
  const float mip_bound = exact ? pow2 : a.bound;
  const float y = exact ? __int_as_float((127 - lvl) << 23) : inv_bound;
  const float H = (float)a.grid;
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

// Position of the n-th set bit of the masks (32 positions a word), or -1.
__device__ __forceinline__ int nth_set(const unsigned int* masks, int words, int n) {
  for (int w = 0; w < words; ++w) {
    const int c = __popc(masks[w]);
    if (n <= c) return 32 * w + nth_bit(masks[w], n);
    n -= c;
  }
  return -1;
}

// q = n / d for 0 <= n < 2^20 and d >= 1 from inv_d = 1 / d (rounded): (n + 0.5) / d
// lies at least 0.5 / d from an integer, far beyond the products' rounding.
__device__ __forceinline__ int quot(int n, float inv_d) {
  return (int)(((float)n + 0.5f) * inv_d);
}

// 12 blocks of 4 warps an SM: at most 40 registers a thread (measured
// faster than 32 registers with spills, or 41 and 42 warps an SM)
__global__ void __launch_bounds__(32 * RAYS_PER_BLOCK, 12) march_kernel(
    const float* __restrict__ rays_o, const float* __restrict__ rays_d, const float* __restrict__ nears,
    const float* __restrict__ fars, const float* __restrict__ noise, const uint8_t* __restrict__ occ,
    const uint8_t* __restrict__ occ_coarse, MarchArgs a, float* __restrict__ t_out,
    uint8_t* __restrict__ mask_out, float* __restrict__ stride_out, float* __restrict__ lastocc_out) {
  // per warp: the coarse rounds' masks, the fine rounds' masks, the kept
  // segments' first candidate t
  extern __shared__ unsigned int smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = blockIdx.x * RAYS_PER_BLOCK + warp;
  if (n >= a.n_rays) return;  // the whole warp
  unsigned int* cmask = smem + warp * (a.words_c + a.words_f + MAX_COARSE_BUDGET);
  unsigned int* fmask = cmask + a.words_c;
  float* seg_t0 = reinterpret_cast<float*>(fmask + a.words_f);
  const float o[3] = {rays_o[3 * n], rays_o[3 * n + 1], rays_o[3 * n + 2]};
  const float d[3] = {rays_d[3 * n], rays_d[3 * n + 1], rays_d[3 * n + 2]};
  const float far = fars[n];
  const float t0 = fmaf(a.dt, noise[n], nears[n]);
  const float inv_bound = 1.0f / a.bound;  // rounded to nearest

  // ---- level 1: coarse segment midpoints (or group-centre probes) against
  // the dilated grid, 32 segments a round
  const int cs = a.coarse_stride;
  const float inv_cs = 1.0f / (float)cs;
  int count_c = 0, last = 0, rounds_c = 0;
  for (int r = 0; r < a.words_c; ++r) {
    const int k0 = 32 * r;
    if (!((fmaf(a.seg, (float)k0, t0) + a.half_seg) - a.half_seg < far)) break;
    const int k = k0 + lane;
    const float t_mid = fmaf(a.seg, (float)k, t0) + a.half_seg;
    const bool in = k < a.num_coarse && t_mid - a.half_seg < far;
    bool valid;
    if (cs == 1) {
      valid = in && occupied(occ_coarse, o, d, t_mid, inv_bound, a);
    } else {
      const int j = k - cs * quot(k, inv_cs);
      int probe = 0;
      if (in && (j == 0 || lane == 0))
        probe = occupied(occ_coarse, o, d, fmaf(a.seg, (float)(k - j) + 0.5f * (float)cs, t0), inv_bound, a);
      const int group_probe = __shfl_sync(FULL, probe, max(lane - j, 0));  // every lane shuffles
      valid = in && group_probe;
    }
    const unsigned int bal = __ballot_sync(FULL, valid);
    if (lane == 0) cmask[r] = bal;
    count_c += __popc(bal);
    if (bal) last = k0 + 32 - __clz(bal);
    rounds_c = r + 1;
  }
  __syncwarp();
  const int kept_c = min(count_c, a.coarse_budget);
  if (lane < kept_c) {
    const int tgt = spread_target(lane + 1, count_c, a.coarse_budget, a.inv_coarse_budget);
    int k = nth_set(cmask, rounds_c, tgt);
    if (k < 0) k = a.num_coarse - 1;  // a rank past the count
    seg_t0[lane] = fmaf(a.seg, (float)k, t0);
  }
  __syncwarp();
  const float seg_stride = count_c > a.coarse_budget ? (float)count_c * a.inv_coarse_budget : 1.0f;

  // ---- level 2: the kept segments' fine candidates against the exact
  // grid, candidate j = b * F + f, 32 a round
  const int F = a.fine, s = a.fine_stride, nf = kept_c * F;
  const float inv_f = 1.0f / (float)F, inv_s = 1.0f / (float)s;
  int count_f = 0, rounds_f = 0;
  for (int r = 0; 32 * r < nf; ++r) {
    const int j = 32 * r + lane;
    const int b = min(quot(j, inv_f), kept_c - 1), f = j - b * F;
    const float ts0 = seg_t0[b];
    const float t_f = fmaf(a.dt, (float)f, ts0);
    const bool in = j < nf && t_f < far;
    bool valid;
    if (s == 1) {
      valid = in && occupied(occ, o, d, t_f, inv_bound, a);
    } else {
      const int q = f - s * quot(f, inv_s);
      int probe = 0;
      if (in && (q == 0 || lane == 0))
        probe = occupied(occ, o, d, fmaf(a.dt, (float)(f - q) + 0.5f * (float)(s - 1), ts0), inv_bound, a);
      const int group_probe = __shfl_sync(FULL, probe, max(lane - q, 0));  // every lane shuffles
      valid = in && group_probe;
    }
    const unsigned int bal = __ballot_sync(FULL, valid);
    if (lane == 0) fmask[r] = bal;
    count_f += __popc(bal);
    rounds_f = r + 1;
  }
  __syncwarp();
  const int kept_f = min(count_f, a.budget);
  float* t_row = t_out + (size_t)n * a.budget;
  uint8_t* m_row = mask_out + (size_t)n * a.budget;
  for (int b = lane; b < a.budget; b += 32) {
    float t = 0.0f;
    if (b < kept_f) {
      const int tgt = spread_target(b + 1, count_f, a.budget, a.inv_budget);
      int j = nth_set(fmask, rounds_f, tgt);
      if (j < 0) {  // a rank past the count: the first slot that is not valid
        j = nf;
        for (int w = 0; w < rounds_f; ++w)
          if (~fmask[w]) {
            j = min(32 * w + __ffs(~fmask[w]) - 1, nf);
            break;
          }
        if (j == a.coarse_budget * F) j -= 1;  // every slot valid: the last
      }
      const int kb = quot(j, inv_f), f = j - kb * F;
      // a slot past the kept segments lies in the last segment (the plain
      // version's index of a masked coarse slot)
      const float ts0 = kb < kept_c ? seg_t0[kb] : fmaf(a.seg, (float)(a.num_coarse - 1), t0);
      t = fmaf(a.dt, (float)f, ts0);
    }
    t_row[b] = t;
    m_row[b] = b < kept_f;
  }
  if (lane == 0) {
    const float fine_stride = count_f > a.budget ? (float)count_f * a.inv_budget : 1.0f;
    stride_out[n] = seg_stride * fine_stride;
    lastocc_out[n] = (float)last;
  }
}

// Dynamic shared memory of one block at these shapes (bytes).
static size_t march_smem(int words_c, int words_f) {
  return sizeof(unsigned int) * (size_t)RAYS_PER_BLOCK * (words_c + words_f + MAX_COARSE_BUDGET);
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
  const int words_c = (num_coarse + 31) / 32, words_f = (coarse_budget * fine + 31) / 32;
  const size_t smem = march_smem(words_c, words_f);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  MarchArgs a = {n_rays, num_coarse, fine, coarse_budget, budget, grid, cascades, e_dt,
                 fine_stride, coarse_stride, words_c, words_f, bound, dt, seg, half_seg,
                 inv_coarse_budget, inv_budget};
  march_kernel<<<(n_rays + RAYS_PER_BLOCK - 1) / RAYS_PER_BLOCK, 32 * RAYS_PER_BLOCK, smem, stream>>>(
      rays_o, rays_d, nears, fars, noise, occ, occ_coarse, a, t_out, mask_out, stride_out,
      lastocc_out);
  return (int)cudaGetLastError();
}
