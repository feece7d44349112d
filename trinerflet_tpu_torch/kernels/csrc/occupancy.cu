// K6: occupancy upkeep -- EMA-max merge, mean, threshold, bbox, dilation.
//
// Replaces trinerflet_tpu/render/renderer.py:332 update_density_grid (the
// part after the field query), :282 _dilate3 and :258 _occupied_bbox. On the
// TPU the merge is a dynamic-update-slice, the dilation r iterated 3^3
// reduce_windows and the bbox per-axis any() reductions, each a separate XLA
// pass over the (CAS, H^3) grid; the bit-packing for the brick tables
// (morton.py:54, raymarch.py:146) has no counterpart here because K1 reads
// the bool grids as bytes.
//
// What bounds it on the H100: bytes. Per cell it reads the old density and
// (in the refreshed block) the new query, writes the merged density and two
// occupancy bytes; a 2 x 128^3 grid is 56 MB of traffic. The dilation's
// (2r+1)^3 byte tests per cell hit L1/L2 (the 4 MB grid stays resident).
//
// Four launches, in stream order:
//   merge      new = old >= 0 ? max(old * decay, tmp) : old on the block
//              [off, off + S) of every cascade (a copy elsewhere), and one
//              float partial sum of max(new, 0) per thread block;
//   finalize   one block sums the partials in a fixed order: mean (the
//              result is deterministic), thresh = min(mean, density_thresh)
//              * scale, and resets the bbox scratch;
//   threshold  occ = new > thresh, and per cascade and axis the min / max
//              index of an occupied cell (shared-memory atomics, then one
//              global atomic per block);
//   dilate     occ_coarse = any of occ over the (2r+1)^3 box around a cell
//              within its cascade (the r-times-iterated 3^3 max-pool with
//              -inf padding is exactly this box); the last block's thread 0
//              turns the min / max indices into the world bbox with the
//              plain version's float32 arithmetic (built with -fmad=false).

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_CAS 8
#define THREADS 256

struct BoxArgs {
  float bound[MAX_CAS];  // min(2^cas, bound) per cascade
  float cell[MAX_CAS];   // 2 * bound_cas / H
  float full_lo, full_hi;
};

__global__ void merge_kernel(const float* __restrict__ old, const float* __restrict__ tmp, int C,
                             long long n, long long S, long long off, float decay,
                             float* __restrict__ out, float* __restrict__ partial) {
  __shared__ float red[THREADS];
  long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  float pos = 0.f;
  if (idx < (long long)C * n) {
    long long c = idx / n, i = idx % n;
    float v = old[idx];
    if (i >= off && i < off + S) {
      float t = tmp[c * S + (i - off)];
      if (v >= 0.f) v = fmaxf(v * decay, t);
    }
    out[idx] = v;
    pos = fmaxf(v, 0.f);
  }
  red[threadIdx.x] = pos;
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) partial[blockIdx.x] = red[0];
}

// One block: stats[0] = mean, stats[1] = thresh; minmax[2 * (3c + ax)] = H
// (min) and [+1] = -1 (max).
__global__ void finalize_kernel(const float* __restrict__ partial, int n_partial, long long count,
                                float density_thresh, float scale, int C, int H,
                                float* __restrict__ stats, int* __restrict__ minmax) {
  __shared__ float red[THREADS];
  float s = 0.f;
  for (int k = threadIdx.x; k < n_partial; k += THREADS) s += partial[k];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int h = THREADS / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) red[threadIdx.x] += red[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    float mean = red[0] / (float)count;
    stats[0] = mean;
    stats[1] = fminf(mean, density_thresh) * scale;
  }
  if (threadIdx.x < 3 * C) {
    minmax[2 * threadIdx.x] = H;
    minmax[2 * threadIdx.x + 1] = -1;
  }
}

__global__ void threshold_kernel(const float* __restrict__ grid, const float* __restrict__ stats,
                                 int C, int H, uint8_t* __restrict__ occ,
                                 int* __restrict__ minmax) {
  __shared__ int smm[2 * 3 * MAX_CAS];
  if (threadIdx.x < 3 * C) {
    smm[2 * threadIdx.x] = H;
    smm[2 * threadIdx.x + 1] = -1;
  }
  __syncthreads();
  const long long n = (long long)H * H * H;
  long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx < (long long)C * n) {
    bool o = grid[idx] > stats[1];
    occ[idx] = o;
    if (o) {
      int c = (int)(idx / n);
      long long i = idx % n;
      int q[3] = {(int)(i / ((long long)H * H)), (int)((i / H) % H), (int)(i % H)};
      for (int ax = 0; ax < 3; ++ax) {
        atomicMin(&smm[2 * (3 * c + ax)], q[ax]);
        atomicMax(&smm[2 * (3 * c + ax) + 1], q[ax]);
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < 3 * C && smm[2 * threadIdx.x + 1] >= 0) {
    atomicMin(&minmax[2 * threadIdx.x], smm[2 * threadIdx.x]);
    atomicMax(&minmax[2 * threadIdx.x + 1], smm[2 * threadIdx.x + 1]);
  }
}

__global__ void dilate_kernel(const uint8_t* __restrict__ occ, int C, int H, int r,
                              const int* __restrict__ minmax, BoxArgs box,
                              uint8_t* __restrict__ occ_coarse, float* __restrict__ bbox) {
  const long long n = (long long)H * H * H;
  long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx < (long long)C * n) {
    long long c = idx / n, i = idx % n;
    int x = (int)(i / ((long long)H * H)), y = (int)((i / H) % H), z = (int)(i % H);
    const uint8_t* g = occ + c * n;
    bool any = false;
    for (int a = max(0, x - r); a <= min(H - 1, x + r) && !any; ++a)
      for (int b = max(0, y - r); b <= min(H - 1, y + r) && !any; ++b) {
        const uint8_t* row = g + ((long long)a * H + b) * H;
        for (int e = max(0, z - r); e <= min(H - 1, z + r); ++e)
          if (row[e]) {
            any = true;
            break;
          }
      }
    occ_coarse[idx] = any;
  }
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == 0) {
    float lo[3], hi[3];
    for (int ax = 0; ax < 3; ++ax) {
      lo[ax] = __int_as_float(0x7f800000);   // +inf
      hi[ax] = __int_as_float(0xff800000);   // -inf
    }
    for (int cas = 0; cas < C; ++cas)
      for (int ax = 0; ax < 3; ++ax) {
        int mn = minmax[2 * (3 * cas + ax)], mx = minmax[2 * (3 * cas + ax) + 1];
        if (mx < 0) continue;
        float cell = box.cell[cas];
        float w_mn = -box.bound[cas] + (float)mn * cell;
        float w_mx = (-box.bound[cas] + (float)mx * cell) + cell;
        lo[ax] = fminf(lo[ax], w_mn - cell);
        hi[ax] = fmaxf(hi[ax], w_mx + cell);
      }
    bool empty = isinf(lo[0]) || isinf(hi[0]);
    for (int ax = 0; ax < 3; ++ax) {
      bbox[ax] = (empty || lo[ax] < box.full_lo) ? box.full_lo : lo[ax];
      bbox[3 + ax] = (empty || hi[ax] > box.full_hi) ? box.full_hi : hi[ax];
    }
  }
}

static unsigned int blocks_for(long long total) {
  return (unsigned int)((total + THREADS - 1) / THREADS);
}

// old (C, n) f32, tmp (C, S) f32 -> out (C, n) f32; partial has
// blocks_for(C * n) floats.
extern "C" int occ_merge_launch(const float* old, const float* tmp, int C, long long n,
                                long long S, long long off, float decay, float* out,
                                float* partial, cudaStream_t stream) {
  if (C < 1 || C > MAX_CAS || off < 0 || S < 0 || off + S > n) return (int)cudaErrorInvalidValue;
  merge_kernel<<<blocks_for((long long)C * n), THREADS, 0, stream>>>(old, tmp, C, n, S, off,
                                                                     decay, out, partial);
  return (int)cudaGetLastError();
}

// -> stats (2,) f32 = (mean, thresh); minmax (C, 3, 2) int32 reset.
extern "C" int occ_finalize_launch(const float* partial, int n_partial, long long count,
                                   float density_thresh, float scale, int C, int H, float* stats,
                                   int* minmax, cudaStream_t stream) {
  if (C < 1 || C > MAX_CAS) return (int)cudaErrorInvalidValue;
  finalize_kernel<<<1, THREADS, 0, stream>>>(partial, n_partial, count, density_thresh, scale, C,
                                             H, stats, minmax);
  return (int)cudaGetLastError();
}

// grid (C, H^3) f32 -> occ (C, H^3) bytes; min / max occupied indices.
extern "C" int occ_threshold_launch(const float* grid, const float* stats, int C, int H,
                                    uint8_t* occ, int* minmax, cudaStream_t stream) {
  if (C < 1 || C > MAX_CAS) return (int)cudaErrorInvalidValue;
  threshold_kernel<<<blocks_for((long long)C * H * H * H), THREADS, 0, stream>>>(grid, stats, C,
                                                                                H, occ, minmax);
  return (int)cudaGetLastError();
}

// occ -> occ_coarse (radius r box), bbox (6,) f32. bounds / cells: C floats.
extern "C" int occ_dilate_launch(const uint8_t* occ, int C, int H, int r, const int* minmax,
                                 const float* bounds, const float* cells, float full_bound,
                                 uint8_t* occ_coarse, float* bbox, cudaStream_t stream) {
  if (C < 1 || C > MAX_CAS || r < 0) return (int)cudaErrorInvalidValue;
  BoxArgs box;
  for (int c = 0; c < MAX_CAS; ++c) {
    box.bound[c] = c < C ? bounds[c] : 0.f;
    box.cell[c] = c < C ? cells[c] : 0.f;
  }
  box.full_lo = -full_bound;
  box.full_hi = full_bound;
  dilate_kernel<<<blocks_for((long long)C * H * H * H), THREADS, 0, stream>>>(
      occ, C, H, r, minmax, box, occ_coarse, bbox);
  return (int)cudaGetLastError();
}
