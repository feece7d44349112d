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
// occupancy bytes; a 2 x 128^3 grid is ~46 MB of traffic at a quarter
// refresh. The threshold needs the mean of the whole merged grid, so the
// work is two launches with the mean between them.
//
// Launch 1, merge and mean (merge_kernel): each thread merges 4 float4
// quads of the (C, H^3) grid, new = old >= 0 ? max(old * decay, tmp) : old
// on the block [off, off + S) of every cascade (a copy elsewhere), with
// 16-byte loads and stores (scalar ones where H^3, S or the offset is no
// multiple of 4), and sums max(new, 0): in float per thread, by xor
// shuffles per warp and in warp order per block, one partial a block. The
// last block to finish (an atomic ticket after a __threadfence) sums the
// partials in index order in float64: the mean, the same bits on every
// call, and thresh = min(mean, density_thresh) * scale. It resets its
// ticket, the second launch's, and the per-cascade min / max scratch.
//
// Launch 2, threshold, dilation and bbox (tile_kernel): a block takes a
// tile of T x T z-rows (x, y) of one cascade and reads its rows and an
// r-row halo in x and y from the merged grid (just written, so mostly from
// L2), whole rows of H cells with 16-byte loads where H is a multiple of 4.
// Thresholding packs a row into W = ceil(H / 32) words in shared memory
// (bit j of word k is cell z = 32 k + j; halo rows off the grid are zero).
// The (2r+1)^3 box -- the r-times-iterated 3^3 max-pool with -inf padding
// of _dilate3, clipped at the grid's faces and within its cascade -- is
// separable: z by shifts and ORs across each row's neighbouring words, then
// y and x by ORs of the neighbouring rows' words. The block writes occ and
// occ_coarse for its own rows (16 cells a 16-byte store where H is a
// multiple of 16, bytes otherwise) and finds the min / max occupied index
// per axis from the words (__ffs / __clz), reduced by __reduce_min_sync /
// __reduce_max_sync, one shared atomic a warp and one global atomic a block
// per value. The last block turns them into the world bbox with the plain
// version's float32 arithmetic (built with -fmad=false). The two tickets
// and the min / max words are scratch the caller keeps per stream: zero
// before the first call, and each call leaves the tickets at zero.
//
// occ_rebuild_launch rebuilds a checkpoint's occupancy from its stored grid
// and mean (trinerflet_tpu/train/trainer.py:884-898, load_checkpoint's
// threshold, _dilate3 and _occupied_bbox): launch 2 alone, after a one-block
// launch that writes the caller's threshold and resets what the merge
// would.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_CAS 8
#define MAX_R 3
#define FULL 0xffffffffu

namespace {

constexpr int kMergeThreads = 256;
constexpr int kMergeQuads = 4;  // float4 quads a thread
constexpr int kMergeCells = 4 * kMergeQuads * kMergeThreads;
constexpr int kTileThreads = 512;
constexpr int kTileLoads = 2;  // rows a warp loads at once
constexpr size_t kTileSmem = 48 * 1024;

// scratch (int32): [0] launch 1's ticket, [1] launch 2's, [2 + 2 (3c + ax)]
// the min and [3 + 2 (3c + ax)] the max occupied index of cascade c on axis
// ax (x, y, z)
constexpr int kMinMax = 2;

struct BoxArgs {
  float bound[MAX_CAS];  // min(2^cas, bound) per cascade
  float cell[MAX_CAS];   // 2 * bound_cas / H
  float full_lo, full_hi;
};

struct TileArgs {
  int C, H, r, W, T, tiles;  // tiles a side of a cascade: ceil(H / T)
  BoxArgs box;
};

__device__ __forceinline__ float merge1(float v, float t, float decay) {
  return v >= 0.f ? fmaxf(v * decay, t) : v;
}

template <bool VEC>
__global__ void __launch_bounds__(kMergeThreads)
    merge_kernel(const float* __restrict__ old, const float* __restrict__ tmp, int C, long long n,
                 long long S, long long off, float decay, float density_thresh, float scale,
                 int H, float* __restrict__ out, float* __restrict__ partial,
                 float* __restrict__ stats, int* __restrict__ scratch) {
  __shared__ float wsum[kMergeThreads / 32];
  __shared__ double dsum[kMergeThreads / 32];
  __shared__ bool s_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long total = (long long)C * n;
  const long long q0 = (long long)blockIdx.x * (kMergeQuads * kMergeThreads) + tid;
  float sum = 0.f;
  if (VEC) {  // n, S and off multiples of 4: a quad lies in one cascade, wholly in or out
    const long long quads = total >> 2;
    float4 v[kMergeQuads], t[kMergeQuads];
    bool in[kMergeQuads];
#pragma unroll
    for (int u = 0; u < kMergeQuads; ++u) {
      const long long q = q0 + (long long)u * kMergeThreads;
      in[u] = false;
      if (q < quads) {
        v[u] = reinterpret_cast<const float4*>(old)[q];
        const long long c = (4 * q) / n, i = 4 * q - c * n;
        in[u] = i >= off && i < off + S;
        if (in[u]) t[u] = *reinterpret_cast<const float4*>(tmp + c * S + (i - off));
      }
    }
#pragma unroll
    for (int u = 0; u < kMergeQuads; ++u) {
      const long long q = q0 + (long long)u * kMergeThreads;
      if (q >= quads) continue;
      float4 w = v[u];
      if (in[u]) {
        w.x = merge1(w.x, t[u].x, decay);
        w.y = merge1(w.y, t[u].y, decay);
        w.z = merge1(w.z, t[u].z, decay);
        w.w = merge1(w.w, t[u].w, decay);
      }
      reinterpret_cast<float4*>(out)[q] = w;
      sum += fmaxf(w.x, 0.f);
      sum += fmaxf(w.y, 0.f);
      sum += fmaxf(w.z, 0.f);
      sum += fmaxf(w.w, 0.f);
    }
  } else {
#pragma unroll
    for (int u = 0; u < kMergeQuads; ++u) {
      const long long q = q0 + (long long)u * kMergeThreads;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long idx = 4 * q + j;
        if (idx >= total) break;
        const long long c = idx / n, i = idx - c * n;
        float w = old[idx];
        if (i >= off && i < off + S) w = merge1(w, tmp[c * S + (i - off)], decay);
        out[idx] = w;
        sum += fmaxf(w, 0.f);
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(FULL, sum, o);
  if (lane == 0) wsum[warp] = sum;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < kMergeThreads / 32; ++w) s += wsum[w];
    partial[blockIdx.x] = s;
    __threadfence();
    s_last = atomicAdd(&scratch[0], 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  // the last block: the partials in index order, in float64
  double d = 0.0;
  const int per = (gridDim.x + kMergeThreads - 1) / kMergeThreads;
  for (int k = tid * per; k < min((int)gridDim.x, (tid + 1) * per); ++k) d += (double)__ldcg(&partial[k]);
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) d += __shfl_down_sync(FULL, d, o);  // lane 0: lanes 0..31 in a fixed tree
  if (lane == 0) dsum[warp] = d;
  __syncthreads();
  if (tid == 0) {
    double s = 0.0;
    for (int w = 0; w < kMergeThreads / 32; ++w) s += dsum[w];
    const float mean = (float)(s / (double)total);
    stats[0] = mean;
    stats[1] = fminf(mean, density_thresh) * scale;
    scratch[0] = 0;
    scratch[1] = 0;
  }
  if (tid < 3 * C) {
    scratch[kMinMax + 2 * tid] = H;
    scratch[kMinMax + 2 * tid + 1] = -1;
  }
}

// 16 occupancy bits -> 16 bytes of 0 / 1 (cell order)
__device__ __forceinline__ uint4 expand16(unsigned int b) {
  uint4 o;
  o.x = ((b & 0xfu) * 0x00204081u) & 0x01010101u;
  o.y = (((b >> 4) & 0xfu) * 0x00204081u) & 0x01010101u;
  o.z = (((b >> 8) & 0xfu) * 0x00204081u) & 0x01010101u;
  o.w = (((b >> 12) & 0xfu) * 0x00204081u) & 0x01010101u;
  return o;
}

// The min / max occupied index of this thread's cells, per axis.
struct MinMax {
  int lo[3], hi[3];
  __device__ explicit MinMax(int H) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      lo[a] = H;
      hi[a] = -1;
    }
  }
  __device__ void add(int x, int y, int zlo, int zhi) {
    lo[0] = min(lo[0], x);
    hi[0] = max(hi[0], x);
    lo[1] = min(lo[1], y);
    hi[1] = max(hi[1], y);
    lo[2] = min(lo[2], zlo);
    hi[2] = max(hi[2], zhi);
  }
};

// VLOAD: H a multiple of 4 (a row's 16-byte loads are aligned); VSTORE: H a
// multiple of 16.
template <bool VLOAD, bool VSTORE>
__global__ void __launch_bounds__(kTileThreads)
    tile_kernel(const float* __restrict__ grid, const float* __restrict__ stats, TileArgs a,
                uint8_t* __restrict__ occ, uint8_t* __restrict__ occ_coarse,
                int* __restrict__ scratch, float* __restrict__ bbox) {
  extern __shared__ unsigned int sm[];
  __shared__ int smm[6];
  __shared__ bool s_last;
  const int H = a.H, r = a.r, W = a.W, T = a.T, E = T + 2 * r;
  unsigned int* bits = sm;            // (E, E, W): the thresholded rows, halo included
  unsigned int* zb = bits + E * E * W;  // (E, E, W): dilated in z
  unsigned int* yb = zb + E * E * W;    // (E, T, W): then in y, for the tile's own y
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int warps = kTileThreads / 32;
  const int per = a.tiles * a.tiles;
  const int c = blockIdx.x / per, tx = (blockIdx.x - c * per) / a.tiles,
            ty = blockIdx.x - c * per - tx * a.tiles;
  const int xh = tx * T - r, yh = ty * T - r;  // the halo's first row
  if (tid < 6) smm[tid] = (tid & 1) ? -1 : H;
  const float thresh = stats[1];
  const long long n = (long long)H * H * H;
  const float* g = grid + (long long)c * n;

  // 1. threshold the rows into words, kTileLoads rows' loads in flight a warp
  if (VLOAD) {  // a warp per 128 cells of a row: lane l has cells 4l..4l+3
    const int chunks = (H + 127) >> 7, items = E * E * chunks;
    for (int i0 = warp; i0 < items; i0 += warps * kTileLoads) {
      float4 v[kTileLoads];
      bool ok[kTileLoads];
#pragma unroll
      for (int u = 0; u < kTileLoads; ++u) {
        const int it = i0 + u * warps, e = it / chunks, j = it - e * chunks;
        const int x = xh + e / E, y = yh + e % E, z = 128 * j + 4 * lane;
        ok[u] = it < items && x >= 0 && x < H && y >= 0 && y < H && z < H;
        if (ok[u]) v[u] = *reinterpret_cast<const float4*>(g + ((long long)x * H + y) * H + z);
      }
#pragma unroll
      for (int u = 0; u < kTileLoads; ++u) {
        const int it = i0 + u * warps;
        if (it >= items) break;  // warp-uniform
        unsigned int b = 0;
        if (ok[u])
          b = (unsigned int)(v[u].x > thresh) | (unsigned int)(v[u].y > thresh) << 1 |
              (unsigned int)(v[u].z > thresh) << 2 | (unsigned int)(v[u].w > thresh) << 3;
        b <<= 4 * (lane & 7);  // word k of the chunk: lanes 8k..8k+7
        b |= __shfl_xor_sync(FULL, b, 1);
        b |= __shfl_xor_sync(FULL, b, 2);
        b |= __shfl_xor_sync(FULL, b, 4);
        const int e = it / chunks, k = 4 * (it - e * chunks) + (lane >> 3);
        if ((lane & 7) == 0 && k < W) bits[e * W + k] = b;
      }
    }
  } else {  // a warp per word: lane l has cell 32k + l
    const int items = E * E * W;
    for (int i0 = warp; i0 < items; i0 += warps * kTileLoads) {
      float v[kTileLoads];
#pragma unroll
      for (int u = 0; u < kTileLoads; ++u) {
        const int it = i0 + u * warps, e = it / W, k = it - e * W;
        const int x = xh + e / E, y = yh + e % E, z = 32 * k + lane;
        const bool ok = it < items && x >= 0 && x < H && y >= 0 && y < H && z < H;
        v[u] = ok ? g[((long long)x * H + y) * H + z] : -1.f;
      }
#pragma unroll
      for (int u = 0; u < kTileLoads; ++u) {
        const int it = i0 + u * warps;
        if (it >= items) break;  // warp-uniform
        const unsigned int b = __ballot_sync(FULL, v[u] > thresh);  // -1 <= any thresh
        if (lane == 0) bits[it] = b;
      }
    }
  }
  __syncthreads();

  // 2. dilate in z: bit z takes bits z - r .. z + r of its row (bits past H
  // are zero in `bits`; those past H in zb are never written out)
  for (int it = tid; it < E * E * W; it += kTileThreads) {
    const int k = it % W;
    const unsigned int w = bits[it];
    const unsigned int lo = k > 0 ? bits[it - 1] : 0u, hi = k + 1 < W ? bits[it + 1] : 0u;
    unsigned int d = w;
    for (int s = 1; s <= r; ++s) d |= (w << s) | (lo >> (32 - s)) | (w >> s) | (hi << (32 - s));
    zb[it] = d;
  }
  __syncthreads();

  // 3. dilate in y: the tile's own y from rows y - r .. y + r
  for (int it = tid; it < E * T * W; it += kTileThreads) {
    const int k = it % W, ly = (it / W) % T, ex = it / (W * T);
    unsigned int d = 0u;
    for (int s = 0; s <= 2 * r; ++s) d |= zb[(ex * E + ly + s) * W + k];
    yb[it] = d;
  }
  __syncthreads();

  // 4. dilate in x, write occ and occ_coarse for the tile's own rows, and
  // the min / max occupied indices
  MinMax mm(H);
  if (VSTORE) {  // a thread per 16 cells
    const int groups = H >> 4, items = T * T * groups;
    for (int it = tid; it < items; it += kTileThreads) {
      const int q = it % groups, ly = (it / groups) % T, lx = it / (groups * T);
      const int x = tx * T + lx, y = ty * T + ly;
      if (x >= H || y >= H) continue;
      const int k = q >> 1, sh = 16 * (q & 1);
      unsigned int d = 0u;
      for (int s = 0; s <= 2 * r; ++s) d |= yb[((lx + s) * T + ly) * W + k];
      const unsigned int o = (bits[((lx + r) * E + ly + r) * W + k] >> sh) & 0xffffu;
      const long long at = (long long)c * n + ((long long)x * H + y) * H + 16 * q;
      *reinterpret_cast<uint4*>(occ + at) = expand16(o);
      *reinterpret_cast<uint4*>(occ_coarse + at) = expand16((d >> sh) & 0xffffu);
      if (o) mm.add(x, y, 16 * q + __ffs(o) - 1, 16 * q + 31 - __clz(o));
    }
  } else {  // a thread per cell
    const int items = T * T * H;
    for (int it = tid; it < items; it += kTileThreads) {
      const int z = it % H, ly = (it / H) % T, lx = it / (H * T);
      const int x = tx * T + lx, y = ty * T + ly;
      if (x >= H || y >= H) continue;
      const int k = z >> 5, b = z & 31;
      unsigned int d = 0u;
      for (int s = 0; s <= 2 * r; ++s) d |= yb[((lx + s) * T + ly) * W + k];
      const unsigned int o = (bits[((lx + r) * E + ly + r) * W + k] >> b) & 1u;
      const long long at = (long long)c * n + ((long long)x * H + y) * H + z;
      occ[at] = (uint8_t)o;
      occ_coarse[at] = (uint8_t)((d >> b) & 1u);
      if (o) mm.add(x, y, z, z);
    }
  }
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const int lo = __reduce_min_sync(FULL, mm.lo[ax]), hi = __reduce_max_sync(FULL, mm.hi[ax]);
    if (lane == 0 && hi >= 0) {
      atomicMin(&smm[2 * ax], lo);
      atomicMax(&smm[2 * ax + 1], hi);
    }
  }
  __syncthreads();
  if (tid < 3 && smm[2 * tid + 1] >= 0) {
    atomicMin(&scratch[kMinMax + 2 * (3 * c + tid)], smm[2 * tid]);
    atomicMax(&scratch[kMinMax + 2 * (3 * c + tid) + 1], smm[2 * tid + 1]);
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&scratch[1], 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!s_last || tid != 0) return;
  // the last block: the world bbox, as the plain version computes it
  float lo[3], hi[3];
  for (int ax = 0; ax < 3; ++ax) {
    lo[ax] = __int_as_float(0x7f800000);  // +inf
    hi[ax] = __int_as_float(0xff800000);  // -inf
  }
  for (int cas = 0; cas < a.C; ++cas)
    for (int ax = 0; ax < 3; ++ax) {
      const int mn = __ldcg(&scratch[kMinMax + 2 * (3 * cas + ax)]);
      const int mx = __ldcg(&scratch[kMinMax + 2 * (3 * cas + ax) + 1]);
      if (mx < 0) continue;
      const float cell = a.box.cell[cas];
      const float w_mn = -a.box.bound[cas] + (float)mn * cell;
      const float w_mx = (-a.box.bound[cas] + (float)mx * cell) + cell;
      lo[ax] = fminf(lo[ax], w_mn - cell);
      hi[ax] = fmaxf(hi[ax], w_mx + cell);
    }
  const bool empty = isinf(lo[0]) || isinf(hi[0]);
  for (int ax = 0; ax < 3; ++ax) {
    bbox[ax] = (empty || lo[ax] < a.box.full_lo) ? a.box.full_lo : lo[ax];
    bbox[3 + ax] = (empty || hi[ax] > a.box.full_hi) ? a.box.full_hi : hi[ax];
  }
  scratch[1] = 0;
}

// The rebuild's first launch: a threshold from the caller (a checkpoint's
// stored mean) where the merge would have written its own, and the second
// launch's ticket and min / max scratch reset as the merge resets them.
__global__ void rebuild_init_kernel(float mean, float thresh, int C, int H, float* stats,
                                    int* scratch) {
  const int tid = threadIdx.x;
  if (tid == 0) {
    stats[0] = mean;
    stats[1] = thresh;
    scratch[1] = 0;
  }
  if (tid < 3 * C) {
    scratch[kMinMax + 2 * tid] = H;
    scratch[kMinMax + 2 * tid + 1] = -1;
  }
}

size_t tile_smem(int T, int r, int W) {
  const size_t E = T + 2 * r;
  return 4 * (2 * E * E * W + E * T * W);
}

// Launch 2 on the merged grid with stats[1] as the threshold.
int tile_launch(const float* grid, int C, int H, int r, const float* bounds, const float* cells,
                float full_bound, uint8_t* occ, uint8_t* occ_coarse, const float* stats,
                float* bbox, int* scratch, cudaStream_t stream) {
  TileArgs a;
  a.C = C;
  a.H = H;
  a.r = r;
  a.W = (H + 31) / 32;
  a.T = 16;  // the largest tile side whose words fit in 48 KB
  while (a.T > 1 && tile_smem(a.T, r, a.W) > kTileSmem) a.T >>= 1;
  const size_t smem = tile_smem(a.T, r, a.W);
  if (smem > kTileSmem) return (int)cudaErrorInvalidValue;
  a.tiles = (H + a.T - 1) / a.T;
  for (int c = 0; c < MAX_CAS; ++c) {
    a.box.bound[c] = c < C ? bounds[c] : 0.f;
    a.box.cell[c] = c < C ? cells[c] : 0.f;
  }
  a.box.full_lo = -full_bound;
  a.box.full_hi = full_bound;
  const unsigned int blocks2 = (unsigned int)(C * a.tiles * a.tiles);
  const bool vload = H % 4 == 0 && (uintptr_t)grid % 16 == 0;
  const bool vstore = H % 16 == 0 && ((uintptr_t)occ | (uintptr_t)occ_coarse) % 16 == 0;
#define K6_TILE(VL, VS)                                                                         \
  tile_kernel<VL, VS><<<blocks2, kTileThreads, smem, stream>>>(grid, stats, a, occ, occ_coarse, \
                                                               scratch, bbox)
  if (vload && vstore) K6_TILE(true, true);
  else if (vload) K6_TILE(true, false);
  else K6_TILE(false, false);
#undef K6_TILE
  return (int)cudaGetLastError();
}

}  // namespace

// int32 words of scratch a call needs; zero before the first call.
extern "C" int occ_scratch_words() { return kMinMax + 6 * MAX_CAS; }

// Floats of the per-block partial sums a call needs.
extern "C" long long occ_partial_words(int C, long long n) {
  return ((long long)C * n + kMergeCells - 1) / kMergeCells;
}

// old (C, n = H^3) f32, tmp (C, S) f32 -> out (C, n) f32, occ and
// occ_coarse (C, H, H, H) bytes, stats (2,) f32 = (mean, thresh), bbox (6,)
// f32; partial (occ_partial_words,) f32, any; scratch (occ_scratch_words,)
// int32, zero before the first call and left so. bounds / cells: C floats.
// Two launches.
extern "C" int occ_upkeep_launch(const float* old, const float* tmp, int C, int H, long long S,
                                 long long off, float decay, float density_thresh, float scale,
                                 int r, const float* bounds, const float* cells, float full_bound,
                                 float* out, uint8_t* occ, uint8_t* occ_coarse, float* stats,
                                 float* bbox, float* partial, int* scratch, cudaStream_t stream) {
  const long long n = (long long)H * H * H;
  if (C < 1 || C > MAX_CAS || H < 1 || r < 1 || r > MAX_R || off < 0 || S < 0 || off + S > n)
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)C * n;
  const unsigned int blocks1 = (unsigned int)((total + kMergeCells - 1) / kMergeCells);
  const bool vec = n % 4 == 0 && S % 4 == 0 && off % 4 == 0 &&
                   ((uintptr_t)old | (uintptr_t)tmp | (uintptr_t)out) % 16 == 0;
  if (vec)
    merge_kernel<true><<<blocks1, kMergeThreads, 0, stream>>>(
        old, tmp, C, n, S, off, decay, density_thresh, scale, H, out, partial, stats, scratch);
  else
    merge_kernel<false><<<blocks1, kMergeThreads, 0, stream>>>(
        old, tmp, C, n, S, off, decay, density_thresh, scale, H, out, partial, stats, scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  return tile_launch(out, C, H, r, bounds, cells, full_bound, occ, occ_coarse, stats, bbox, scratch,
                     stream);
}

// A checkpoint's occupancy: launch 2 alone on a stored grid (C, n = H^3) f32
// with the threshold min(mean, density_thresh) * scale the caller computed
// from the stored mean -> occ, occ_coarse, bbox; stats (2,) f32 = (mean,
// thresh). scratch as occ_upkeep_launch's. Two launches (the reset, then
// the tiles).
extern "C" int occ_rebuild_launch(const float* grid, int C, int H, float mean, float thresh,
                                  int r, const float* bounds, const float* cells,
                                  float full_bound, uint8_t* occ, uint8_t* occ_coarse,
                                  float* stats, float* bbox, int* scratch, cudaStream_t stream) {
  if (C < 1 || C > MAX_CAS || H < 1 || r < 1 || r > MAX_R) return (int)cudaErrorInvalidValue;
  rebuild_init_kernel<<<1, 32, 0, stream>>>(mean, thresh, C, H, stats, scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return tile_launch(grid, C, H, r, bounds, cells, full_bound, occ, occ_coarse, stats, bbox,
                     scratch, stream);
}
