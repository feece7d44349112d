// K5: global compaction of the per-ray (N, B) sample layout into a shared
// ray-major buffer of M slots, and K3c: volume compositing of that buffer,
// forward and analytic backward.
//
// K5 replaces trinerflet_tpu/ops/raymarch.py:422 compact_global_dense (both
// its prefix-mask path and its sort path) and :361 compact_samples, as called
// from render/renderer.py:606 (the global layout the budget tuner engages).
// The JAX package finds each slot's source by a flat sort of position keys
// or, for prefix masks, by a boundary scatter-add and two cumsums: the TPU
// has no cheap compaction. Here it is what it is on a GPU: per-ray counts,
// an exclusive scan, one copy pass. An arbitrary mask is compacted in row
// order, which is what both JAX paths yield.
//
// What bounds K5 on the H100: bytes. It reads the (N, B) mask once, t and
// dt of the kept candidates and their rays, and writes 9 words per slot of
// the M-slot buffer plus the per-ray offsets and counts; a few integer
// operations per candidate.
//
// Design: two launches. compact_tile_kernel takes a tile of R rays a block
// (tile ids from an atomic counter, so a tile only ever waits on tiles
// whose blocks are running). The block stages the tile's mask bytes -- one
// contiguous range -- in shared memory with 16-byte loads, each byte read
// once. G lanes then take a row's bytes G at a time (G = 8, 16 or 32 by B:
// a warp holds 32 / G rows); __ballot_sync gives each chunk's bits, written
// out with the count of valid candidates before the chunk (8 bytes a chunk
// of G candidates). Warp 0 scans the tile's row counts and finds the tile's
// offset by a single-pass scan with decoupled look-back (each tile
// publishes its sum, then its inclusive prefix, in one 64-bit status word;
// the look-back reads 128 tiles' words a step; integer sums, so the offsets
// are the same on every call), and the block writes its rays' offsets and
// counts clipped to M, as the plain version does; the last tile writes
// num_valid = min(total, M). compact_copy_kernel copies: S blocks a tile
// (a tile's rows can hold every kept sample of the buffer -- a buffer
// filled by the first rays -- so one block a tile would copy them alone),
// each lane group a chunk, four chunks' loads in flight; the candidate of
// rank q in its row goes to slot offset + q while q is below the clipped
// count, so each ray's run is contiguous. Its other blocks fill the tail
// [num_valid, M) with padding (ray id PAD_RAY_ID), reading num_valid on the
// device (no copy to the host), and zero the tile counter and status words
// for the next call; the caller keeps that scratch per stream. Rays and t0
// are read through their strides (a batch's rays are often a view). Built
// with -fmad=false: xyz = clip(o + d*t) and ts = t + dt - t0 round as
// separate operations, as the plain version's do, so the buffer is equal
// bit for bit.
//
// K3c replaces trinerflet_tpu/ops/raymarch.py:754 composite_compact (the JAX
// package differentiates it through segmented global cumsums). One thread per
// ray walks its segment [offset, offset + count) with a running sum S of
// sd = sigma*dt, kept in float64 and rounded to f32 for T = exp(-S) as the
// plain version rounds its float64 sum (so both take the same t_thresh cut):
// alpha = 1 - exp(-sd), w = alpha*T where T >= t_thresh. It writes sum w,
// sum w*t, sum w*rgb and sum w*t^2; the z-variance is formed from them in
// the wrapper. The JAX package's global
// f32 cumsum minus a per-ray base cancels badly on a large buffer; the
// running per-ray sum is the quantity it stands for.
// Backward: a forward walk parks S_i in the dsigma slot; the reverse walk
// keeps R = sum_{k>i} a_k w_k, with a_k = g_ws + g_depth t_k +
// g_image . rgb_k + g_z2 t_k^2, and writes
// dsigma_i = dt_i (alive_i a_i exp(-sd_i) T_i - R), drgb_i = w_i g_image.
// Padding slots (ray_id >= N) get zeros. Bound: bytes (per slot it reads
// sigma, dt, t, rgb, ray_id and writes dsigma, drgb) for ~20 flops.

#include <cuda_runtime.h>
#include <stdint.h>

#define PAD_RAY_ID (1 << 30)
#define FULL 0xffffffffu
#define K5_WARPS 8
#define K5_SMEM (46 * 1024)
#define K5_MAX_ROWS 128
#define K5_BATCH 4   // chunks a lane group copies at once
#define K5_ITEMS 16  // chunks a lane group copies in all (sets S, the copy blocks a tile)
#define K5_PAD_BLOCKS 512
// a tile's status word: the flag in bits 32-33, the value in bits 0-31
#define ST_SUM (1ull << 32)     // the tile's own sum
#define ST_PREFIX (2ull << 32)  // the sum of every tile up to and including it

struct K5Args {
  int N, B, M, W, R, num_tiles, S;  // W chunks of G mask bytes a row, R rows a tile, S copy blocks a tile
  long long ro_s0, ro_s1, rd_s0, rd_s1, t0_s;  // strides of rays_o, rays_d, t0 (elements)
  float bound;
};

// Lanes per row: a warp holds 32 / G rows of B <= G bytes.
__host__ __device__ inline int k5_lanes(int B) { return B > 16 ? 32 : (B > 8 ? 16 : 8); }
__host__ __device__ inline int k5_chunks(int B) { return (B + k5_lanes(B) - 1) / k5_lanes(B); }

// Shared memory of a tile of R rows: each chunk's bits and count before it,
// the row's count and offset (4-byte words), then the staged mask bytes from
// a 16-byte boundary, with the slack that the range's alignment and the
// last 16-byte load take.
__host__ __device__ inline size_t k5_words(int B, int R) {
  return ((size_t)R * (2 + 2 * k5_chunks(B)) + 3) & ~(size_t)3;
}
static size_t k5_smem(int B, int R) { return 4 * k5_words(B, R) + (size_t)R * B + 32; }

// Rows per tile: at most K5_MAX_ROWS, as many as the shared memory takes.
static int k5_rows(int B) {
  int R = K5_MAX_ROWS;
  while (R > 1 && k5_smem(B, R) > K5_SMEM) R >>= 1;
  return R;
}

__device__ __forceinline__ unsigned long long read_status(const unsigned long long* st) {
  return *reinterpret_cast<const volatile unsigned long long*>(st);
}

template <int G>
__global__ void __launch_bounds__(32 * K5_WARPS) compact_tile_kernel(
    const uint8_t* __restrict__ mask, K5Args a, unsigned int* __restrict__ tile_counter,
    unsigned long long* status, unsigned int* __restrict__ bits_out, int* __restrict__ before_out,
    int* __restrict__ offsets, int* __restrict__ counts, int* __restrict__ num_valid) {
  constexpr int P = 32 / G;  // rows a warp holds
  constexpr unsigned int GMASK = G == 32 ? FULL : ((1u << G) - 1u);
  extern __shared__ uint4 smem4[];
  const int W = a.W, R = a.R;
  unsigned int* bits = reinterpret_cast<unsigned int*>(smem4);  // (R, W)
  int* before = reinterpret_cast<int*>(bits + R * W);           // (R, W): valid before the chunk
  int* rcount = before + R * W;                                  // row counts
  int* roffset = rcount + R;                                     // row offsets in the tile
  uint8_t* mbytes = reinterpret_cast<uint8_t*>(smem4) + 4 * k5_words(a.B, R);
  __shared__ int s_tile, s_prefix, s_total;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = lane / G, j = lane % G;
  if (tid == 0) s_tile = (int)atomicAdd(tile_counter, 1u);
  __syncthreads();
  const int tile = s_tile;
  const int n0 = tile * R;
  const int rows = max(min(R, a.N - n0), 0);

  // 0. stage the tile's mask bytes: aligned 16-byte loads of the range,
  // each within the pages its bytes lie on
  const uintptr_t lo = reinterpret_cast<uintptr_t>(mask + (size_t)n0 * a.B);
  const uintptr_t lo16 = lo & ~(uintptr_t)15;
  const int skew = (int)(lo - lo16);
  const int vecs = rows * a.B > 0 ? (skew + rows * a.B + 15) >> 4 : 0;
  uint4* mb4 = reinterpret_cast<uint4*>(mbytes);
  for (int v = tid; v < vecs; v += 32 * K5_WARPS) mb4[v] = reinterpret_cast<const uint4*>(lo16)[v];
  __syncthreads();

  // 1. G lanes a row: chunk c holds bytes c*G + j
  const uint8_t* mrows = mbytes + skew;
  for (int r0 = warp * P; r0 < rows; r0 += K5_WARPS * P) {
    const int r = r0 + sub;
    const bool row_in = r < rows;
    int sum = 0;
    for (int c = 0; c < W; ++c) {
      const int k = c * G + j;
      const bool m = row_in && k < a.B && mrows[r * a.B + k] != 0;
      const unsigned int mine = (__ballot_sync(FULL, m) >> (sub * G)) & GMASK;
      if (j == 0 && row_in) {
        bits[r * W + c] = mine;
        before[r * W + c] = sum;
      }
      sum += __popc(mine);
    }
    if (j == 0 && row_in) rcount[r] = sum;
  }
  __syncthreads();
  for (int i = tid; i < rows * W; i += 32 * K5_WARPS) {
    bits_out[(size_t)n0 * W + i] = bits[i];
    before_out[(size_t)n0 * W + i] = before[i];
  }

  // 2. warp 0: the rows' offsets in the tile, then the tile's offset
  if (warp == 0) {
    const int per = (R + 31) / 32;
    const int i0 = min(lane * per, rows), i1 = min(i0 + per, rows);
    int s = 0;
    for (int i = i0; i < i1; ++i) s += rcount[i];
    int x = s;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(FULL, x, d);
      if (lane >= d) x += y;
    }
    const int sum = __shfl_sync(FULL, x, 31);
    int run = x - s;
    for (int i = i0; i < i1; ++i) {
      const int c = rcount[i];
      roffset[i] = run;
      run += c;
    }
    int prefix = 0;
    if (tile == 0) {
      if (lane == 0) atomicExch(&status[0], ST_PREFIX | (unsigned int)sum);
    } else {
      if (lane == 0) atomicExch(&status[tile], ST_SUM | (unsigned int)sum);
      // look back 4 x 32 tiles a step: lane i of window u reads tile
      // look - 32 u - i and waits for its flag; the nearest prefix ends it
      for (int look = tile - 1;; look -= 128) {
        unsigned long long st[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = look - 32 * u - lane;
          st[u] = i >= 0 ? read_status(&status[i]) : ST_PREFIX;  // before tile 0: a prefix of 0
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = look - 32 * u - lane;
          while (i >= 0 && (st[u] >> 32) == 0) st[u] = read_status(&status[i]);
        }
        bool found = false;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (!found) {
            const unsigned int pre = __ballot_sync(FULL, (st[u] >> 32) == 2);
            const int first = pre ? __ffs(pre) - 1 : 31;
            int v = lane <= first ? (int)(unsigned int)st[u] : 0;
#pragma unroll
            for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(FULL, v, d);
            prefix += v;
            found = pre != 0;
          }
        }
        if (found) break;
      }
      if (lane == 0) atomicExch(&status[tile], ST_PREFIX | (unsigned int)(prefix + sum));
    }
    if (lane == 0) {
      s_prefix = prefix;
      s_total = prefix + sum;
    }
  }
  __syncthreads();

  // 3. the rays' offsets and counts, clipped to M
  for (int i = tid; i < rows; i += 32 * K5_WARPS) {
    const int o = min(s_prefix + roffset[i], a.M);
    offsets[n0 + i] = o;
    counts[n0 + i] = min(rcount[i], a.M - o);
  }
  if (tile == a.num_tiles - 1 && tid == 0) num_valid[0] = min(s_total, a.M);
}

// Blocks [0, num_tiles * S): S a tile, lane group g of the tile's S * GROUPS
// takes chunks g, g + S * GROUPS, ... of its (row, chunk) items, K5_BATCH at
// a time. The other blocks: the padding tail [num_valid, M), and the
// scratch zeroed for the next call.
template <int G>
__global__ void __launch_bounds__(32 * K5_WARPS) compact_copy_kernel(
    const float* __restrict__ rays_o, const float* __restrict__ rays_d, const float* __restrict__ t,
    const float* __restrict__ dt, const float* __restrict__ t0, K5Args a,
    const unsigned int* __restrict__ bits, const int* __restrict__ before,
    const int* __restrict__ offsets, const int* __restrict__ counts,
    const int* __restrict__ num_valid, unsigned int* __restrict__ tile_counter,
    unsigned long long* __restrict__ status, float* __restrict__ xyzs, float* __restrict__ dirs,
    float* __restrict__ ts, float* __restrict__ dts, int* __restrict__ ray_id) {
  constexpr int P = 32 / G;
  constexpr int GROUPS = K5_WARPS * P;  // lane groups a block
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = lane / G, j = lane % G;
  const int copy_blocks = a.num_tiles * a.S;
  if ((int)blockIdx.x >= copy_blocks) {
    const long long g = (long long)(blockIdx.x - copy_blocks) * blockDim.x + tid;
    const long long stride = (long long)(gridDim.x - copy_blocks) * blockDim.x;
    if (g == 0) tile_counter[0] = 0u;
    for (long long i = g; i < a.num_tiles; i += stride) status[i] = 0ull;
    const long long nv = num_valid[0];
    for (long long i = 3 * nv + g; i < 3 * (long long)a.M; i += stride) {
      xyzs[i] = 0.0f;
      dirs[i] = 0.0f;
    }
    for (long long s = nv + g; s < a.M; s += stride) {
      ts[s] = 0.0f;
      dts[s] = 0.0f;
      ray_id[s] = PAD_RAY_ID;
    }
    return;
  }
  const int tile = blockIdx.x / a.S, part = blockIdx.x - tile * a.S;
  const int n0 = tile * a.R;
  const int rows = min(a.R, a.N - n0);
  if (offsets[n0] >= a.M) return;  // the buffer is full before this tile
  const int W = a.W, items = rows * W, step = a.S * GROUPS;
  for (int it0 = part * GROUPS + warp * P + sub; it0 < items; it0 += K5_BATCH * step) {
    // every load of the batch issued at once: the chunk's bits, the row's
    // offset and count, its ray and each lane's t and dt (any k < B is in
    // the row), then the stores of the kept ones
    unsigned int mine[K5_BATCH];
    int q[K5_BATCH], cnt[K5_BATCH], off[K5_BATCH];
    float tv[K5_BATCH], dv[K5_BATCH], o[K5_BATCH][3], d[K5_BATCH][3], st0[K5_BATCH];
#pragma unroll
    for (int u = 0; u < K5_BATCH; ++u) {
      const int it = min(it0 + u * step, items - 1);
      const int r = it / W, c = it - r * W;
      const long long n = n0 + r;
      const size_t at = (size_t)n0 * W + it;
      const int k = min(c * G + j, a.B - 1);
      mine[u] = it0 + u * step < items ? bits[at] : 0u;
      q[u] = before[at];
      cnt[u] = counts[n];
      off[u] = offsets[n];
      tv[u] = t[(size_t)n * a.B + k];
      dv[u] = dt[(size_t)n * a.B + k];
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        o[u][e] = rays_o[n * a.ro_s0 + e * a.ro_s1];
        d[u][e] = rays_d[n * a.rd_s0 + e * a.rd_s1];
      }
      st0[u] = t0[n * a.t0_s];
    }
#pragma unroll
    for (int u = 0; u < K5_BATCH; ++u) {
      const int rank = q[u] + __popc(mine[u] & ((1u << j) - 1u));
      if (!((mine[u] >> j) & 1u) || rank >= cnt[u]) continue;
      const size_t s = (size_t)(off[u] + rank);
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        const float x = o[u][e] + d[u][e] * tv[u];  // two roundings (-fmad=false)
        xyzs[3 * s + e] = fminf(fmaxf(x, -a.bound), a.bound);
        dirs[3 * s + e] = d[u][e];
      }
      ts[s] = (tv[u] + dv[u]) - st0[u];
      dts[s] = dv[u];
      ray_id[s] = n0 + (min(it0 + u * step, items - 1)) / W;
    }
  }
}

// 64-bit words of scratch one call needs: the tile counter, then a status
// word per tile. Zeroed before the first call; each call leaves it zeroed.
extern "C" long long compact_scratch_words(int N, int B) {
  const int R = k5_rows(B);
  return 1 + (N > 0 ? (N + R - 1) / R : 1);
}

// Chunks of the (N, B) mask a call writes out, each 8 bytes (its bits and
// the valid candidates before it in its row).
extern "C" long long compact_chunk_words(int N, int B) { return (long long)N * k5_chunks(B); }

// rays_o, rays_d (N, 3) f32 with element strides (ro_s0, ro_s1), (rd_s0,
// rd_s1); t, dt (N, B) f32 and mask (N, B) bool bytes, contiguous; t0 (N,)
// f32 with stride t0_s -> xyzs, dirs (M, 3), ts, dts (M,) f32, ray_id (M,),
// offsets, counts (N,), num_valid () int32; scratch (scratch_words,) int64,
// zero; chunks (2 * chunk_words,) int32, any. Two launches.
extern "C" int compact_launch(const float* rays_o, const float* rays_d, const float* t,
                              const float* dt, const uint8_t* mask, const float* t0, int N, int B,
                              int M, float bound, long long ro_s0, long long ro_s1,
                              long long rd_s0, long long rd_s1, long long t0_s, float* xyzs,
                              float* dirs, float* ts, float* dts, int* ray_id, int* offsets,
                              int* counts, int* num_valid, long long* scratch,
                              long long scratch_words, int* chunks, cudaStream_t stream) {
  if (B < 0 || M < 1) return (int)cudaErrorInvalidValue;
  const int G = k5_lanes(B), R = k5_rows(B), W = k5_chunks(B);
  const int num_tiles = N > 0 ? (N + R - 1) / R : 1;
  const size_t smem = k5_smem(B, R);
  if (smem > K5_SMEM || scratch_words < 1 + num_tiles) return (int)cudaErrorInvalidValue;
  const int groups = K5_WARPS * (32 / G);
  const int S = (R * W + groups * K5_ITEMS - 1) / (groups * K5_ITEMS);
  unsigned int* counter = reinterpret_cast<unsigned int*>(scratch);
  unsigned long long* status = reinterpret_cast<unsigned long long*>(scratch + 1);
  unsigned int* bits = reinterpret_cast<unsigned int*>(chunks);
  int* before = chunks + (size_t)N * W;
  const K5Args a = {N, B, M, W, R, num_tiles, S > 0 ? S : 1, ro_s0, ro_s1, rd_s0, rd_s1, t0_s,
                    bound};
  const int threads = 32 * K5_WARPS;
  const long long pad_work = (3LL * M + threads - 1) / threads;
  const int pad_blocks = (int)(pad_work < K5_PAD_BLOCKS ? (pad_work > 0 ? pad_work : 1) : K5_PAD_BLOCKS);
  const int copy_blocks = N > 0 ? num_tiles * a.S : 0;
#define K5_LAUNCH(LANES)                                                                        \
  do {                                                                                          \
    compact_tile_kernel<LANES><<<num_tiles, threads, smem, stream>>>(                           \
        mask, a, counter, status, bits, before, offsets, counts, num_valid);                   \
    cudaError_t err = cudaGetLastError();                                                       \
    if (err != cudaSuccess) return (int)err;                                                    \
    compact_copy_kernel<LANES><<<copy_blocks + pad_blocks, threads, 0, stream>>>(               \
        rays_o, rays_d, t, dt, t0, a, bits, before, offsets, counts, num_valid, counter, status, \
        xyzs, dirs, ts, dts, ray_id);                                                           \
  } while (0)
  if (G == 32) K5_LAUNCH(32);
  else if (G == 16) K5_LAUNCH(16);
  else K5_LAUNCH(8);
#undef K5_LAUNCH
  return (int)cudaGetLastError();
}

__global__ void composite_compact_kernel(const float* __restrict__ sigma,
                                         const float* __restrict__ rgb,
                                         const float* __restrict__ dts,
                                         const float* __restrict__ ts,
                                         const int* __restrict__ offsets,
                                         const int* __restrict__ counts, int N, float t_thresh,
                                         float* __restrict__ ws, float* __restrict__ depth,
                                         float* __restrict__ image, float* __restrict__ z2) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int beg = offsets[n], end = offsets[n] + counts[n];
  double S = 0.0;
  float s_w = 0.f, s_t = 0.f, s_z = 0.f, r = 0.f, g = 0.f, b = 0.f;
  for (int i = beg; i < end; ++i) {
    const float sd = sigma[i] * dts[i];
    const float T = expf(-(float)S);
    const float w = T >= t_thresh ? (1.0f - expf(-sd)) * T : 0.0f;
    const float wt = w * ts[i];
    s_w += w;
    s_t += wt;
    s_z += wt * ts[i];
    r += w * rgb[3 * i];
    g += w * rgb[3 * i + 1];
    b += w * rgb[3 * i + 2];
    S += (double)sd;
  }
  ws[n] = s_w;
  depth[n] = s_t;
  image[3 * n] = r;
  image[3 * n + 1] = g;
  image[3 * n + 2] = b;
  z2[n] = s_z;
}

// sigma, dts, ts (M,) f32, rgb (M, 3) f32, offsets, counts (N,) int32 -> ws,
// depth, z2 (N,), image (N, 3) f32. Only the slots of the segments
// [offset, offset + count) are read.
extern "C" int composite_compact_launch(const float* sigma, const float* rgb, const float* dts,
                                        const float* ts, const int* offsets, const int* counts,
                                        int N, float t_thresh, float* ws, float* depth,
                                        float* image, float* z2, cudaStream_t stream) {
  if (N == 0) return 0;
  const int threads = 128;
  composite_compact_kernel<<<(N + threads - 1) / threads, threads, 0, stream>>>(
      sigma, rgb, dts, ts, offsets, counts, N, t_thresh, ws, depth, image, z2);
  return (int)cudaGetLastError();
}

// One thread per ray (its segment) and per slot (zeros for padding slots).
__global__ void composite_compact_backward_kernel(
    const float* __restrict__ sigma, const float* __restrict__ rgb, const float* __restrict__ dts,
    const float* __restrict__ ts, const int* __restrict__ ray_id, const int* __restrict__ offsets,
    const int* __restrict__ counts, const float* __restrict__ g_ws,
    const float* __restrict__ g_depth, const float* __restrict__ g_image,
    const float* __restrict__ g_z2, int N, int M, float t_thresh, float* __restrict__ dsigma,
    float* __restrict__ drgb) {
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  if (gid < M && ray_id[gid] >= N) {
    dsigma[gid] = 0.0f;
    drgb[3 * gid] = 0.0f;
    drgb[3 * gid + 1] = 0.0f;
    drgb[3 * gid + 2] = 0.0f;
  }
  if (gid >= N) return;
  const int n = gid;
  const int beg = offsets[n], end = offsets[n] + counts[n];
  double S = 0.0;
  for (int i = beg; i < end; ++i) {
    dsigma[i] = (float)S;  // S_i as the forward rounds it, read back by the reverse walk
    S += (double)(sigma[i] * dts[i]);
  }
  const float gw = g_ws[n], gd = g_depth[n], gz = g_z2[n];
  const float gr = g_image[3 * n], gg = g_image[3 * n + 1], gb = g_image[3 * n + 2];
  float R = 0.f;
  for (int i = end - 1; i >= beg; --i) {
    const float T = expf(-dsigma[i]);
    const float sd = sigma[i] * dts[i];
    const float e = expf(-sd);
    const bool alive = T >= t_thresh;
    const float t = ts[i];
    const float a = gw + gd * t + gr * rgb[3 * i] + gg * rgb[3 * i + 1] + gb * rgb[3 * i + 2] +
                    gz * t * t;
    const float w = alive ? (1.0f - e) * T : 0.0f;
    drgb[3 * i] = w * gr;
    drgb[3 * i + 1] = w * gg;
    drgb[3 * i + 2] = w * gb;
    dsigma[i] = dts[i] * ((alive ? a * e * T : 0.0f) - R);
    R += a * w;
  }
}

// Inputs as composite_compact_launch plus ray_id (M,) int32 (to zero the
// padding slots) and the cotangents g_ws, g_depth, g_z2 (N,), g_image (N, 3)
// f32 -> dsigma (M,), drgb (M, 3) f32.
extern "C" int composite_compact_backward_launch(
    const float* sigma, const float* rgb, const float* dts, const float* ts, const int* ray_id,
    const int* offsets, const int* counts, const float* g_ws, const float* g_depth,
    const float* g_image, const float* g_z2, int N, int M, float t_thresh, float* dsigma,
    float* drgb, cudaStream_t stream) {
  const int work = N > M ? N : M;
  if (work == 0) return 0;
  const int threads = 128;
  composite_compact_backward_kernel<<<(work + threads - 1) / threads, threads, 0, stream>>>(
      sigma, rgb, dts, ts, ray_id, offsets, counts, g_ws, g_depth, g_image, g_z2, N, M, t_thresh,
      dsigma, drgb);
  return (int)cudaGetLastError();
}
