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
// package differentiates it through segmented global cumsums). What bounds
// it: bytes (per slot in a segment sigma, dt, t and rgb in, in the backward
// also ray_id, and dsigma and drgb out) for ~20-30 flops. Design: a lane
// group of G = 8, 16 or 32 lanes per ray (the host picks G from M / N: 8 up
// to 16 slots a ray, 16 up to 48, 32 past that) walks the ray's contiguous
// segment [offset, offset + count) in chunks of G slots, one slot a lane, so
// every load of sigma, dt and t is contiguous across the group, and rgb
// moves as the chunk's 3G contiguous floats that shuffles hand each lane;
// four chunks' loads are issued at once. The exclusive sum S of sd =
// sigma*dt is an inclusive float64 group scan plus the chunk carry, rounded
// to f32 for T = exp(-S) as the plain version rounds its float64 sum (so
// both take the same t_thresh cut): alpha = 1 - exp(-sd), w = alpha*T where
// T >= t_thresh. Forward: each lane sums w, w*t, w*rgb and w*t^2 in float64
// (the plain version's index_add_ on doubles), reduced over the group at
// the end; the z-variance is formed from them in the wrapper. The JAX
// package's global f32 cumsum minus a per-ray base cancels badly on a
// large buffer; the per-ray sum is the quantity it stands for. Backward:
// with a_k = g_ws + g_depth t_k + g_image . rgb_k + g_z2 t_k^2 and b_k =
// a_k w_k, a first walk sums the ray's total of b in float64; a second
// recomputes S and an inclusive float64 scan of b, and the suffix
// sum_{k>i} b_k is the total less it (the plain version's seg_end - incl):
// dsigma_i = dt_i (alive_i a_i exp(-sd_i) T_i - suffix_i), drgb_i = w_i
// g_image. Where the warp's longest ray fits in one batch of four chunks
// (the global layout's short rows), the chunks, their weights and a stay in
// registers and both sums come from one pass over them. Nothing goes
// through device memory between the walks, and nothing is added
// atomically: two calls give the same bits. Other blocks of the backward's
// launch zero the padding slots (ray_id >= N).

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

namespace k3c {

constexpr int kThreads = 128;
constexpr int kBatch = 4;         // chunks whose loads a group issues at once
constexpr int kPadBlocks = 256;   // the backward's blocks that zero the padding slots

// What one lane holds of a chunk of G slots: its own slot's scalars and
// three of the chunk's 3G rgb floats (elements lane, lane + G, lane + 2G).
struct Chunk {
  float sigma, dt, t;
  float rgb[3];
};

__device__ __forceinline__ Chunk load_chunk(const float* __restrict__ sigma,
                                            const float* __restrict__ rgb,
                                            const float* __restrict__ dts,
                                            const float* __restrict__ ts, int beg, int cnt, int c,
                                            int lane, int G) {
  Chunk k;
  const int j = c * G + lane;
  const bool ok = j < cnt;
  k.sigma = ok ? sigma[beg + j] : 0.0f;
  k.dt = ok ? dts[beg + j] : 0.0f;
  k.t = ok ? ts[beg + j] : 0.0f;
  const long long base = 3LL * (beg + c * G);
  const int lim = 3 * (cnt - c * G);
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const int el = lane + e * G;
    k.rgb[e] = el < lim ? rgb[base + el] : 0.0f;
  }
  return k;
}

__device__ __forceinline__ float slot(const float v[3], int j) {
  return j == 0 ? v[0] : (j == 1 ? v[1] : v[2]);
}

// Where lane's rgb elements sit (as in composite.cu): element e_j = lane +
// j G of a chunk is channel e_j % 3 of the chunk's slot e_j / 3; pick[ch]
// is the element j whose channel is ch.
template <int G>
struct Slots {
  int sample[3], channel[3], pick[3];
  __device__ explicit Slots(int lane) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int e = lane + j * G;
      sample[j] = e / 3;
      channel[j] = e % 3;
      pick[j] = ((j + 3 - lane % 3) * (G % 3)) % 3;
    }
  }
};

// The three channels of this lane's own slot from the chunk's rgb elements.
template <int G>
__device__ __forceinline__ void own_rgb(const Chunk& k, const Slots<G>& s, int lane, float col[3]) {
#pragma unroll
  for (int ch = 0; ch < 3; ++ch)
    col[ch] = __shfl_sync(FULL, slot(k.rgb, s.pick[ch]), (3 * lane + ch) & (G - 1), G);
}

// Inclusive sum over a group's G lanes (Hillis-Steele, in float64).
template <int G>
__device__ __forceinline__ double scan_sum(double v, int lane) {
#pragma unroll
  for (int d = 1; d < G; d <<= 1) {
    const double y = __shfl_up_sync(FULL, v, d, G);
    if (lane >= d) v += y;
  }
  return v;
}

template <int G>
__device__ __forceinline__ double sum_group(double v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o, G);
  return v;
}

// A chunk's weights: S, the running exclusive sum of sd = sigma dt in
// float64 (the plain version's per-ray sum; an inclusive group scan plus
// the carry of the chunks before), rounded to f32 for T = exp(-S) and the
// t_thresh cut; w = (1 - exp(-sd)) T where T >= t_thresh (0 past the count).
struct Weights {
  float T, e, w;  // e = exp(-sd)
};

template <int G>
__device__ __forceinline__ Weights weights(const Chunk& k, bool ok, double& carry, int lane,
                                           float t_thresh) {
  const float sd = k.sigma * k.dt;
  const double incl = scan_sum<G>((double)sd, lane);
  const double up = __shfl_up_sync(FULL, incl, 1, G);
  Weights q;
  q.T = expf(-(float)(carry + (lane == 0 ? 0.0 : up)));
  carry += __shfl_sync(FULL, incl, G - 1, G);
  q.e = expf(-sd);
  q.w = (ok && q.T >= t_thresh) ? (1.0f - q.e) * q.T : 0.0f;
  return q;
}

// Walks a ray's segment in chunks of G slots, kBatch chunks' loads at once;
// every group of the warp runs the warp's longest walk (the shuffles take
// the whole warp), a chunk past a ray's count holding zeros.
// visit(chunk, c, j, weights) sees each slot j = c G + lane of each chunk c
// (every lane, every chunk of the walk).
template <int G, typename Visit>
__device__ __forceinline__ void walk(const float* __restrict__ sigma, const float* __restrict__ rgb,
                                     const float* __restrict__ dts, const float* __restrict__ ts,
                                     int beg, int cnt, int nch, int lane, float t_thresh,
                                     Visit&& visit) {
  double carry = 0.0;
  for (int c0 = 0; c0 < nch; c0 += kBatch) {
    Chunk k[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) k[u] = load_chunk(sigma, rgb, dts, ts, beg, cnt, c0 + u, lane, G);
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (c0 + u >= nch) break;  // warp-uniform
      const int j = (c0 + u) * G + lane;
      visit(k[u], c0 + u, j, weights<G>(k[u], j < cnt, carry, lane, t_thresh));
    }
  }
}

template <int G>
__device__ __forceinline__ int longest_walk(int cnt) {
  return __reduce_max_sync(FULL, (cnt + G - 1) / G);
}

template <int G>
__global__ void __launch_bounds__(kThreads)
    forward_kernel(const float* __restrict__ sigma, const float* __restrict__ rgb,
                   const float* __restrict__ dts, const float* __restrict__ ts,
                   const int* __restrict__ offsets, const int* __restrict__ counts, int N,
                   float t_thresh, float* __restrict__ ws, float* __restrict__ depth,
                   float* __restrict__ image, float* __restrict__ z2) {
  const int lane = threadIdx.x & (G - 1);
  const int n = blockIdx.x * (kThreads / G) + threadIdx.x / G;
  const bool live = n < N;  // every group runs the walk: the shuffles take the whole warp
  const int beg = live ? offsets[n] : 0, cnt = live ? counts[n] : 0;
  const Slots<G> sl(lane);
  double s_w = 0.0, s_t = 0.0, s_z = 0.0, s_r = 0.0, s_g = 0.0, s_b = 0.0;
  walk<G>(sigma, rgb, dts, ts, beg, cnt, longest_walk<G>(cnt), lane, t_thresh,
          [&](const Chunk& k, int, int, const Weights& q) {
            float col[3];
            own_rgb<G>(k, sl, lane, col);
            const float wt = q.w * k.t;
            s_w += (double)q.w;
            s_t += (double)wt;
            s_z += (double)(wt * k.t);
            s_r += (double)(q.w * col[0]);
            s_g += (double)(q.w * col[1]);
            s_b += (double)(q.w * col[2]);
          });
  s_w = sum_group<G>(s_w);
  s_t = sum_group<G>(s_t);
  s_z = sum_group<G>(s_z);
  s_r = sum_group<G>(s_r);
  s_g = sum_group<G>(s_g);
  s_b = sum_group<G>(s_b);
  if (live && lane == 0) {
    ws[n] = (float)s_w;
    depth[n] = (float)s_t;
    image[3 * n] = (float)s_r;
    image[3 * n + 1] = (float)s_g;
    image[3 * n + 2] = (float)s_b;
    z2[n] = (float)s_z;
  }
}

// One ray's cotangents (as read by a lane group), and a_k = g_ws + g_depth
// t_k + g_image . rgb_k + g_z2 t_k^2, as the plain version associates it.
template <int G>
struct Cotangent {
  float gw, gd, gz, gi[3];
  float g_slot[3];  // g_image at each of the lane's rgb elements' channels
  __device__ Cotangent(const float* __restrict__ g_ws, const float* __restrict__ g_depth,
                       const float* __restrict__ g_image, const float* __restrict__ g_z2, int n,
                       bool live, const Slots<G>& sl) {
    gw = live ? g_ws[n] : 0.0f;
    gd = live ? g_depth[n] : 0.0f;
    gz = live ? g_z2[n] : 0.0f;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) gi[ch] = live ? g_image[3 * n + ch] : 0.0f;
#pragma unroll
    for (int q = 0; q < 3; ++q) g_slot[q] = slot(gi, sl.channel[q]);
  }
  __device__ float a(const Chunk& k, const float col[3]) const {
    return ((gw + gd * k.t) + ((gi[0] * col[0] + gi[1] * col[1]) + gi[2] * col[2])) +
           (gz * k.t) * k.t;
  }
};

// A chunk's gradients from its weights, its a and the inclusive sum of b =
// a w through it: the suffix sum_{k>i} b_k is the ray's total less that
// sum, as the plain version forms it (seg_end - incl).
template <int G>
__device__ __forceinline__ void write_grad(const Chunk& k, const Weights& q, float a, double incl,
                                           double total, int beg, int cnt, int c, int lane,
                                           float t_thresh, const Slots<G>& sl,
                                           const Cotangent<G>& g, float* __restrict__ dsigma,
                                           float* __restrict__ drgb) {
  const int j = c * G + lane;
  const float suffix = (float)(total - incl);
  if (j < cnt) dsigma[beg + j] = k.dt * ((q.T >= t_thresh ? a * q.e * q.T : 0.0f) - suffix);
  const long long base = 3LL * (beg + c * G);
  const int lim = 3 * (cnt - c * G);
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const float we = __shfl_sync(FULL, q.w, sl.sample[e], G);
    const int el = lane + e * G;
    if (el < lim) drgb[base + el] = we * g.g_slot[e];
  }
}

// Blocks [0, ray_blocks): a lane group per ray; the others zero the padding
// slots (ray_id >= N).
template <int G>
__global__ void __launch_bounds__(kThreads) backward_kernel(
    const float* __restrict__ sigma, const float* __restrict__ rgb, const float* __restrict__ dts,
    const float* __restrict__ ts, const int* __restrict__ ray_id, const int* __restrict__ offsets,
    const int* __restrict__ counts, const float* __restrict__ g_ws,
    const float* __restrict__ g_depth, const float* __restrict__ g_image,
    const float* __restrict__ g_z2, int N, int M, float t_thresh, int ray_blocks,
    float* __restrict__ dsigma, float* __restrict__ drgb) {
  if ((int)blockIdx.x >= ray_blocks) {
    const int stride = (gridDim.x - ray_blocks) * kThreads;
    for (int s = (blockIdx.x - ray_blocks) * kThreads + threadIdx.x; s < M; s += stride)
      if (ray_id[s] >= N) {
        dsigma[s] = 0.0f;
        drgb[3LL * s] = 0.0f;
        drgb[3LL * s + 1] = 0.0f;
        drgb[3LL * s + 2] = 0.0f;
      }
    return;
  }
  const int lane = threadIdx.x & (G - 1);
  const int n = blockIdx.x * (kThreads / G) + threadIdx.x / G;
  const bool live = n < N;
  const int beg = live ? offsets[n] : 0, cnt = live ? counts[n] : 0;
  const int nch = longest_walk<G>(cnt);
  const Slots<G> sl(lane);
  const Cotangent<G> g(g_ws, g_depth, g_image, g_z2, n, live, sl);
  if (nch <= kBatch) {
    // the warp's rays fit in one batch of chunks: keep the chunks, their
    // weights and a in registers and take both sums from them
    Chunk k[kBatch];
    Weights q[kBatch];
    float a[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) k[u] = load_chunk(sigma, rgb, dts, ts, beg, cnt, u, lane, G);
    double carry = 0.0, total = 0.0;
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (u >= nch) break;  // warp-uniform
      const bool ok = u * G + lane < cnt;
      q[u] = weights<G>(k[u], ok, carry, lane, t_thresh);
      float col[3];
      own_rgb<G>(k[u], sl, lane, col);
      a[u] = ok ? g.a(k[u], col) : 0.0f;
      total += (double)(a[u] * q[u].w);
    }
    total = sum_group<G>(total);
    double incl = 0.0;
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (u >= nch) break;
      incl += scan_sum<G>((double)(a[u] * q[u].w), lane);
      write_grad<G>(k[u], q[u], a[u], incl, total, beg, cnt, u, lane, t_thresh, sl, g, dsigma,
                    drgb);
      incl = __shfl_sync(FULL, incl, G - 1, G);
    }
    return;
  }
  // longer rays: walk 1 sums the ray's total of b = a w, walk 2 recomputes
  // the weights and a, and takes the inclusive sum of b
  double total = 0.0;
  walk<G>(sigma, rgb, dts, ts, beg, cnt, nch, lane, t_thresh,
          [&](const Chunk& k, int, int j, const Weights& q) {
            float col[3];
            own_rgb<G>(k, sl, lane, col);
            if (j < cnt) total += (double)(g.a(k, col) * q.w);
          });
  total = sum_group<G>(total);
  double bcarry = 0.0;
  walk<G>(sigma, rgb, dts, ts, beg, cnt, nch, lane, t_thresh,
          [&](const Chunk& k, int c, int j, const Weights& q) {
            float col[3];
            own_rgb<G>(k, sl, lane, col);
            const float a = j < cnt ? g.a(k, col) : 0.0f;
            const double incl = bcarry + scan_sum<G>((double)(a * q.w), lane);
            write_grad<G>(k, q, a, incl, total, beg, cnt, c, lane, t_thresh, sl, g, dsigma, drgb);
            bcarry = __shfl_sync(FULL, incl, G - 1, G);
          });
}

// Lanes per ray from the buffer's slots a ray, M / N (the host knows it
// without reading the counts): short rows take several rays a warp. The
// global layout's buffer holds 1.5x the mean kept samples (M / N = 16 on
// bench's step: 8 lanes); the flat march's exact layout fills its N * B
// slots from a few long rays (B 20, rays of ~250 slots: 16 lanes, measured
// faster there than 8 or 32).
int group_for(int M, int N) {
  const long long mean = N > 0 ? ((long long)M + N - 1) / N : 0;
  return mean <= 16 ? 8 : (mean <= 48 ? 16 : 32);
}

}  // namespace k3c

// sigma, dts, ts (M,) f32, rgb (M, 3) f32, offsets, counts (N,) int32 -> ws,
// depth, z2 (N,), image (N, 3) f32. Only the slots of the segments
// [offset, offset + count) are read. One launch, a lane group per ray.
extern "C" int composite_compact_launch(const float* sigma, const float* rgb, const float* dts,
                                        const float* ts, const int* offsets, const int* counts,
                                        int N, int M, float t_thresh, float* ws, float* depth,
                                        float* image, float* z2, cudaStream_t stream) {
  if (N == 0) return 0;
  const int G = k3c::group_for(M, N), rays = k3c::kThreads / G;
  const unsigned int blocks = (unsigned int)((N + rays - 1) / rays);
#define K3C_FWD(LANES)                                                                    \
  k3c::forward_kernel<LANES><<<blocks, k3c::kThreads, 0, stream>>>(sigma, rgb, dts, ts, \
                                                                   offsets, counts, N,  \
                                                                   t_thresh, ws, depth, \
                                                                   image, z2)
  if (G == 8) K3C_FWD(8);
  else if (G == 16) K3C_FWD(16);
  else K3C_FWD(32);
#undef K3C_FWD
  return (int)cudaGetLastError();
}

// Inputs as composite_compact_launch plus ray_id (M,) int32 (to zero the
// padding slots) and the cotangents g_ws, g_depth, g_z2 (N,), g_image (N, 3)
// f32 -> dsigma (M,), drgb (M, 3) f32. One launch: a lane group per ray
// (two forward walks) and blocks that zero the padding slots.
extern "C" int composite_compact_backward_launch(
    const float* sigma, const float* rgb, const float* dts, const float* ts, const int* ray_id,
    const int* offsets, const int* counts, const float* g_ws, const float* g_depth,
    const float* g_image, const float* g_z2, int N, int M, float t_thresh, float* dsigma,
    float* drgb, cudaStream_t stream) {
  if (N == 0 && M == 0) return 0;
  const int G = k3c::group_for(M, N), rays = k3c::kThreads / G;
  const int ray_blocks = (N + rays - 1) / rays;
  const long long pad_work = ((long long)M + k3c::kThreads - 1) / k3c::kThreads;
  const int pad_blocks = (int)(pad_work < k3c::kPadBlocks ? (pad_work > 0 ? pad_work : 1)
                                                          : k3c::kPadBlocks);
  const unsigned int blocks = (unsigned int)(ray_blocks + pad_blocks);
#define K3C_BWD(LANES)                                                                        \
  k3c::backward_kernel<LANES><<<blocks, k3c::kThreads, 0, stream>>>(                        \
      sigma, rgb, dts, ts, ray_id, offsets, counts, g_ws, g_depth, g_image, g_z2, N, M,     \
      t_thresh, ray_blocks, dsigma, drgb)
  if (G == 8) K3C_BWD(8);
  else if (G == 16) K3C_BWD(16);
  else K3C_BWD(32);
#undef K3C_BWD
  return (int)cudaGetLastError();
}
