// K2: fused triplane projection + bilinear sample (forward), its plane
// gradient (backward), and K2x, the coordinate gradient.
//
// Replaces trinerflet_tpu/ops/grid_sample.py:131 grid_sample_2d_quad
// (_quad_fwd :138) as reached from models/triplane.py:289 sample_triplane
// after project_to_planes (:272). The TPU version packs each texel's 2x2
// neighbourhood into one (4C) row so bilinear costs one row gather per
// (sample, plane) -- TPU gathers cost per ROW, not per byte.
//
// Coordinates, as the plain versions compute them on either device (this
// file is built with -fmad=false, so every operation rounds alone): the
// texel coordinate of u is (u / lbound + 1) * 0.5 * (n - 1), a true
// division, then clamped into [0, n - 1]; x0 = min(floor(x), W - 2),
// wx = x - x0, the corner weights (1 - wx)(1 - wy), wx (1 - wy), (1 - wx) wy,
// wx wy. Plane 0 spans (x, z), 1 (x, y), 2 (y, z). A learned zoom divides in
// torch and passes lbound = 1.
//
// Forward. What bounds it on the H100: bytes, as scattered row reads (4
// corner rows of C channels per (sample, plane), C f32 outputs written), and,
// on planes that sit in L2 (k-planes' 64^2), instructions and stores. Design:
// a group of L lanes per (sample, plane) row, L = C x sizeof(plane) / 16 (at
// least 1): each lane projects the point itself (the same few operations as
// its neighbours, no shuffle), reads its 16-byte slice of the four corner
// rows and writes its slice of the output, so a warp's loads of one corner
// row and its stores cover whole rows, and consecutive rows are contiguous.
// The row index is 32-bit (the wrapper checks the sizes) and split into
// (point, plane) by a 32-bit division by the constant 3. Each channel's sum
// is (a w00 + b w01) + c w10 + d w11, each product rounded, as the plain
// version sums.
//
// Backward (replaces _quad_bwd :151 / _corner_bwd :210 and the sort +
// one-hot-matmul scatter they call, ops/scatter.py:375 scatter_add_outer):
// the plane gradient sum_corners w_corner * g, in the plane dtype. Bound:
// bytes, the cotangent read once and the gradient written once. The design
// keeps every float32 sum on chip: the (sample, plane) rows are binned by
// the output tile of the plane their 2x2 footprint touches (TX x TY texels; a
// row on a tile edge is listed in each tile it touches) by a counting sort,
// and one block per (tile, chunk of the tile's rows) accumulates w * g into
// the tile in shared memory, each texel summed by the one lane group that
// owns it (no float atomics: on sm_90 they are compare-and-swap loops in
// shared memory), then writes the tile once, in the plane dtype. Five
// launches, enqueued by one call with no
// device-to-host copy (grids are sized from upper bounds; blocks past the
// work exit):
//   1. count: lane groups of C / 4 lanes read each cotangent row with 16-byte
//      loads; a row whose cotangent is all zero is dropped; the others get a
//      key (tile, and whether the footprint crosses the tile's right or
//      bottom edge) and count into a block-local shared-memory histogram of
//      the tiles, added to the global counts at the block's end;
//   2. scan: one block turns the counts into row offsets, the chunks of each
//      tile (one, or ceil(count / cap) for a tile with more rows than the
//      chunk cap), the scratch slots of split tiles and their list;
//   3. scatter: each row's id to its tiles' lists, slots reserved by
//      warp-aggregated atomics on per-tile cursors;
//   4. accumulate: persistent blocks over the chunks, a chunk's rows in
//      batches sorted by texel in shared memory; a tile with one chunk is
//      written straight in the plane dtype (one rounding of the float32 sum,
//      as before); the chunks of a split tile write float32 partial tiles to
//      scratch;
//   5. reduce: the partial tiles of each split tile summed in chunk order
//      and written in the plane dtype.
// The cap adapts to the run (at least CAP_MIN rows, and large enough that
// the split tiles' chunks fit the NSLOT scratch slots), which keeps the
// blocks of the small k-planes planes and of dense scene centres balanced.
// The float sums of a texel run in the order its rows reach the tile's list
// (the scatter's atomics), which is unspecified.
//
// K2x, the coordinate gradient (replaces JAX's autodiff of grid_sample_2d
// :23 / sample_planes :61 in the coordinates, which models/triplane.py:310-321
// switches to when the rotation or the lbound zoom is learned): per point
// and plane dL/du = (sum_c g_c [(f01 - f00)(1 - wy) + (f11 - f10) wy])
// clip'(x) (W - 1) / 2, dL/dv alike, clip' being JAX's (1 inside, 0.5 at
// either bound, 0 outside); the three planes' (u, v) sum into dL/dxyz
// (plane 0 is (x, z), 1 (x, y), 2 (y, z)), over lbound. One thread per point
// loops over the three planes: it reads the cotangent row and the four
// corner rows, adds w * g into a float32 plane gradient with atomics, and
// keeps dL/dxyz in registers, written once (no atomics). A second kernel
// casts the plane gradient to bf16. Bound: bytes (the cotangent, the corner
// rows of the points that carry one, the touched texels read-modify-written,
// the gradients written).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

// ---------------------------------------------------------------------------
// Shared pieces
// ---------------------------------------------------------------------------

struct Cell {
  int x0, y0;
  float w00, w01, w10, w11;
};

// The texel coordinate of u before the clamp.
__device__ __forceinline__ float texel(float u, float lbound, int n) {
  return (u / lbound + 1.f) * 0.5f * (float)(n - 1);
}

// The corner (x0, y0) and the four weights of plane p's (u, v) at point
// (px, py, pz).
__device__ __forceinline__ Cell cell_of(float px, float py, float pz, int p, float lbound, int H, int W) {
  const float u = p == 2 ? py : px;
  const float v = p == 1 ? py : pz;
  const float x = fminf(fmaxf(texel(u, lbound, W), 0.f), (float)(W - 1));
  const float y = fminf(fmaxf(texel(v, lbound, H), 0.f), (float)(H - 1));
  const float fx0 = fminf(fmaxf(floorf(x), 0.f), (float)(W - 2));
  const float fy0 = fminf(fmaxf(floorf(y), 0.f), (float)(H - 2));
  const float wx = x - fx0, wy = y - fy0;
  Cell c;
  c.x0 = (int)fx0;
  c.y0 = (int)fy0;
  c.w00 = (1.f - wx) * (1.f - wy);
  c.w01 = wx * (1.f - wy);
  c.w10 = (1.f - wx) * wy;
  c.w11 = wx * wy;
  return c;
}

// A lane's slice of N channels of a plane row, as float32.
template <int N>
__device__ __forceinline__ void load_slice(const float* __restrict__ r, float* v) {
#pragma unroll
  for (int k = 0; k < N / 4; ++k) {
    const float4 q = reinterpret_cast<const float4*>(r)[k];
    v[4 * k] = q.x;
    v[4 * k + 1] = q.y;
    v[4 * k + 2] = q.z;
    v[4 * k + 3] = q.w;
  }
}

template <int N>
__device__ __forceinline__ void load_slice(const __nv_bfloat16* __restrict__ r, float* v) {
  if constexpr (N == 8) {
    const uint4 q = *reinterpret_cast<const uint4*>(r);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      v[2 * e] = f.x;
      v[2 * e + 1] = f.y;
    }
  } else {
    static_assert(N == 4, "bf16 slices are 4 or 8 channels");
    const uint2 q = *reinterpret_cast<const uint2*>(r);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      v[2 * e] = f.x;
      v[2 * e + 1] = f.y;
    }
  }
}

// A whole row of C channels (K2x).
template <int C, typename T>
__device__ __forceinline__ void load_row(const T* __restrict__ r, float* v) {
  constexpr int S = sizeof(T) == 2 ? (C >= 8 ? 8 : 4) : 4;
#pragma unroll
  for (int k = 0; k < C / S; ++k) load_slice<S>(r + k * S, v + k * S);
}

// ---------------------------------------------------------------------------
// K2 forward
// ---------------------------------------------------------------------------

template <int C, typename T>
struct FwdShape {
  static constexpr int BYTES = C * (int)sizeof(T);
  static constexpr int L = BYTES >= 16 ? BYTES / 16 : 1;  // lanes per row
  static constexpr int N = C / L;                          // channels per lane
};

template <int C, typename T>
__global__ void __launch_bounds__(256) sample_points_kernel(const T* __restrict__ planes,
                                                            const float* __restrict__ xyz,
                                                            unsigned int rows, int H, int W,
                                                            float lbound, float* __restrict__ out) {
  constexpr int L = FwdShape<C, T>::L, N = FwdShape<C, T>::N;
  const unsigned int t = blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned int row = t / L;  // L is a power of two
  if (row >= rows) return;
  const int sub = (int)(t % L);
  const unsigned int m = row / 3u;
  const int p = (int)(row - 3u * m);
  const Cell c = cell_of(xyz[3 * m], xyz[3 * m + 1], xyz[3 * m + 2], p, lbound, H, W);
  const T* r00 = planes + ((unsigned int)(p * H + c.y0) * (unsigned int)W + (unsigned int)c.x0) * C + sub * N;
  const T* r10 = r00 + W * C;
  float a[N], b[N], acc[N];
  load_slice<N>(r00, a);
  load_slice<N>(r00 + C, b);
#pragma unroll
  for (int k = 0; k < N; ++k) acc[k] = a[k] * c.w00 + b[k] * c.w01;
  load_slice<N>(r10, a);
  load_slice<N>(r10 + C, b);
#pragma unroll
  for (int k = 0; k < N; ++k) acc[k] = acc[k] + a[k] * c.w10 + b[k] * c.w11;
  float4* o = reinterpret_cast<float4*>(out + row * C + sub * N);
#pragma unroll
  for (int k = 0; k < N / 4; ++k) o[k] = make_float4(acc[4 * k], acc[4 * k + 1], acc[4 * k + 2], acc[4 * k + 3]);
}

template <int C>
static int launch_fwd(const void* planes, const float* xyz, int M, int H, int W, int bf16,
                      float lbound, float* out, cudaStream_t stream) {
  const unsigned int rows = 3u * (unsigned int)M;
  const int threads = 256;
  if (bf16) {
    const unsigned long long n = (unsigned long long)rows * FwdShape<C, __nv_bfloat16>::L;
    sample_points_kernel<C, __nv_bfloat16><<<(unsigned int)((n + threads - 1) / threads), threads, 0, stream>>>(
        (const __nv_bfloat16*)planes, xyz, rows, H, W, lbound, out);
  } else {
    const unsigned long long n = (unsigned long long)rows * FwdShape<C, float>::L;
    sample_points_kernel<C, float><<<(unsigned int)((n + threads - 1) / threads), threads, 0, stream>>>(
        (const float*)planes, xyz, rows, H, W, lbound, out);
  }
  return 0;
}

// planes (3, H, W, C) channel-last, bf16 (bf16 != 0) or f32; xyz (M, 3) f32
// -> out (M, 3, C) f32. C must be 4, 8, 16 or 32, H, W >= 2, and the wrapper
// keeps 3 H W C and 3 M C below 2^31.
extern "C" int sample_points_launch(const void* planes, const float* xyz, int M, int H, int W,
                                    int C, int bf16, float lbound, float* out, cudaStream_t stream) {
  if (M == 0) return 0;
  if (H < 2 || W < 2) return (int)cudaErrorInvalidValue;
  switch (C) {
    case 4: launch_fwd<4>(planes, xyz, M, H, W, bf16, lbound, out, stream); break;
    case 8: launch_fwd<8>(planes, xyz, M, H, W, bf16, lbound, out, stream); break;
    case 16: launch_fwd<16>(planes, xyz, M, H, W, bf16, lbound, out, stream); break;
    case 32: launch_fwd<32>(planes, xyz, M, H, W, bf16, lbound, out, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K2 backward: binned shared-memory accumulation
// ---------------------------------------------------------------------------

#define TX 32               // tile width in texels
#define BWD_THREADS 256
#define SCAN_THREADS 1024
#define CAP_MIN 2048        // fewest rows a chunk holds before its tile splits
#define NSLOT 1024          // float32 partial tiles in scratch
#define SPLIT_SLICES 16     // blocks that reduce one split tile
#define HIST_MAX 16384      // tiles a block-local histogram holds (64 KB)

template <int C>
struct Tile {
  static constexpr int TY = C == 32 ? 16 : 32;  // tile height in texels
  static constexpr int FLOATS = TX * TY * C;      // 16 K floats (64 KB) at C = 16, 32
};

__host__ __device__ __forceinline__ int tiles_x(int W) { return (W + TX - 1) / TX; }

// The meta words the scan writes: entries, chunks, split tiles, chunk cap.
enum { META_E = 0, META_CHUNKS = 1, META_SPLIT = 2, META_CAP = 3, META_WORDS = 4 };

struct BwdScratch {
  int* keys;         // (R,) per row: tile << 2 | crosses-bottom << 1 | crosses-right, or -1
  int* ids;          // (4R,) row ids by tile
  int* counts;       // (T,) rows per tile
  int* offsets;      // (T + 1,) first entry of each tile
  int* cursor;       // (T,) next free entry of each tile (scatter)
  int* chunk_start;  // (T + 1,) first chunk of each tile
  int* slot_start;   // (T,) first scratch slot of a split tile
  int* split_tiles;  // (T,) the split tiles
  int* chunk_tile;   // (T + NSLOT,) the tile of each chunk
  int* meta;         // (META_WORDS,)
};

static BwdScratch carve(int* base, long long R, int T) {
  BwdScratch s;
  int* p = base;
  s.keys = p; p += R;
  s.ids = p; p += 4 * R;
  s.counts = p; p += T;
  s.offsets = p; p += T + 1;
  s.cursor = p; p += T;
  s.chunk_start = p; p += T + 1;
  s.slot_start = p; p += T;
  s.split_tiles = p; p += T;
  s.chunk_tile = p; p += T + NSLOT;
  s.meta = p;
  return s;
}

static long long scratch_int_words(long long R, int T) { return 5 * R + 7LL * T + NSLOT + 2 + META_WORDS; }

// The k-th tile (k = 0: the row's own; 1: right, 2: below, 3: both) a
// row's key lists it in, or -1.
__device__ __forceinline__ int tile_of_key(int key, int k, int tx_n) {
  if (key < 0) return -1;
  const int dx = k & 1, dy = k >> 1;
  if ((dx && !(key & 1)) || (dy && !(key & 2))) return -1;
  return (key >> 2) + dx + dy * tx_n;
}

template <int C>
__global__ void __launch_bounds__(BWD_THREADS) bwd_count_kernel(const float* __restrict__ xyz,
                                                                const float* __restrict__ g,
                                                                unsigned int rows, int H, int W,
                                                                float lbound, int T, int use_hist,
                                                                int* __restrict__ keys,
                                                                int* __restrict__ counts) {
  constexpr int G = C / 4, TY = Tile<C>::TY;
  extern __shared__ int hist[];
  if (use_hist) {
    for (int i = threadIdx.x; i < T; i += blockDim.x) hist[i] = 0;
    __syncthreads();
  }
  const int tx_n = tiles_x(W), ty_n = (H + TY - 1) / TY;
  const int lane = threadIdx.x & 31, sub = lane % G;
  // a contiguous run of rows per block (neighbouring samples of a ray touch
  // few tiles), its warps striding through it
  const unsigned int per_warp = 32 / G, step = (blockDim.x / 32) * per_warp;
  const unsigned int span = (rows + gridDim.x - 1) / gridDim.x;
  const unsigned int end = min(rows, (blockIdx.x + 1) * span);
  for (unsigned int base = blockIdx.x * span + (threadIdx.x / 32) * per_warp; base < end; base += step) {
    const unsigned int row = base + lane / G;
    const bool valid = row < end;
    int nz = 0;
    if (valid) {
      const float4 q = reinterpret_cast<const float4*>(g + (size_t)row * C)[sub];
      nz = (q.x != 0.f) | (q.y != 0.f) | (q.z != 0.f) | (q.w != 0.f);
    }
#pragma unroll
    for (int o = 1; o < G; o <<= 1) nz |= __shfl_xor_sync(0xffffffffu, nz, o);
    int key = -1;  // the row's key, on its group's first lane
    if (valid && sub == 0 && nz) {
      const unsigned int m = row / 3u;
      const int p = (int)(row - 3u * m);
      const Cell c = cell_of(xyz[3 * m], xyz[3 * m + 1], xyz[3 * m + 2], p, lbound, H, W);
      const int t = (p * ty_n + c.y0 / TY) * tx_n + c.x0 / TX;
      key = (t << 2) | (((c.y0 % TY) == TY - 1) << 1) | ((c.x0 % TX) == TX - 1);
    }
    if (valid && sub == 0) keys[row] = key;
    // the lanes of the warp that count into one tile add once
    int* h = use_hist ? hist : counts;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int t = tile_of_key(key, k, tx_n);
      const unsigned int same = __match_any_sync(0xffffffffu, t);
      if (t >= 0 && lane == __ffs(same) - 1) atomicAdd(h + t, __popc(same));
    }
  }
  if (use_hist) {
    __syncthreads();
    for (int i = threadIdx.x; i < T; i += blockDim.x)
      if (hist[i]) atomicAdd(counts + i, hist[i]);
  }
}

// An exclusive scan of four int sums over the block (SCAN_THREADS threads).
__device__ __forceinline__ int4 block_exclusive_scan4(int4 v, int4* total) {
  __shared__ int4 warp_sums[SCAN_THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int4 incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int a = __shfl_up_sync(0xffffffffu, incl.x, o), b = __shfl_up_sync(0xffffffffu, incl.y, o);
    const int c = __shfl_up_sync(0xffffffffu, incl.z, o), d = __shfl_up_sync(0xffffffffu, incl.w, o);
    if (lane >= o) {
      incl.x += a;
      incl.y += b;
      incl.z += c;
      incl.w += d;
    }
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int4 s = warp_sums[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int a = __shfl_up_sync(0xffffffffu, s.x, o), b = __shfl_up_sync(0xffffffffu, s.y, o);
      const int c = __shfl_up_sync(0xffffffffu, s.z, o), d = __shfl_up_sync(0xffffffffu, s.w, o);
      if (lane >= o) {
        s.x += a;
        s.y += b;
        s.z += c;
        s.w += d;
      }
    }
    warp_sums[lane] = s;  // inclusive sums of the warps
  }
  __syncthreads();
  const int4 before = warp > 0 ? warp_sums[warp - 1] : make_int4(0, 0, 0, 0);
  *total = warp_sums[SCAN_THREADS / 32 - 1];
  return make_int4(before.x + incl.x - v.x, before.y + incl.y - v.y, before.z + incl.z - v.z,
                   before.w + incl.w - v.w);
}

// One block of SCAN_THREADS: thread i owns a contiguous run of tiles. First
// the entry total E and the cap; then one scan of (rows, chunks, split
// chunks, split tiles) per tile.
__global__ void __launch_bounds__(SCAN_THREADS) bwd_scan_kernel(const int* __restrict__ counts, int T,
                                                                BwdScratch s) {
  __shared__ int cap_s;
  const int per = (T + SCAN_THREADS - 1) / SCAN_THREADS;
  const int lo = min((int)threadIdx.x * per, T), hi = min(lo + per, T);
  int e = 0;
  for (int i = lo; i < hi; ++i) e += counts[i];
  int4 tot;
  block_exclusive_scan4(make_int4(e, 0, 0, 0), &tot);
  if (threadIdx.x == 0) {
    const long long want = (2LL * tot.x + NSLOT - 1) / NSLOT;  // split chunks <= 2 E / cap <= NSLOT
    cap_s = (int)(want > CAP_MIN ? want : CAP_MIN);
  }
  __syncthreads();
  const int cap = cap_s;
  int4 mine = make_int4(0, 0, 0, 0);
  for (int i = lo; i < hi; ++i) {
    const int c = counts[i];
    const int n = c > cap ? (c + cap - 1) / cap : 1;
    mine.x += c;
    mine.y += n;
    mine.z += n > 1 ? n : 0;
    mine.w += n > 1;
  }
  int4 run = block_exclusive_scan4(mine, &tot);
  for (int i = lo; i < hi; ++i) {
    const int c = counts[i];
    const int n = c > cap ? (c + cap - 1) / cap : 1;
    s.offsets[i] = run.x;
    s.cursor[i] = run.x;
    s.chunk_start[i] = run.y;
    s.slot_start[i] = run.z;
    for (int k = 0; k < n; ++k) s.chunk_tile[run.y + k] = i;  // chunks <= T + NSLOT
    if (n > 1) s.split_tiles[run.w] = i;
    run.x += c;
    run.y += n;
    run.z += n > 1 ? n : 0;
    run.w += n > 1;
  }
  if (threadIdx.x == 0) {
    s.offsets[T] = tot.x;
    s.chunk_start[T] = tot.y;
    s.meta[META_E] = tot.x;
    s.meta[META_CHUNKS] = tot.y;
    s.meta[META_SPLIT] = tot.w;
    s.meta[META_CAP] = cap;
  }
}

// One thread per row: its id into the list of each tile its footprint
// touches. The lanes of a warp that go to one tile reserve their entries
// with one atomic.
__global__ void __launch_bounds__(BWD_THREADS) bwd_scatter_kernel(const int* __restrict__ keys,
                                                                  unsigned int rows, int tx_n,
                                                                  int* __restrict__ cursor,
                                                                  int* __restrict__ ids) {
  const unsigned int row = blockIdx.x * blockDim.x + threadIdx.x;
  const int key = row < rows ? keys[row] : -1;
  const int lane = threadIdx.x & 31;
  const unsigned int below = (1u << lane) - 1u;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int t = tile_of_key(key, k, tx_n);
    const unsigned int same = __match_any_sync(0xffffffffu, t);
    if (t < 0) continue;
    const int leader = __ffs(same) - 1;
    int base = 0;
    if (lane == leader) base = atomicAdd(cursor + t, __popc(same));
    base = __shfl_sync(same, base, leader);
    ids[base + __popc(same & below)] = (int)row;
  }
}

// Persistent blocks over the chunks: each accumulates its rows' w * g into
// its tile in shared memory, then writes the tile (in the plane dtype) or,
// for a chunk of a split tile, its float32 partial. Shared-memory float
// atomics compile to compare-and-swap loops on sm_90 (ATOMS.CAST.SPIN), so
// no two threads add into one texel word: the chunk's rows go in batches of
// BATCH (one per thread; a batch's cotangent rows and points are fetched
// while the batch before it is summed), each row's cotangent, cell and
// weights staged in shared memory, and its (row, corner) items sorted by texel with a counting
// sort (integer shared atomics, which are native); then each texel is
// summed by the one lane group that owns it (C / 4 lanes, a float4 of
// channels each), in registers, and added to the tile with a plain load and
// store.
#define BATCH BWD_THREADS   // rows staged at once, one per thread

// A row's cotangent and point (nothing for row < 0).
template <int C>
__device__ __forceinline__ void fetch_row(int row, const float* __restrict__ g, const float* __restrict__ xyz,
                                          float4* q, float* pt) {
  if (row < 0) return;
  const float4* gr = reinterpret_cast<const float4*>(g + (size_t)row * C);
#pragma unroll
  for (int k = 0; k < C / 4; ++k) q[k] = gr[k];
  const unsigned int m = (unsigned int)row / 3u;
#pragma unroll
  for (int d = 0; d < 3; ++d) pt[d] = xyz[3 * m + d];
}

template <int C, typename T>
__global__ void __launch_bounds__(BWD_THREADS) bwd_accumulate_kernel(const float* __restrict__ xyz,
                                                                     const float* __restrict__ g,
                                                                     int H, int W, float lbound,
                                                                     BwdScratch s, T* __restrict__ grad,
                                                                     float* __restrict__ partials) {
  constexpr int G = C / 4, TY = Tile<C>::TY, FLOATS = Tile<C>::FLOATS;
  constexpr int NT = TX * TY;               // texels of a tile
  constexpr int GROUPS = BWD_THREADS / G;   // lane groups of a block
  constexpr int PER = NT / BWD_THREADS;     // texel counts scanned per thread
  extern __shared__ float4 tile4[];
  __shared__ float4 sg4[BATCH * G];          // the rows' cotangents
  __shared__ float4 sw[BATCH];               // the rows' weights w00, w01, w10, w11
  __shared__ int toff[NT + 1];               // texel counts, then their offsets
  __shared__ unsigned short items[4 * BATCH];  // row << 2 | corner, by texel
  __shared__ int warp_sums[BWD_THREADS / 32];
  const int tx_n = tiles_x(W), ty_n = (H + TY - 1) / TY;
  const int chunks = s.meta[META_CHUNKS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = threadIdx.x % G, group = threadIdx.x / G;
  for (int ch = blockIdx.x; ch < chunks; ch += gridDim.x) {
    const int t = s.chunk_tile[ch];
    const int j = ch - s.chunk_start[t], n = s.chunk_start[t + 1] - s.chunk_start[t];
    const int first = s.offsets[t], cnt = s.offsets[t + 1] - first;
    const int e0 = first + (int)((long long)cnt * j / n), e1 = first + (int)((long long)cnt * (j + 1) / n);
    const int p = t / (tx_n * ty_n), rem = t - p * tx_n * ty_n;
    const int oy = (rem / tx_n) * TY, ox = (rem % tx_n) * TX;
    for (int i = threadIdx.x; i < FLOATS / 4; i += BWD_THREADS) tile4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    // one row per thread: the first batch's fetched now, each later batch's
    // while the batch before it is summed
    const int r = threadIdx.x;
    int row = e0 + r < e1 ? s.ids[e0 + r] : -1;
    float4 q[G];
    float pt[3];
    fetch_row<C>(row, g, xyz, q, pt);
    for (int b0 = e0; b0 < e1; b0 += BATCH) {
      const int next_row = b0 + BATCH + r < e1 ? s.ids[b0 + BATCH + r] : -1;
      for (int i = threadIdx.x; i <= NT; i += BWD_THREADS) toff[i] = 0;
      __syncthreads();
      // stage the row; count its corners in the tile by texel
      int texel[4] = {-1, -1, -1, -1}, slot[4];
      if (row >= 0) {
#pragma unroll
        for (int k = 0; k < G; ++k) sg4[r * G + k] = q[k];
        const Cell c = cell_of(pt[0], pt[1], pt[2], (int)((unsigned int)row % 3u), lbound, H, W);
        sw[r] = make_float4(c.w00, c.w01, c.w10, c.w11);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int lx = c.x0 + (k & 1) - ox, ly = c.y0 + (k >> 1) - oy;
          if (lx >= 0 && lx < TX && ly >= 0 && ly < TY) {
            texel[k] = ly * TX + lx;
            slot[k] = atomicAdd(&toff[texel[k]], 1);
          }
        }
      }
      __syncthreads();
      // exclusive scan of the counts: PER consecutive texels per thread
      int local[PER], sum = 0;
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        local[k] = toff[threadIdx.x * PER + k];
        sum += local[k];
      }
      int incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      if (lane == 31) warp_sums[warp] = incl;
      __syncthreads();
      int base = incl - sum;
      for (int w = 0; w < warp; ++w) base += warp_sums[w];
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        toff[threadIdx.x * PER + k] = base;
        base += local[k];
      }
      if (threadIdx.x == BWD_THREADS - 1) toff[NT] = base;
      __syncthreads();
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (texel[k] >= 0) items[toff[texel[k]] + slot[k]] = (unsigned short)((r << 2) | k);
      __syncthreads();
      row = next_row;
      fetch_row<C>(row, g, xyz, q, pt);
      // each lane group sums the items of its texels and adds them once
      for (int tx = group; tx < NT; tx += GROUPS) {
        const int i0 = toff[tx], i1 = toff[tx + 1];
        if (i0 == i1) continue;
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int i = i0; i < i1; ++i) {
          const int it = items[i], rr = it >> 2, k = it & 3;
          const float4 wv = sw[rr];
          const float w = k == 0 ? wv.x : k == 1 ? wv.y : k == 2 ? wv.z : wv.w;
          const float4 q = sg4[rr * G + sub];
          acc.x += w * q.x;
          acc.y += w * q.y;
          acc.z += w * q.z;
          acc.w += w * q.w;
        }
        float4* d = tile4 + tx * G + sub;
        float4 v = *d;
        v.x += acc.x;
        v.y += acc.y;
        v.z += acc.z;
        v.w += acc.w;
        *d = v;
      }
      __syncthreads();
    }
    if (n == 1) {
      // (ly, lx, 4 channels) per thread step; rows of the tile are contiguous
      // in the plane
      for (int i = threadIdx.x; i < FLOATS / 4; i += BWD_THREADS) {
        const int ly = i / (TX * C / 4), r = i - ly * (TX * C / 4);
        const int lx = r / (C / 4), c4 = r - lx * (C / 4);
        const int y = oy + ly, x = ox + lx;
        if (y >= H || x >= W) continue;
        const float4 v = tile4[i];
        const unsigned int o = ((unsigned int)(p * H + y) * (unsigned int)W + (unsigned int)x) * C + c4 * 4;
        if constexpr (sizeof(T) == 2) {
          __nv_bfloat162 lo2 = __floats2bfloat162_rn(v.x, v.y), hi2 = __floats2bfloat162_rn(v.z, v.w);
          uint2 packed;
          packed.x = *reinterpret_cast<unsigned int*>(&lo2);
          packed.y = *reinterpret_cast<unsigned int*>(&hi2);
          *reinterpret_cast<uint2*>(grad + o) = packed;
        } else {
          *reinterpret_cast<float4*>(grad + o) = v;
        }
      }
    } else {
      float4* dst = reinterpret_cast<float4*>(partials + (size_t)(s.slot_start[t] + j) * FLOATS);
      for (int i = threadIdx.x; i < FLOATS / 4; i += BWD_THREADS) dst[i] = tile4[i];
    }
    __syncthreads();
  }
}

// The split tiles: SPLIT_SLICES blocks per tile, each summing its slice of
// the tile's partials in chunk order and writing it in the plane dtype.
template <int C, typename T>
__global__ void __launch_bounds__(BWD_THREADS) bwd_reduce_kernel(int H, int W, BwdScratch s,
                                                                 const float* __restrict__ partials,
                                                                 T* __restrict__ grad) {
  constexpr int TY = Tile<C>::TY, FLOATS = Tile<C>::FLOATS, SLICE = FLOATS / 4 / SPLIT_SLICES;
  const int tx_n = tiles_x(W), ty_n = (H + TY - 1) / TY;
  const int work = s.meta[META_SPLIT] * SPLIT_SLICES;
  for (int b = blockIdx.x; b < work; b += gridDim.x) {
    const int t = s.split_tiles[b / SPLIT_SLICES], slice = b % SPLIT_SLICES;
    const int n = s.chunk_start[t + 1] - s.chunk_start[t];
    const float4* src = reinterpret_cast<const float4*>(partials + (size_t)s.slot_start[t] * FLOATS);
    const int p = t / (tx_n * ty_n), rem = t - p * tx_n * ty_n;
    const int oy = (rem / tx_n) * TY, ox = (rem % tx_n) * TX;
    for (int i = slice * SLICE + threadIdx.x; i < (slice + 1) * SLICE; i += BWD_THREADS) {
      const int ly = i / (TX * C / 4), r = i - ly * (TX * C / 4);
      const int lx = r / (C / 4), c4 = r - lx * (C / 4);
      const int y = oy + ly, x = ox + lx;
      if (y >= H || x >= W) continue;
      float4 v = src[i];
      for (int j = 1; j < n; ++j) {
        const float4 a = src[(size_t)j * (FLOATS / 4) + i];
        v.x += a.x;
        v.y += a.y;
        v.z += a.z;
        v.w += a.w;
      }
      const unsigned int o = ((unsigned int)(p * H + y) * (unsigned int)W + (unsigned int)x) * C + c4 * 4;
      if constexpr (sizeof(T) == 2) {
        __nv_bfloat162 lo2 = __floats2bfloat162_rn(v.x, v.y), hi2 = __floats2bfloat162_rn(v.z, v.w);
        uint2 packed;
        packed.x = *reinterpret_cast<unsigned int*>(&lo2);
        packed.y = *reinterpret_cast<unsigned int*>(&hi2);
        *reinterpret_cast<uint2*>(grad + o) = packed;
      } else {
        *reinterpret_cast<float4*>(grad + o) = v;
      }
    }
  }
}

static int num_sms() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}

static int tiles_of(int H, int W, int C) {
  const int TY = C == 32 ? 16 : 32;
  return 3 * ((H + TY - 1) / TY) * tiles_x(W);
}

template <int C, typename T>
static int launch_bwd(const float* xyz, const float* g, int M, int H, int W, float lbound, T* grad,
                      int* iscratch, float* partials, cudaStream_t stream) {
  const int T_ = tiles_of(H, W, C);
  const unsigned int rows = 3u * (unsigned int)M;
  BwdScratch s = carve(iscratch, rows, T_);
  cudaError_t err = cudaMemsetAsync(s.counts, 0, sizeof(int) * (size_t)T_, stream);
  if (err != cudaSuccess) return (int)err;
  const int sms = num_sms();
  // 1. count: each block a few rows per thread, so its histogram's zeroing
  // and flush stay small beside them
  const int use_hist = T_ <= HIST_MAX;
  const size_t hist_bytes = use_hist ? sizeof(int) * (size_t)T_ : 0;
  static bool hist_attr = false;
  if (!hist_attr) {
    cudaFuncSetAttribute(bwd_count_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, 4 * HIST_MAX);
    hist_attr = true;
  }
  const unsigned long long threads_needed = (unsigned long long)rows * (C / 4);
  unsigned long long blocks = (threads_needed + 16ULL * BWD_THREADS - 1) / (16ULL * BWD_THREADS);
  if (blocks > 8ULL * sms) blocks = 8ULL * sms;
  if (blocks < 1) blocks = 1;
  bwd_count_kernel<C><<<(unsigned int)blocks, BWD_THREADS, hist_bytes, stream>>>(
      xyz, g, rows, H, W, lbound, T_, use_hist, s.keys, s.counts);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // 2. scan
  bwd_scan_kernel<<<1, SCAN_THREADS, 0, stream>>>(s.counts, T_, s);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // 3. scatter
  bwd_scatter_kernel<<<(rows + BWD_THREADS - 1) / BWD_THREADS, BWD_THREADS, 0, stream>>>(
      s.keys, rows, tiles_x(W), s.cursor, s.ids);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // 4. accumulate: as many resident blocks as the tile's shared memory allows
  const size_t tile_bytes = sizeof(float) * (size_t)Tile<C>::FLOATS;
  static int per_sm = 0;
  if (per_sm == 0) {
    cudaFuncSetAttribute(bwd_accumulate_kernel<C, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)tile_bytes);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bwd_accumulate_kernel<C, T>, BWD_THREADS,
                                                  tile_bytes);
    if (per_sm < 1) per_sm = 1;
  }
  bwd_accumulate_kernel<C, T><<<per_sm * sms, BWD_THREADS, tile_bytes, stream>>>(
      xyz, g, H, W, lbound, s, grad, partials);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // 5. reduce the split tiles
  bwd_reduce_kernel<C, T><<<2 * sms, BWD_THREADS, 0, stream>>>(H, W, s, partials, grad);
  return (int)cudaGetLastError();
}

// Scratch the K2 backward needs at these sizes: int32 words and float32
// words (the partial tiles), allocated by the caller.
extern "C" int sample_points_backward_workspace(int M, int H, int W, int C, long long* int_words,
                                                long long* float_words) {
  if (C != 4 && C != 8 && C != 16 && C != 32) return (int)cudaErrorInvalidValue;
  const int TY = C == 32 ? 16 : 32;
  *int_words = scratch_int_words(3LL * M, tiles_of(H, W, C));
  *float_words = (long long)NSLOT * TX * TY * C;
  return 0;
}

// xyz (M, 3) f32, g (M, 3, C) f32 -> grad (3, H, W, C) in the plane dtype
// (bf16 != 0: bf16, else f32), every element written. iscratch and partials
// as sample_points_backward_workspace sizes them. Five launches (and a
// memset of the tile counts) on the stream; no synchronisation.
extern "C" int sample_points_backward_launch(const float* xyz, const float* g, int M, int H, int W,
                                             int C, int bf16, float lbound, void* grad, int* iscratch,
                                             float* partials, cudaStream_t stream) {
  if (M == 0) return 0;
  if (H < 2 || W < 2) return (int)cudaErrorInvalidValue;
#define K2B(CC)                                                                                 \
  case CC:                                                                                      \
    return bf16 ? launch_bwd<CC, __nv_bfloat16>(xyz, g, M, H, W, lbound, (__nv_bfloat16*)grad,   \
                                                iscratch, partials, stream)                    \
                : launch_bwd<CC, float>(xyz, g, M, H, W, lbound, (float*)grad, iscratch, partials, \
                                        stream);
  switch (C) {
    K2B(4)
    K2B(8)
    K2B(16)
    K2B(32)
    default: return (int)cudaErrorInvalidValue;
  }
#undef K2B
}

// ---------------------------------------------------------------------------
// K2x
// ---------------------------------------------------------------------------

// The JAX package's gradient of clip(v, 0, hi): a tie at either bound
// splits it, 0.5.
__device__ __forceinline__ float clip_grad(float v, float hi) {
  if (v > 0.f && v < hi) return 1.f;
  return (v == 0.f || v == hi) ? 0.5f : 0.f;
}

template <int C, typename T>
__global__ void sample_points_backward_xyz_kernel(const T* __restrict__ planes,
                                                  const float* __restrict__ xyz,
                                                  const float* __restrict__ g, int M, int H, int W,
                                                  float lbound, float* __restrict__ grad,
                                                  float* __restrict__ dxyz) {
  long long m = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  float px = xyz[3 * m], py = xyz[3 * m + 1], pz = xyz[3 * m + 2];
  float du[3], dv[3];
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    du[p] = 0.f;
    dv[p] = 0.f;
    float gv[C];
    const float4* gr = reinterpret_cast<const float4*>(g + (3 * m + p) * C);
    bool any = false;
#pragma unroll
    for (int k = 0; k < C / 4; ++k) {
      float4 q = gr[k];
      gv[4 * k] = q.x;
      gv[4 * k + 1] = q.y;
      gv[4 * k + 2] = q.z;
      gv[4 * k + 3] = q.w;
      any |= (q.x != 0.f) | (q.y != 0.f) | (q.z != 0.f) | (q.w != 0.f);
    }
    if (!any) continue;  // unrouted or masked samples: both gradients are 0
    const float xr = texel(p == 2 ? py : px, lbound, W);
    const float yr = texel(p == 1 ? py : pz, lbound, H);
    float x = fminf(fmaxf(xr, 0.f), (float)(W - 1));
    float y = fminf(fmaxf(yr, 0.f), (float)(H - 1));
    float fx0 = fminf(fmaxf(floorf(x), 0.f), (float)(W - 2));
    float fy0 = fminf(fmaxf(floorf(y), 0.f), (float)(H - 2));
    float wx = x - fx0, wy = y - fy0;
    const float w[4] = {(1.f - wx) * (1.f - wy), wx * (1.f - wy), (1.f - wx) * wy, wx * wy};
    long long t00 = ((long long)p * H + (int)fy0) * W + (int)fx0;
    const long long rows[4] = {t00, t00 + 1, t00 + W, t00 + W + 1};
    float f00[C], f01[C], f10[C], f11[C];
    load_row<C>(planes + rows[0] * C, f00);
    load_row<C>(planes + rows[1] * C, f01);
    load_row<C>(planes + rows[2] * C, f10);
    load_row<C>(planes + rows[3] * C, f11);
    float dwx = 0.f, dwy = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      dwx += gv[c] * ((f01[c] - f00[c]) * (1.f - wy) + (f11[c] - f10[c]) * wy);
      dwy += gv[c] * ((f10[c] - f00[c]) * (1.f - wx) + (f11[c] - f01[c]) * wx);
    }
    du[p] = dwx * clip_grad(xr, (float)(W - 1)) * (float)(W - 1) * 0.5f;
    dv[p] = dwy * clip_grad(yr, (float)(H - 1)) * (float)(H - 1) * 0.5f;
    if (grad == nullptr) continue;  // the planes need no gradient (an analytic normal)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float* dst = grad + rows[r] * C;
#pragma unroll
      for (int c = 0; c < C; ++c) atomicAdd(dst + c, w[r] * gv[c]);
    }
  }
  dxyz[3 * m] = (du[0] + du[1]) / lbound;
  dxyz[3 * m + 1] = (dv[1] + du[2]) / lbound;
  dxyz[3 * m + 2] = (dv[0] + dv[2]) / lbound;
}

__global__ void cast_bf16_kernel(const float* __restrict__ x, long long n,
                                 __nv_bfloat16* __restrict__ out) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = __float2bfloat16_rn(x[i]);
}

template <int C>
static void launch_xyz_c(const void* planes, const float* xyz, const float* g, int M, int H, int W,
                         int bf16, float lbound, float* grad, float* dxyz, cudaStream_t stream) {
  const int threads = 128;
  unsigned int blocks = (unsigned int)(((long long)M + threads - 1) / threads);
  if (bf16)
    sample_points_backward_xyz_kernel<C, __nv_bfloat16><<<blocks, threads, 0, stream>>>(
        (const __nv_bfloat16*)planes, xyz, g, M, H, W, lbound, grad, dxyz);
  else
    sample_points_backward_xyz_kernel<C, float><<<blocks, threads, 0, stream>>>(
        (const float*)planes, xyz, g, M, H, W, lbound, grad, dxyz);
}

// K2x. planes (3, H, W, C) channel-last, bf16 (bf16 != 0) or f32; xyz (M, 3)
// f32; g (M, 3, C) f32 -> grad (3, H, W, C) f32, which the caller zeroes (the
// plane gradient, float atomics in an unspecified order; null: not computed),
// and dxyz (M, 3) f32, every row written.
extern "C" int sample_points_backward_xyz_launch(const void* planes, const float* xyz,
                                                 const float* g, int M, int H, int W, int C,
                                                 int bf16, float lbound, float* grad, float* dxyz,
                                                 cudaStream_t stream) {
  if (M == 0) return 0;
  if (H < 2 || W < 2) return (int)cudaErrorInvalidValue;
  switch (C) {
    case 4: launch_xyz_c<4>(planes, xyz, g, M, H, W, bf16, lbound, grad, dxyz, stream); break;
    case 8: launch_xyz_c<8>(planes, xyz, g, M, H, W, bf16, lbound, grad, dxyz, stream); break;
    case 16: launch_xyz_c<16>(planes, xyz, g, M, H, W, bf16, lbound, grad, dxyz, stream); break;
    case 32: launch_xyz_c<32>(planes, xyz, g, M, H, W, bf16, lbound, grad, dxyz, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// x (n,) f32 -> out (n,) bf16, round to nearest even.
extern "C" int cast_bf16_launch(const float* x, long long n, void* out, cudaStream_t stream) {
  if (n == 0) return 0;
  const int threads = 256;
  cast_bf16_kernel<<<(unsigned int)((n + threads - 1) / threads), threads, 0, stream>>>(
      x, n, (__nv_bfloat16*)out);
  return (int)cudaGetLastError();
}
