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
// row on a tile edge is listed in each tile it touches) by a stable counting
// sort, and one block per (tile, chunk of the tile's rows) accumulates w * g
// into the tile in shared memory, no two threads adding into one texel word
// at once (no float atomics: on sm_90 they are compare-and-swap loops in
// shared memory), then writes the tile once, in the plane dtype. Every sum
// runs in an order fixed by the inputs (a tile's list in the order the
// scatter walks the rows, a batch's items by (texel, warp, corner, lane)),
// so two calls on the same inputs give the same bits. Six launches,
// enqueued by one call with no device-to-host
// copy (grids are sized from upper bounds; blocks past the work exit):
//   1. count: lane groups of C / 4 lanes read each cotangent row with 16-byte
//      loads; a row whose cotangent is all zero is dropped; the others get a
//      key (tile, and whether the footprint crosses the tile's right or
//      bottom edge) and count into a block-local shared-memory histogram of
//      the tiles over the block's contiguous run of rows, written out as the
//      block's row of a (blocks, tiles) count matrix;
//   2. column scan: per tile, the count matrix's column turned into each
//      block's first entry within the tile's list, and the tile's count;
//   3. scan: one block turns the counts into row offsets, the chunks of each
//      tile (one, or ceil(count / cap) for a tile with more rows than the
//      chunk cap), the scratch slots of split tiles and their list;
//   4. scatter: one warp per count block walks the block's run of rows,
//      32 at a time, and writes each row's id to its tiles' lists, corner by
//      corner, ranked within the warp by __match_any_sync, at per-tile
//      cursors in shared memory;
//   5. accumulate: persistent blocks over the chunks, a chunk's rows in
//      batches sorted by texel in shared memory; a tile with one chunk is
//      written straight in the plane dtype (one rounding of the float32
//      sum); the chunks of a split tile write float32 partial tiles to
//      scratch;
//   6. reduce: the partial tiles of each split tile summed in chunk order
//      and written in the plane dtype.
// The cap adapts to the run (at least CAP_MIN rows, and large enough that
// the split tiles' chunks fit the NSLOT scratch slots), which keeps the
// blocks of the small k-planes planes and of dense scene centres balanced.
//
// K2x, the coordinate gradient (replaces JAX's autodiff of grid_sample_2d
// :23 / sample_planes :61 in the coordinates, which models/triplane.py:310-321
// switches to when the rotation or the lbound zoom is learned): per point
// and plane dL/du = (sum_c g_c [(f01 - f00)(1 - wy) + (f11 - f10) wy])
// clip'(x) (W - 1) / 2, dL/dv alike, clip' being JAX's (1 inside, 0.5 at
// either bound, 0 outside); the three planes' (u, v) sum into dL/dxyz
// (plane 0 is (x, z), 1 (x, y), 2 (y, z)), over lbound. Its plane gradient
// is the K2 backward's six passes above, enqueued by the same call (so it
// is bit for bit the K2 backward's on the same cotangent and points).
// dL/dxyz is one more launch: a group of L lanes per point (the forward's L:
// one 16-byte slice of a row per lane), each lane reading its slices of the
// three cotangent rows first, then per plane of the four corner rows, the
// group summing its partial channel sums with __shfl_xor_sync; a (point,
// plane) row whose cotangent is all zero reads no corner, and, after the
// plane gradient's count pass has marked it (key -1), not its cotangent
// either. (Folded into the count pass, which reads every cotangent row
// already, it measured slower: whole points per warp iteration leave lanes
// idle, and the corner reads lengthen each iteration.) Bound: bytes (the
// cotangent, the corner rows of the rows that carry one, dL/dxyz and the
// plane gradient written).
//
// K2x², the backward of K2x (replaces JAX's autodiff of grid_sample_2d :23 /
// sample_planes :61 twice, which training through an analytic normal takes:
// trinerflet_tpu/models/registry.py:443 under jax.value_and_grad). Given the
// cotangent gg of dL/dxyz, per (point, plane) with (a_u, a_v) the plane's
// axes of gg / lbound, c_u = a_u clip'(x)(W - 1)/2, c_v alike and h =
// sum_c g_c (f00 - f01 - f10 + f11):
//   dL/dg = c_u [(f01 - f00)(1 - wy) + (f11 - f10) wy] + c_v [(f10 - f00)(1 - wx) + (f11 - f01) wx],
//   dL/dxyz: the plane's u axis gets c_v h s_u, its v axis c_u h s_v (the
//     bilinear Hessian's cross term; clip'' is 0), summed into the point's
//     axes as K2x sums and over lbound,
//   dL/dplanes: each corner row gets g times its weight's derivative along
//     gg: f00 -(c_u (1 - wy) + c_v (1 - wx)), f01 c_u (1 - wy) - c_v wx,
//     f10 c_v (1 - wx) - c_u wy, f11 c_u wy + c_v wx.
// Bound: bytes (gg and the points in; g and the corner rows of the rows gg
// reaches; dL/dg and dL/dxyz written, the plane gradient written once). On
// a training step gg reaches ~19% of the rows (masked samples carry none),
// and the first design (a dL/dg launch, then the K2 backward's six binned
// passes) spent three quarters of its time in those passes: the count pass
// read every row's g, the scatter's warps walked every row's key, and the
// accumulate pass staged a zeroed shared tile for tiles no row touches.
// Design, six launches: (1) a first pass shaped as K2x's dL/dxyz pass (a lane
// group per point, a 16-byte slice of each row per lane, the group's h by
// __shfl_xor_sync), its points in contiguous runs, a run per count block and
// a part of it per warp: per row gg first, then g only for a row gg reaches
// (a component along its plane's axes) and the four corner rows only where
// c_u or c_v is not zero; it writes dL/dg (zeros for the rest) and dL/dxyz,
// and, with the plane gradient, gives each reached row with a g its key
// and count in the block's histogram, as the count pass would, and writes
// the warp's reached rows (ids and keys) to its list in row order, ranked by
// ballots; (2, 3) the column scan and scan; (4) the scatter walks the
// block's lists, warp by warp, in place of every row's key, so the tiles'
// lists are the row walk's, entry for entry; (5) the accumulate pass in
// DERIV mode computes a row's weights (the bilinear weights' derivatives
// along gg) from its cell and gg when it is staged, its blocks take the
// next chunk from a counter (a third of the tiles have no row, and static
// turns left blocks idle), and a tile with no row writes its zeros from
// registers without touching the shared tile; (6) the reduce. Every sum
// keeps the first design's order, so dL/dg, dL/dxyz and the plane gradient
// are its bits. Without the plane gradient the first pass runs alone.
// Measured and kept out: thread 0 taking the next chunk and reading its
// head while the current one is summed (slower). What bounds it now: the
// accumulate pass's batches (their barriers and shared-memory sort) and the
// plane gradient's write; the first pass's dL/dg write.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

// ---------------------------------------------------------------------------
// Shared pieces
// ---------------------------------------------------------------------------

struct Cell {
  int x0, y0;
  float w00, w01, w10, w11;
  float xr, yr, wx, wy;  // the texel coordinates before the clamp, the weights' fractions
};

// The texel coordinate of u before the clamp.
__device__ __forceinline__ float texel(float u, float lbound, int n) {
  return (u / lbound + 1.f) * 0.5f * (float)(n - 1);
}

// The corner (x0, y0) and the four weights of plane p's (u, v) at point
// (px, py, pz).
__device__ __forceinline__ Cell cell_of(float px, float py, float pz, int p, float lbound, int H, int W) {
  Cell c;
  c.xr = texel(p == 2 ? py : px, lbound, W);
  c.yr = texel(p == 1 ? py : pz, lbound, H);
  const float x = fminf(fmaxf(c.xr, 0.f), (float)(W - 1));
  const float y = fminf(fmaxf(c.yr, 0.f), (float)(H - 1));
  const float fx0 = fminf(fmaxf(floorf(x), 0.f), (float)(W - 2));
  const float fy0 = fminf(fmaxf(floorf(y), 0.f), (float)(H - 2));
  c.wx = x - fx0;
  c.wy = y - fy0;
  c.x0 = (int)fx0;
  c.y0 = (int)fy0;
  c.w00 = (1.f - c.wx) * (1.f - c.wy);
  c.w01 = c.wx * (1.f - c.wy);
  c.w10 = (1.f - c.wx) * c.wy;
  c.w11 = c.wx * c.wy;
  return c;
}

// The JAX package's gradient of clip(v, 0, hi): a tie at either bound
// splits it, 0.5.
__device__ __forceinline__ float clip_grad(float v, float hi) {
  if (v > 0.f && v < hi) return 1.f;
  return (v == 0.f || v == hi) ? 0.5f : 0.f;
}

// dL/du of a (point, plane) row from its channel sum dw (r the texel
// coordinate before the clamp, n the plane's side along u).
__device__ __forceinline__ float coord_grad(float dw, float r, int n) {
  return dw * clip_grad(r, (float)(n - 1)) * (float)(n - 1) * 0.5f;
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
#define HIST_MAX 16384      // tiles a shared histogram (or cursor array) holds (64 KB)
#define MATRIX_MAX (8 << 20)  // entries of the (blocks, tiles) count matrix

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
  int* chunk_start;  // (T + 1,) first chunk of each tile
  int* slot_start;   // (T,) first scratch slot of a split tile
  int* split_tiles;  // (T,) the split tiles
  int* chunk_tile;   // (T + NSLOT,) the tile of each chunk
  int* meta;         // (META_WORDS,)
  int* matrix;       // (B, T) rows of each tile in each count block's run, then
                     // each block's first entry within the tile's list
};

static BwdScratch carve(int* base, long long R, int T) {
  BwdScratch s;
  int* p = base;
  s.keys = p; p += R;
  s.ids = p; p += 4 * R;
  s.counts = p; p += T;
  s.offsets = p; p += T + 1;
  s.chunk_start = p; p += T + 1;
  s.slot_start = p; p += T;
  s.split_tiles = p; p += T;
  s.chunk_tile = p; p += T + NSLOT;
  s.meta = p; p += META_WORDS;
  s.matrix = p;
  return s;
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

// Blocks of the count pass (and warps of the scatter, which walk the same
// runs of rows): a few rows per thread, at most 8 per SM, and few enough
// that the count matrix stays within MATRIX_MAX entries.
static int count_blocks(long long R, int C, int T) {
  long long b = (R * (C / 4) + 16LL * BWD_THREADS - 1) / (16LL * BWD_THREADS);
  const long long most = 8LL * num_sms(), fit = MATRIX_MAX / T;
  if (b > most) b = most;
  if (b > fit) b = fit;
  return (int)(b < 1 ? 1 : b);
}

static long long scratch_int_words(long long R, int T, int B) {
  return 5 * R + 6LL * T + NSLOT + 2 + META_WORDS + (long long)B * T;
}

// A row's key: its cell's tile, and whether its footprint crosses the
// tile's right or bottom edge.
template <int C>
__device__ __forceinline__ int key_of(const Cell& c, int p, int tx_n, int ty_n) {
  constexpr int TY = Tile<C>::TY;
  const int t = (p * ty_n + c.y0 / TY) * tx_n + c.x0 / TX;
  return (t << 2) | (((c.y0 % TY) == TY - 1) << 1) | ((c.x0 % TX) == TX - 1);
}

// The k-th tile (k = 0: the row's own; 1: right, 2: below, 3: both) a
// row's key lists it in, or -1.
__device__ __forceinline__ int tile_of_key(int key, int k, int tx_n) {
  if (key < 0) return -1;
  const int dx = k & 1, dy = k >> 1;
  if ((dx && !(key & 1)) || (dy && !(key & 2))) return -1;
  return (key >> 2) + dx + dy * tx_n;
}

// A row's tiles counted into the histogram h: the lanes of the warp that
// count into one tile add once (every lane calls it; key -1: none).
__device__ __forceinline__ void count_key(int key, int tx_n, int lane, int* h) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int t = tile_of_key(key, k, tx_n);
    const unsigned int same = __match_any_sync(0xffffffffu, t);
    if (t >= 0 && lane == __ffs(same) - 1) atomicAdd(h + t, __popc(same));
  }
}

// The rows of block b are [b * span, min((b + 1) * span, rows)).
__device__ __forceinline__ unsigned int run_span(unsigned int rows) {
  return (rows + gridDim.x - 1) / gridDim.x;
}

// At most 32 registers: count_blocks launches 8 blocks an SM, all resident.
template <int C>
__global__ void __launch_bounds__(BWD_THREADS, 8) bwd_count_kernel(const float* __restrict__ xyz,
                                                                   const float* __restrict__ g,
                                                                   unsigned int rows, int H, int W,
                                                                   float lbound, int T, int use_hist,
                                                                   int* __restrict__ keys,
                                                                   int* __restrict__ matrix) {
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
  const unsigned int span = run_span(rows);
  const unsigned int end = min(rows, (blockIdx.x + 1) * span);
  int* row_counts = matrix + (size_t)blockIdx.x * T;
  int* h = use_hist ? hist : row_counts;
  // a row's key and its tiles' counts, from its group's cotangent slices
  auto count_row = [&](unsigned int row, float4 q) {
    const bool valid = row < end;
    int nz = valid && ((q.x != 0.f) | (q.y != 0.f) | (q.z != 0.f) | (q.w != 0.f));
#pragma unroll
    for (int o = 1; o < G; o <<= 1) nz |= __shfl_xor_sync(0xffffffffu, nz, o);
    int key = -1;  // the row's key, on its group's first lane
    const unsigned int m = row / 3u;
    const int p = (int)(row - 3u * m);
    if (valid && sub == 0 && nz)
      key = key_of<C>(cell_of(xyz[3 * m], xyz[3 * m + 1], xyz[3 * m + 2], p, lbound, H, W), p, tx_n, ty_n);
    if (valid && sub == 0) keys[row] = key;
    count_key(key, tx_n, lane, h);
  };
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  // two iterations' cotangent slices in flight at once
  for (unsigned int base = blockIdx.x * span + (threadIdx.x / 32) * per_warp; base < end; base += 2 * step) {
    const unsigned int row = base + lane / G, row2 = row + step;
    const float4 q = row < end ? reinterpret_cast<const float4*>(g + (size_t)row * C)[sub] : zero;
    const float4 q2 = row2 < end ? reinterpret_cast<const float4*>(g + (size_t)row2 * C)[sub] : zero;
    count_row(row, q);
    count_row(row2, q2);
  }
  if (use_hist) {
    __syncthreads();
    for (int i = threadIdx.x; i < T; i += blockDim.x) row_counts[i] = hist[i];
  }
}

// 32 tiles per block of SCAN_THREADS: lane = tile, warp = one of 32
// segments of the count blocks. Each column of the count matrix becomes the
// exclusive prefix over the blocks (a block's first entry within the tile's
// list), and its sum the tile's count.
__global__ void __launch_bounds__(SCAN_THREADS) bwd_colscan_kernel(int* __restrict__ matrix, int B, int T,
                                                                   int* __restrict__ counts) {
  __shared__ int seg[32][33];
  const int lane = threadIdx.x & 31, s = threadIdx.x >> 5;
  const int t = blockIdx.x * 32 + lane;
  const int per = (B + 31) / 32, b0 = min(s * per, B), b1 = min(b0 + per, B);
  int sum = 0;
  if (t < T)
    for (int b = b0; b < b1; ++b) sum += matrix[(size_t)b * T + t];
  seg[s][lane] = sum;
  __syncthreads();
  {  // warp s scans the segments of tile blockIdx.x * 32 + s (lane = segment)
    const int v = seg[lane][s];
    int incl = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += u;
    }
    seg[lane][s] = incl - v;
    const int ts = blockIdx.x * 32 + s;
    if (lane == 31 && ts < T) counts[ts] = incl;
  }
  __syncthreads();
  if (t < T) {
    int run = seg[s][lane];
    for (int b = b0; b < b1; ++b) {
      const int c = matrix[(size_t)b * T + t];
      matrix[(size_t)b * T + t] = run;
      run += c;
    }
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

// 32 rows (one a lane, in row order; key -1: none) into the lists of the
// tiles their footprints touch, at the tiles' cursors (then advanced), the
// lanes that go to one tile ranked by lane. The cursors live in shared
// memory (SHARED) or in the block's row of the matrix (cur_g, each a
// tile's entries before the block's).
template <bool SHARED>
__device__ __forceinline__ void scatter_rows(int key, int row, int tx_n, int lane, int* cur_s, volatile int* cur_g,
                                             const int* __restrict__ offsets, int* __restrict__ ids) {
  const unsigned int below = (1u << lane) - 1u;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int t = tile_of_key(key, k, tx_n);
    const unsigned int same = __match_any_sync(0xffffffffu, t);
    const int leader = __ffs(same) - 1;
    int pos = 0;
    if (t >= 0 && lane == leader) {
      if constexpr (SHARED) {
        pos = cur_s[t];
        cur_s[t] = pos + __popc(same);
      } else {
        pos = cur_g[t];
        cur_g[t] = pos + __popc(same);
        pos += offsets[t];
      }
    }
    pos = __shfl_sync(0xffffffffu, pos, leader);
    if (t >= 0) ids[pos + __popc(same & below)] = row;
    __syncwarp();
  }
}

// One warp per count block, over the block's run of rows in order: each
// row's id into the list of each tile its footprint touches.
template <bool SHARED>
__global__ void __launch_bounds__(32) bwd_scatter_kernel(const int* __restrict__ keys, unsigned int rows,
                                                         int tx_n, int T, const int* __restrict__ offsets,
                                                         int* __restrict__ matrix, int* __restrict__ ids) {
  extern __shared__ int cur_s[];
  const int lane = threadIdx.x;
  int* row_pos = matrix + (size_t)blockIdx.x * T;
  if constexpr (SHARED) {
    for (int i = lane; i < T; i += 32) cur_s[i] = offsets[i] + row_pos[i];
    __syncwarp();
  }
  const unsigned int span = run_span(rows);
  const unsigned int lo = blockIdx.x * span, hi = min(rows, lo + span);
  int key = lo + lane < hi ? keys[lo + lane] : -1;
  for (unsigned int base = lo; base < hi; base += 32) {
    const unsigned int row = base + lane;
    const int next = row + 32 < hi ? keys[row + 32] : -1;
    if (__ballot_sync(0xffffffffu, key >= 0) != 0)  // else 32 rows with no cotangent
      scatter_rows<SHARED>(key, (int)row, tx_n, lane, cur_s, row_pos, offsets, ids);
    key = next;
  }
}

// The points of K2x²'s first pass: a contiguous run per block, a contiguous
// part of it per warp (COUNT_WARPS warps a block); [*lo, *hi) is warp w's.
#define COUNT_WARPS (BWD_THREADS / 32)
__device__ __forceinline__ void warp_points(unsigned int M, int w, unsigned int* lo, unsigned int* hi) {
  const unsigned int pspan = (M + gridDim.x - 1) / gridDim.x, wspan = (pspan + COUNT_WARPS - 1) / COUNT_WARPS;
  const unsigned int b0 = blockIdx.x * pspan, b1 = min(M, b0 + pspan);
  *lo = min(b1, b0 + w * wspan);
  *hi = min(b1, *lo + wspan);
}

// K2x²: a block per count block, over the lists of reached rows its first
// pass wrote (warp by warp, each in row order), so the tiles' lists come out
// as the row walk above makes them. The block's threads set the cursors;
// one warp walks the block's lists as one sequence, 32 entries at a time,
// the next 32 loaded while it places these.
template <bool SHARED>
__global__ void __launch_bounds__(BWD_THREADS) bwd_scatter_list_kernel(const int* __restrict__ keys,
                                                                       const int* __restrict__ rowlist,
                                                                       const int* __restrict__ list_count,
                                                                       unsigned int M, int tx_n, int T,
                                                                       const int* __restrict__ offsets,
                                                                       int* __restrict__ matrix,
                                                                       int* __restrict__ ids) {
  extern __shared__ int cur_s[];
  const int lane = threadIdx.x;
  int* row_pos = matrix + (size_t)blockIdx.x * T;
  if constexpr (SHARED) {
    for (int i = threadIdx.x; i < T; i += blockDim.x) cur_s[i] = offsets[i] + row_pos[i];
    __syncthreads();
  }
  if (threadIdx.x >= 32) return;
  // lane w < COUNT_WARPS: list w's first slot (3 lo) and the entries up to its end
  unsigned int lo = 0, hi = 0;
  int upto = 0;
  if (lane < COUNT_WARPS) {
    warp_points(M, lane, &lo, &hi);
    upto = list_count[blockIdx.x * COUNT_WARPS + lane];
  }
#pragma unroll
  for (int o = 1; o < COUNT_WARPS; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, upto, o);
    if (lane >= o) upto += y;
  }
  const int total = __shfl_sync(0xffffffffu, upto, COUNT_WARPS - 1);
  // entry i of the sequence: its list's slot
  auto slot = [&](int i) {
    int w = 0;
#pragma unroll
    for (int k = 0; k < COUNT_WARPS - 1; ++k) w += __shfl_sync(0xffffffffu, upto, k) <= i;
    const int before = __shfl_sync(0xffffffffu, upto, (w + COUNT_WARPS - 1) % COUNT_WARPS);
    return 3 * (long long)__shfl_sync(0xffffffffu, lo, w) + i - (w ? before : 0);
  };
  long long at = slot(lane);
  int key = lane < total ? keys[at] : -1, row = lane < total ? rowlist[at] : 0;
  for (int i = 0; i < total; i += 32) {
    at = slot(i + 32 + lane);
    const bool more = i + 32 + lane < total;
    const int next_key = more ? keys[at] : -1, next_row = more ? rowlist[at] : 0;
    scatter_rows<SHARED>(key, row, tx_n, lane, cur_s, row_pos, offsets, ids);
    key = next_key;
    row = next_row;
  }
}

// Persistent blocks over the chunks: each accumulates its rows' w * g into
// its tile in shared memory, then writes the tile (in the plane dtype) or,
// for a chunk of a split tile, its float32 partial. Shared-memory float
// atomics compile to compare-and-swap loops on sm_90 (ATOMS.CAST.SPIN), so
// no two threads add into one texel word: the chunk's rows go in batches of
// BATCH (one per thread; a batch's cotangent rows and points are fetched
// while the batch before it is summed), each row's cotangent, cell and
// weights staged in shared memory, and its (row, corner) items sorted by
// texel with a counting sort whose ranks are fixed by (warp, corner, lane):
// per-warp byte counts of each texel, ranks within a warp by
// __match_any_sync; then the items, in texel order, are split evenly over
// the lane groups (C / 4 lanes, a float4 of channels each): a group sums
// each run of one texel in registers and adds it to the tile with a plain
// load and store; the first and last texel of its range, which the groups
// beside it may share, go to slots that are added afterwards in group order
// (so a texel with many items is shared out, and every sum runs in an order
// fixed by the inputs).
// Channels 4 c4 .. 4 c4 + 3 of texel (oy + ly, ox + lx) of plane p, float4
// i = (ly, lx, c4) of a tile, into the plane gradient in its dtype (rows of a
// tile are contiguous in the plane); nothing past the plane's edge.
template <int C, typename T>
__device__ __forceinline__ void store_tile4(T* __restrict__ grad, int p, int oy, int ox, int H, int W, int i,
                                            float4 v) {
  const int ly = i / (TX * C / 4), r = i - ly * (TX * C / 4);
  const int lx = r / (C / 4), c4 = r - lx * (C / 4);
  const int y = oy + ly, x = ox + lx;
  if (y >= H || x >= W) return;
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

#define BATCH BWD_THREADS   // rows staged at once, one per thread

// A row's cotangent and point (nothing for row < 0), and in DERIV mode the
// point's gg.
template <int C, bool DERIV>
__device__ __forceinline__ void fetch_row(int row, const float* __restrict__ g, const float* __restrict__ xyz,
                                          const float* __restrict__ ggx, float4* q, float* pt, float* gx) {
  if (row < 0) return;
  const float4* gr = reinterpret_cast<const float4*>(g + (size_t)row * C);
#pragma unroll
  for (int k = 0; k < C / 4; ++k) q[k] = gr[k];
  const unsigned int m = (unsigned int)row / 3u;
#pragma unroll
  for (int d = 0; d < 3; ++d) pt[d] = xyz[3 * m + d];
  if constexpr (DERIV) {
#pragma unroll
    for (int d = 0; d < 3; ++d) gx[d] = ggx[3 * m + d];
  }
}

// (s_u, s_v) = clip'(r)(n - 1)/2 of a cell's two texel coordinates: the
// derivatives of wx and wy in the plane's coordinates u and v.
__device__ __forceinline__ float2 texel_scales(const Cell& c, int H, int W) {
  return make_float2(clip_grad(c.xr, (float)(W - 1)) * (float)(W - 1) * 0.5f,
                     clip_grad(c.yr, (float)(H - 1)) * (float)(H - 1) * 0.5f);
}

// The coefficients (c_u, c_v) of K2x² at plane p's cell: gg's components
// along the plane's axes over lbound, times (s_u, s_v).
__device__ __forceinline__ float2 deriv_coeffs(int p, const float* gx, float lbound, float2 s) {
  const float au = (p == 2 ? gx[1] : gx[0]) / lbound, av = (p == 1 ? gx[1] : gx[2]) / lbound;
  return make_float2(au * s.x, av * s.y);
}

// The derivatives of the four bilinear weights along gg (K2x²'s plane
// gradient weights), in the order w00, w01, w10, w11.
__device__ __forceinline__ float4 deriv_weights(const Cell& c, int p, const float* gx, float lbound, int H, int W) {
  const float2 k = deriv_coeffs(p, gx, lbound, texel_scales(c, H, W));
  const float cu = k.x, cv = k.y;
  return make_float4(-(cu * (1.f - c.wy) + cv * (1.f - c.wx)), cu * (1.f - c.wy) - cv * c.wx,
                     cv * (1.f - c.wx) - cu * c.wy, cu * c.wy + cv * c.wx);
}

// DERIV: K2x²'s plane gradient, each row's weights the derivatives of the
// bilinear weights along its point's gg (deriv_weights).
template <int C, typename T, bool DERIV>
__global__ void __launch_bounds__(BWD_THREADS) bwd_accumulate_kernel(const float* __restrict__ xyz,
                                                                     const float* __restrict__ g,
                                                                     int H, int W, float lbound,
                                                                     BwdScratch s, T* __restrict__ grad,
                                                                     float* __restrict__ partials,
                                                                     const float* __restrict__ ggx,
                                                                     int* __restrict__ next_chunk) {
  constexpr int G = C / 4, TY = Tile<C>::TY, FLOATS = Tile<C>::FLOATS;
  constexpr int NT = TX * TY;               // texels of a tile
  constexpr int GROUPS = BWD_THREADS / G;   // lane groups of a block
  constexpr int PER = NT / BWD_THREADS;     // texel counts scanned per thread
  constexpr int WARPS = BWD_THREADS / 32;
  extern __shared__ float4 tile4[];          // the tile, then the range-edge slots' sums
  float4* edge_acc = tile4 + FLOATS / 4;     // (2 GROUPS, G) sums of the ranges' first and last texels
  int* edge_tx = reinterpret_cast<int*>(edge_acc + 2 * GROUPS * G);  // (2 GROUPS,) their texels or -1
  __shared__ float4 sg4[BATCH * G];          // the rows' cotangents
  __shared__ float4 sw[BATCH];               // the rows' weights w00, w01, w10, w11
  __shared__ int toff[NT + 1];               // texel offsets
  __shared__ __align__(16) unsigned char wcnt[WARPS][NT];  // items of each texel per warp, then their prefix
  __shared__ int items[4 * BATCH];           // texel << 10 | row << 2 | corner, by texel
  __shared__ int warp_sums[WARPS];
  __shared__ int taken[2];                   // DERIV: the chunks taken, by parity of the turn
  const int tx_n = tiles_x(W), ty_n = (H + TY - 1) / TY;
  const int chunks = s.meta[META_CHUNKS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned int below = (1u << lane) - 1u;
  const int sub = threadIdx.x % G, group = threadIdx.x / G;
  // the K2 backward's blocks take every gridDim.x-th chunk; K2x²'s take the
  // next from a counter, so blocks that drew empty or light tiles take more
  for (int turn = 0;; ++turn) {
    int ch = blockIdx.x + turn * gridDim.x;
    if constexpr (DERIV) {
      if (threadIdx.x == 0) taken[turn & 1] = atomicAdd(next_chunk, 1);
      __syncthreads();
      ch = taken[turn & 1];
    }
    if (ch >= chunks) break;
    const int t = s.chunk_tile[ch];
    const int j = ch - s.chunk_start[t], n = s.chunk_start[t + 1] - s.chunk_start[t];
    const int first = s.offsets[t], cnt = s.offsets[t + 1] - first;
    const int e0 = first + (int)((long long)cnt * j / n), e1 = first + (int)((long long)cnt * (j + 1) / n);
    const int p = t / (tx_n * ty_n), rem = t - p * tx_n * ty_n;
    const int oy = (rem / tx_n) * TY, ox = (rem % tx_n) * TX;
    if constexpr (DERIV) {
      if (cnt == 0) {  // a tile no row touches: its zeros from registers, the shared tile left alone
        for (int i = threadIdx.x; i < FLOATS / 4; i += BWD_THREADS)
          store_tile4<C>(grad, p, oy, ox, H, W, i, make_float4(0.f, 0.f, 0.f, 0.f));
        continue;
      }
    }
    for (int i = threadIdx.x; i < FLOATS / 4; i += BWD_THREADS) tile4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    // one row per thread: the first batch's fetched now, each later batch's
    // while the batch before it is summed
    const int r = threadIdx.x;
    int row = e0 + r < e1 ? s.ids[e0 + r] : -1;
    float4 q[G];
    float pt[3], gx[3];
    fetch_row<C, DERIV>(row, g, xyz, ggx, q, pt, gx);
    for (int b0 = e0; b0 < e1; b0 += BATCH) {
      const int next_row = b0 + BATCH + r < e1 ? s.ids[b0 + BATCH + r] : -1;
      for (int i = threadIdx.x; i < WARPS * NT / 16; i += BWD_THREADS)
        reinterpret_cast<uint4*>(&wcnt[0][0])[i] = make_uint4(0u, 0u, 0u, 0u);
      __syncthreads();
      // stage the row; rank its corners in the tile among the warp's items
      // of the same texel
      int texel[4] = {-1, -1, -1, -1}, slot[4];
      if (row >= 0) {
#pragma unroll
        for (int k = 0; k < G; ++k) sg4[r * G + k] = q[k];
        const int p = (int)((unsigned int)row % 3u);
        const Cell c = cell_of(pt[0], pt[1], pt[2], p, lbound, H, W);
        if constexpr (DERIV) {
          sw[r] = deriv_weights(c, p, gx, lbound, H, W);
        } else {
          sw[r] = make_float4(c.w00, c.w01, c.w10, c.w11);
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int lx = c.x0 + (k & 1) - ox, ly = c.y0 + (k >> 1) - oy;
          if (lx >= 0 && lx < TX && ly >= 0 && ly < TY) texel[k] = ly * TX + lx;
        }
      }
      unsigned char* wc = wcnt[warp];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int x = texel[k];
        const unsigned int same = __match_any_sync(0xffffffffu, x);
        const int leader = __ffs(same) - 1;
        int base = 0;
        if (x >= 0 && lane == leader) {
          base = wc[x];
          wc[x] = (unsigned char)(base + __popc(same));
        }
        slot[k] = __shfl_sync(0xffffffffu, base, leader) + __popc(same & below);
        __syncwarp();
      }
      __syncthreads();
      // per texel: the warps' counts turned into their prefix (<= 7 x 32
      // fits a byte), then an exclusive scan of the texel totals, PER
      // consecutive texels per thread
      int local[PER], sum = 0;
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int x = threadIdx.x * PER + k;
        int run = 0;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
          const int c = wcnt[w][x];
          wcnt[w][x] = (unsigned char)run;
          run += c;
        }
        local[k] = run;
        sum += run;
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
        if (texel[k] >= 0)
          items[toff[texel[k]] + wc[texel[k]] + slot[k]] = (texel[k] << 10) | (r << 2) | k;
      __syncthreads();
      row = next_row;
      fetch_row<C, DERIV>(row, g, xyz, ggx, q, pt, gx);
      // the items in texel order, split evenly over the lane groups: each
      // sums runs of one texel and adds a run to the tile once; the first
      // and last texel of a group's range may be shared with the groups
      // beside it, so their sums go to the edge slots, added below in
      // group order by the first slot of each texel
      const int n_items = toff[NT], per = (n_items + GROUPS - 1) / GROUPS;
      const int lo = min(group * per, n_items), hi = min(lo + per, n_items);
      int cur = -1, runs = 0;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int i = lo; i < hi; ++i) {
        const int it = items[i], tx = it >> 10, rr = (it >> 2) & 255, k = it & 3;
        if (tx != cur) {
          if (runs == 1) {
            edge_acc[2 * group * G + sub] = acc;
            if (sub == 0) edge_tx[2 * group] = cur;
          } else if (runs > 1) {
            float4* d = tile4 + cur * G + sub;
            float4 v = *d;
            v.x += acc.x;
            v.y += acc.y;
            v.z += acc.z;
            v.w += acc.w;
            *d = v;
          }
          cur = tx;
          ++runs;
          acc = make_float4(0.f, 0.f, 0.f, 0.f);
        }
        const float4 wv = sw[rr];
        const float w = k == 0 ? wv.x : k == 1 ? wv.y : k == 2 ? wv.z : wv.w;
        const float4 q = sg4[rr * G + sub];
        acc.x += w * q.x;
        acc.y += w * q.y;
        acc.z += w * q.z;
        acc.w += w * q.w;
      }
      // the last run: the first slot when it is the range's only one
      edge_acc[(2 * group + (runs > 1)) * G + sub] = acc;
      if (sub == 0) {
        edge_tx[2 * group + (runs > 1)] = runs > 0 ? cur : -1;
        if (runs <= 1) edge_tx[2 * group + 1] = -1;
      }
      __syncthreads();
      for (int e = 2 * group; e < 2 * group + 2; ++e) {
        const int tx = edge_tx[e];
        if (tx < 0) continue;
        int before = e - 1;
        while (before >= 0 && edge_tx[before] < 0) --before;
        if (before >= 0 && edge_tx[before] == tx) continue;  // not this texel's first slot
        float4 sum = edge_acc[e * G + sub];
        for (int f = e + 1; f < 2 * GROUPS; ++f) {
          const int fx = edge_tx[f];
          if (fx < 0) continue;
          if (fx != tx) break;
          const float4 a = edge_acc[f * G + sub];
          sum.x += a.x;
          sum.y += a.y;
          sum.z += a.z;
          sum.w += a.w;
        }
        float4* d = tile4 + tx * G + sub;
        float4 v = *d;
        v.x += sum.x;
        v.y += sum.y;
        v.z += sum.z;
        v.w += sum.w;
        *d = v;
      }
      __syncthreads();
    }
    if (n == 1) {
      for (int i = threadIdx.x; i < FLOATS / 4; i += BWD_THREADS) store_tile4<C>(grad, p, oy, ox, H, W, i, tile4[i]);
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
      float4 v = src[i];
      for (int j = 1; j < n; ++j) {
        const float4 a = src[(size_t)j * (FLOATS / 4) + i];
        v.x += a.x;
        v.y += a.y;
        v.z += a.z;
        v.w += a.w;
      }
      store_tile4<C>(grad, p, oy, ox, H, W, i, v);
    }
  }
}

static int tiles_of(int H, int W, int C) {
  const int TY = C == 32 ? 16 : 32;
  return 3 * ((H + TY - 1) / TY) * tiles_x(W);
}

// K2x²'s lists of reached rows, after the count matrix: (R,) row ids, then
// (B, COUNT_WARPS) counts, then the accumulate pass's chunk counter.
static int* list_rows(const BwdScratch& s, int B, int T) { return s.matrix + (size_t)B * T; }

// The passes after the count: column scan, scan, scatter, accumulate,
// reduce. DERIV: K2x²'s (the scatter over the first pass's lists of reached
// rows; the accumulate pass's derivative weights from ggx).
template <int C, typename T, bool DERIV>
static int launch_bins(const float* xyz, const float* g, int M, int H, int W, float lbound, T* grad,
                       const BwdScratch& s, int B, int T_, float* partials, cudaStream_t stream,
                       const float* ggx = nullptr) {
  const unsigned int rows = 3u * (unsigned int)M;
  const int sms = num_sms(), use_hist = T_ <= HIST_MAX;
  cudaError_t err;
  // 2. column scan of the count matrix
  bwd_colscan_kernel<<<(T_ + 31) / 32, SCAN_THREADS, 0, stream>>>(s.matrix, B, T_, s.counts);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // 3. scan
  bwd_scan_kernel<<<1, SCAN_THREADS, 0, stream>>>(s.counts, T_, s);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // 4. scatter: one warp per count block
  if constexpr (DERIV) {
    const int* rl = list_rows(s, B, T_);
    const int* lc = rl + rows;
    if (use_hist) {
      static bool attr = false;
      if (!attr) {
        cudaFuncSetAttribute(bwd_scatter_list_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             4 * HIST_MAX);
        attr = true;
      }
      bwd_scatter_list_kernel<true><<<B, BWD_THREADS, sizeof(int) * (size_t)T_, stream>>>(
          s.keys, rl, lc, (unsigned int)M, tiles_x(W), T_, s.offsets, s.matrix, s.ids);
    } else {
      bwd_scatter_list_kernel<false><<<B, 32, 0, stream>>>(s.keys, rl, lc, (unsigned int)M, tiles_x(W), T_,
                                                           s.offsets, s.matrix, s.ids);
    }
  } else if (use_hist) {
    static bool scatter_attr = false;
    if (!scatter_attr) {
      cudaFuncSetAttribute(bwd_scatter_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, 4 * HIST_MAX);
      scatter_attr = true;
    }
    bwd_scatter_kernel<true><<<B, 32, sizeof(int) * (size_t)T_, stream>>>(s.keys, rows, tiles_x(W), T_,
                                                                           s.offsets, s.matrix, s.ids);
  } else {
    bwd_scatter_kernel<false><<<B, 32, 0, stream>>>(s.keys, rows, tiles_x(W), T_, s.offsets, s.matrix, s.ids);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // 5. accumulate: as many resident blocks as the tile's shared memory allows
  // the tile and the edge slots: (2 GROUPS, G) float4 sums and 2 GROUPS texels
  const size_t tile_bytes = sizeof(float) * (size_t)Tile<C>::FLOATS + sizeof(float4) * 2 * BWD_THREADS +
                            sizeof(int) * 2 * (BWD_THREADS / (C / 4));
  static int per_sm = 0;
  if (per_sm == 0) {
    cudaFuncSetAttribute(bwd_accumulate_kernel<C, T, DERIV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)tile_bytes);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bwd_accumulate_kernel<C, T, DERIV>, BWD_THREADS,
                                                  tile_bytes);
    if (per_sm < 1) per_sm = 1;
  }
  bwd_accumulate_kernel<C, T, DERIV><<<per_sm * sms, BWD_THREADS, tile_bytes, stream>>>(
      xyz, g, H, W, lbound, s, grad, partials, ggx, DERIV ? list_rows(s, B, T_) + rows + COUNT_WARPS * B : nullptr);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // 6. reduce the split tiles
  bwd_reduce_kernel<C, T><<<2 * sms, BWD_THREADS, 0, stream>>>(H, W, s, partials, grad);
  return (int)cudaGetLastError();
}

template <int C, typename T>
static int launch_bwd(const float* xyz, const float* g, int M, int H, int W, float lbound, T* grad,
                      int* iscratch, float* partials, cudaStream_t stream) {
  const int T_ = tiles_of(H, W, C);
  const unsigned int rows = 3u * (unsigned int)M;
  const int B = count_blocks(rows, C, T_);
  BwdScratch s = carve(iscratch, rows, T_);
  cudaError_t err;
  // 1. count: each block a few rows per thread, so its histogram's zeroing
  // and write-out stay small beside them; without a block-local histogram
  // the block adds into its zeroed row of the matrix
  const int use_hist = T_ <= HIST_MAX;
  if (!use_hist && (err = cudaMemsetAsync(s.matrix, 0, sizeof(int) * (size_t)B * T_, stream)) != cudaSuccess)
    return (int)err;
  const size_t hist_bytes = use_hist ? sizeof(int) * (size_t)T_ : 0;
  static bool hist_attr = false;
  if (!hist_attr) {
    cudaFuncSetAttribute(bwd_count_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, 4 * HIST_MAX);
    hist_attr = true;
  }
  bwd_count_kernel<C><<<B, BWD_THREADS, hist_bytes, stream>>>(xyz, g, rows, H, W, lbound, T_, use_hist,
                                                              s.keys, s.matrix);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return launch_bins<C, T, false>(xyz, g, M, H, W, lbound, grad, s, B, T_, partials, stream);
}

// Scratch the K2 backward (and K2x's plane gradient) needs at these sizes:
// int32 words and float32 words (the partial tiles), allocated by the caller.
extern "C" int sample_points_backward_workspace(int M, int H, int W, int C, long long* int_words,
                                                long long* float_words) {
  if (C != 4 && C != 8 && C != 16 && C != 32) return (int)cudaErrorInvalidValue;
  const int TY = C == 32 ? 16 : 32, T = tiles_of(H, W, C);
  *int_words = scratch_int_words(3LL * M, T, count_blocks(3LL * M, C, T));
  *float_words = (long long)NSLOT * TX * TY * C;
  return 0;
}

// K2x²'s scratch with its plane gradient: the K2 backward's, and the first
// pass's lists of reached rows.
extern "C" int sample_points_backward_xyz_backward_workspace(int M, int H, int W, int C, long long* int_words,
                                                             long long* float_words) {
  const int err = sample_points_backward_workspace(M, H, W, C, int_words, float_words);
  if (err == 0) *int_words += 3LL * M + (long long)COUNT_WARPS * count_blocks(3LL * M, C, tiles_of(H, W, C)) + 1;
  return err;
}

// xyz (M, 3) f32, g (M, 3, C) f32 -> grad (3, H, W, C) in the plane dtype
// (bf16 != 0: bf16, else f32), every element written. iscratch and partials
// as sample_points_backward_workspace sizes them. Six launches (and, for
// planes of more than HIST_MAX tiles, a memset of the count matrix) on the
// stream; no synchronisation.
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

// dL/dxyz: a group of L lanes per point (L divides 32, so a group lies in
// one warp, and every lane of the grid's last warp runs the shuffles). The
// three cotangent slices are loaded before any corner, so a lane has them
// in flight together; with the count pass's keys (the plane gradient's
// passes ran first) a row whose key is -1, an all-zero cotangent, is not
// read at all.
template <int C, typename T>
__global__ void __launch_bounds__(256) bwd_xyz_kernel(const T* __restrict__ planes, const float* __restrict__ xyz,
                                                      const float* __restrict__ g, const int* __restrict__ keys,
                                                      unsigned int M, int H, int W, float lbound,
                                                      float* __restrict__ dxyz) {
  constexpr int L = FwdShape<C, T>::L, N = FwdShape<C, T>::N;
  const unsigned int t = blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned int m = t / L;  // L is a power of two
  const int sub = (int)(t % L);
  const bool valid = m < M;
  float pt[3] = {0.f, 0.f, 0.f}, gv[3][N];
  int nz[3] = {0, 0, 0};
  if (valid) {
#pragma unroll
    for (int d = 0; d < 3; ++d) pt[d] = xyz[3 * m + d];
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      if (keys == nullptr || keys[3u * m + p] >= 0) {
        load_slice<N>(g + (3u * m + p) * C + sub * N, gv[p]);
      } else {
#pragma unroll
        for (int k = 0; k < N; ++k) gv[p][k] = 0.f;
      }
    }
  }
  float du[3], dv[3];
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    if (valid) {
#pragma unroll
      for (int k = 0; k < N; ++k) nz[p] |= gv[p][k] != 0.f;
    }
#pragma unroll
    for (int o = 1; o < L; o <<= 1) nz[p] |= __shfl_xor_sync(0xffffffffu, nz[p], o);
    float dwx = 0.f, dwy = 0.f;
    Cell c{};
    if (nz[p]) {  // unrouted or masked samples read no corner: both gradients are 0
      c = cell_of(pt[0], pt[1], pt[2], p, lbound, H, W);
      const T* r00 = planes + ((unsigned int)(p * H + c.y0) * (unsigned int)W + (unsigned int)c.x0) * C + sub * N;
      const T* r10 = r00 + W * C;
      float f00[N], f01[N], f10[N], f11[N];
      load_slice<N>(r00, f00);
      load_slice<N>(r00 + C, f01);
      load_slice<N>(r10, f10);
      load_slice<N>(r10 + C, f11);
#pragma unroll
      for (int k = 0; k < N; ++k) {
        dwx += gv[p][k] * ((f01[k] - f00[k]) * (1.f - c.wy) + (f11[k] - f10[k]) * c.wy);
        dwy += gv[p][k] * ((f10[k] - f00[k]) * (1.f - c.wx) + (f11[k] - f01[k]) * c.wx);
      }
    }
#pragma unroll
    for (int o = 1; o < L; o <<= 1) {
      dwx += __shfl_xor_sync(0xffffffffu, dwx, o);
      dwy += __shfl_xor_sync(0xffffffffu, dwy, o);
    }
    du[p] = nz[p] ? coord_grad(dwx, c.xr, W) : 0.f;
    dv[p] = nz[p] ? coord_grad(dwy, c.yr, H) : 0.f;
  }
  if (valid && sub == 0) {
    dxyz[3 * m] = (du[0] + du[1]) / lbound;
    dxyz[3 * m + 1] = (dv[1] + du[2]) / lbound;
    dxyz[3 * m + 2] = (dv[0] + dv[2]) / lbound;
  }
}

template <int C, typename T>
static int launch_xyz(const T* planes, const float* xyz, const float* g, int M, int H, int W, float lbound,
                      T* grad, int* iscratch, float* partials, float* dxyz, cudaStream_t stream) {
  const int* keys = nullptr;
  if (grad != nullptr) {
    const int err = launch_bwd<C, T>(xyz, g, M, H, W, lbound, grad, iscratch, partials, stream);
    if (err != 0) return err;
    keys = carve(iscratch, 3LL * M, tiles_of(H, W, C)).keys;
  }
  const unsigned long long n = (unsigned long long)M * FwdShape<C, T>::L;
  bwd_xyz_kernel<C, T><<<(unsigned int)((n + 255) / 256), 256, 0, stream>>>(planes, xyz, g, keys, (unsigned int)M,
                                                                          H, W, lbound, dxyz);
  return (int)cudaGetLastError();
}

// K2x. planes (3, H, W, C) channel-last, bf16 (bf16 != 0) or f32; xyz (M, 3)
// f32; g (M, 3, C) f32 -> grad (3, H, W, C) in the plane dtype, every element
// written (the K2 backward's passes, with iscratch and partials as
// sample_points_backward_workspace sizes them; grad null: not computed),
// and dxyz (M, 3) f32, every row written: seven launches, or one without the
// plane gradient. No synchronisation.
extern "C" int sample_points_backward_xyz_launch(const void* planes, const float* xyz,
                                                 const float* g, int M, int H, int W, int C,
                                                 int bf16, float lbound, void* grad, int* iscratch,
                                                 float* partials, float* dxyz, cudaStream_t stream) {
  if (M == 0) return 0;
  if (H < 2 || W < 2) return (int)cudaErrorInvalidValue;
#define K2X(CC)                                                                                      \
  case CC:                                                                                           \
    return bf16 ? launch_xyz<CC, __nv_bfloat16>((const __nv_bfloat16*)planes, xyz, g, M, H, W, lbound, \
                                                (__nv_bfloat16*)grad, iscratch, partials, dxyz, stream) \
                : launch_xyz<CC, float>((const float*)planes, xyz, g, M, H, W, lbound, (float*)grad,   \
                                        iscratch, partials, dxyz, stream);
  switch (C) {
    K2X(4)
    K2X(8)
    K2X(16)
    K2X(32)
    default: return (int)cudaErrorInvalidValue;
  }
#undef K2X
}

// ---------------------------------------------------------------------------
// K2x²
// ---------------------------------------------------------------------------

// K2x²'s first pass: a group of L lanes per point (as bwd_xyz_kernel; every
// lane runs the group's shuffles), the points in contiguous runs
// (warp_points). Per (point, plane) row, gg first: a row gg reaches (gg has
// a component along the plane's axes) reads its g slice and, where its
// coefficients c_u, c_v are not both zero, its four corner slices; dL/dg is
// written for every row (zeros where nothing reaches it), dL/dxyz per
// point. With matrix (the plane gradient asked for): a reached row with a g
// gets its key, counted into the block's histogram as the count pass
// counts, and each warp writes its reached rows' ids and keys, in row order,
// to its list (from 3 lo on; the count to list_count), which the scatter
// walks in place of every row's key.
template <int C, typename T>
__global__ void __launch_bounds__(BWD_THREADS, 4) bwd_xyz_bwd_kernel(
    const T* __restrict__ planes, const float* __restrict__ xyz, const float* __restrict__ g,
    const float* __restrict__ ggx, unsigned int M, int H, int W, float lbound, float* __restrict__ dg,
    float* __restrict__ dxyz, int T_, int use_hist, int* __restrict__ keys, int* __restrict__ rowlist,
    int* __restrict__ list_count, int* __restrict__ matrix) {
  constexpr int L = FwdShape<C, T>::L, N = FwdShape<C, T>::N, TY = Tile<C>::TY, PER = 32 / L;
  extern __shared__ int hist[];
  const bool counting = matrix != nullptr;
  if (counting && blockIdx.x == 0 && threadIdx.x == 0) list_count[gridDim.x * COUNT_WARPS] = 0;  // chunk counter
  if (counting && use_hist) {
    for (int i = threadIdx.x; i < T_; i += blockDim.x) hist[i] = 0;
    __syncthreads();
  }
  const int tx_n = tiles_x(W), ty_n = (H + TY - 1) / TY;
  const int lane = threadIdx.x & 31, sub = lane % L;
  const unsigned int below = (1u << lane) - 1u;
  unsigned int lo, hi;
  warp_points(M, threadIdx.x >> 5, &lo, &hi);
  int* h = !counting ? nullptr : use_hist ? hist : matrix + (size_t)blockIdx.x * T_;
  int listed = 0;  // the warp's reached rows so far
  for (unsigned int base = lo; base < hi; base += PER) {
    const unsigned int m = base + lane / L;
    const bool valid = m < hi;
    float pt[3] = {0.f, 0.f, 0.f}, gx[3] = {0.f, 0.f, 0.f};
    if (valid) {
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        pt[d] = xyz[3 * m + d];
        gx[d] = ggx[3 * m + d];
      }
    }
    float du[3], dv[3];
    int key[3];
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      const Cell c = cell_of(pt[0], pt[1], pt[2], p, lbound, H, W);
      const float2 sc = texel_scales(c, H, W), k = deriv_coeffs(p, gx, lbound, sc);
      const float cu = k.x, cv = k.y;
      const bool reached = valid && (gx[p == 2 ? 1 : 0] != 0.f || gx[p == 1 ? 1 : 2] != 0.f);
      float gv[N];
      int nz = 0;
      if (reached) {
        load_slice<N>(g + (3u * m + p) * C + sub * N, gv);
#pragma unroll
        for (int e = 0; e < N; ++e) nz |= gv[e] != 0.f;
      }
#pragma unroll
      for (int o = 1; o < L; o <<= 1) nz |= __shfl_xor_sync(0xffffffffu, nz, o);
      float hs = 0.f;
      float* out = dg == nullptr ? nullptr : dg + (3u * m + p) * C + sub * N;
      if (valid && (cu != 0.f || cv != 0.f)) {  // the same for the whole group; then reached
        const T* r00 = planes + ((unsigned int)(p * H + c.y0) * (unsigned int)W + (unsigned int)c.x0) * C + sub * N;
        const T* r10 = r00 + W * C;
        float f00[N], f01[N], f10[N], f11[N], ov[N];
        load_slice<N>(r00, f00);
        load_slice<N>(r00 + C, f01);
        load_slice<N>(r10, f10);
        load_slice<N>(r10 + C, f11);
#pragma unroll
        for (int e = 0; e < N; ++e) {
          ov[e] = cu * ((f01[e] - f00[e]) * (1.f - c.wy) + (f11[e] - f10[e]) * c.wy) +
                  cv * ((f10[e] - f00[e]) * (1.f - c.wx) + (f11[e] - f01[e]) * c.wx);
          hs += gv[e] * (f00[e] - f01[e] - f10[e] + f11[e]);
        }
        if (out != nullptr) {
#pragma unroll
          for (int e = 0; e < N / 4; ++e)
            reinterpret_cast<float4*>(out)[e] = make_float4(ov[4 * e], ov[4 * e + 1], ov[4 * e + 2], ov[4 * e + 3]);
        }
      } else if (valid && out != nullptr) {
#pragma unroll
        for (int e = 0; e < N / 4; ++e) reinterpret_cast<float4*>(out)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int o = 1; o < L; o <<= 1) hs += __shfl_xor_sync(0xffffffffu, hs, o);
      du[p] = cv * hs * sc.x;
      dv[p] = cu * hs * sc.y;
      key[p] = counting && reached && nz && sub == 0 ? key_of<C>(c, p, tx_n, ty_n) : -1;
    }
    if (valid && sub == 0 && dxyz != nullptr) {
      dxyz[3 * m] = (du[0] + du[1]) / lbound;
      dxyz[3 * m + 1] = (dv[1] + du[2]) / lbound;
      dxyz[3 * m + 2] = (dv[0] + dv[2]) / lbound;
    }
    if (counting) {
      const unsigned int r0 = __ballot_sync(0xffffffffu, key[0] >= 0), r1 = __ballot_sync(0xffffffffu, key[1] >= 0),
                         r2 = __ballot_sync(0xffffffffu, key[2] >= 0);
      int pos = 3 * (int)lo + listed + __popc(r0 & below) + __popc(r1 & below) + __popc(r2 & below);
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        count_key(key[p], tx_n, lane, h);
        if (key[p] >= 0) {
          keys[pos] = key[p];
          rowlist[pos] = (int)(3u * m + p);
          ++pos;
        }
      }
      listed += __popc(r0) + __popc(r1) + __popc(r2);
    }
  }
  if (counting) {
    if (lane == 0) list_count[blockIdx.x * COUNT_WARPS + (threadIdx.x >> 5)] = listed;
    if (use_hist) {
      __syncthreads();
      int* row_counts = matrix + (size_t)blockIdx.x * T_;
      for (int i = threadIdx.x; i < T_; i += blockDim.x) row_counts[i] = hist[i];
    }
  }
}

// K2x²: its first pass, then (with the plane gradient) the binned passes.
template <int C, typename T>
static int launch_xyz_bwd(const T* planes, const float* xyz, const float* g, const float* ggx, int M, int H, int W,
                          float lbound, float* dg, float* dxyz, T* grad, int* iscratch, float* partials,
                          cudaStream_t stream) {
  if (grad == nullptr) {  // dL/dg and dL/dxyz alone: a warp's points in one round
    if (dg == nullptr && dxyz == nullptr) return 0;
    const unsigned long long n = (unsigned long long)M * FwdShape<C, T>::L;
    bwd_xyz_bwd_kernel<C, T><<<(unsigned int)((n + BWD_THREADS - 1) / BWD_THREADS), BWD_THREADS, 0, stream>>>(
        planes, xyz, g, ggx, (unsigned int)M, H, W, lbound, dg, dxyz, 0, 0, nullptr, nullptr, nullptr, nullptr);
    return (int)cudaGetLastError();
  }
  const int T_ = tiles_of(H, W, C);
  const unsigned int rows = 3u * (unsigned int)M;
  const int B = count_blocks(rows, C, T_);
  BwdScratch s = carve(iscratch, rows, T_);
  int* rl = list_rows(s, B, T_);
  cudaError_t err;
  const int use_hist = T_ <= HIST_MAX;
  if (!use_hist && (err = cudaMemsetAsync(s.matrix, 0, sizeof(int) * (size_t)B * T_, stream)) != cudaSuccess)
    return (int)err;
  static bool hist_attr = false;
  if (!hist_attr) {
    cudaFuncSetAttribute(bwd_xyz_bwd_kernel<C, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, 4 * HIST_MAX);
    hist_attr = true;
  }
  bwd_xyz_bwd_kernel<C, T><<<B, BWD_THREADS, use_hist ? sizeof(int) * (size_t)T_ : 0, stream>>>(
      planes, xyz, g, ggx, (unsigned int)M, H, W, lbound, dg, dxyz, T_, use_hist, s.keys, rl, rl + rows, s.matrix);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return launch_bins<C, T, true>(xyz, g, M, H, W, lbound, grad, s, B, T_, partials, stream, ggx);
}

// K2x². planes (3, H, W, C) channel-last, bf16 (bf16 != 0) or f32; xyz (M, 3)
// f32; g (M, 3, C) f32, K2x's cotangent; ggx (M, 3) f32, the cotangent of
// K2x's dL/dxyz -> dg (M, 3, C) f32 and dxyz (M, 3) f32 (one launch; either
// null: not computed), and grad (3, H, W, C) in the plane dtype, every
// element written (the K2 backward's six passes in DERIV mode, iscratch and
// partials as sample_points_backward_workspace sizes them; null: not
// computed). No synchronisation.
extern "C" int sample_points_backward_xyz_backward_launch(const void* planes, const float* xyz, const float* g,
                                                          const float* ggx, int M, int H, int W, int C, int bf16,
                                                          float lbound, float* dg, float* dxyz, void* grad,
                                                          int* iscratch, float* partials, cudaStream_t stream) {
  if (M == 0) return 0;
  if (H < 2 || W < 2) return (int)cudaErrorInvalidValue;
#define K2XX(CC)                                                                                          \
  case CC:                                                                                                \
    return bf16 ? launch_xyz_bwd<CC, __nv_bfloat16>((const __nv_bfloat16*)planes, xyz, g, ggx, M, H, W, lbound, \
                                                    dg, dxyz, (__nv_bfloat16*)grad, iscratch, partials, stream) \
                : launch_xyz_bwd<CC, float>((const float*)planes, xyz, g, ggx, M, H, W, lbound, dg, dxyz,       \
                                            (float*)grad, iscratch, partials, stream);
  switch (C) {
    K2XX(4)
    K2XX(8)
    K2XX(16)
    K2XX(32)
    default: return (int)cudaErrorInvalidValue;
  }
#undef K2XX
}
