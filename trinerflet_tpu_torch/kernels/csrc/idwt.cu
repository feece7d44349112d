// K4: one level of the inverse 2D DWT (stride-2 synthesis) and its adjoint,
// each one launch per level, tiled in shared memory.
//
// Replaces trinerflet_tpu/ops/wavelets.py:510 idwt2d (via _synthesis_1d :460,
// _synthesis_operator :365, _apply_operator :389), driven by
// trinerflet_tpu/models/triplane.py:168 _idwt_ladder, and its backward, the
// transpose of :389. The JAX package runs each 1-D pass as a dense
// banded-matrix product on the TPU's matrix unit, where more than 99% of the
// operator entries are zero.
//
// What bounds it on the H100: bytes. Each output is ~L/2 taps from `lo` and
// ~L/2 from `hi` (9 + 9 for bior6.8): a few flops per byte, far below the
// card's f32 ridge, so the floor is reading yl + yh once and writing the
// plane once (the adjoint: reading the plane's cotangent once and writing the
// four bands' once). The tensor cores cannot help. Close to that floor the
// f32 FMAs and the instructions around them (18 + 18 FMAs per output of a
// bior6.8 level) become the limit, so the kernel also keeps those few.
//
// Design: one block per output tile of one plane; the grid is (tiles of the
// columns, tiles of the rows, planes), so all index arithmetic is 32-bit and
// divides only by compile-time constants. The block copies its input window
// (the tile's rows and columns of the four bands, or of the cotangent, with
// the taps' halo) into shared memory once, with asynchronous 16-byte copies
// where the rows allow (all of a thread's copies in flight together), zero
// outside the array, so no tap tests a bound. The first 1-D pass runs from
// shared memory into shared memory and the second writes the tile: the
// rounded intermediate (lo / hi, or their cotangents) never goes to device
// memory. Shared memory holds the plane dtype, in which every staged value
// is exact (lo / hi are already rounded to it): bf16 halves its bytes, and
// more blocks fit on an SM. The halo's extra rows of the first pass (NW - 1
// per tile in the forward) are recomputed by each tile that needs them.
//
// Polyphase pairs: output 2k + e of a 1-D synthesis is
//   sum_m x[k + S_e - m] * g[P_e + 2m], m = 0 .. L/2 - 1,
// so one thread makes both outputs of a pair from one window of NW inputs
// held in registers, and every thread of a warp uses the same taps. The tap
// count and the synthesis pad are template parameters (one instantiation per
// filter bank of ops/wavelets.py); every loop over taps is unrolled, so each
// tap is a compile-time offset into the kernel's parameters.
//
// Rounding and order: sums are f32 and run over the taps in ascending order,
// rounded to the plane dtype where the JAX package rounds (after each 1-D
// operator, e.g. S0 . yl and S1 . lh, and after their add; the adjoint after
// each transposed operator). The window's zeros add exact zeros, so the sums
// equal those of a loop that skips the out-of-range taps.
//
// Adjoint: each 1-D synthesis out[j] = sum_i x[i] g[j - 2i + off]
// (off = L - 1 - pl) transposes to the stride-2 correlation
// x[i] = sum_t y[2i + t - off] g[t], the analysis shape, with the same taps.
// A block owns a tile of (H, W) coefficients, loads the (2 tile + L - 2)
// window of the cotangent, runs the H correlation into shared memory (the
// cotangents of lo and hi) and the W correlation into yl's and the three
// bands'.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define MAX_TAPS 32

// The tiles are the fastest of those measured on bench.py's ladder
// (scripts/torch_k4_timing.py times them); a re-tune edits them here.
constexpr int NT = 256;    // threads per block
constexpr int TH = 64;     // forward: output rows per tile
constexpr int TW = 128;    // forward: output columns per tile
constexpr int RPT = 4;     // forward second pass: output row pairs per thread
constexpr int TI = 24;     // adjoint: coefficient rows per tile
constexpr int TJ = 64;     // adjoint: coefficient columns per tile
constexpr int RPT_A = 4;   // adjoint first pass: coefficient rows per thread
static_assert(TH % (2 * RPT) == 0 && TI % RPT_A == 0, "whole row groups per tile");

struct Taps {
  float g0[MAX_TAPS];
  float g1[MAX_TAPS];
};

// The geometry of one synthesis filter bank: L taps, left pad PL.
template <int L, int PL>
struct Syn {
  static constexpr int HALF = L / 2;
  static constexpr int OFF = L - 1 - PL;
  static constexpr int S0 = OFF >> 1, P0 = OFF & 1;
  static constexpr int S1 = (OFF + 1) >> 1, P1 = (OFF + 1) & 1;
  static constexpr int HI = S0 > S1 ? S0 : S1;
  // the pair's window starts at input k (the lowest index, min S_e - HALF + 1, is 0)
  static constexpr int NW = HI + 1;
  static_assert(L % 2 == 0 && L <= MAX_TAPS && (PL == 0 || PL == 1), "even L, pad 0 or 1");
  static_assert((S0 < S1 ? S0 : S1) - (HALF - 1) == 0, "window starts at k");
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
// x rounded to T (round to nearest even), kept as a float
template <typename T> __device__ __forceinline__ float rnd(float x);
template <> __device__ __forceinline__ float rnd<float>(float x) { return x; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Staged values live in shared memory in the plane dtype: an input, or lo /
// hi already rounded to T, is exact in T, and bf16 halves the bytes.
// ld2: two adjacent values at an even offset as floats; st4: four values.
__device__ __forceinline__ float2 ld2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
}
__device__ __forceinline__ void st4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void st4(__nv_bfloat16* p, float a, float b, float c, float d) {
  const __nv_bfloat162 h[2] = {__floats2bfloat162_rn(a, b), __floats2bfloat162_rn(c, d)};
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
}

// 16-byte asynchronous copy from device to shared memory; wait_copies waits
// for all of the thread's copies.
__device__ __forceinline__ void copy16_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void wait_copies() { asm volatile("cp.async.wait_all;\n" ::); }

// One window chunk: row[c .. c + N) (N values of 16 bytes) into dst (16-byte
// aligned), zero where a column is outside [0, n) or the row is absent
// (nullptr). `vec`: rows are 16-byte aligned, so an in-range chunk is one
// asynchronous 16-byte copy and many are in flight at once.
template <typename T>
__device__ __forceinline__ void copy_chunk(const T* row, int c, int n, bool vec, T* dst) {
  constexpr int N = 16 / sizeof(T);
  if (row != nullptr && vec && c >= 0 && c + N <= n) {
    copy16_async(dst, row + c);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (row != nullptr && (unsigned)(c + i) < (unsigned)n)
        dst[i] = row[c + i];
      else
        store(dst + i, 0.f);
    }
  }
}

// x[0 .. 2 NX) = a[0 .. 2 NX) as floats, a at an even offset
template <int NX, typename T>
__device__ __forceinline__ void window2(const T* a, float* x) {
#pragma unroll
  for (int u = 0; u < NX; ++u) {
    const float2 t = ld2(a + 2 * u);
    x[2 * u] = t.x;
    x[2 * u + 1] = t.y;
  }
}

// Both outputs of one polyphase pair of a 1-D synthesis with taps G1 ? g1 : g0,
// from the pair's window x[0 .. NW).
template <int L, int PL, bool G1>
__device__ __forceinline__ void syn_pair(const float* x, const Taps& tp, float& o0, float& o1) {
  using S = Syn<L, PL>;
  float a = 0.f, b = 0.f;
#pragma unroll
  for (int m = 0; m < S::HALF; ++m)
    a += x[S::S0 - m] * (G1 ? tp.g1[S::P0 + 2 * m] : tp.g0[S::P0 + 2 * m]);
#pragma unroll
  for (int m = 0; m < S::HALF; ++m)
    b += x[S::S1 - m] * (G1 ? tp.g1[S::P1 + 2 * m] : tp.g0[S::P1 + 2 * m]);
  o0 = a;
  o1 = b;
}

template <int L, int PL>
struct FwdTile {
  static constexpr int NW = Syn<L, PL>::NW;
  static constexpr int CW = TW / 2 + NW - 1;    // window columns
  __host__ __device__ static constexpr int cwp(int v) { return (CW + v - 1) / v * v; }
  static constexpr int RW = TH / 2 + NW - 1;    // window rows (of the bands, and of lo / hi)
  __host__ __device__ static constexpr int smem_values(int v) { return 4 * RW * cwp(v) + 2 * RW * TW; }
};

// yl (P, H, W), yh (P, 3, H, W) with bands (hl, lh, hh) -> out (P, Ho, Wo);
// the tile is TH x TW outputs.
template <typename T, int L, int PL>
__global__ void __launch_bounds__(NT)
idwt_kernel(const T* __restrict__ yl, const T* __restrict__ yh, int H, int W, int Ho, int Wo,
            int vec, Taps tp, T* __restrict__ out) {
  using S = Syn<L, PL>;
  using F = FwdTile<L, PL>;
  constexpr int NW = S::NW;
  constexpr int V = 16 / sizeof(T);
  constexpr int CWP = F::cwp(V);
  constexpr int NCH = CWP / V;
  extern __shared__ float4 smem4[];
  T* smem = reinterpret_cast<T*>(smem4);
  constexpr int rw = F::RW;
  T* s_in = smem;                   // [4][rw][CWP]: yl, hl, lh, hh
  T* s_lo = smem + 4 * rw * CWP;    // [rw][TW]
  T* s_hi = s_lo + rw * TW;
  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * (TW / 2);  // the tile's first column pair = its first input column
  const int r0 = blockIdx.y * (TH / 2);  // its first row pair = its first input row
  const size_t plane = (size_t)H * W;
  const size_t p = blockIdx.z;

  // 1. the four bands' window
  for (int b = 0; b < 4; ++b) {
    const T* src = b == 0 ? yl + p * plane : yh + (p * 3 + b - 1) * plane;
    T* dst = s_in + b * rw * CWP;
    for (int it = tid; it < rw * NCH; it += NT) {
      const int rr = it / NCH, c = (it - rr * NCH) * V;
      const int gr = r0 + rr;
      copy_chunk<T>(gr < H ? src + gr * W : nullptr, k0 + c, W, vec != 0, dst + rr * CWP + c);
    }
  }
  wait_copies();
  __syncthreads();

  // 2. W pass: lo = rnd(rnd(yl . S0) + rnd(lh . S1)), hi = rnd(rnd(hl . S0) + rnd(hh . S1))
  //    on every window row, two column pairs (2s, 2s + 1) per thread from one
  //    window of NW + 1 columns, read as float2
  constexpr int NX = NW / 2 + 1;  // float2 reads covering NW + 1 columns
  for (int it = tid; it < rw * (TW / 4); it += NT) {
    const int r = it / (TW / 4), s2 = 2 * (it - r * (TW / 4));
    const T* a = s_in + r * CWP + s2;
    float y[4], l[4], h[4], d[4];
    float x[2 * NX];
    window2<NX>(a, x);
    syn_pair<L, PL, false>(x, tp, y[0], y[1]);
    syn_pair<L, PL, false>(x + 1, tp, y[2], y[3]);
    window2<NX>(a + 2 * rw * CWP, x);
    syn_pair<L, PL, true>(x, tp, l[0], l[1]);
    syn_pair<L, PL, true>(x + 1, tp, l[2], l[3]);
    window2<NX>(a + 1 * rw * CWP, x);
    syn_pair<L, PL, false>(x, tp, h[0], h[1]);
    syn_pair<L, PL, false>(x + 1, tp, h[2], h[3]);
    window2<NX>(a + 3 * rw * CWP, x);
    syn_pair<L, PL, true>(x, tp, d[0], d[1]);
    syn_pair<L, PL, true>(x + 1, tp, d[2], d[3]);
    float lo[4], hi[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      lo[i] = rnd<T>(rnd<T>(y[i]) + rnd<T>(l[i]));
      hi[i] = rnd<T>(rnd<T>(h[i]) + rnd<T>(d[i]));
    }
    st4(s_lo + r * TW + 2 * s2, lo[0], lo[1], lo[2], lo[3]);
    st4(s_hi + r * TW + 2 * s2, hi[0], hi[1], hi[2], hi[3]);
  }
  __syncthreads();

  // 3. H pass: out = rnd(lo . S0) + rnd(hi . S1), two columns and RPT row
  //    pairs per thread, one column at a time from a window of RPT + NW - 1
  //    rows in registers; each row pair's two columns in one store
  constexpr int WR = RPT + NW - 1;
  T* o_plane = out + p * (size_t)Ho * Wo;
  for (int it = tid; it < (TW / 2) * (TH / (2 * RPT)); it += NT) {
    const int c = 2 * (it % (TW / 2)), q0 = (it / (TW / 2)) * RPT;
    float o[2][RPT][2];  // [column][row pair][row 2k, 2k + 1]
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float wl[WR], wh[WR];
#pragma unroll
      for (int m = 0; m < WR; ++m) {
        const float2 a = ld2(s_lo + (q0 + m) * TW + c), b = ld2(s_hi + (q0 + m) * TW + c);
        wl[m] = h ? a.y : a.x;
        wh[m] = h ? b.y : b.x;
      }
#pragma unroll
      for (int q = 0; q < RPT; ++q) {
        float a0, a1, b0, b1;
        syn_pair<L, PL, false>(wl + q, tp, a0, a1);
        syn_pair<L, PL, true>(wh + q, tp, b0, b1);
        o[h][q][0] = rnd<T>(a0) + rnd<T>(b0);
        o[h][q][1] = rnd<T>(a1) + rnd<T>(b1);
      }
    }
    const int oc = blockIdx.x * TW + c;
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      const int orow = 2 * (r0 + q0 + q);
      if (oc < Wo && orow < Ho) {  // Wo and Ho are even
        T* op = o_plane + orow * Wo + oc;
        store2(op, o[0][q][0], o[1][q][0]);
        store2(op + Wo, o[0][q][1], o[1][q][1]);
      }
    }
  }
}

template <typename T, int L, int PL>
struct AdjTile {
  static constexpr int OFF = L - 1 - PL;
  static constexpr int V = 16 / sizeof(T);
  static constexpr int OFFA = (OFF + V - 1) / V * V;  // window origin 2 j0 - OFFA: whole vectors
  static constexpr int SH = OFFA - OFF;               // window column of cotangent column 2 j0 - OFF
  static constexpr int DC = 2 * TJ + L - 2;           // columns of the lo / hi cotangents
  static constexpr int GCP = (DC + SH + V - 1) / V * V;
  static constexpr int GR = 2 * TI + L - 2;           // window rows
  static constexpr int SMEM_VALUES = GR * GCP + 2 * TI * DC;
};

// G (P, Ho, Wo) -> d_yl (P, H, W), d_yh (P, 3, H, W) with bands (hl, lh, hh);
// the tile is TI x TJ coefficients.
template <typename T, int L, int PL>
__global__ void __launch_bounds__(NT)
idwt_adjoint_kernel(const T* __restrict__ G, int H, int W, int Ho, int Wo, int vec,
                    Taps tp, T* __restrict__ d_yl, T* __restrict__ d_yh) {
  using A = AdjTile<T, L, PL>;
  constexpr int V = A::V, DC = A::DC, GCP = A::GCP, NCH = GCP / V;
  extern __shared__ float4 smem4[];
  T* smem = reinterpret_cast<T*>(smem4);
  constexpr int gr = A::GR;
  T* s_g = smem;                 // [gr][GCP]: rows from 2 i0 - OFF, columns from 2 j0 - OFFA
  T* s_lo = smem + gr * GCP;     // [TI][DC]: column y is cotangent column 2 j0 - OFF + y
  T* s_hi = s_lo + TI * DC;
  const int tid = threadIdx.x;
  const int i0 = blockIdx.y * TI, j0 = blockIdx.x * TJ;
  const size_t p = blockIdx.z;
  const T* src = G + p * (size_t)Ho * Wo;

  // 1. the cotangent's window
  for (int it = tid; it < gr * NCH; it += NT) {
    const int rr = it / NCH, c = (it - rr * NCH) * V;
    const int row = 2 * i0 - A::OFF + rr;
    copy_chunk<T>((unsigned)row < (unsigned)Ho ? src + row * Wo : nullptr, 2 * j0 - A::OFFA + c, Wo,
                  vec != 0, s_g + rr * GCP + c);
  }
  wait_copies();
  __syncthreads();

  // 2. H correlation: d_lo[i][y] = rnd(sum_t G[2i + t - OFF][y] g0[t]), d_hi with g1,
  //    RPT_A rows per thread from one window of 2 RPT_A + L - 2 rows in registers
  constexpr int WR = 2 * RPT_A + L - 2;
  for (int it = tid; it < DC * (TI / RPT_A); it += NT) {
    const int y = it % DC, q0 = (it / DC) * RPT_A;
    float w[WR];
#pragma unroll
    for (int m = 0; m < WR; ++m) w[m] = to_f32(s_g[(2 * q0 + m) * GCP + y + A::SH]);
#pragma unroll
    for (int q = 0; q < RPT_A; ++q) {
      float sl = 0.f, sh = 0.f;
#pragma unroll
      for (int t = 0; t < L; ++t) {
        sl += w[2 * q + t] * tp.g0[t];
        sh += w[2 * q + t] * tp.g1[t];
      }
      store(s_lo + (q0 + q) * DC + y, sl);
      store(s_hi + (q0 + q) * DC + y, sh);
    }
  }
  __syncthreads();

  // 3. W correlation: d_yl[i][j] = sum_t d_lo[i][2j + t - OFF] g0[t], d_lh with g1,
  //    d_hl / d_hh from d_hi with g0 / g1
  const size_t plane = (size_t)H * W;
  for (int it = tid; it < TI * TJ; it += NT) {
    const int r = it / TJ, jj = it - r * TJ;
    const T* a = s_lo + r * DC + 2 * jj;
    const T* b = s_hi + r * DC + 2 * jj;
    float yl = 0.f, lh = 0.f, hl = 0.f, hh = 0.f;
#pragma unroll
    for (int u = 0; u < L / 2; ++u) {
      const float2 vl = ld2(a + 2 * u), vh = ld2(b + 2 * u);
      yl += vl.x * tp.g0[2 * u];
      lh += vl.x * tp.g1[2 * u];
      hl += vh.x * tp.g0[2 * u];
      hh += vh.x * tp.g1[2 * u];
      yl += vl.y * tp.g0[2 * u + 1];
      lh += vl.y * tp.g1[2 * u + 1];
      hl += vh.y * tp.g0[2 * u + 1];
      hh += vh.y * tp.g1[2 * u + 1];
    }
    const int i = i0 + r, j = j0 + jj;
    if (i < H && j < W) {
      const size_t off = (size_t)i * W + j;
      store(d_yl + p * plane + off, yl);
      store(d_yh + (p * 3 + 0) * plane + off, hl);
      store(d_yh + (p * 3 + 1) * plane + off, lh);
      store(d_yh + (p * 3 + 2) * plane + off, hh);
    }
  }
}

static Taps make_taps(const float* g0, const float* g1, int L) {
  Taps tp;
  for (int t = 0; t < MAX_TAPS; ++t) {
    tp.g0[t] = t < L ? g0[t] : 0.f;
    tp.g1[t] = t < L ? g1[t] : 0.f;
  }
  return tp;
}

static bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// The kernels' shared memory is a constant of each instance, so its limit
// is raised on the instance's first launch only.
template <typename T, int L, int PL>
static int launch_fwd(const void* yl, const void* yh, int P, int H, int W, const Taps& tp,
                      void* out, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  constexpr int bytes = FwdTile<L, PL>::smem_values(V) * (int)sizeof(T);
  const int Ho = 2 * H - L + 2, Wo = 2 * W - L + 2;
  auto kern = idwt_kernel<T, L, PL>;
  static const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  const int vec = aligned16(yl) && aligned16(yh) && W % V == 0;
  dim3 grid((Wo + TW - 1) / TW, (Ho + TH - 1) / TH, P);
  kern<<<grid, NT, bytes, stream>>>((const T*)yl, (const T*)yh, H, W, Ho, Wo, vec, tp, (T*)out);
  return (int)cudaGetLastError();
}

template <typename T, int L, int PL>
static int launch_adj(const void* G, int P, int Ho, int Wo, const Taps& tp, void* d_yl,
                      void* d_yh, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  constexpr int bytes = AdjTile<T, L, PL>::SMEM_VALUES * (int)sizeof(T);
  const int H = (Ho + L - 2) / 2, W = (Wo + L - 2) / 2;
  auto kern = idwt_adjoint_kernel<T, L, PL>;
  static const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  const int vec = aligned16(G) && Wo % V == 0;
  dim3 grid((W + TJ - 1) / TJ, (H + TI - 1) / TI, P);
  kern<<<grid, NT, bytes, stream>>>((const T*)G, H, W, Ho, Wo, vec, tp, (T*)d_yl, (T*)d_yh);
  return (int)cudaGetLastError();
}

// The filter banks of ops/wavelets.py as (taps, left pad): haar, bior2.2,
// bior4.4, bior2.6, bior6.8.
#define IDWT_BANKS(X) X(2, 1) X(6, 0) X(10, 0) X(14, 0) X(18, 0)

// yl (P, H, W), yh (P, 3, H, W) of bf16 (bf16 != 0) or f32 -> out
// (P, 2H - L + 2, 2W - L + 2) of the same dtype, in tiles of TH x TW outputs.
// g0 / g1 are host arrays of L taps.
extern "C" int idwt_launch(const void* yl, const void* yh, int P, int H, int W, int bf16,
                           const float* g0, const float* g1, int L, int pl, void* out,
                           cudaStream_t stream) {
  if (P <= 0 || P > 65535) return (int)cudaErrorInvalidValue;
  if (2 * H - L + 2 <= 0 || 2 * W - L + 2 <= 0) return 0;
  const Taps tp = make_taps(g0, g1, L);
#define X(LL, PP)                                                                               \
  if (L == LL && pl == PP)                                                                      \
    return bf16 ? launch_fwd<__nv_bfloat16, LL, PP>(yl, yh, P, H, W, tp, out, stream) \
                : launch_fwd<float, LL, PP>(yl, yh, P, H, W, tp, out, stream);
  IDWT_BANKS(X)
#undef X
  return (int)cudaErrorInvalidValue;
}

// G (P, Ho, Wo) of bf16 (bf16 != 0) or f32 -> d_yl (P, H, W), d_yh (P, 3, H, W)
// with H = (Ho + L - 2) / 2, W = (Wo + L - 2) / 2, in tiles of TI x TJ
// coefficients.
extern "C" int idwt_adjoint_launch(const void* G, int P, int Ho, int Wo, int bf16, const float* g0,
                                   const float* g1, int L, int pl, void* d_yl, void* d_yh,
                                   cudaStream_t stream) {
  if (P <= 0 || P > 65535) return (int)cudaErrorInvalidValue;
  if (Ho + L - 2 < 2 || Wo + L - 2 < 2) return 0;
  const Taps tp = make_taps(g0, g1, L);
#define X(LL, PP)                                                                               \
  if (L == LL && pl == PP)                                                                      \
    return bf16 ? launch_adj<__nv_bfloat16, LL, PP>(G, P, Ho, Wo, tp, d_yl, d_yh, stream) \
                : launch_adj<float, LL, PP>(G, P, Ho, Wo, tp, d_yl, d_yh, stream);
  IDWT_BANKS(X)
#undef X
  return (int)cudaErrorInvalidValue;
}
